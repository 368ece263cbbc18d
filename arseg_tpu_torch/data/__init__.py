"""Host-side datasets and the loader — copies of the JAX package's
``data/*``: the readers the port's training, eval protocol and video
inference run, and the CamVid variants (bidirectional flow, CU map) the
JAX package carries beside them. Importing this
package imports neither PIL nor cv2; the readers import them where they
open a file."""

from arseg_tpu_torch.data.camvid import (CamVid, CamVidWithBiFlow, CamVidWithFlow,
                                         CamVidWithFlowTest, CamVidwithCUmap,
                                         CamVidwithCUmapSingleBranch)
from arseg_tpu_torch.data.cityscapes import CityScapes, CityScapesWithFlow
from arseg_tpu_torch.data.loader import Loader, device_prefetch

__all__ = ["CamVid", "CamVidWithBiFlow", "CamVidWithFlow", "CamVidWithFlowTest",
           "CamVidwithCUmap", "CamVidwithCUmapSingleBranch", "CityScapes",
           "CityScapesWithFlow", "Loader", "device_prefetch"]
