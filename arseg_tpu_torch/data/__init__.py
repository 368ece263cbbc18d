"""Host-side datasets and the loader — copies of the JAX package's
``data/*`` that the port's training, eval protocol and video inference
run. Importing this
package imports neither PIL nor cv2; the readers import them where they
open a file."""

from arseg_tpu_torch.data.camvid import CamVid, CamVidWithFlow, CamVidWithFlowTest
from arseg_tpu_torch.data.cityscapes import CityScapes, CityScapesWithFlow
from arseg_tpu_torch.data.loader import Loader, device_prefetch

__all__ = ["CamVid", "CamVidWithFlow", "CamVidWithFlowTest", "CityScapes",
           "CityScapesWithFlow", "Loader", "device_prefetch"]
