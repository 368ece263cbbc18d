from arseg_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_nearest,
    adaptive_avg_pool,
    adaptive_max_pool_11,
)
from arseg_tpu_torch.ops.warp import warp_feature, pad_for_warp, scale_and_resize_flow
from arseg_tpu_torch.ops.local_attention import (
    local_similar,
    local_weighting,
    creff_attention,
    creff_local_module,
    creff_local_module_resize,
)

__all__ = [
    "resize_bilinear",
    "resize_nearest",
    "adaptive_avg_pool",
    "adaptive_max_pool_11",
    "warp_feature",
    "pad_for_warp",
    "scale_and_resize_flow",
    "local_similar",
    "local_weighting",
    "creff_attention",
    "creff_local_module",
    "creff_local_module_resize",
]
