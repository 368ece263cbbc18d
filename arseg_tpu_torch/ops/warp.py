"""Motion-vector feature warping (torch grid_sample semantics), NHWC — port
of ``arseg_tpu/ops/warp.py``.

The reference's ``warpFeature`` builds an absolute sampling grid from
per-pixel motion vectors and calls ``F.grid_sample`` (bilinear, zero
padding, align_corners=False). Here the sampling is K2
(``warp_kernel.warp_bilinear``): the kernel on the card, its plain version
on the CPU.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch.ops import warp_kernel
from arseg_tpu_torch.ops.resize import _lerp_axis, _nearest_index_on


def pad_for_warp(feature):
    """1-px zero border of an NHWC feature: the form ``warp_feature`` takes
    with ``prepadded=True``."""
    return F.pad(feature, (0, 0, 1, 1, 1, 1))


def _planes(flow):
    if isinstance(flow, tuple):
        return flow
    return flow[..., 0], flow[..., 1]


def warp_feature(feature, flow, align_corners: bool = False, prepadded: bool = False):
    """Warp ``feature`` [S, H, W, C] by pixel displacements.

    flow: a tuple (fx, fy) of [N, H, W] planes, or an [N, H, W, 2] array,
    N a multiple of S: flow plane i samples feature i // (N // S) (the GOP
    warps one keyframe feature to each frame, the multi-GOP step B keyframe
    features to their GOPs' frames). prepadded=True: ``feature`` is
    ``pad_for_warp(source)`` and flow is at the unpadded geometry."""
    if prepadded:
        feature = feature[:, 1:-1, 1:-1]
    fx, fy = _planes(flow)
    return warp_kernel.warp_bilinear(feature, fx.float(), fy.float(), align_corners)


def _resize_plane_bilinear(x, out_hw, align_corners):
    """Bilinear resize of [..., H, W] planes: separable gather + lerp, the
    arithmetic of the JAX function (H axis, then W axis)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    y = _lerp_axis(x, h, oh, align_corners, x.ndim - 2)
    return _lerp_axis(y, w, ow, align_corners, x.ndim - 1)


def _resize_plane_nearest(x, out_hw):
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    y = x.index_select(-2, _nearest_index_on(h, oh, x.device))
    return y.index_select(-1, _nearest_index_on(w, ow, x.device))


def scale_and_resize_flow(flow, feat_hw, mode: str, split: bool = False):
    """Rescale MV magnitude to feature scale (x feat_h / flow_h, before the
    resample) and resample to feat_hw: bilinear align_corners=True (eval
    path) or nearest (train path). flow: [N, Hf, Wf, 2] or (fx, fy)
    planes. split=True returns (fx, fy) planes, else the stacked array."""
    fx, fy = _planes(flow)
    s = torch.tensor(feat_hw[0] / fx.shape[-2], dtype=torch.float32)
    fx = fx.float() * s
    fy = fy.float() * s
    if mode == "bilinear":
        fx = _resize_plane_bilinear(fx, feat_hw, True)
        fy = _resize_plane_bilinear(fy, feat_hw, True)
    elif mode == "nearest":
        fx = _resize_plane_nearest(fx, feat_hw)
        fy = _resize_plane_nearest(fy, feat_hw)
    else:
        raise ValueError(f"unknown flow resize mode: {mode}")
    if split:
        return fx, fy
    return torch.stack([fx, fy], dim=-1)
