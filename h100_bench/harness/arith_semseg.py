"""The yardstick's arithmetic for the Cityscapes PSPNet-18
(``reference/pspnet_semseg.py``): the counted FLOPs of a served GOP. The
peaks, the frozen window and warp counts and K1's and K2's costs are
``harness.arith``'s.

Model FLOPs: the reference under ``FlopCounterMode`` on the meta device at
the cell's shapes (convolutions; resizes, pools and elementwise work are
not counted): the HR keyframe's trunk, PPM and ``cls`` with its 1x1 head,
phase 1 of the G-1 frames at the LR scale (trunk, PPM and ``cls[:4]``),
and at the 1/8 feature grid the fusion's three depthwise convs and the 1x1
head on the fused feature; plus the frozen counts of the window (197 FLOP
an element past the convs) and of the warp (7). The aux head is not run.
"""

import functools

import torch
import torch.nn.functional as F

from harness import arith


def _model(n_classes, kwargs):
    from reference.pspnet_semseg import PSPNetSemsegAR

    with torch.device("meta"):
        return PSPNetSemsegAR(n_classes, **dict(kwargs)).eval()


def _key(cfg):
    kwargs = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                          for k, v in cfg.get("reference_kwargs", {}).items()))
    return (tuple(cfg["frame_hw"]), cfg["lr_scale"], cfg["n_classes"], cfg["gop"],
            cfg["middle_dim"], cfg["feature_stride"], kwargs)


@functools.lru_cache(maxsize=None)
def _serve_flops(frame_hw, lr, n_classes, gop, channels, stride, kwargs):
    model = _model(n_classes, kwargs)
    lr_hw = tuple(int(v * lr) for v in frame_hw)
    fh, fw = frame_hw[0] // stride, frame_hw[1] // stride
    n = gop - 1

    def gop_forward():
        model.key(torch.empty(1, 3, *frame_hw, device="meta"))
        mid = model.phase1(torch.empty(n, 3, *lr_hw, device="meta"))[-1]
        fa = model.fuse_attention
        lr_up = F.interpolate(mid, size=(fh, fw), mode="bilinear", align_corners=True)
        ref = torch.empty(n, channels, fh, fw, device="meta")
        for conv, x in ((fa.lr_query_conv, lr_up), (fa.hr_key_conv, ref), (fa.hr_value_conv, ref)):
            conv(x)
        model.final_conv(lr_up)

    elems = n * fh * fw * channels
    return arith._counted(gop_forward) + elems * (arith.K1_WINDOW_FLOPS + arith.K2_FLOPS)


def serve_flops_per_gop(cfg):
    """FLOPs of one GOP: the HR keyframe (with its head), phase 1 of the
    G-1 frames at the LR scale, the fusion and the head at 1/8, the warp."""
    return _serve_flops(*_key(cfg))

