"""The yardstick's arithmetic for PSPNet-18 V1 (``reference/pspnet.py``):
the operations and bytes of K3, the port's fused CReFF module with the 1x1
``final_conv`` and the argmax (``csrc/creff_phase2_argmax.cu``), from its
shapes, and the counted FLOPs of a served GOP. The peaks and the bound are
``harness.arith``'s.

K3 over [n, h, w, c] with k classes: each input byte read once (the
upsampled LR feature and the warped keyframe feature, bf16; the packed
taps, biases and head, float32) and each output byte written once (an
int32 class a pixel); a pixel-channel takes K1's 251 FLOP (three 3x3
depthwise convs 54, a 49-tap window of logits 98 and of weighting 98, the
residual 1) and 2 k for the 1x1 conv, and a pixel k more for its bias.

Model FLOPs: the reference under ``FlopCounterMode`` on the meta device at
the cell's shapes (convolutions and linear layers; resizes, pools and
elementwise work are not counted): the HR keyframe's backbone, PSP and
decoder with its ``final_conv``, phase 1 of the G-1 frames at the LR
scale, and the fusion's depthwise convs and ``final_conv`` at the frame's
size; plus the frozen counts of the window (197 FLOP an element past the
convs) and of the warp (7).
"""

import functools

import torch
import torch.nn.functional as F

from harness import arith

K3_FLOPS = arith.K1_FLOPS  # an element, before the head


def k3_cost(n, h, w, c, n_classes, elem_bytes=2):
    """(FLOPs, bytes) of one K3 launch over [n, h, w, c]."""
    pixels = n * h * w
    flops = pixels * (c * (K3_FLOPS + 2 * n_classes) + n_classes)
    params = (3 * 9 * c + 3 * c + c * n_classes + n_classes) * 4
    return flops, 2 * pixels * c * elem_bytes + pixels * 4 + params


def _model(cfg, fuse):
    from reference.pspnet import PSPNetV1

    with torch.device("meta"):
        return PSPNetV1(cfg["n_classes"], with_fuse=fuse, **cfg.get("reference_kwargs", {})).eval()


@functools.lru_cache(maxsize=None)
def _serve_flops(frame_hw, lr, n_classes, gop, channels, kwargs):
    cfg = dict(n_classes=n_classes, reference_kwargs=dict(kwargs))
    hr, ar = _model(cfg, False), _model(cfg, True)
    lr_hw = tuple(int(v * lr) for v in frame_hw)
    n = gop - 1

    def gop_forward():
        hr.key(torch.empty(1, 3, *frame_hw, device="meta"))
        mid = ar.phase1(torch.empty(n, 3, *lr_hw, device="meta"))[-1]
        fa = ar.fuse_attention
        lr_up = F.interpolate(mid, size=frame_hw, mode="bilinear", align_corners=True)
        ref = torch.empty(n, channels, *frame_hw, device="meta")
        for conv, x in ((fa.lr_query_conv, lr_up), (fa.hr_key_conv, ref), (fa.hr_value_conv, ref)):
            conv(x)
        ar.final_conv(lr_up)

    elems = n * frame_hw[0] * frame_hw[1] * channels
    return arith._counted(gop_forward) + elems * (arith.K1_WINDOW_FLOPS + arith.K2_FLOPS)


def serve_flops_per_gop(cfg):
    """FLOPs of one GOP: the HR keyframe (with its head), phase 1 of the
    G-1 frames at the LR scale, the fusion at full resolution, the head,
    and the warp."""
    kwargs = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                          for k, v in cfg.get("reference_kwargs", {}).items()))
    return _serve_flops(tuple(cfg["frame_hw"]), cfg["lr_scale"], cfg["n_classes"], cfg["gop"],
                        cfg["middle_dim"], kwargs)
