"""The yardstick's arithmetic: the published peaks of one H100, the
operations and bytes of the port's kernels K1 (fused CReFF module) and K2
(MV warp) from their shapes, and the counted FLOPs of a served GOP and of
a training step.

Kernel counts (frozen from ``chip_smoke.py``'s ``k1_case``, ``k2_case``
and ``_bound``): each input byte read once and each output byte written
once; K1 251 FLOP an element (three 3x3 depthwise convs 54, a 49-tap
window of logits 98 and of weighting 98, the residual 1), K2 7 an output
element (four bilinear products and their sum).

Model FLOPs: the plain float32 reference under
``torch.utils.flop_counter.FlopCounterMode`` on the meta device at the
cell's own shapes (convolutions and matrix products; elementwise work is
not counted), plus the frozen counts of the window (K1's 197 FLOP an
element past its convs; twice that for its backward) and of the warp.
"""

import functools

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK = {"bfloat16_flops": 989e12, "float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

K1_FLOPS = 251
K1_WINDOW_FLOPS = 197  # K1_FLOPS less the three depthwise convs (54)
K2_FLOPS = 7


def k1_cost(n, h, w, c, elem_bytes=2):
    """(FLOPs, bytes) of one K1 launch over [n, h, w, c]."""
    numel = n * h * w * c
    return numel * K1_FLOPS, 3 * numel * elem_bytes + (3 * 9 * c + 3 * c) * 4


def k2_cost(n, sources, h, w, c, elem_bytes=2):
    """(FLOPs, bytes) of one K2 launch: ``sources`` features [S, h, w, c]
    warped to n frames by float32 planes fx, fy [n, h, w]."""
    out = n * h * w * c
    return out * K2_FLOPS, sources * h * w * c * elem_bytes + 2 * n * h * w * 4 + out * elem_bytes


def bound_s(flops, nbytes, dtype="bfloat16"):
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK[f"{dtype}_flops"], nbytes / PEAK["hbm_bytes_per_s"])


def feature_hw(cfg):
    s = cfg["feature_stride"]
    return cfg["frame_hw"][0] // s, cfg["frame_hw"][1] // s


def lr_hw(cfg):
    return tuple(int(v * cfg["lr_scale"]) for v in cfg["frame_hw"])


def _counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def _models(cfg, device):
    from reference.model import BiSeNetV1

    with torch.device(device):
        return (BiSeNetV1(cfg["n_classes"], with_fuse=False),
                BiSeNetV1(cfg["n_classes"], with_fuse=True, win=cfg["atten_k"]))


@functools.lru_cache(maxsize=None)
def _serve_flops(frame_hw, lr, n_classes, atten_k, stride, gop, channels):
    cfg = dict(frame_hw=frame_hw, lr_scale=lr, n_classes=n_classes, atten_k=atten_k,
               feature_stride=stride)
    hr, ar = (m.eval() for m in _models(cfg, "meta"))
    fh, fw = feature_hw(cfg)
    n = gop - 1

    def gop_forward():
        hr.key(torch.empty(1, 3, *frame_hw, device="meta"))
        mid = ar.phase1(torch.empty(n, 3, *lr_hw(cfg), device="meta"))[-1]
        fa = ar.fuse_attention
        lr_up = F.interpolate(mid, size=(fh, fw), mode="bilinear", align_corners=True)
        ref = torch.empty(n, channels, fh, fw, device="meta")
        for conv, x in ((fa.lr_query_conv, lr_up), (fa.hr_key_conv, ref), (fa.hr_value_conv, ref)):
            conv(x)
        ar.conv_out.conv_out(lr_up)

    elems = n * fh * fw * channels
    return _counted(gop_forward) + elems * (K1_WINDOW_FLOPS + K2_FLOPS)


def serve_flops_per_gop(cfg):
    """FLOPs of one GOP: the HR keyframe, phase 1 of the G-1 frames at the
    LR scale, the fusion and the 1x1 head (the aux heads are not run)."""
    return _serve_flops(tuple(cfg["frame_hw"]), cfg["lr_scale"], cfg["n_classes"],
                        cfg["atten_k"], cfg["feature_stride"], cfg["gop"], cfg["middle_dim"])


@functools.lru_cache(maxsize=None)
def _train_flops(frame_hw, lr, n_classes, atten_k, stride, batch, channels):
    cfg = dict(frame_hw=frame_hw, lr_scale=lr, n_classes=n_classes, atten_k=atten_k,
               feature_stride=stride)
    teacher = _models(cfg, "meta")[1].eval()
    student = _models(cfg, "meta")[1]
    fh, fw = feature_hw(cfg)

    def step():
        x = torch.empty(batch, 3, *frame_hw, device="meta")
        with torch.no_grad():
            teacher.key(x)
            teacher.key(x)
        out16, out32, mid = student.phase1(torch.empty(batch, 3, *lr_hw(cfg), device="meta"))
        fa = student.fuse_attention
        lr_up = F.interpolate(mid, size=(fh, fw), mode="bilinear", align_corners=True)
        ref = torch.empty(batch, channels, fh, fw, device="meta")
        q = fa.lr_query_conv(lr_up)
        k = fa.hr_key_conv(ref)
        v = fa.hr_value_conv(ref)
        fused = lr_up + q + k + v
        out = student.conv_out.conv_out(fused)
        (out.sum() + out16.sum() + out32.sum() + fused.sum()).backward()

    elems = batch * fh * fw * channels
    return _counted(step) + elems * (3 * K1_WINDOW_FLOPS + K2_FLOPS)


def train_flops_per_step(cfg, batch):
    """FLOPs of one FST stage-2 step: two teacher forwards (frame and
    keyframe), the student's forward and backward at the LR scale with its
    aux heads, the fusion (window: forward once, backward twice) and the
    warp."""
    return _train_flops(tuple(cfg["frame_hw"]), cfg["lr_scale"], cfg["n_classes"],
                        cfg["atten_k"], cfg["feature_stride"], batch, cfg["middle_dim"])
