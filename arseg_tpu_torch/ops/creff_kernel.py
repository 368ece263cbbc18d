"""K1: the fused CReFF module — the wrapper of ``csrc/creff_qkv_fused.cu``
and its plain PyTorch version.

Replaces ``arseg_tpu/ops/pallas_creff.py`` ``creff_qkv_fused``
(``_qkv_kernel`` -> ``_fused_module_body``):

    out = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)

over a kh x kw window, NHWC. The source note in the ``.cu`` file says what
bounds the kernel and how it is laid out.

``creff_qkv_fused`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on what the kernel does not take.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch.ops import _build

NAME = "creff_qkv_fused"
CHANNEL_CHUNK = 16  # csrc/creff_qkv_fused.cu CC


def aligned16(x):
    """x contiguous, copied if its data does not start on 16 bytes (the
    bfloat16 body stages its halos, taps and biases with 16-byte copies)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def pack_qkv(q_w, q_b, k_w, k_b, v_w, v_b):
    """Torch depthwise weights [C, 1, 3, 3] and biases [C] of the three
    convs -> (taps [3, 9, C], bias [3, C]) float32, tap a*3+b."""
    taps = torch.stack([wt.reshape(wt.shape[0], 9).t() for wt in (q_w, k_w, v_w)])
    bias = torch.stack([q_b, k_b, v_b])
    return taps.float().contiguous(), bias.float().contiguous()


def _dw3(x, taps, bias, dtype=torch.float32):
    """3x3 depthwise conv (zero padding) of NHWC x in float32 (or ``dtype``),
    taps summed in the kernel's order (columns outer, rows inner), then the
    bias."""
    n, h, w, _ = x.shape
    xp = F.pad(x.to(dtype), (0, 0, 1, 1, 1, 1))
    acc = None
    for b in range(3):
        for a in range(3):
            term = xp[:, a : a + h, b : b + w, :] * taps[a * 3 + b]
            acc = term if acc is None else acc + term
    return acc + bias


def creff_module_f32_plain(lr_up, ref, taps, bias, kh, kw):
    """The module body's arithmetic up to its float32 output (what an
    epilogue receives): float32 depthwise convs with Q, K, V rounded to the
    input type, float32 logits and softmax, p rounded to the input type,
    float32 window sum and residual. Window positions outside the image are
    zero (logit 0, value 0)."""
    from arseg_tpu_torch.ops.local_attention import local_similar, local_weighting

    dt = lr_up.dtype
    q = _dw3(lr_up, taps[0], bias[0]).to(dt).float()
    k = _dw3(ref, taps[1], bias[1]).to(dt).float()
    v = _dw3(ref, taps[2], bias[2]).to(dt).float()
    p = torch.softmax(local_similar(q, k, kh, kw), dim=-1).to(dt).float()
    return lr_up.float() + local_weighting(v, p, kh, kw)


def creff_qkv_fused_plain(lr_up, ref, taps, bias, kh, kw):
    """Plain version of the kernel's arithmetic: the module body in float32,
    rounded once to the input type."""
    return creff_module_f32_plain(lr_up, ref, taps, bias, kh, kw).to(lr_up.dtype)


def creff_qkv_fused(lr_up, ref, taps, bias, kh, kw):
    """lr_up, ref [N, H, W, C] (float32 or bfloat16); taps, bias from
    ``pack_qkv`` -> [N, H, W, C]. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if lr_up.device.type == "cpu":
        return creff_qkv_fused_plain(lr_up, ref, taps, bias, kh, kw)
    if lr_up.dim() != 4 or lr_up.shape != ref.shape:
        raise ValueError(f"lr_up {tuple(lr_up.shape)} and ref {tuple(ref.shape)} must be one NHWC shape")
    if lr_up.dtype != ref.dtype or lr_up.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME} takes float32 or bfloat16 inputs of one dtype")
    c = lr_up.shape[-1]
    if c % CHANNEL_CHUNK:
        raise ValueError(f"{NAME} needs C % {CHANNEL_CHUNK} == 0, got C={c}")
    if kh != kw or kh not in (3, 5, 7):
        raise ValueError(f"{NAME} is built for square 3, 5 or 7 windows, got {kh}x{kw}")
    if tuple(taps.shape) != (3, 9, c) or tuple(bias.shape) != (3, c):
        raise ValueError("taps/bias must come from pack_qkv")
    devs = {t.device for t in (lr_up, ref, taps, bias)}
    if len(devs) != 1:
        raise ValueError(f"{NAME} inputs must be on one device, got {devs}")
    lr_up = aligned16(lr_up)
    ref = aligned16(ref)
    taps = aligned16(taps.float())
    bias = aligned16(bias.float())
    out = torch.empty_like(lr_up)
    _build.kernels().creff_qkv_fused(out, lr_up, ref, taps, bias, int(kh), int(kw))
    _build.LAUNCHES[NAME] += 1
    return out
