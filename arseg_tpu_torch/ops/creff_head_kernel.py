"""K3: the fused CReFF module + 1x1 ``final_conv`` + argmax — the wrapper of
``csrc/creff_phase2_argmax.cu`` and its plain PyTorch version.

Replaces ``arseg_tpu/ops/pallas_creff.py`` ``creff_phase2_argmax``
(``_qkv_head_kernel``), the camvid-psp18 V1 serving head:

    pred[n,y,x] = argmax_k(sum_c round(fused[n,y,x,c]) * fc_w[c,k] + fc_b[k])

with ``fused`` K1's function, rounded to the input type; int32 maps, lowest
index on ties. Bound at [11,720,960,64] bf16: bytes, about 0.59 ms (lr_up
and ref read once, the int32 map written once; the source note in the
``.cu`` file has the count). The kernel keeps the fused feature and the
logits in registers, so only the class map reaches device memory.

``creff_phase2_argmax`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, raising on what the kernel does not
take.
"""

import torch

from arseg_tpu_torch.ops import _build
from arseg_tpu_torch.ops.creff_kernel import CHANNEL_CHUNK, aligned16, creff_qkv_fused_plain

NAME = "creff_phase2_argmax"
MAX_CLASSES = 19  # csrc/creff_phase2_argmax.cu MAX_CLASSES


def pack_head(weight, bias, dtype):
    """Torch 1x1 conv weight [K, C, 1, 1] and bias [K] -> (fc_w [C, K],
    fc_b [K]) float32 holding values of ``dtype``, as the TPU kernel casts
    its packed head to the input type."""
    fc_w = weight.reshape(weight.shape[0], -1).t().to(dtype).float().contiguous()
    fc_b = bias.to(dtype).float().contiguous()
    return fc_w, fc_b


def creff_phase2_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Plain version: K1's plain version (the fused feature, rounded to the
    input type), then the 1x1 conv in float32 and the first index of the
    largest logit."""
    fused = creff_qkv_fused_plain(lr_up, ref, taps, bias, kh, kw).float()
    logits = torch.matmul(fused, fc_w.float()) + fc_b.float()
    return logits.argmax(dim=-1).to(torch.int32)


def creff_phase2_argmax(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """lr_up, ref [N, H, W, C] (float32 or bfloat16); taps, bias from
    ``creff_kernel.pack_qkv``; fc_w, fc_b from ``pack_head`` -> int32
    [N, H, W]. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if lr_up.device.type == "cpu":
        return creff_phase2_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
    lr_up, ref, args = check_head_args(NAME, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
    out = torch.empty(lr_up.shape[:3], dtype=torch.int32, device=lr_up.device)
    _build.kernels().creff_phase2_argmax(out, lr_up, ref, *args, int(kh), int(kw))
    _build.LAUNCHES[NAME] += 1
    return out


def check_head_args(name, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Raise on what the module + head kernels (K3, K5) do not take; else
    (lr_up, ref, [taps, bias, fc_w, fc_b]) contiguous and 16-byte aligned,
    the last four in float32."""
    if lr_up.dim() != 4 or lr_up.shape != ref.shape:
        raise ValueError(f"lr_up {tuple(lr_up.shape)} and ref {tuple(ref.shape)} must be one NHWC shape")
    if lr_up.dtype != ref.dtype or lr_up.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16 inputs of one dtype")
    c = lr_up.shape[-1]
    if c % CHANNEL_CHUNK:
        raise ValueError(f"{name} needs C % {CHANNEL_CHUNK} == 0, got C={c}")
    if kh != kw or kh not in (3, 5, 7):
        raise ValueError(f"{name} is built for square 3, 5 or 7 windows, got {kh}x{kw}")
    if tuple(taps.shape) != (3, 9, c) or tuple(bias.shape) != (3, c):
        raise ValueError("taps/bias must come from pack_qkv")
    if fc_w.dim() != 2 or fc_w.shape[0] != c or tuple(fc_b.shape) != (fc_w.shape[1],):
        raise ValueError(f"fc_w must be [C={c}, K] and fc_b [K], got {tuple(fc_w.shape)}, "
                         f"{tuple(fc_b.shape)}")
    if not 1 <= fc_w.shape[1] <= MAX_CLASSES:
        raise ValueError(f"{name} takes 1 to {MAX_CLASSES} classes, got {fc_w.shape[1]}")
    devs = {t.device for t in (lr_up, ref, taps, bias, fc_w, fc_b)}
    if len(devs) != 1:
        raise ValueError(f"{name} inputs must be on one device, got {devs}")
    args = [aligned16(x.float()) for x in (taps, bias, fc_w, fc_b)]
    return aligned16(lr_up), aligned16(ref), args
