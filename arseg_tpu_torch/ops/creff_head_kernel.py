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

``creff_phase2_argmax`` takes its first input at ref's size (lr_up) or
smaller: the LR feature, whose bilinear ``align_corners=True`` resize to
ref's size is lr_up. A bfloat16 LR feature on the card goes to the LR
form (``creff_phase2_argmax_lr``), which builds lr_up in shared memory,
equal to ``F.interpolate``'s on the card bit for bit, so it never reaches
device memory (about 0.37 ms of bytes at [11,360,480,64] ->
[11,720,960,64]); its launcher refuses more than 64 channels. A float32
one, which only the parity checks run, is resized by ``resize_bilinear``
and goes to the full-size kernel: a dispatch by dtype. A CPU tensor takes
the plain version; a CUDA tensor launches a kernel, raising on what the
kernel does not take.
"""

import torch

from arseg_tpu_torch.ops import _build
from arseg_tpu_torch.ops.creff_kernel import aligned16, check_inputs, creff_qkv_fused_plain
from arseg_tpu_torch.ops.resize import resize_bilinear

NAME = "creff_phase2_argmax"
NAME_LR = "creff_phase2_argmax_lr"  # the LR form: the same kernel reading the LR feature
MAX_CLASSES = 19  # csrc/creff_phase2_argmax.cu and creff_phase2_upsample_argmax.cu


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


def creff_phase2_argmax_lr_plain(lr, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Plain version of the LR form: lr resized to ref's size (bilinear,
    align_corners=True), then K3's plain version."""
    lr_up = resize_bilinear(lr, ref.shape[1:3], align_corners=True)
    return creff_phase2_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)


def _is_lr(lr, ref):
    """Whether ``lr`` is an LR feature for ``ref``: both NHWC, lr no taller
    and no wider than ref and smaller in one of the two."""
    if lr.dim() != 4 or ref.dim() != 4:
        return False
    (h_in, w_in), (h, w) = lr.shape[1:3], ref.shape[1:3]
    return h_in <= h and w_in <= w and (h_in, w_in) != (h, w)


def creff_phase2_argmax(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """lr_up [N, H, W, C] or the LR feature [N, h_in, w_in, C] (``_is_lr``),
    ref [N, H, W, C] (float32 or bfloat16); taps, bias from
    ``creff_kernel.pack_qkv``; fc_w, fc_b from ``pack_head`` -> int32
    [N, H, W]. CPU tensors take the plain version; CUDA tensors launch the
    kernel: the LR form for a bfloat16 LR feature."""
    if _is_lr(lr_up, ref):
        if lr_up.device.type == "cpu":
            return creff_phase2_argmax_lr_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
        if lr_up.dtype == torch.bfloat16:
            return launch_lr(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
        lr_up = resize_bilinear(lr_up, ref.shape[1:3], align_corners=True)
    if lr_up.device.type == "cpu":
        return creff_phase2_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
    return launch_head(NAME, 1, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)


def launch_lr(lr, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Launch the LR form after the CReFF checks (ref's, and lr's N, C and
    dtype against ref's) and the class count -> int32 [N, H, W]. The C
    launcher refuses more than 64 channels."""
    check_inputs(NAME_LR, dict(ref=ref), kh, kw, taps, bias, fc_w, fc_b)
    _check_classes(NAME_LR, fc_w)
    n, h, w, c = ref.shape
    if (lr.shape[0], lr.shape[3]) != (n, c) or lr.dtype != ref.dtype or lr.device != ref.device:
        raise ValueError(f"{NAME_LR}: lr {tuple(lr.shape)} {lr.dtype} must hold ref's frames and "
                         f"channels in ref's dtype on ref's device, ref {tuple(ref.shape)} "
                         f"{ref.dtype}")
    out = torch.empty((n, h, w), dtype=torch.int32, device=ref.device)
    _build.launch(NAME_LR, out, aligned16(lr), aligned16(ref),
                  *(aligned16(x.float()) for x in (taps, bias, fc_w, fc_b)),
                  n, lr.shape[1], lr.shape[2], h, w, c, fc_w.shape[1], kh, kw, ref.dtype)
    return out


def _check_classes(name, fc_w):
    if not 1 <= fc_w.shape[1] <= MAX_CLASSES:
        raise ValueError(f"{name} takes 1 to {MAX_CLASSES} classes, got {fc_w.shape[1]}")


def launch_head(name, up, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Launch a module + head kernel (K3 with ``up`` 1, K5 with ``up`` 8)
    after the CReFF checks and the class count -> int32 [N, up*h, up*w]."""
    check_inputs(name, dict(lr_up=lr_up, ref=ref), kh, kw, taps, bias, fc_w, fc_b)
    _check_classes(name, fc_w)
    n, h, w, c = lr_up.shape
    out = torch.empty((n, up * h, up * w), dtype=torch.int32, device=lr_up.device)
    _build.launch(name, out, aligned16(lr_up), aligned16(ref),
                  *(aligned16(x.float()) for x in (taps, bias, fc_w, fc_b)),
                  n, h, w, c, fc_w.shape[1], kh, kw, lr_up.dtype)
    return out
