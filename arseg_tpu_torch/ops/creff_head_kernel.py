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
from arseg_tpu_torch.ops.creff_kernel import aligned16, check_inputs, creff_qkv_fused_plain

NAME = "creff_phase2_argmax"
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


def creff_phase2_argmax(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """lr_up, ref [N, H, W, C] (float32 or bfloat16); taps, bias from
    ``creff_kernel.pack_qkv``; fc_w, fc_b from ``pack_head`` -> int32
    [N, H, W]. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if lr_up.device.type == "cpu":
        return creff_phase2_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
    return launch_head(NAME, 1, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)


def launch_head(name, up, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Launch a module + head kernel (K3 with ``up`` 1, K5 with ``up`` 8)
    after the CReFF checks and the class count -> int32 [N, up*h, up*w]."""
    check_inputs(name, dict(lr_up=lr_up, ref=ref), kh, kw, taps, bias, fc_w, fc_b)
    if not 1 <= fc_w.shape[1] <= MAX_CLASSES:
        raise ValueError(f"{name} takes 1 to {MAX_CLASSES} classes, got {fc_w.shape[1]}")
    n, h, w, c = lr_up.shape
    out = torch.empty((n, up * h, up * w), dtype=torch.int32, device=lr_up.device)
    _build.launch(name, out, aligned16(lr_up), aligned16(ref),
                  *(aligned16(x.float()) for x in (taps, bias, fc_w, fc_b)),
                  n, h, w, c, fc_w.shape[1], kh, kw, lr_up.dtype)
    return out
