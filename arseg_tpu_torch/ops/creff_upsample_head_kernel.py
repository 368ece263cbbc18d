"""K5: the fused CReFF module + 1x1 ``final_conv`` + x8 bilinear upsample +
argmax — the wrapper of ``csrc/creff_phase2_upsample_argmax.cu`` and its
plain PyTorch version.

Replaces ``arseg_tpu/ops/pallas_creff.py`` ``creff_phase2_upsample_argmax``
(``_qkv_upsample_head_kernel``), BiSeNet's inference head under
``nn/bisenet.USE_FUSED_UPSAMPLE_HEAD``:

    pred = argmax_k(bilinear_x8(final_conv(MyAttention(lr_up, ref))))

with align_corners=False, int32 maps [N, 8h, 8w], lowest index on ties.
Neither the fused feature nor a logit plane reaches device memory. Unlike
K3, the 1x1 conv takes the fused feature unrounded, in float32, as the TPU
kernel does; only the logits are rounded. bfloat16 runs the tensor-core
module body ``csrc/creff_module_mma.cuh`` on overlapping 16 x 16 tiles and
the conv and upsample in float32 on the CUDA cores; float32, which only the
parity checks use, runs the CUDA-core body. Bound at [11,90,120,256] bf16:
bytes, about 0.045 ms (the source note in the ``.cu`` file has the count
and the design).

``creff_phase2_upsample_argmax`` takes the plain version for a CPU tensor
and launches the kernel for a CUDA tensor, raising on what the kernel does
not take.
"""

import numpy as np
import torch

from arseg_tpu_torch.ops.creff_head_kernel import launch_head
from arseg_tpu_torch.ops.creff_kernel import creff_module_f32_plain
from arseg_tpu_torch.ops.resize import _linear_gather

NAME = "creff_phase2_upsample_argmax"
UP = 8  # csrc/creff_phase2_upsample_argmax.cu UP


def pack_upsample_head(weight, bias, dtype):
    """Torch 1x1 conv weight [K, C, 1, 1] and bias [K] -> (fc_w [C, K]
    float32 holding values of ``dtype``, fc_b [K] float32). The TPU kernel
    casts the weight to the input type and keeps the bias in float32."""
    fc_w = weight.reshape(weight.shape[0], -1).t().to(dtype).float().contiguous()
    return fc_w, bias.float().contiguous()


def _lerp_x8(x, axis):
    """x UP resize along `axis` with align_corners=False, in float32, as
    (1 - w) * x[i0] + w * x[i1]; where the border clamp folds i1 onto i0
    the weights merge into 1 on i0 (the interpolation matrix's entry)."""
    i0, i1, w = _linear_gather(x.shape[axis], x.shape[axis] * UP, False)
    w = np.where(i0 == i1, np.float32(0), w)
    shape = [1] * x.dim()
    shape[axis] = w.size
    wt = torch.from_numpy(w).to(x.device).reshape(shape)
    x0 = x.index_select(axis, torch.from_numpy(i0).to(x.device))
    x1 = x.index_select(axis, torch.from_numpy(i1).to(x.device))
    return x0 * (1 - wt) + x1 * wt


def upsampled_logits_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """The float32 logits [N, 8h, 8w, K] that the plain version's argmax
    reads, the TPU kernel's sequence spelled out: the module in float32;
    per-class logits summed in float32, rounded to the input type; the
    column interpolation in float32, rounded to the input type; the row
    interpolation in float32; then the float32 bias."""
    dt = lr_up.dtype
    fused = creff_module_f32_plain(lr_up, ref, taps, bias, kh, kw)
    logits = torch.matmul(fused, fc_w.float()).to(dt).float()  # [N, h, w, K]
    cols = _lerp_x8(logits, 2).to(dt).float()                   # [N, h, 8w, K]
    return _lerp_x8(cols, 1) + fc_b.float()                     # [N, 8h, 8w, K]


def creff_phase2_upsample_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """Plain version: the first index of the largest of
    ``upsampled_logits_plain``."""
    logits = upsampled_logits_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
    return logits.argmax(dim=-1).to(torch.int32)


def creff_phase2_upsample_argmax(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
    """lr_up, ref [N, h, w, C] (float32 or bfloat16); taps, bias from
    ``creff_kernel.pack_qkv``; fc_w, fc_b from ``pack_upsample_head`` ->
    int32 [N, 8h, 8w]. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if lr_up.device.type == "cpu":
        return creff_phase2_upsample_argmax_plain(lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
    return launch_head(NAME, UP, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)
