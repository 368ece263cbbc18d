"""K4: windowed local attention — the wrapper of ``csrc/creff_attention.cu``
and its plain PyTorch version.

Replaces ``arseg_tpu/ops/pallas_creff.py`` ``creff_fused_pallas``
(``_kernel``), which ``ops/local_attention.creff_attention`` reaches for
every fusion variant of the "local" family except "local" itself:

    out = softmax(local_similar(q, k)) . v

over a kh x kw window, NHWC, q, k and v of one shape, without the
[N, H, W, kh*kw] weights in device memory. Window positions outside the
image give logit 0 and value 0, as ``nn.Unfold`` does. bfloat16 runs the
tensor-core window products of ``csrc/creff_module_mma.cuh`` (``mma.sync``,
``cp.async`` copies two chunks ahead); float32, which only the parity
checks use, runs a CUDA-core window loop. The source note in the ``.cu``
file says what bounds the kernel and how it is laid out.

``creff_attention`` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor, raising on what the kernel does not take:
the bfloat16 kernel copies 16 bytes at a time, so its tensors' data must
start on 16 bytes.
"""

import torch

from arseg_tpu_torch.ops import _build
from arseg_tpu_torch.ops.creff_kernel import check_inputs, check_shape

NAME = "creff_attention"


def creff_attention_plain(q, k, v, kh, kw):
    """Plain version: ``local_attention.creff_reference`` in float32 with p
    rounded to the input type before the weighting, as the TPU kernel
    rounds it, and one final rounding (both the identity in float32)."""
    from arseg_tpu_torch.ops.local_attention import local_similar, local_weighting

    dt = q.dtype
    p = torch.softmax(local_similar(q.float(), k.float(), kh, kw), dim=-1).to(dt).float()
    return local_weighting(v.float(), p, kh, kw).to(dt)


def creff_attention(q, k, v, kh, kw):
    """q, k, v [N, H, W, C] of one shape (float32 or bfloat16) -> [N, H, W, C].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    qkv = dict(q=q, k=k, v=v)
    check_shape(NAME, qkv)
    if q.device.type == "cpu":
        return creff_attention_plain(q, k, v, kh, kw)
    check_inputs(NAME, qkv, kh, kw)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{NAME} in bfloat16 needs q, k, v whose data starts on 16 bytes "
                         "(16-byte copies); got a view at an offset")
    out = torch.empty_like(q)
    _build.launch(NAME, out, q, k, v, *q.shape, kh, kw, q.dtype)
    return out
