"""The resize-and-argmax head — the wrapper of
``csrc/resize_bilinear_argmax.cu`` and its plain PyTorch version.

    maps[n, y, x] = argmax_k F.interpolate(logits, (H, W), mode="bilinear",
                                           align_corners)[n, k, y, x]

as int32, lowest class on ties. The JAX package leaves this head to XLA;
there is no TPU kernel. The kernel reads the logits once and writes only the
maps: the resized logits (19 classes of 88 frames at 1024x2048: 7.0 GB in
bf16) never reach device memory, and no output size is refused. Its values
are ``F.interpolate``'s on the card bit for bit, so its maps are those of
the resize and ``argmax`` it replaces; the source note says how. In float32
PyTorch's result depends on the logits' layout (its channels_last kernel
rounds one lerp otherwise), so the wrapper tells the kernel which layout the
caller's logits have before it makes them channels_last.

``resized_argmax`` takes the plain version for a CPU tensor: the resize and
argmax over ``nn/functional.frame_chunks``, each chunk under a
``gop.head_chunk`` span. A CUDA tensor launches the kernel, under one
``gop.head_chunk`` span, or raises on what it does not take.
"""

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from arseg_tpu_torch.nn.functional import frame_chunks
from arseg_tpu_torch.ops import _build

NAME = "resize_bilinear_argmax"
# PyTorch resizes channels_last logits of this many classes or more with its
# channels_last kernel (fewer: with its NCHW kernel, as found on the card);
# in float32 that kernel contracts the top row's lerp the other way from its
# NCHW kernel (the source note), so the kernel is told which one to match
CHANNELS_LAST_MIN = 16


def _reads_as_channels_last(t):
    """Whether PyTorch suggests channels_last for the 4-D tensor t, as its
    resize does to choose a kernel (c10's is_channels_last_strides_2d_s4:
    strides falling in the order C, W, H, N, ambiguous ones NCHW)."""
    sizes, strides = t.shape, t.stride()
    if strides[1] == 0:
        return False
    least = 0
    for d in (1, 3, 2, 0):
        if sizes[d] == 0 or strides[d] < least or (d == 0 and least == strides[1]):
            return False
        least = strides[d] * sizes[d] if sizes[d] > 1 else strides[d]
    return True


def resized_argmax_plain(logits, out_hw, align_corners):
    """int32 maps [n, *out_hw]: ``F.interpolate`` and ``argmax`` over
    ``frame_chunks``, so that no resized chunk reaches ``F.interpolate``'s
    INT_MAX elements, each chunk's maps written into one output."""
    n, c = logits.shape[:2]
    preds = torch.empty((n, *out_hw), dtype=torch.int32, device=logits.device)
    for lo, hi in frame_chunks(n, c * out_hw[0] * out_hw[1]):
        with record_function("gop.head_chunk"):
            up = F.interpolate(logits[lo:hi], size=tuple(out_hw), mode="bilinear",
                               align_corners=align_corners)
            preds[lo:hi] = up.argmax(dim=1)
    return preds


def resized_argmax(logits, out_hw, align_corners):
    """logits [N, C, h, w] (float32 or bfloat16 on a card) -> int32 maps
    [N, *out_hw]: the argmax of their bilinear resize to ``out_hw``. CPU
    tensors take the plain version; others launch the kernel, on logits
    made channels_last first where they are not."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if logits.device.type == "cpu":
        return resized_argmax_plain(logits, out_hw, align_corners)
    if logits.dim() != 4:
        raise ValueError(f"{NAME} takes NCHW logits, got shape {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME} takes float32 or bfloat16, got {logits.dtype}")
    n, c, h_in, w_in = logits.shape
    top_right = (logits.dtype == torch.float32 and c >= CHANNELS_LAST_MIN
                 and _reads_as_channels_last(logits))
    x = logits.contiguous(memory_format=torch.channels_last)
    preds = torch.empty((n, *out_hw), dtype=torch.int32, device=logits.device)
    with record_function("gop.head_chunk"):
        _build.launch(NAME, preds, x, n, c, h_in, w_in, *out_hw, bool(align_corners), top_right,
                      x.dtype)
    return preds
