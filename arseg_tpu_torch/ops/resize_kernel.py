"""The backward of bilinear resize in gather form — the wrapper of
``csrc/resize_bilinear_backward.cu``, its plain PyTorch version, and
``BilinearResize``, the autograd Function that training's resizes go
through (``ops/resize.interpolate_bilinear`` routes to it).

For ``y = F.interpolate(x, (Hout, Wout), mode="bilinear", align_corners)``
and an incoming gradient ``g`` of ``y``:

    dx[n, c, i, j] = sum_oh Ah[oh, i] * sum_ow Aw[ow, j] * g[n, c, oh, ow]

with ``Ah``, ``Aw`` the forward's per-axis weights (``resize._linear_gather``,
float32 source coordinates as torch computes them). The output indices that
read one input index form a contiguous run; ``transposed_tables`` lists, per
input index, the run's first output index, its length and its weights. Both
versions sum in float32 (float64 for float64 on the CPU), first along W,
then along H, and round once to the input type; PyTorch's own backward on
the card scatters with atomic adds, in the input type. The JAX package has
no kernel here (XLA transposes its resize); the source note in the ``.cu``
file says what bounds the kernel and how it is laid out.

``resize_bilinear_backward`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, raising on what the kernel does not
take. ``BilinearResize``'s forward is ``F.interpolate`` itself, so every
forward value is PyTorch's; it saves only the input's size and
``align_corners``, and its backward node is ``BilinearResizeBackward``.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from arseg_tpu_torch.ops import _build
from arseg_tpu_torch.ops.resize import _linear_gather

NAME = "resize_bilinear_backward"
# the launch plan (csrc/resize_bilinear_backward.cu). NCHW: a block walks a
# band of input rows a chunk of output rows at a time; the chunk is what
# LOADS_PER_BLOCK 16-byte loads hold (the kernel's kLoads x kThreads), or
# about CHUNK_FLOATS floats where rows are not 16-byte vectors, made smaller
# until the block's shared memory is within SMEM_TARGET (three blocks an SM);
# a plane is cut into as many bands as give BLOCKS blocks (eight an SM of the
# H100's 132). NHWC: a block holds T for all the output rows its band reads;
# the band is the tallest of BAND_ROWS within SMEM_TARGET that leaves BLOCKS
# blocks, with NHWC_VECTORS 16-byte vectors of channels a block (fewer where
# a band would not fit). SMEM_MAX is the most a block may take.
BAND_ROWS = (16, 8, 4, 2, 1)
SMEM_TARGET, SMEM_MAX = 72 * 1024, 232448
BLOCKS = 8 * 132
LOADS_PER_BLOCK, CHUNK_FLOATS = 4 * 256, 8192
NHWC_VECTORS = 4


@lru_cache(maxsize=None)
def transposed_tables(in_size: int, out_size: int, align_corners: bool, dtype=np.float32):
    """Per input index j: ([in, 2] int32: the first output index that reads
    j and how many do; [in, L] weights in `dtype`, 0 past the run). Output
    o reads i0(o) and i1(o) = min(i0(o) + 1, in - 1) with weights 1 - w(o)
    and w(o) (``resize._linear_gather``, in `dtype` as torch computes them
    for float64 tensors and in float32 for the others), and i0 never falls,
    so the outputs that read j are those with i0 in {j - 1, j}: one run.
    Where both taps fall on j (the last input index) their weights add."""
    i0, i1, w = _linear_gather(in_size, out_size, align_corners, dtype)
    j = np.arange(in_size)
    lo = np.searchsorted(i0, j - 1, side="left")
    length = np.searchsorted(i0, j, side="right") - lo
    k = np.arange(max(1, int(length.max())))
    o = np.minimum(lo[:, None] + k, out_size - 1)
    jj = j[:, None]
    wt = np.where(i0[o] == jj, 1 - w[o], dtype(0)) + np.where(i1[o] == jj, w[o], dtype(0))
    wt = np.where(k < length[:, None], wt, dtype(0)).astype(dtype)
    return np.stack([lo, length], 1).astype(np.int32), wt


@lru_cache(maxsize=None)
@torch.inference_mode(False)
def _tables_on(in_size: int, out_size: int, align_corners: bool, device):
    """``transposed_tables`` (float32) as tensors on `device`, copied once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in transposed_tables(in_size, out_size, align_corners))


@lru_cache(maxsize=None)
def band_rows(in_size: int, out_size: int, align_corners: bool, bh: int):
    """The most output rows that one band of ``bh`` input rows reads: from
    the first run's start to the last run's end (neither ever falls), as
    the kernel's band_rows."""
    runs, _ = transposed_tables(in_size, out_size, align_corners)
    first = runs[::bh, 0]
    last = runs[np.minimum(np.arange(bh - 1, in_size + bh - 1, bh), in_size - 1)].sum(1)
    return int(max(0, (last - first).max()))


def _row_pitch(wout):
    """A staged output row in floats, one skipped every 32 (the kernel's row_pitch)."""
    return wout + ((wout - 1) >> 5) + 1


def _nchw_floats(win, wout, lh, lw, chunk):
    """The NCHW kernel's shared memory in floats: the column tables
    (column_floats), a chunk of staged rows, the ring of T's rows
    (ring_rows: a power of two holding a chunk and a run)."""
    ring = 1 << (chunk + lh - 1).bit_length()
    return (2 * win + win * (lw | 1) + 3) // 4 * 4 + chunk * _row_pitch(wout) + ring * win


@lru_cache(maxsize=None)
def plan(nhwc, n, c, in_hw, out_hw, vec, align_corners):
    """(band rows, most output rows a band reads (NHWC; 0 for NCHW), tile)
    for the kernel: tile is the output rows a chunk (NCHW) or the 16-byte
    vectors of channels a block (NHWC). Raises where even the smallest tile
    does not fit a block's shared memory."""
    (hin, win), (hout, wout) = in_hw, out_hw
    lh = transposed_tables(hin, hout, align_corners)[1].shape[1]
    lw = transposed_tables(win, wout, align_corners)[1].shape[1]
    if not nhwc:
        if wout % vec == 0 and wout // vec <= LOADS_PER_BLOCK:
            chunk = LOADS_PER_BLOCK // (wout // vec)
        else:
            chunk = max(1, CHUNK_FLOATS // _row_pitch(wout))
        chunk = min(chunk, hout)
        while chunk > 1 and 4 * _nchw_floats(win, wout, lh, lw, chunk) > SMEM_TARGET:
            chunk -= 1
        if 4 * _nchw_floats(win, wout, lh, lw, chunk) > SMEM_MAX:
            raise ValueError(f"{NAME}: a row of {tuple(out_hw)} does not fit a block's shared "
                             f"memory")
        bands = min(hin, -(-BLOCKS // max(1, n * c)))
        return -(-hin // bands), 0, chunk
    fits = []
    for tile in dict.fromkeys(min(c // vec, t) for t in (NHWC_VECTORS, 2, 1)):
        for bh in BAND_ROWS:
            rmax = band_rows(hin, hout, align_corners, bh)
            smem = 4 * rmax * win * tile * vec
            if smem <= SMEM_MAX:
                fits.append((bh, rmax, tile, smem,
                             n * math.ceil(c // vec / tile) * math.ceil(hin / bh)))
    if not fits:
        raise ValueError(f"{NAME}: a band of one row of {tuple(in_hw)} <- {tuple(out_hw)} does "
                         f"not fit a block's shared memory")
    small = [f for f in fits if f[3] <= SMEM_TARGET]
    best = next((f for f in small if f[4] >= BLOCKS), None)
    if best is None:
        best = max(small, key=lambda f: f[4]) if small else min(fits, key=lambda f: f[3])
    return best[:3]


def _channels_last(t):
    """Whether t's channels are innermost (NHWC in memory; not where C = 1)."""
    return t.shape[1] > 1 and t.stride(1) == 1


def _contract(x, runs, wt):
    """[..., out] -> [..., in]: each input index's weighted run of x."""
    k = torch.arange(wt.shape[1], device=x.device)
    idx = (runs[:, :1].long() + k).clamp_(max=x.shape[-1] - 1)
    return (x[..., idx] * wt).sum(-1)


def resize_bilinear_backward_plain(g, in_hw, align_corners):
    """The gradient at the input, in float32 torch ops over the transposed
    tables (float64 ops and tables for float64 g): along W, then along H;
    in g's type and layout, on g's device."""
    at = np.float64 if g.dtype == torch.float64 else np.float32
    (hin, win), (hout, wout) = in_hw, g.shape[-2:]
    th, wh = (torch.from_numpy(a).to(g.device)
              for a in transposed_tables(hin, hout, align_corners, at))
    tw, ww = (torch.from_numpy(a).to(g.device)
              for a in transposed_tables(win, wout, align_corners, at))
    t = _contract(g.to(ww.dtype), tw, ww)
    dx = _contract(t.transpose(-1, -2), th, wh).transpose(-1, -2)
    fmt = torch.channels_last if _channels_last(g) else torch.contiguous_format
    return dx.to(g.dtype).contiguous(memory_format=fmt)


def resize_bilinear_backward(g, in_hw, align_corners):
    """g [N, C, Hout, Wout] (float32 or bfloat16 on a card) -> the gradient
    of F.interpolate(x, (Hout, Wout), mode="bilinear", align_corners) at an
    x of spatial size ``in_hw``, in g's type and layout, as PyTorch's own
    backward gives it: channels_last where g's channels are innermost (and
    fill 16-byte vectors), else NCHW-contiguous. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if g.device.type == "cpu":
        return resize_bilinear_backward_plain(g, in_hw, align_corners)
    if g.dim() != 4:
        raise ValueError(f"{NAME} takes an NCHW gradient, got shape {tuple(g.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME} takes float32 or bfloat16, got {g.dtype}")
    n, c, hout, wout = g.shape
    hin, win = int(in_hw[0]), int(in_hw[1])
    vec = 16 // g.element_size()
    nhwc = _channels_last(g) and c % vec == 0
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    g = g.contiguous(memory_format=fmt)
    if g.data_ptr() % 16:
        g = g.clone(memory_format=fmt)
    th, wh = _tables_on(hin, hout, align_corners, g.device)
    tw, ww = _tables_on(win, wout, align_corners, g.device)
    bh, rmax, tile = plan(nhwc, n, c, (hin, win), (hout, wout), vec, align_corners)
    dx = torch.empty((n, c, hin, win), dtype=g.dtype, device=g.device, memory_format=fmt)
    _build.launch(NAME, dx, g, th, wh, wh.shape[1], tw, ww, ww.shape[1], n, c, hin, win, hout,
                  wout, bh, rmax, tile, nhwc, g.dtype)
    return dx


class BilinearResize(torch.autograd.Function):
    """``F.interpolate(x, size, mode="bilinear", align_corners)`` whose
    backward is ``resize_bilinear_backward``. The gradient keeps the
    incoming gradient's layout, as PyTorch's own backward's does: in the
    FST step the loss's NCHW gradient of an OHEM resize is the incoming
    gradient of the head's x8 resize before it, so a copy to the input's
    channels_last layout would be undone at once."""

    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_hw = tuple(x.shape[-2:])
        ctx.align_corners = align_corners
        return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return resize_bilinear_backward(g, ctx.in_hw, ctx.align_corners), None, None
