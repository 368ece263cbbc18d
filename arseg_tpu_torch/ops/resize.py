"""Spatial resampling with torch ``F.interpolate`` semantics, NHWC layout.

Plain forms of ``arseg_tpu/ops/resize.py``: bilinear (``align_corners``
True and False), nearest, and the adaptive pools of the PSP head. The index
tables (``_linear_gather``, ``_linear_matrix``, ``_nearest_index``,
``_adaptive_avg_matrix``) are copies of the JAX package's, so the flow-plane
resize in ``ops/warp.py`` and the pools repeat its arithmetic. Their tensor
forms are copied to a device once: a copy from pageable host memory waits
for the device's queue, so a copy per call would stall the host behind
every kernel queued before it. They are made outside inference mode
whatever the first caller's mode: a table first made under
``torch.inference_mode`` (serving, eval) would be an inference tensor,
which autograd refuses to save, and a later training step of the same
shape in the same process would fail.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _linear_gather(in_size: int, out_size: int, align_corners: bool, dtype=np.float32):
    """(i0, i1, w) per output index for 1-D linear resampling; source
    coordinates are computed in float32, as torch does (in float64 with
    ``dtype=np.float64``, as torch does for float64 tensors)."""
    i = np.arange(out_size, dtype=dtype)
    if align_corners:
        if out_size == 1:
            src = np.zeros_like(i)
        else:
            scale = dtype(in_size - 1) / dtype(out_size - 1)
            src = i * scale
    else:
        scale = dtype(in_size) / dtype(out_size)
        src = np.maximum((i + dtype(0.5)) * scale - dtype(0.5), dtype(0))
    x0 = np.floor(src).astype(np.int64)
    w = (src - x0).astype(dtype)
    x0 = np.minimum(x0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    return x0, x1, w


@lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool):
    """[out_size, in_size] row-stochastic interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    x0, x1, w = _linear_gather(in_size, out_size, align_corners)
    np.add.at(m, (np.arange(out_size), x0), 1.0 - w)
    np.add.at(m, (np.arange(out_size), x1), w)
    return m


@lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int):
    """Index vector matching torch mode='nearest' along one axis."""
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


@lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int):
    """[out_size, in_size] averaging matrix matching AdaptiveAvgPool along
    one axis (start=floor(j*in/out), end=ceil((j+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for j in range(out_size):
        start = (j * in_size) // out_size
        end = -((-(j + 1) * in_size) // out_size)  # ceil
        m[j, start:end] = 1.0 / (end - start)
    return m


@lru_cache(maxsize=None)
@torch.inference_mode(False)
def _linear_gather_on(in_size: int, out_size: int, align_corners: bool, device, dtype):
    """``_linear_gather``'s tables as tensors on `device`, copied once."""
    i0, i1, w = _linear_gather(in_size, out_size, align_corners)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(w).to(device, dtype))


@lru_cache(maxsize=None)
@torch.inference_mode(False)
def _nearest_index_on(in_size: int, out_size: int, device):
    """``_nearest_index`` as a tensor on `device`, copied once."""
    return torch.from_numpy(_nearest_index(in_size, out_size)).to(device)


@lru_cache(maxsize=None)
@torch.inference_mode(False)
def _adaptive_avg_matrix_on(in_size: int, out_size: int, device):
    """``_adaptive_avg_matrix`` as a tensor on `device`, copied once."""
    return torch.from_numpy(_adaptive_avg_matrix(in_size, out_size)).to(device)


def _lerp_axis(x, in_size, out_size, align_corners, axis):
    """1-D linear resample along `axis`: two gathers and (1-w)*x0 + w*x1."""
    i0, i1, w = _linear_gather_on(in_size, out_size, align_corners, x.device, x.dtype)
    x0 = x.index_select(axis, i0)
    x1 = x.index_select(axis, i1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    wb = w.reshape(shape)
    return x0 * (1 - wb) + x1 * wb


def _as_nchw(x):
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    return x.reshape((-1, h, w, c)).permute(0, 3, 1, 2), lead


def _from_nchw(y, lead):
    y = y.permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def interpolate_bilinear(x, size, align_corners: bool):
    """F.interpolate(x, size, mode='bilinear', align_corners=...) of an NCHW
    tensor: the same values. When autograd records the call (training), it
    goes through ``resize_kernel.BilinearResize``, whose backward is the
    gather form (a kernel on the card) in place of PyTorch's atomic scatter;
    otherwise (serving, eval, no gradient) it is F.interpolate itself."""
    size = (int(size[0]), int(size[1]))
    if torch.is_grad_enabled() and x.requires_grad:
        # imported here: resize_kernel builds its tables from this module's
        from arseg_tpu_torch.ops.resize_kernel import BilinearResize

        return BilinearResize.apply(x, size, align_corners)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def resize_bilinear(x, out_hw, align_corners: bool):
    """Bilinear resize of an NHWC (any leading batch) tensor, matching
    F.interpolate(mode='bilinear', align_corners=...)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-3:-1]) == (oh, ow):
        return x
    y, lead = _as_nchw(x)
    return _from_nchw(interpolate_bilinear(y, (oh, ow), align_corners), lead)


def resize_nearest(x, out_hw):
    """Nearest resize of an NHWC tensor, matching torch mode='nearest'."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-3:-1]) == (oh, ow):
        return x
    y, lead = _as_nchw(x)
    y = F.interpolate(y, size=(oh, ow), mode="nearest")
    return _from_nchw(y, lead)


def adaptive_avg_pool(x, out_hw):
    """AdaptiveAvgPool2d of an NHWC (any leading batch) tensor: two
    averaging-matrix products in float32 (H, then W), cast back. On the H100
    at the PSP head's channels_last bf16 shapes this is far quicker than
    F.adaptive_avg_pool2d, whose kernel took about 1 ms a call there."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    mh = _adaptive_avg_matrix_on(h, oh, x.device)
    mw = _adaptive_avg_matrix_on(w, ow, x.device)
    y = torch.einsum("ph,...hwc->...pwc", mh, x.float())
    return torch.einsum("qw,...pwc->...pqc", mw, y).to(x.dtype)


def adaptive_max_pool_11(x):
    """AdaptiveMaxPool2d((1, 1)) + flatten: [..., H, W, C] -> [..., C]."""
    return x.amax(dim=(-3, -2))
