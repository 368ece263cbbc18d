"""Spatial resampling with torch ``F.interpolate`` semantics, NHWC layout.

Plain forms of ``arseg_tpu/ops/resize.py``: bilinear (``align_corners``
True and False) and nearest. The index tables (``_linear_gather``,
``_linear_matrix``, ``_nearest_index``) are copies of the JAX package's, so
the flow-plane resize in ``ops/warp.py`` repeats its arithmetic exactly.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _linear_gather(in_size: int, out_size: int, align_corners: bool):
    """(i0, i1, w) per output index for 1-D linear resampling; source
    coordinates are computed in float32, as torch does."""
    i = np.arange(out_size, dtype=np.float32)
    if align_corners:
        if out_size == 1:
            src = np.zeros_like(i)
        else:
            scale = np.float32(in_size - 1) / np.float32(out_size - 1)
            src = i * scale
    else:
        scale = np.float32(in_size) / np.float32(out_size)
        src = np.maximum((i + np.float32(0.5)) * scale - np.float32(0.5), np.float32(0))
    x0 = np.floor(src).astype(np.int64)
    w = (src - x0).astype(np.float32)
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


def _lerp_axis(x, in_size, out_size, align_corners, axis):
    """1-D linear resample along `axis`: two gathers and (1-w)*x0 + w*x1."""
    i0, i1, w = _linear_gather(in_size, out_size, align_corners)
    x0 = x.index_select(axis, torch.from_numpy(i0).to(x.device))
    x1 = x.index_select(axis, torch.from_numpy(i1).to(x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    wb = torch.from_numpy(w).to(x.device, x.dtype).reshape(shape)
    return x0 * (1 - wb) + x1 * wb


def _as_nchw(x):
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    return x.reshape((-1, h, w, c)).permute(0, 3, 1, 2), lead


def _from_nchw(y, lead):
    y = y.permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def resize_bilinear(x, out_hw, align_corners: bool):
    """Bilinear resize of an NHWC (any leading batch) tensor, matching
    F.interpolate(mode='bilinear', align_corners=...)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-3:-1]) == (oh, ow):
        return x
    y, lead = _as_nchw(x)
    y = F.interpolate(y, size=(oh, ow), mode="bilinear", align_corners=align_corners)
    return _from_nchw(y, lead)


def resize_nearest(x, out_hw):
    """Nearest resize of an NHWC tensor, matching torch mode='nearest'."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-3:-1]) == (oh, ow):
        return x
    y, lead = _as_nchw(x)
    y = F.interpolate(y, size=(oh, ow), mode="nearest")
    return _from_nchw(y, lead)
