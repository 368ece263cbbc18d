"""K2: bilinear zero-padding MV warp, NHWC — the wrapper of
``csrc/warp_bilinear.cu`` and its plain PyTorch version.

Replaces ``arseg_tpu/ops/pallas_warp.py`` (``_blocked_pass``) and
``arseg_tpu/ops/pallas_warp2.py`` (``ref_to_lanes_h``, ``warp_pass1``,
``transpose_mid``, ``warp_pass2``), which all compute
``arseg_tpu/ops/warp.py``'s ``warp_feature``. The source note in the ``.cu``
file says what bounds the kernel and how it is laid out.

Sources: ``src`` holds S images for n frames, n a multiple of S, and frame
i reads source ``i // (n // S)``. S = 1 is the GOP (one keyframe feature
warped to every frame), S = B the multi-GOP step (B keyframe features, each
warped to the G-1 frames of its GOP; the kernel reads each source in place,
where the JAX package repeats it G-1 times), S = n one source per frame
(the eval engine). The wrapper refuses an n that S does not divide.

``warp_bilinear`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on what the kernel does not take.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch.ops import _build

NAME = "warp_bilinear"


def _source_coord(i, f, n, align_corners):
    """Source coordinate along one axis in the JAX expression order:
    v = i + f; g = 2*v/max(n-1,1) - 1; then grid_sample's unnormalisation."""
    v = i + f
    # a tensor divisor: PyTorch turns division by a Python number into a
    # multiplication by its reciprocal on the card, which rounds differently
    g = 2.0 * v / torch.tensor(float(max(n - 1, 1)), device=v.device) - 1.0
    if align_corners:
        return (g + 1.0) * (n - 1) / 2.0
    return ((g + 1.0) * n - 1.0) / 2.0


def warp_bilinear_plain(src, fx, fy, align_corners=False):
    """Plain version: src [S, H, W, C]; fx, fy [N, H, W] float32 pixel
    displacements, N a multiple of S -> [N, H, W, C] in src's dtype; frame i
    samples source i // (N // S). Repeats
    ``arseg_tpu/ops/warp.py`` ``_grid_sample_planes`` step by step: floor,
    per-corner validity weights, a [2, 2, C] gather from the 1-px zero-padded
    source, float32 products summed in corner order, one rounding."""
    n, h, w = fx.shape
    c = src.shape[-1]
    xx = torch.arange(w, dtype=torch.float32, device=fx.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=fx.device)[None, :, None]
    ix = _source_coord(xx, fx.float(), w, align_corners)
    iy = _source_coord(yy, fy.float(), h, align_corners)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0

    def axis_w(v0, frac, lim, d):
        valid = ((v0 + d >= 0) & (v0 + d <= lim)).float()
        return (frac if d else 1 - frac) * valid

    wx0, wx1 = axis_w(x0, wx, w - 1, 0), axis_w(x0, wx, w - 1, 1)
    wy0, wy1 = axis_w(y0, wy, h - 1, 0), axis_w(y0, wy, h - 1, 1)
    # top-left corner in the 1-px zero-padded source, clipped to [0, w] as
    # the JAX gather is: a clipped index only lands on corners of weight 0
    xi = (x0.clamp(-1, w - 1) + 1).long()
    yi = (y0.clamp(-1, h - 1) + 1).long()
    fp = F.pad(src, (0, 0, 1, 1, 1, 1))
    ns = src.shape[0]
    fp = fp.expand(n, -1, -1, -1) if ns == 1 else fp.repeat_interleave(n // ns, dim=0)
    flat = fp.reshape(n, (h + 2) * (w + 2), c)
    xi1 = xi + 1
    yi1 = yi + 1

    def corner(yc, xc):
        idx = (yc * (w + 2) + xc).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c).float()

    out = (
        corner(yi, xi) * (wy0 * wx0)[..., None]
        + corner(yi, xi1) * (wy0 * wx1)[..., None]
        + corner(yi1, xi) * (wy1 * wx0)[..., None]
        + corner(yi1, xi1) * (wy1 * wx1)[..., None]
    )
    return out.to(src.dtype)


def warp_bilinear(src, fx, fy, align_corners=False):
    """src [S, H, W, C] (float32 or bfloat16); fx, fy [N, H, W] float32, N
    a multiple of S -> [N, H, W, C]; frame i samples source i // (N // S).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    n, h, w = fx.shape
    if (src.dim() != 4 or tuple(src.shape[1:3]) != (h, w) or src.shape[0] < 1
            or n % src.shape[0]):
        raise ValueError(f"src {tuple(src.shape)} does not match flow planes {tuple(fx.shape)}: "
                         f"one source per {n} // S frames, S dividing {n}")
    if src.device.type == "cpu":
        return warp_bilinear_plain(src, fx, fy, align_corners)
    if fy.shape != fx.shape or fx.dtype != torch.float32 or fy.dtype != torch.float32:
        raise ValueError("fx, fy must be float32 planes of one shape")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME} takes float32 or bfloat16, got {src.dtype}")
    if src.shape[-1] % 8:
        raise ValueError(f"{NAME} needs C % 8 == 0, got C={src.shape[-1]}")
    if (h + 1) * (w + 1) * src.shape[-1] > 2**31 - 1:
        raise ValueError(f"{NAME} indexes one frame's image in int32: [{h},{w},{src.shape[-1]}] "
                         f"is too large")
    if not (src.device == fx.device == fy.device):
        raise ValueError("src and flows must be on one device")
    src = src.contiguous()
    fx = fx.contiguous()
    fy = fy.contiguous()
    if src.data_ptr() % 16:
        raise ValueError(f"{NAME} needs a 16-byte aligned source")
    out = torch.empty((n, h, w, src.shape[-1]), dtype=src.dtype, device=src.device)
    _build.launch(NAME, out, src, fx, fy, n, src.shape[0], h, w, src.shape[-1], align_corners,
                  src.dtype)
    return out
