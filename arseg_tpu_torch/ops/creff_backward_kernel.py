"""K1B: the backward of K1, the fused CReFF module — the wrapper of
``csrc/creff_qkv_fused_backward.cu`` and its plain PyTorch version.

For ``out = lr_up + softmax_o(q . k[+o]) . v[+o]`` with ``q = dw3(lr_up)``,
``k = dw3(ref)``, ``v = dw3(ref)`` (``creff_kernel``) and an incoming
gradient ``g``:

    dP[p,o] = g[p] . v[p+o]          dS = P (dP - sum_o P dP)
    dq[p] = sum_o dS[p,o] k[p+o]     dk[r] = sum_o dS[r-o,o] q[r-o]
    dv[r] = sum_o P[r-o,o] g[r-o]
    d lr_up = g + dw3^T(dq; Wq)      d ref = dw3^T(dk; Wk) + dw3^T(dv; Wv)

and the taps' and biases' gradients, pixel sums of dq, dk, dv against the
shifted inputs. Q, K, V and P are rounded to the input type as K1 rounds
them; every sum is float32. The JAX package has no kernel here (its
custom_vjp re-derives through composed ops); the source note in the ``.cu``
file says what bounds the kernel and how it is laid out.

``creff_qkv_fused_backward`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, raising on what the kernel does not
take.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch.ops import _build
from arseg_tpu_torch.ops.creff_kernel import CHANNEL_CHUNK, _dw3, aligned16

NAME = "creff_qkv_fused_backward"


def _weighting_t(x, wgt, kh, kw):
    """The transpose of ``local_weighting`` in its value: out[r] =
    sum_o wgt[r - o, o] x[r - o], over positions r inside the image."""
    n, h, w, c = x.shape
    ph, pw = kh // 2, kw // 2
    out = x.new_zeros(n, h + 2 * ph, w + 2 * pw, c)
    for o in range(kh * kw):
        dy, dx = divmod(o, kw)
        out[:, dy : dy + h, dx : dx + w] += wgt[..., o : o + 1] * x
    return out[:, ph : ph + h, pw : pw + w]


def _dw3_t(dy, taps):
    """The transpose of ``_dw3`` in its input, for one conv's [9, C] taps."""
    n, h, w, c = dy.shape
    out = dy.new_zeros(n, h + 2, w + 2, c)
    for t in range(9):
        a, b = divmod(t, 3)
        out[:, a : a + h, b : b + w] += dy * taps[t]
    return out[:, 1 : 1 + h, 1 : 1 + w]


def _dw3_grads(dy, x):
    """The gradients of one conv's taps and bias: [10, C], tap a*3+b (the
    sum over pixels of dy times x shifted by (a - 1, b - 1)), then the bias."""
    h, w = dy.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = [(dy * xp[:, a : a + h, b : b + w]).sum((0, 1, 2)) for a in range(3) for b in range(3)]
    return torch.stack(rows + [dy.sum((0, 1, 2))])


def creff_qkv_fused_backward_plain(lr_up, ref, g, taps, bias, kh, kw, need_ref=True):
    """The analytic backward in float32 torch ops (float64 for float64
    inputs): (d lr_up, d ref or None without ``need_ref``, d
    taps-and-biases [3, 10, C] in float32, or float64), the first two in
    the input type."""
    from arseg_tpu_torch.ops.local_attention import local_similar, local_weighting

    dt = lr_up.dtype
    at = torch.float64 if dt == torch.float64 else torch.float32
    lr, rf, g, taps, bias = (x.to(at) for x in (lr_up, ref, g, taps, bias))
    q = _dw3(lr, taps[0], bias[0], at).to(dt).to(at)
    k = _dw3(rf, taps[1], bias[1], at).to(dt).to(at)
    v = _dw3(rf, taps[2], bias[2], at).to(dt).to(at)
    p = torch.softmax(local_similar(q, k, kh, kw), dim=-1).to(dt).to(at)
    dp = local_similar(g, v, kh, kw)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = local_weighting(k, ds, kh, kw)
    dk = _weighting_t(q, ds, kh, kw)
    dv = _weighting_t(g, p, kh, kw)
    d_lr = (g + _dw3_t(dq, taps[0])).to(dt)
    d_ref = (_dw3_t(dk, taps[1]) + _dw3_t(dv, taps[2])).to(dt) if need_ref else None
    d_tb = torch.stack([_dw3_grads(dq, lr), _dw3_grads(dk, rf), _dw3_grads(dv, rf)])
    return d_lr, d_ref, d_tb


def creff_qkv_fused_backward(lr_up, ref, g, taps, bias, kh, kw, need_ref=True):
    """lr_up, ref, g [N, H, W, C] (float32 or bfloat16); taps, bias from
    ``pack_qkv`` -> (d lr_up, d ref or None, d taps-and-biases [3, 10, C]
    float32). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if lr_up.device.type == "cpu":
        return creff_qkv_fused_backward_plain(lr_up, ref, g, taps, bias, kh, kw, need_ref)
    if lr_up.dim() != 4 or lr_up.shape != ref.shape or lr_up.shape != g.shape:
        raise ValueError(f"lr_up {tuple(lr_up.shape)}, ref {tuple(ref.shape)} and g "
                         f"{tuple(g.shape)} must be one NHWC shape")
    if lr_up.dtype != ref.dtype or lr_up.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME} takes float32 or bfloat16 inputs of one dtype")
    n, h, w, c = lr_up.shape
    if c % CHANNEL_CHUNK:
        raise ValueError(f"{NAME} needs C % {CHANNEL_CHUNK} == 0, got C={c}")
    if kh != kw or kh not in (3, 5, 7):
        raise ValueError(f"{NAME} is built for square 3, 5 or 7 windows, got {kh}x{kw}")
    if tuple(taps.shape) != (3, 9, c) or tuple(bias.shape) != (3, c):
        raise ValueError("taps/bias must come from pack_qkv")
    devs = {t.device for t in (lr_up, ref, g, taps, bias)}
    if len(devs) != 1:
        raise ValueError(f"{NAME} inputs must be on one device, got {devs}")
    lr_up, ref, g = aligned16(lr_up), aligned16(ref), aligned16(g.to(lr_up.dtype))
    taps, bias = aligned16(taps.float()), aligned16(bias.float())
    lib = _build.kernels()
    d_lr = torch.empty_like(lr_up)
    d_ref = torch.empty_like(ref) if need_ref else None
    d_tb = torch.empty(3, 10, c, dtype=torch.float32, device=lr_up.device)
    ws = torch.empty(lib.creff_qkv_fused_backward_workspace(lr_up, int(kh)), dtype=torch.uint8,
                     device=lr_up.device)
    lib.creff_qkv_fused_backward(d_lr, d_ref, d_tb, ws, lr_up, ref, g, taps, bias, int(kh),
                                 int(kw))
    _build.LAUNCHES[NAME] += 1
    return d_lr, d_ref, d_tb


def unpack_qkv_grads(d_tb, wb):
    """[3, 10, C] gradients -> those of the torch weights and biases ``wb``
    (q_w, q_b, k_w, k_b, v_w, v_b: [C, 1, 3, 3] and [C]), each in its own
    dtype (``pack_qkv``'s layout reversed)."""
    out = []
    for i in range(3):
        wt, b = wb[2 * i], wb[2 * i + 1]
        out += [d_tb[i, :9].t().reshape(wt.shape).to(wt.dtype), d_tb[i, 9].to(b.dtype)]
    return out
