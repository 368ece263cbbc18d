"""CReFF local cross-attention ops, NHWC layout (port of
``arseg_tpu/ops/local_attention.py``):

  similar:   w[n,y,x,o]  = sum_c q[n,y,x,c] * k[n, y+dy-kh//2, x+dx-kw//2, c]
  weighting: out[n,y,x,c] = sum_o w[n,y,x,o] * v[n, y+dy-kh//2, x+dx-kw//2, c]

with o = dy*kw + dx row-major and zero padding outside the image: a window
position outside the image contributes logit 0 (not -inf) and value 0,
exactly like nn.Unfold.

``creff_attention`` is softmax(similar(q, k)) . v on Q, K, V that the
caller computed; its forward goes through K4
(``creff_attention_kernel.creff_attention``). ``creff_local_module`` is
the whole MyAttention forward (3x3 depthwise Q/K/V convs + windowed
attention + residual); its forward goes through K1
(``creff_kernel.creff_qkv_fused``). Each runs the kernel on the card and
its plain version on the CPU; each backward re-derives the gradients
through the composed ops, as the JAX custom_vjps do.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch.ops import creff_attention_kernel, creff_kernel
from arseg_tpu_torch.ops.resize import resize_bilinear


def _offsets(kh, kw):
    return [(dy, dx) for dy in range(kh) for dx in range(kw)]


def _pad_hw(x, kh, kw):
    ph, pw = kh // 2, kw // 2
    return F.pad(x, (0, 0, pw, pw, ph, ph))


def local_similar(q, k, kh: int, kw: int):
    """q, k: [N,H,W,C] -> [N,H,W,kh*kw] neighbourhood dot products."""
    h, w = q.shape[1:3]
    kp = _pad_hw(k, kh, kw)
    return torch.stack(
        [(q * kp[:, dy : dy + h, dx : dx + w]).sum(-1) for dy, dx in _offsets(kh, kw)],
        dim=-1,
    )


def local_weighting(v, wgt, kh: int, kw: int):
    """v: [N,H,W,C], wgt: [N,H,W,kh*kw] -> [N,H,W,C] weighted neighbourhood sum."""
    h, w = v.shape[1:3]
    vp = _pad_hw(v, kh, kw)
    out = torch.zeros_like(v)
    for o, (dy, dx) in enumerate(_offsets(kh, kw)):
        out = out + wgt[..., o : o + 1] * vp[:, dy : dy + h, dx : dx + w]
    return out


def creff_reference(q, k, v, kh: int, kw: int):
    """softmax(similar(q, k)) weighted sum of v."""
    return local_weighting(v, torch.softmax(local_similar(q, k, kh, kw), dim=-1), kh, kw)


class _CreffAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kh, kw):
        ctx.save_for_backward(q, k, v)
        ctx.window = (kh, kw)
        return creff_attention_kernel.creff_attention(q, k, v, kh, kw)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = creff_reference(*inputs, *ctx.window)
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)


def creff_attention(q, k, v, kh: int = 7, kw: int = 7):
    """softmax(similar(q, k)) weighted sum of v; q, k, v [N, H, W, C] of one
    shape (port of the JAX ``creff_attention`` custom_vjp)."""
    return _CreffAttention.apply(q, k, v, kh, kw)


def _dwconv3(x, weight, bias):
    """3x3 depthwise conv of NHWC x with a torch [C, 1, 3, 3] weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype),
                 padding=1, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def module_composed(lr_up, hr, q_w, q_b, k_w, k_b, v_w, v_b, kh, kw):
    """MyAttention forward through composed ops (the differentiable form)."""
    q = _dwconv3(lr_up, q_w, q_b)
    k = _dwconv3(hr, k_w, k_b)
    v = _dwconv3(hr, v_w, v_b)
    return lr_up + creff_reference(q, k, v, kh, kw)


class _CreffLocalModule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lr_up, hr, q_w, q_b, k_w, k_b, v_w, v_b, kh, kw):
        ctx.save_for_backward(lr_up, hr, q_w, q_b, k_w, k_b, v_w, v_b)
        ctx.window = (kh, kw)
        taps, bias = creff_kernel.pack_qkv(q_w, q_b, k_w, k_b, v_w, v_b)
        return creff_kernel.creff_qkv_fused(lr_up, hr, taps.to(lr_up.device),
                                            bias.to(lr_up.device), kh, kw)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = module_composed(*inputs, *ctx.window)
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)


def creff_local_module(lr_up, hr, q_w, q_b, k_w, k_b, v_w, v_b, kh: int = 7, kw: int = 7):
    """MyAttention forward on NHWC lr_up (already at hr's size) and hr; the
    conv weights are torch depthwise [C, 1, 3, 3] with biases [C]."""
    return _CreffLocalModule.apply(lr_up, hr, q_w, q_b, k_w, k_b, v_w, v_b, kh, kw)


def creff_local_module_resize(lr, hr, q_w, q_b, k_w, k_b, v_w, v_b, kh: int = 7, kw: int = 7):
    """MyAttention forward taking lr at its own resolution: bilinear resize
    to hr's size (align_corners=True), then the module. Gradients flow
    through the resize and the module's composed backward."""
    lr_up = resize_bilinear(lr, hr.shape[1:3], align_corners=True)
    return creff_local_module(lr_up, hr, q_w, q_b, k_w, k_b, v_w, v_b, kh, kw)
