"""Plain float32 reference of AR-Seg's BiSeNetV1 with the CReFF ``local``
fusion (github.com/THU-LYJ-Lab/AR-Seg, ``model/bisenet.py:481-575``), in
plain PyTorch and written for this benchmark alone: it imports nothing of
the program under test and takes none of its weights or tables.

State-dict keys are the reference checkpoint's, so one seeded state dict
loads into the program's model and into this one. Semantics held:

- ResNet-18 context backbone (strides 1, 2, 2, 2); the context path's
  x2 nearest upsample of the 1/32 feature, resized bilinearly
  (align_corners=True) to the 1/16 grid where the sizes are odd; the
  spatial path resized to the context path's 1/8 grid;
- heads: 1x1 conv, then x8 (aux: x8, x16) bilinear, align_corners=False;
- CReFF ``local`` (MyAttention): the LR feature resized bilinearly
  (align_corners=True) to the warped HR feature's grid; depthwise 3x3
  Q/K/V convs; a 7x7 window of dot products in which positions outside the
  image have key 0 and value 0 (so logit 0, as ``nn.Unfold`` pads);
  softmax over the window; the weighted sum plus the upsampled LR feature;
- the MV warp of ``warpFeature``: grid 2 (i + f) / (n - 1) - 1, then
  ``F.grid_sample`` bilinear, zero padding, align_corners=False.

``lowp_mode(dtype)`` computes in a lower precision, emulated: inside it
every conv's input, weight and output, every BatchNorm's and resize's
output, the window's Q, K, V, probabilities and output, and the warp's
output are rounded to ``dtype`` (float8 e4m3 with one scale per tensor,
or bfloat16), and so is the gradient flowing back through each of those
points. ``fp8_control()`` is the comparison's control.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

_LOWP = [None]
FP8_MAX = 448.0


@contextlib.contextmanager
def lowp_mode(dtype):
    _LOWP[0] = dtype
    try:
        yield
    finally:
        _LOWP[0] = None


def fp8_control():
    return lowp_mode(torch.float8_e4m3fn)


def _round(x, dtype):
    if dtype == torch.bfloat16:
        return x.to(dtype).to(x.dtype)
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


def lowp(x):
    """x rounded to the ``lowp_mode`` precision (and its gradient on the
    way back); x itself outside it."""
    if _LOWP[0] is None or not x.is_floating_point():
        return x
    return _Round.apply(x, _LOWP[0])


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return lowp(F.conv2d(lowp(x), lowp(self.weight), self.bias, self.stride, self.padding,
                             self.dilation, self.groups))


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        return lowp(super().forward(x))


def bn(c):
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, ks, stride=stride, padding=padding, bias=False)
        self.bn = bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(Conv2d(cin, planes, 1, stride=stride, bias=False),
                                            bn(planes))

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for i, stride in enumerate((1, 2, 2, 2)):
            planes = 64 * 2 ** i
            setattr(self, f"layer{i + 1}", nn.Sequential(BasicBlock(cin, planes, stride),
                                                         BasicBlock(planes, planes, 1)))
            cin = planes

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        x2 = self.layer2(self.layer1(x))
        x3 = self.layer3(x2)
        return x2, x3, self.layer4(x3)


def up_to(x, hw, align_corners):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return lowp(F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners))


def up_by(x, k):
    return lowp(F.interpolate(x, size=(x.shape[-2] * k, x.shape[-1] * k), mode="bilinear",
                              align_corners=False))


class ARM(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = bn(cout)

    def forward(self, x):
        feat = self.conv(x)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(feat.mean((2, 3), True))))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.arm16 = ARM(256, 128)
        self.arm32 = ARM(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        s32 = self.arm32(f32) + self.conv_avg(f32.mean((2, 3), True))
        up32 = self.conv_head32(up_to(F.interpolate(s32, scale_factor=2, mode="nearest"),
                                      f16.shape[-2:], True))
        up16 = self.conv_head16(F.interpolate(self.arm16(f16) + up32, scale_factor=2,
                                              mode="nearest"))
        return up16, up32


class SpatialPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(3, 64, ks=7, stride=2, padding=3)
        self.conv2 = ConvBNReLU(64, 64, stride=2)
        self.conv3 = ConvBNReLU(64, 64, stride=2)
        self.conv_out = ConvBNReLU(64, 128, ks=1, padding=0)

    def forward(self, x):
        return self.conv_out(self.conv3(self.conv2(self.conv1(x))))


class FFM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.convblk = ConvBNReLU(c, c, ks=1, padding=0)
        self.conv = Conv2d(c, c, 1, bias=False)
        self.bn = bn(c)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        return feat * torch.sigmoid(self.bn(self.conv(feat.mean((2, 3), True)))) + feat


class Output(nn.Module):
    def __init__(self, cin, mid, n_classes, up):
        super().__init__()
        self.up = up
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = Conv2d(mid, n_classes, 1, bias=True)

    def forward(self, x):
        return up_by(self.conv_out(self.conv(x)), self.up)


def window_attention(q, k, v, win=7):
    """softmax over the win x win window of q . k, weighting v; NCHW, zero
    key and value outside the image. A loop over the window's offsets, so
    that autograd keeps views and not unfolded copies."""
    h, w = q.shape[-2:]
    r = win // 2
    q, k, v = lowp(q), lowp(k), lowp(v)
    kp = F.pad(k, (r, r, r, r))
    vp = F.pad(v, (r, r, r, r))
    offs = [(dy, dx) for dy in range(win) for dx in range(win)]
    logits = torch.stack([(q * kp[:, :, dy:dy + h, dx:dx + w]).sum(1) for dy, dx in offs], 1)
    p = lowp(torch.softmax(logits, dim=1))
    out = torch.zeros_like(v)
    for o, (dy, dx) in enumerate(offs):
        out = out + p[:, o:o + 1] * vp[:, :, dy:dy + h, dx:dx + w]
    return lowp(out)


class LocalFusion(nn.Module):
    """MyAttention: the CReFF ``local`` fusion."""

    def __init__(self, c, win=7):
        super().__init__()
        self.win = win
        self.lr_query_conv = Conv2d(c, c, 3, padding=1, groups=c, bias=True)
        self.hr_key_conv = Conv2d(c, c, 3, padding=1, groups=c, bias=True)
        self.hr_value_conv = Conv2d(c, c, 3, padding=1, groups=c, bias=True)

    def forward(self, hr, lr):
        lr_up = up_to(lr, hr.shape[-2:], True)
        return lr_up + window_attention(self.lr_query_conv(lr_up), self.hr_key_conv(hr),
                                        self.hr_value_conv(hr), self.win)


class BiSeNetV1(nn.Module):
    """``with_fuse``: the AR model (CReFF after ``conv_out.conv``);
    ``aux``: the two auxiliary heads of training."""

    def __init__(self, n_classes, with_fuse=False, aux=True, win=7):
        super().__init__()
        self.cp = ContextPath()
        self.sp = SpatialPath()
        self.ffm = FFM(256)
        self.conv_out = Output(256, 256, n_classes, 8)
        if aux:
            self.conv_out16 = Output(128, 64, n_classes, 8)
            self.conv_out32 = Output(128, 64, n_classes, 16)
        if with_fuse:
            self.fuse_attention = LocalFusion(256, win)

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """The checkpoint's second names of the head (``feat_conv_out``,
        ``final_conv``) are the same modules: they are checked equal and
        dropped."""
        sd = dict(state_dict)
        for alias, name in (("feat_conv_out.", "conv_out.conv."),
                            ("final_conv.", "conv_out.conv_out.")):
            for key in [k for k in sd if k.startswith(alias)]:
                other = name + key[len(alias):]
                if other in sd and not torch.equal(sd[key], sd[other]):
                    raise ValueError(f"{key} differs from {other}")
                del sd[key]
        return super().load_state_dict(sd, strict=strict, assign=assign)

    def trunk(self, x):
        f8, f16 = self.cp(x)
        fuse = self.ffm(up_to(self.sp(x), f8.shape[-2:], True), f8)
        return f8, f16, self.conv_out.conv(fuse)

    def key(self, x):
        """HR keyframe: (logits x8, the feature after ``conv_out.conv``)."""
        feat = self.trunk(x)[-1]
        return up_by(self.conv_out.conv_out(feat), 8), feat

    def phase1(self, x):
        """(aux16, aux32, mid) at the LR input."""
        f8, f16, mid = self.trunk(x)
        return self.conv_out16(f8), self.conv_out32(f16), mid

    def phase2(self, mid, ref):
        """(logits x8, fused feature) from the LR feature and the warped
        keyframe feature."""
        fused = self.fuse_attention(ref, mid)
        return up_by(self.conv_out.conv_out(fused), 8), fused


def warp(feat, fx, fy):
    """``warpFeature``: feat [n, C, H, W] sampled at (x + fx, y + fy),
    fx, fy [n, H, W] in pixels of the feature grid."""
    n, _, h, w = feat.shape
    xs = torch.arange(w, device=feat.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=feat.device, dtype=torch.float32).view(1, h, 1)
    grid = torch.stack([2.0 * (xs + fx) / max(w - 1, 1) - 1.0,
                        2.0 * (ys + fy) / max(h - 1, 1) - 1.0], dim=-1)
    return lowp(F.grid_sample(feat, grid.to(feat.dtype), mode="bilinear", padding_mode="zeros",
                              align_corners=False))


def flow_to_grid(fx, fy, hw, mode):
    """Frame-sized MV planes [n, Hf, Wf] in pixels -> the feature grid hw:
    "bilinear" (serving: resized with align_corners=True, then scaled by
    h / Hf) or "nearest" (training: scaled, then nearest)."""
    s = hw[0] / fx.shape[-2]
    planes = torch.stack([fx, fy], 1).float()
    if mode == "bilinear":
        planes = up_to(planes, hw, True) * s
    else:
        planes = F.interpolate(planes * s, size=tuple(hw), mode="nearest")
    return planes[:, 0], planes[:, 1]
