"""BiSeNetV1 (+ CReFF-fused variant), NCHW — port of
``arseg_tpu/nn/bisenet.py``.

Module names are the reference checkpoint's: ``cp`` (context path),
``sp`` (spatial path), ``ffm``, ``conv_out`` (+ ``conv_out16``/``conv_out32``
in aux_mode "train"), ``fuse_attention``; ``feat_conv_out`` and
``final_conv`` are the same module objects as ``conv_out.conv`` and
``conv_out.conv_out``, so the state dict carries both names, as the
reference's does, and a released ``.pth`` loads strict.

Serving entry points compute no auxiliary head: ``forward_key`` (HR
keyframe: logits + fused feature) and ``forward_phase1(x, with_aux=False)``.
``forward_phase2_argmax`` takes the planes head (1x1 conv, x8 bilinear,
argmax) unless ``USE_FUSED_UPSAMPLE_HEAD`` is set and the fusion is
"local": then K5 runs the fusion and the whole head in one kernel.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.attention import get_fusion
from arseg_tpu_torch.nn.functional import ConvBNReLU, batch_norm, resize_bilinear_nchw
from arseg_tpu_torch.nn.resnet import ResNet
from arseg_tpu_torch.ops import creff_kernel, creff_upsample_head_kernel
from arseg_tpu_torch.ops.resize import interpolate_bilinear, resize_bilinear

# The fused inference head (CReFF + final_conv + x8 upsample + argmax in one
# kernel, K5: ops/creff_upsample_head_kernel.py), as the JAX package's
# USE_FUSED_UPSAMPLE_HEAD. Off, as there. In five alternating pairs of
# tools_torch_profile_gop.py runs on camvid-bise18 (NVIDIA H100 80GB HBM3,
# 700 W) K5's head took 0.98 ms less device time per GOP than K1 + the
# planes head (5.384 against 6.361 ms) but won only two pairs of five on
# the wall clock: the path is host-bound, so the gain does not show yet
# (PERF.md, section 6).
USE_FUSED_UPSAMPLE_HEAD = False


def _upsample(x, factor):
    return interpolate_bilinear(x, (x.shape[-2] * factor, x.shape[-1] * factor), False)


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = batch_norm(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    def __init__(self, depth):
        super().__init__()
        self.resnet = ResNet(depth)
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x, return_stages=True)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = F.interpolate(feat32_sum, scale_factor=2, mode="nearest")
        feat32_up = self.conv_head32(resize_bilinear_nchw(feat32_up, feat16.shape[-2:], True))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(F.interpolate(feat16_sum, scale_factor=2, mode="nearest"))
        return feat16_up, feat32_up  # x8, x16


class SpatialPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(3, 64, ks=7, stride=2, padding=3)
        self.conv2 = ConvBNReLU(64, 64, stride=2)
        self.conv3 = ConvBNReLU(64, 64, stride=2)
        self.conv_out = ConvBNReLU(64, 128, ks=1, padding=0)

    def forward(self, x):
        return self.conv_out(self.conv3(self.conv2(self.conv1(x))))


class FeatureFusionModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1, padding=0)
        self.conv = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn = batch_norm(cout)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = torch.sigmoid(self.bn(self.conv(feat.mean(dim=(2, 3), keepdim=True))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin, mid, n_classes, up_factor):
        super().__init__()
        self.up_factor = up_factor
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = nn.Conv2d(mid, n_classes, 1, bias=True)

    def forward(self, x):
        return _upsample(self.conv_out(self.conv(x)), self.up_factor)


class BiSeNetV1(nn.Module):
    # forward_phase2_argmax returns class maps at 8x the fused feature's
    # resolution; dispatchers check feat_hw * 8 == target_hw
    phase2_argmax_upscale = 8

    def __init__(self, n_classes, backend="resnet18", aux_mode="train", with_fuse=False,
                 attention_type="local", atten_k=7, generator=None):
        super().__init__()
        self.n_classes = n_classes
        self.aux_mode = aux_mode
        self.with_fuse = with_fuse
        self.attention_type = attention_type
        self.atten_k = atten_k
        self.middle_dim = 256
        self.cp = ContextPath(int(backend.replace("resnet", "")))
        self.sp = SpatialPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes, 8)
        self.feat_conv_out = self.conv_out.conv
        self.final_conv = self.conv_out.conv_out
        if aux_mode == "train":
            self.conv_out16 = BiSeNetOutput(128, 64, n_classes, 8)
            self.conv_out32 = BiSeNetOutput(128, 64, n_classes, 16)
        if with_fuse:
            self.fuse_attention = get_fusion(attention_type, atten_k)(self.middle_dim)
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))

    def init_weights(self, gen):
        """The JAX package's init schemes: torch default for the backbone,
        kaiming_normal_(a=1) elsewhere, default BN."""
        self.cp.resnet.init_weights(gen)
        for name, m in self.named_modules():
            if name.startswith("cp.resnet"):
                continue
            if isinstance(m, nn.Conv2d) and m.groups == 1:
                Init.conv_kaiming_normal_a1_(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                Init.bn_default_(m)
        if self.with_fuse:
            self.fuse_attention.init_weights(gen)

    def _trunk(self, x):
        feat_cp8, feat_cp16 = self.cp(x)
        feat_sp = resize_bilinear_nchw(self.sp(x), feat_cp8.shape[-2:], True)
        return feat_cp8, feat_cp16, self.ffm(feat_sp, feat_cp8)

    def _aux(self, feat_cp8, feat_cp16):
        return self.conv_out16(feat_cp8), self.conv_out32(feat_cp16)

    def _main_head(self, feat_fuse):
        feat = self.conv_out.conv(feat_fuse)
        return _upsample(self.conv_out.conv_out(feat), 8), feat

    def forward(self, x, mode="normal", ref_p=None):
        """aux_mode "train": (out, out16, out32, feat); "eval": (out,).
        normal: feat is the feature after ``conv_out.conv``. merge (the
        fused model; ref_p the warped keyframe feature): phase 1, then the
        fusion with ref_p and the main head on the fused feature, which is
        feat, as the JAX ``apply(mode="merge")``."""
        if mode == "merge":
            aux = self.aux_mode == "train"
            p1 = self.forward_phase1(x, with_aux=aux)
            out, fused = self.forward_phase2(p1[-1] if aux else p1, ref_p)
            return (out, *p1[:2], fused) if aux else (out,)
        feat_cp8, feat_cp16, feat_fuse = self._trunk(x)
        out, feat_fuse = self._main_head(feat_fuse)
        if self.aux_mode == "train":
            return (out, *self._aux(feat_cp8, feat_cp16), feat_fuse)
        if self.aux_mode == "eval":
            return (out,)
        raise NotImplementedError(self.aux_mode)

    def forward_key(self, x):
        """Serving HR pass on the keyframe: (logits upsampled x8, the
        256-ch feature after conv_out.conv), no auxiliary head."""
        return self._main_head(self._trunk(x)[-1])

    def forward_phase1(self, x, with_aux=None):
        """LR backbone to the 256-ch mid feature; with the auxiliary heads
        (aux_mode "train" by default) returns (out16, out32, mid)."""
        if with_aux is None:
            with_aux = self.aux_mode == "train"
        feat_cp8, feat_cp16, feat_fuse = self._trunk(x)
        mid = self.conv_out.conv(feat_fuse)
        if with_aux:
            return (*self._aux(feat_cp8, feat_cp16), mid)
        return mid

    def forward_phase2(self, mid, ref):
        fused = self.fuse_attention(ref, mid)
        return _upsample(self.conv_out.conv_out(fused), 8), fused

    def forward_phase2_argmax(self, mid, ref, return_fused=False):
        """argmax(x8 bilinear(final_conv(CReFF fusion))) as int32 class maps
        [N, 8h, 8w]; with return_fused also the fused feature. Under
        USE_FUSED_UPSAMPLE_HEAD with the "local" fusion K5 computes the
        maps and never writes the fused feature; return_fused=True then
        computes it beside them (K1)."""
        if USE_FUSED_UPSAMPLE_HEAD and self.attention_type == "local":
            fa = self.fuse_attention
            ref_nhwc = ref.permute(0, 2, 3, 1)
            lr_up = resize_bilinear(mid.permute(0, 2, 3, 1), ref_nhwc.shape[1:3],
                                    align_corners=True)
            taps, bias = creff_kernel.pack_qkv(*fa.qkv_weights())
            fc_w, fc_b = creff_upsample_head_kernel.pack_upsample_head(
                self.final_conv.weight, self.final_conv.bias, lr_up.dtype)
            pred = creff_upsample_head_kernel.creff_phase2_upsample_argmax(
                lr_up, ref_nhwc, taps, bias, fc_w, fc_b, self.atten_k, self.atten_k)
            return (pred, fa(ref, mid)) if return_fused else pred
        fused = self.fuse_attention(ref, mid)
        pred = _upsample(self.conv_out.conv_out(fused), 8).argmax(dim=1).to(torch.int32)
        return (pred, fused) if return_fused else pred
