"""PSPNet (Cityscapes / semseg flavour) + CReFF, NCHW — port of
``arseg_tpu/nn/pspnet_semseg.py``.

  layer0: 7x7/s2 conv, BN, relu, 3x3/s2 max pool; layer1-4: the dilated
    ResNet-18/34/50/101/152 in the "semseg" style (``nn/resnet.py``);
    ``feat_dim`` is layer4's width (512, or 2048 for the bottleneck ones).
  PPM: adaptive-avg pyramids -> 1x1 conv (no bias) -> BN -> relu ->
    bilinear upsample (align_corners=True) -> concat [x, p1..p4].
  cls: 3x3 conv (no bias) -> BN -> relu -> Dropout2d(0.1) -> 1x1 conv; aux
    the same on layer3's output. Logits are resized to the input size
    (align_corners=True). No log_softmax.
  With the fusion (the registry builds cityscapes-psp18 with it in both
  registries, as the reference does), CReFF acts on the 512-channel
  ``cls[:-1]`` feature at 1/8, and phase 2 is fusion -> ``cls[4]`` with no
  upsample.

Module names are the reference checkpoint's: ``layer0.{0,1}``,
``layer{1..4}``, ``ppm.features.{i}.{1,2}``, ``cls.{0,1,4}``,
``aux.{0,1,4}``, ``final_conv`` (the same module as ``cls[4]``, so the
state dict carries both names) and ``fuse_attention.*``.

Serving entry points compute no aux head: ``forward_key`` (HR keyframe:
logits at the input size + the feature CReFF takes) and
``forward_phase1(x, with_aux=False)``. There is no
``forward_phase2_argmax``: callers take forward_phase2 -> resize -> argmax.
With the "local" fusion, CReFF is K1 (``ops/creff_kernel.py``).
"""

import torch
import torch.nn as nn

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.attention import get_fusion
from arseg_tpu_torch.nn.functional import Dropout2d, batch_norm, resize_bilinear_nchw
from arseg_tpu_torch.nn.pspnet import AdaptiveAvgPool
from arseg_tpu_torch.nn.resnet import ResNet


class PPM(nn.Module):
    def __init__(self, in_dim, reduction_dim, bins):
        super().__init__()
        self.features = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(b), nn.Conv2d(in_dim, reduction_dim, 1, bias=False),
                          batch_norm(reduction_dim), nn.ReLU())
            for b in bins
        )

    def forward(self, x):
        hw = x.shape[-2:]
        return torch.cat([x] + [resize_bilinear_nchw(f(x), hw, True) for f in self.features],
                         dim=1)


def _head(cin, mid, n_classes, dropout):
    """3x3 conv (no bias) -> BN -> relu -> Dropout2d -> 1x1 conv: keys 0, 1, 4."""
    return nn.Sequential(nn.Conv2d(cin, mid, 3, padding=1, bias=False), batch_norm(mid), nn.ReLU(),
                         Dropout2d(dropout), nn.Conv2d(mid, n_classes, 1))


class PSPNetSemseg(nn.Module):
    """with_fuse=True adds the CReFF module at the 512-channel cls feature."""

    def __init__(self, layers=18, bins=(1, 2, 3, 6), dropout=0.1, classes=2, zoom_factor=8,
                 feat_dim=512, with_fuse=False, attention_type="local", atten_k=7,
                 generator=None):
        super().__init__()
        self.n_classes = classes
        self.zoom_factor = zoom_factor
        self.with_fuse = with_fuse
        self.attention_type = attention_type
        self.atten_k = atten_k
        self.middle_dim = 512
        trunk = ResNet(layers, variant="semseg")
        self.layer0 = nn.Sequential(trunk.conv1, trunk.bn1, nn.ReLU(),
                                    nn.MaxPool2d(3, stride=2, padding=1))
        self.layer1, self.layer2 = trunk.layer1, trunk.layer2
        self.layer3, self.layer4 = trunk.layer3, trunk.layer4
        self.ppm = PPM(feat_dim, feat_dim // len(bins), bins)
        self.cls = _head(feat_dim * 2, 512, classes, dropout)
        self.aux = _head(feat_dim // 2, 256, classes, dropout)
        self.final_conv = self.cls[4]
        if with_fuse:
            self.fuse_attention = get_fusion(attention_type, atten_k)(self.middle_dim)
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))

    def init_weights(self, gen):
        """The JAX package's init schemes: msra for the backbone, the torch
        default for the PPM and both heads, default BN, kaiming_normal_(a=1)
        in the fusion."""
        for name, m in self.named_modules():
            if name.startswith("fuse_attention"):
                continue
            backbone = name.startswith("layer")
            if isinstance(m, nn.Conv2d):
                (Init.conv_msra_ if backbone else Init.conv_kaiming_uniform_)(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                Init.bn_default_(m)
        if self.with_fuse:
            self.fuse_attention.init_weights(gen)

    def _trunk(self, x):
        """(layer3's output, layer4's output)."""
        x_tmp = self.layer3(self.layer2(self.layer1(self.layer0(x))))
        return x_tmp, self.layer4(x_tmp)

    def _cls_feature(self, x):
        """cls[:-1] after the PPM: the 512-channel feature p."""
        return self.cls[:4](self.ppm(x))

    def _to_input(self, logits, hw):
        return resize_bilinear_nchw(logits, hw, True) if self.zoom_factor != 1 else logits

    def forward(self, x, mode="normal", ref_p=None):
        """normal: (logits at the input size, aux logits at the input size,
        p). merge (ref_p the warped keyframe feature): (``forward_phase2``'s
        logits at ref_p's size, not resized, aux logits at the input size,
        the fused feature), as the JAX ``apply(mode="merge")``. The JAX
        model without the fusion returns (logits, aux) in normal mode; this
        one returns p beside them whatever ``with_fuse`` is."""
        hw = x.shape[-2:]
        if mode == "merge":
            x_tmp, feat = self.forward_phase1(x)
            out, fused = self.forward_phase2(feat, ref_p)
            return out, self._to_input(self.aux(x_tmp), hw), fused
        x_tmp, y = self._trunk(x)
        feat = self._cls_feature(y)
        return (self._to_input(self.cls[4](feat), hw), self._to_input(self.aux(x_tmp), hw), feat)

    def forward_key(self, x):
        """Serving HR pass on the keyframe: (logits at the input size, p),
        no aux head."""
        feat = self._cls_feature(self._trunk(x)[1])
        return self._to_input(self.cls[4](feat), x.shape[-2:]), feat

    def forward_phase1(self, x, with_aux=True):
        """(layer3's output, which the aux head takes, p); with_aux=False
        returns p alone."""
        x_tmp, y = self._trunk(x)
        feat = self._cls_feature(y)
        return (x_tmp, feat) if with_aux else feat

    def forward_phase2(self, mid, ref):
        """mid: phase 1's p; ref: the warped keyframe feature -> (logits at
        ref's size, fused); no upsample."""
        fused = self.fuse_attention(ref, mid)
        return self.final_conv(fused), fused
