"""PSPNet (CamVid flavour) + CReFF-fused variants, NCHW — port of
``arseg_tpu/nn/pspnet.py``.

  PSPModule: adaptive-avg pyramids (1, 2, 3, 6) -> 1x1 conv (no bias) ->
    bilinear upsample (align_corners=False) -> concat with the input -> 1x1
    bottleneck -> relu.
  PSPUpsample: x2 bilinear (align_corners=False) -> 3x3 conv -> BN -> PReLU.
  PSPNet: dilated ResNet ("arseg"), DenseNet-121 or SqueezeNet
    (``nn/extractors.py``) -> PSP -> dropout -> three upsamples ->
    the 64-ch feature p at input resolution; heads: 1x1 ``final_conv`` ->
    resize to the output size (align_corners=True) -> log_softmax, and a
    classifier on the global-max-pooled layer3 feature.
  fuse_version 1: CReFF at p (64 ch, full resolution); 2: CReFF at the
    512-ch backbone feature before the PSP head; 3: CReFF at the 64-ch stem
    output, phase 2 re-runs layers 1-4 and the whole head. 0: no fusion.

Module names are the reference checkpoint's: ``feats.*``,
``psp.stages.{i}.1``, ``psp.bottleneck``, ``up_{1,2,3}.conv.{0,1,2}``,
``final_conv``, ``classifier.{0,2}``, ``fuse_attention.*``.

Serving entry points compute no classifier: ``forward_key`` (HR keyframe:
logits at the input size + the feature CReFF takes) and
``forward_phase1(x, with_aux=False)``. ``forward_phase2_argmax`` of V1 with
the "local" fusion is K3 (``ops/creff_head_kernel.py``): the x2 resize of
the LR feature to full resolution, the fused module, ``final_conv`` and the
argmax in one kernel on the card, which reads the LR feature at its own
size. K3 runs over consecutive chunks of frames
(``nn/functional.frame_chunks``), each under ``CHUNK_ELEMENTS`` elements
at full resolution (``F.interpolate``, which the CPU path and
``return_fused=True`` take, refuses an output of INT_MAX elements or
more, which 8 GOPs of 720x960 at 64 channels pass); below that bound it
runs once.

Spans (``record_function``, no-ops unless a profiler records):
``psp.decoder`` around the PSP module and the three upsamples, for the
keyframe and the LR frames alike.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.attention import get_fusion
from arseg_tpu_torch.nn.extractors import BACKBONES
from arseg_tpu_torch.nn.functional import (Dropout2d, batch_norm, frame_chunks,
                                           resize_bilinear_nchw)
from arseg_tpu_torch.nn.resnet import ResNet
from arseg_tpu_torch.ops import creff_head_kernel, creff_kernel
from arseg_tpu_torch.ops.resize import adaptive_avg_pool, adaptive_max_pool_11

MIDDLE_DIM = {0: None, 1: 64, 2: 512, 3: 64}


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class AdaptiveAvgPool(nn.Module):
    """AdaptiveAvgPool2d((size, size)) of an NCHW tensor through
    ``ops.adaptive_avg_pool`` (the JAX package's averaging matrices)."""

    def __init__(self, size):
        super().__init__()
        self.size = size

    def forward(self, x):
        return adaptive_avg_pool(_nhwc(x), (self.size, self.size)).permute(0, 3, 1, 2)


class PSPModule(nn.Module):
    def __init__(self, features, out_features=1024, sizes=(1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(s), nn.Conv2d(features, features, 1, bias=False))
            for s in sizes
        )
        self.bottleneck = nn.Conv2d(features * (len(sizes) + 1), out_features, 1, bias=True)

    def forward(self, x):
        hw = x.shape[-2:]
        priors = [resize_bilinear_nchw(stage(x), hw, False) for stage in self.stages] + [x]
        return F.relu(self.bottleneck(torch.cat(priors, dim=1)))


class PSPUpsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), batch_norm(cout),
                                  nn.PReLU(1))

    def forward(self, x):
        return self.conv(resize_bilinear_nchw(x, (2 * x.shape[-2], 2 * x.shape[-1]), False))


class PSPNet(nn.Module):
    """fuse_version 0 = plain, 1/2/3 = the WithFuse variants."""

    # forward_phase2_argmax returns class maps at the fused feature's own
    # resolution; dispatchers check feat_hw * 1 == target_hw
    phase2_argmax_upscale = 1

    def __init__(self, n_classes=18, sizes=(1, 2, 3, 6), psp_size=2048, deep_features_size=1024,
                 backend="resnet18", input_channel=3, attention_type="local", atten_k=7,
                 fuse_version=0, generator=None):
        super().__init__()
        if backend.startswith("resnet"):
            feats = ResNet(int(backend.replace("resnet", "")), input_channel, variant="arseg")
        elif backend in BACKBONES:
            if fuse_version == 3:
                raise ValueError(f"fuse_version 3 fuses at a ResNet's stem; {backend!r} has none")
            feats = BACKBONES[backend](input_channel)
        else:
            raise ValueError(f"unknown PSPNet backbone {backend!r}")
        self.n_classes = n_classes
        self.fuse_version = fuse_version
        self.attention_type = attention_type
        self.atten_k = atten_k
        self.middle_dim = MIDDLE_DIM[fuse_version]
        self.feats = feats
        self.psp = PSPModule(psp_size, 1024, sizes)
        self.drop_1 = Dropout2d(0.3)
        self.up_1 = PSPUpsample(1024, 256)
        self.up_2 = PSPUpsample(256, 64)
        self.up_3 = PSPUpsample(64, 64)
        self.drop_2 = Dropout2d(0.15)
        self.final_conv = nn.Conv2d(64, n_classes, 1)
        self.classifier = nn.Sequential(
            nn.Linear(deep_features_size, 256), nn.ReLU(), nn.Linear(256, n_classes)
        )
        if fuse_version:
            self.fuse_attention = get_fusion(attention_type, atten_k)(self.middle_dim)
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))

    def init_weights(self, gen):
        """The JAX package's init schemes: msra for the backbone, the torch
        defaults for the PSP head, upsamples, final_conv and classifier,
        PReLU 0.25, default BN, kaiming_normal_(a=1) in the fusion."""
        self.feats.init_weights(gen)
        for name, m in self.named_modules():
            if name.startswith(("feats", "fuse_attention")):
                continue
            if isinstance(m, nn.Conv2d):
                Init.conv_kaiming_uniform_(m, gen)
            elif isinstance(m, nn.Linear):
                Init.linear_default_(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                Init.bn_default_(m)
            elif isinstance(m, nn.PReLU):
                Init.prelu_default_(m)
        if self.fuse_version:
            self.fuse_attention.init_weights(gen)

    # -- shared pieces ------------------------------------------------------

    def _backbone(self, x):
        """(f, class_f, stem): layer4 and layer3 outputs and the stem's; a
        DenseNet or SqueezeNet gives its two features and no stem."""
        if not isinstance(self.feats, ResNet):
            return (*self.feats(x), None)
        stem = self.feats.stem(x)
        class_f = self.feats.layer3(self.feats.layer2(self.feats.layer1(stem)))
        return self.feats.layer4(class_f), class_f, stem

    def _decoder(self, f):
        with record_function("psp.decoder"):
            y = self.drop_1(self.psp(f))
            for up in (self.up_1, self.up_2, self.up_3):
                y = self.drop_2(up(y))
            return y

    def _classifier(self, class_f):
        aux = adaptive_max_pool_11(_nhwc(class_f))
        return self.classifier(aux)

    def _head(self, feat, out_hw, log_probs=True):
        out = resize_bilinear_nchw(self.final_conv(feat), out_hw, True)
        # log_softmax is monotonic, so argmax consumers (serving) skip it
        return F.log_softmax(out, dim=1) if log_probs else out

    def _mid(self, feat, f, stem):
        return {0: feat, 1: feat, 2: f, 3: stem}[self.fuse_version]

    # -- forward modes ------------------------------------------------------

    def forward(self, x, mode="normal", ref_p=None):
        """normal: (log-probabilities at the input size, classifier logits,
        mid): mid is p for V0/V1, the backbone feature for V2, the stem
        output for V3. merge (the fused variants; ref_p the warped keyframe
        feature): phase 1, then phase 2 with ref_p; V1 and V2 return (head
        at ref_p's size, classifier logits, fused), V3 ``forward_phase2``'s
        triple, as the JAX ``apply(mode="merge")``."""
        if mode == "merge":
            if self.fuse_version in (1, 2):
                out_cls, mid = self.forward_phase1(x)
                out, fused = self.forward_phase2(mid, ref_p)
                return out, out_cls, fused
            if self.fuse_version == 3:
                return self.forward_phase2(self.forward_phase1(x)[0], ref_p)
            raise ValueError("merge mode requires a fuse variant")
        f, class_f, stem = self._backbone(x)
        feat = self._decoder(f)
        out = self._head(feat, x.shape[-2:])
        return out, self._classifier(class_f), self._mid(feat, f, stem)

    def forward_key(self, x):
        """Serving HR pass on the keyframe: (logits at the input size, mid as
        in ``forward``), no classifier, no log_softmax."""
        f, _, stem = self._backbone(x)
        feat = self._decoder(f)
        return self._head(feat, x.shape[-2:], log_probs=False), self._mid(feat, f, stem)

    def forward_phase1(self, x, with_aux=True):
        """V0/V1: (classifier logits, p); V2: (classifier logits, backbone
        feature); V3: (stem output,). with_aux=False returns the last one
        alone and computes no classifier."""
        if self.fuse_version == 3:
            stem = self.feats.stem(x)
            return (stem,) if with_aux else stem
        f, class_f, _ = self._backbone(x)
        mid = f if self.fuse_version == 2 else self._decoder(f)
        return (self._classifier(class_f), mid) if with_aux else mid

    def forward_phase2(self, mid, ref, log_probs=True):
        """mid: phase 1's feature; ref: the warped keyframe feature. V1:
        (head at ref's size, fused); V2: (head, fused); V3: (head,
        classifier logits, fused)."""
        out_hw = ref.shape[-2:]
        if self.fuse_version == 1:
            fused = self.fuse_attention(ref, mid)
            return self._head(fused, out_hw, log_probs), fused
        if self.fuse_version == 2:
            f = self.fuse_attention(ref, mid)
            return self._head(self._decoder(f), out_hw), f
        if self.fuse_version == 3:
            fused = self.fuse_attention(ref, mid)
            class_f = self.feats.layer3(self.feats.layer2(self.feats.layer1(fused)))
            y = self._decoder(self.feats.layer4(class_f))
            return self._head(y, out_hw), self._classifier(class_f), fused
        raise ValueError("phase2 requires a fuse variant")

    def forward_phase2_argmax(self, mid, ref, return_fused=False):
        """int32 class maps [N, H, W] at ref's resolution: argmax of
        final_conv(fusion) (log_softmax and the identity resize skipped). V1
        with the "local" fusion runs K3 on the LR feature, which never
        writes the resized feature or the fused one; return_fused=True then
        computes the fused feature beside the maps. K3 (and the fused
        feature) run over ``frame_chunks``."""
        if self.fuse_version == 1 and self.attention_type == "local":
            fa = self.fuse_attention
            ref_nhwc, mid_nhwc = _nhwc(ref), _nhwc(mid)
            hw = ref_nhwc.shape[1:3]
            taps, bias = creff_kernel.pack_qkv(*fa.qkv_weights())
            fc_w, fc_b = creff_head_kernel.pack_head(self.final_conv.weight,
                                                     self.final_conv.bias, mid.dtype)
            preds, fused = [], []
            for lo, hi in frame_chunks(ref.shape[0], hw[0] * hw[1] * mid.shape[1]):
                preds.append(creff_head_kernel.creff_phase2_argmax(
                    mid_nhwc[lo:hi], ref_nhwc[lo:hi], taps, bias, fc_w, fc_b, self.atten_k,
                    self.atten_k))
                if return_fused:
                    fused.append(fa(ref[lo:hi], mid[lo:hi]))
            pred = preds[0] if len(preds) == 1 else torch.cat(preds)
            if return_fused:
                return pred, fused[0] if len(fused) == 1 else torch.cat(fused)
            return pred
        outs = self.forward_phase2(mid, ref, log_probs=False)
        pred = outs[0].argmax(dim=1).to(torch.int32)
        return (pred, outs[-1]) if return_fused else pred
