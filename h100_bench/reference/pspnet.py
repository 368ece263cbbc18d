"""Plain float32 reference of AR-Seg's PSPNet-18 with the CReFF ``local``
fusion at the decoder's output, fuse version 1 (github.com/THU-LYJ-Lab/AR-Seg,
``model/pspnet.py:103-231`` ``PSPNetWithFuse``, ``model/pspnet.py:14-46``
the PSP module and ``PSPUpsample``, ``model/extractors.py:108-158`` the
dilated ResNet-18), in plain PyTorch and written for this benchmark alone:
it imports nothing of the program under test and takes none of its weights
or tables. From ``reference/model.py`` it takes the rounding convolution and
BatchNorm (so that ``lowp_mode`` covers this model too) and the CReFF
``local`` fusion.

State-dict keys are the reference checkpoint's (``feats.*``,
``psp.stages.{i}.1``, ``psp.bottleneck``, ``up_{1,2,3}.conv.{0,1,2}``,
``final_conv``, ``classifier.{0,2}``, ``fuse_attention.*``), so one seeded
state dict loads into the program's model and into this one. Semantics
held:

- dilated ResNet-18 at output stride 8: a 7x7/2 conv, BN, relu, a 3x3/2
  max pool; layers of two basic blocks with strides (1, 2, 1, 1) and
  dilations (1, 1, 2, 4), where the first block of a layer keeps dilation
  1 in both convs and the second dilates both (padding = dilation); the
  features of layer 4 (512 channels) and layer 3;
- PSP: for each bin (1, 2, 3, 6) an adaptive average pool and a 1x1 conv
  without bias, resized bilinearly back to the input's grid; the four and
  the input concatenated, a 1x1 conv with bias to 1024, relu;
- three ``PSPUpsample``s 1024 -> 256 -> 64 -> 64: x2 bilinear, a 3x3 conv
  with bias, BN, PReLU (one slope);
- ``final_conv`` 1x1 64 -> 12 with bias; the classifier on the
  global-max-pooled layer-3 feature (Linear 256 -> 256, relu, Linear to
  12), built for the state dict and not run in serving;
- fuse version 1: ``fuse_attention`` (``local`` 7x7) at p, the 64-channel
  decoder output at the frame's resolution: the LR frame's p resized
  bilinearly (align_corners=True) to the warped keyframe p's grid, then the
  module; ``final_conv`` on the fused feature.

Departures from ``model/pspnet.py``: the PSP and decoder resizes take
``align_corners=False`` explicitly, which is what ``F.upsample`` bilinear
defaults to since PyTorch 0.4 (the code calls it without the argument);
dropout is the identity (eval mode); the head returns logits, not
``log_softmax`` of them (monotonic, so the served class is the same), and
the classifier is not run. TF32 is switched off when a model is built.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Conv2d, LocalFusion, bn, lowp


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def up_half(x, hw):
    """Bilinear resize, align_corners=False (``F.upsample``'s default)."""
    return lowp(F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False))


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, dilation=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=dilation, dilation=dilation,
                            bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(Conv2d(cin, planes, 1, stride=stride, bias=False),
                                            bn(planes))

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class DilatedResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for i, (stride, dilation) in enumerate(((1, 1), (2, 1), (1, 2), (1, 4))):
            planes = 64 * 2 ** i
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock(cin, planes, stride),
                                  BasicBlock(planes, planes, dilation=dilation)))
            cin = planes

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        x3 = self.layer3(self.layer2(self.layer1(x)))
        return self.layer4(x3), x3


class PSPModule(nn.Module):
    def __init__(self, features, out_features=1024, sizes=(1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d((s, s)), Conv2d(features, features, 1, bias=False))
            for s in sizes)
        self.bottleneck = Conv2d(features * (len(sizes) + 1), out_features, 1)

    def forward(self, x):
        hw = x.shape[-2:]
        priors = [up_half(stage(x), hw) for stage in self.stages] + [x]
        return F.relu(self.bottleneck(torch.cat(priors, 1)))


class PSPUpsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(cin, cout, 3, padding=1), bn(cout), nn.PReLU())

    def forward(self, x):
        return self.conv(up_half(x, (2 * x.shape[-2], 2 * x.shape[-1])))


class PSPNetV1(nn.Module):
    """``with_fuse``: the AR model (CReFF at p); without it the HR model."""

    def __init__(self, n_classes, with_fuse=False, sizes=(1, 2, 3, 6), psp_size=512,
                 deep_features_size=256, win=7):
        super().__init__()
        no_tf32()
        self.feats = DilatedResNet18()
        self.psp = PSPModule(psp_size, 1024, sizes)
        self.up_1 = PSPUpsample(1024, 256)
        self.up_2 = PSPUpsample(256, 64)
        self.up_3 = PSPUpsample(64, 64)
        self.final_conv = Conv2d(64, n_classes, 1)
        self.classifier = nn.Sequential(nn.Linear(deep_features_size, 256), nn.ReLU(),
                                        nn.Linear(256, n_classes))
        if with_fuse:
            self.fuse_attention = LocalFusion(64, win)

    def decoder(self, x):
        """p: the 64-channel feature at the input's resolution."""
        return self.up_3(self.up_2(self.up_1(self.psp(self.feats(x)[0]))))

    def key(self, x):
        """HR keyframe: (logits at the input's size, p)."""
        p = self.decoder(x)
        return self.final_conv(p), p

    def phase1(self, x):
        """(p,) at the LR input."""
        return (self.decoder(x),)

    def phase2(self, mid, ref):
        """(logits at ref's size, fused feature) from the LR frame's p and
        the warped keyframe p."""
        fused = self.fuse_attention(ref, mid)
        return self.final_conv(fused), fused

