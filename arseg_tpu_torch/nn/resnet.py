"""ResNet-18/34 backbones, NCHW — port of the basic-block variants of
``arseg_tpu/nn/resnet.py``:

* "bisenet" (the BiSeNet context backbone): strides (1, 2, 2, 2), no
  dilation; ``return_stages`` gives (feat8, feat16, feat32).
* "arseg" (the dilated PSPNet backbone, 8x downsample): strides
  (1, 2, 1, 1), dilations (1, 1, 2, 4); block 0 of each layer keeps
  dilation 1 in both convs, later blocks use (d, d); the forward returns
  (x4, x3). ``stem`` and ``layer{1..4}`` give per-layer access.
* "semseg" (the cityscapes PSPNet backbone): as "arseg", but block 0 of a
  dilated layer dilates its conv2 as well, (1, d).

Module names follow the torch checkpoint: conv1, bn1, layer{1..4}.{i}.{conv1,
bn1, conv2, bn2, downsample.{0,1}}."""

import torch.nn as nn
import torch.nn.functional as F

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.functional import batch_norm

RESNET_BASIC_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
VARIANTS = {
    # variant: (strides, dilations, whether block 0 dilates its conv2)
    "bisenet": ((1, 2, 2, 2), (1, 1, 1, 1), False),
    "arseg": ((1, 2, 1, 1), (1, 1, 2, 4), False),
    "semseg": ((1, 2, 1, 1), (1, 1, 2, 4), True),
}


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, dil1=1, dil2=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=dil1, dilation=dil1,
                               bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dil2, dilation=dil2, bias=False)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride=stride, bias=False), batch_norm(planes)
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNet(nn.Module):
    def __init__(self, depth=18, input_channel=3, variant="bisenet"):
        super().__init__()
        if depth not in RESNET_BASIC_LAYERS:
            raise NotImplementedError(
                f"resnet{depth}: only the basic-block ResNet-18/34 is ported (no headline "
                "config uses another)"
            )
        if variant not in VARIANTS:
            raise ValueError(f"unknown resnet variant {variant!r}; options: {sorted(VARIANTS)}")
        self.variant = variant
        strides, dilations, dilate_first = VARIANTS[variant]
        self.conv1 = nn.Conv2d(input_channel, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        cin = 64
        layers = zip(RESNET_BASIC_LAYERS[depth], strides, dilations)
        for li, (count, stride, dil) in enumerate(layers):
            planes = 64 * 2**li
            blocks = []
            for bi in range(count):
                dil1 = 1 if bi == 0 else dil
                dil2 = dil if bi or dilate_first else 1
                blocks.append(BasicBlock(cin, planes, stride if bi == 0 else 1, dil1, dil2))
                cin = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def init_weights(self, gen):
        """"bisenet": torch Conv2d default init for every conv; "arseg" and
        "semseg": N(0, sqrt(2/n)) (msra). Default BN."""
        conv_init = Init.conv_kaiming_uniform_ if self.variant == "bisenet" else Init.conv_msra_
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_init(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                Init.bn_default_(m)

    def stem(self, x):
        """7x7/s2 conv, BN, relu, 3x3/s2 max pool."""
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)

    def forward(self, x, return_stages=True):
        x = self.layer1(self.stem(x))
        x2 = self.layer2(x)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        if return_stages:
            return x2, x3, x4
        return x4, x3
