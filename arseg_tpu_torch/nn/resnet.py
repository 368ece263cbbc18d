"""ResNet backbones, NCHW — port of ``arseg_tpu/nn/resnet.py``: the
basic-block ResNet-18/34 and the bottleneck ResNet-50/101/152, in three
variants:

* "bisenet" (the BiSeNet context backbone): strides (1, 2, 2, 2), no
  dilation; ``return_stages`` gives (feat8, feat16, feat32).
* "arseg" (the dilated PSPNet backbone, 8x downsample): strides
  (1, 2, 1, 1), dilations (1, 1, 2, 4); block 0 of each layer keeps
  dilation 1 in both convs, later blocks use (d, d); the forward returns
  (x4, x3). ``stem`` and ``layer{1..4}`` give per-layer access.
* "semseg" (the cityscapes PSPNet backbone): as "arseg", but block 0 of a
  dilated layer dilates its conv2 as well, (1, d).

A bottleneck block's 1x1 conv1 and conv3 carry neither stride nor
dilation: its 3x3 conv2 carries both (the second dilation of the rules
above). Module names follow the torch checkpoint: conv1, bn1,
layer{1..4}.{i}.{conv1, bn1, conv2, bn2, [conv3, bn3,] downsample.{0,1}}."""

import torch.nn as nn
import torch.nn.functional as F

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.functional import batch_norm

RESNET_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
VARIANTS = {
    # variant: (strides, dilations, whether block 0 dilates its conv2)
    "bisenet": ((1, 2, 2, 2), (1, 1, 1, 1), False),
    "arseg": ((1, 2, 1, 1), (1, 1, 2, 4), False),
    "semseg": ((1, 2, 1, 1), (1, 1, 2, 4), True),
}


def _downsample(cin, cout, stride):
    """The 1x1 projection of a block whose shape changes, else None."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), batch_norm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride, dil1=1, dil2=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=dil1, dilation=dil1,
                               bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dil2, dilation=dil2, bias=False)
        self.bn2 = batch_norm(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride, dil1=1, dil2=1):
        super().__init__()
        del dil1  # the 1x1 conv1 has no dilation
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dil2, dilation=dil2,
                               bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = _downsample(cin, planes * 4, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNet(nn.Module):
    def __init__(self, depth=18, input_channel=3, variant="bisenet"):
        super().__init__()
        if depth not in RESNET_LAYERS:
            raise ValueError(f"resnet{depth}: depths are {sorted(RESNET_LAYERS)}")
        if variant not in VARIANTS:
            raise ValueError(f"unknown resnet variant {variant!r}; options: {sorted(VARIANTS)}")
        self.variant = variant
        kind, counts = RESNET_LAYERS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        strides, dilations, dilate_first = VARIANTS[variant]
        self.conv1 = nn.Conv2d(input_channel, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        cin = 64
        for li, (count, stride, dil) in enumerate(zip(counts, strides, dilations)):
            planes = 64 * 2**li
            blocks = []
            for bi in range(count):
                dil1 = 1 if bi == 0 else dil
                dil2 = dil if bi or dilate_first else 1
                blocks.append(block(cin, planes, stride if bi == 0 else 1, dil1, dil2))
                cin = planes * block.expansion
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
