"""Strided ResNet-18/34 (the BiSeNet context backbone), NCHW — port of the
"bisenet" variant of ``arseg_tpu/nn/resnet.py``: strides (1, 2, 2, 2), no
dilation, ``return_stages`` gives (feat8, feat16, feat32). Module names
follow the torch checkpoint: conv1, bn1, layer{1..4}.{i}.{conv1, bn1,
conv2, bn2, downsample.{0,1}}."""

import torch.nn as nn
import torch.nn.functional as F

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.functional import batch_norm

RESNET_BASIC_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
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
    def __init__(self, depth=18, input_channel=3):
        super().__init__()
        if depth not in RESNET_BASIC_LAYERS:
            raise NotImplementedError(
                f"resnet{depth}: only the basic-block ResNet-18/34 of BiSeNet is "
                "ported (ROADMAP Queue A, PSPNet family)"
            )
        self.conv1 = nn.Conv2d(input_channel, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        cin = 64
        for li, (count, stride) in enumerate(zip(RESNET_BASIC_LAYERS[depth], (1, 2, 2, 2))):
            planes = 64 * 2**li
            blocks = []
            for bi in range(count):
                blocks.append(BasicBlock(cin, planes, stride if bi == 0 else 1))
                cin = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def init_weights(self, gen):
        """torch Conv2d default init for every conv, default BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                Init.conv_kaiming_uniform_(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                Init.bn_default_(m)

    def forward(self, x, return_stages=True):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        x = self.layer1(x)
        x2 = self.layer2(x)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        if return_stages:
            return x2, x3, x4
        return x4, x3
