"""The PSPNet backbones that are not ResNets, NCHW — port of
``arseg_tpu/nn/extractors.py`` (reference ``model/extractors.py:165-320``):

* DenseNet-121 with an 8x downsample: the stem (7x7/s2 conv, BN, relu,
  3x3/s2 max pool), then four dense blocks; of the three transitions only
  the first average-pools. The forward returns (the last block's
  1024-channel feature, transition3's 512-channel output), the second
  being the deep-supervision feature the classifier takes.
* SqueezeNet 1.1, dilated: ``feat_1`` (3x3/s2 conv, relu), ``feat_2`` (max
  pool, two fires), ``feat_3`` (max pool, two fires with dilation 2),
  ``feat_4`` (four fires with dilation 4); no BN. The forward returns
  (feat_4's 512 channels at 1/8, feat_3's 256).

Module names are the reference checkpoint's, so that its state dict loads
with ``strict=True``: DenseNet's stem lives under ``start_features``, a
dense layer names its modules ``norm.1``, ``conv.1``, ``norm.2``,
``conv.2``, and every dense block and transition is registered twice, as
``denseblockN`` / ``transitionN`` and as ``blocks.<i>`` of a
``ModuleList`` (the same module objects, so the state dict carries both
names); SqueezeNet's groups are ``Sequential``s whose indices count the
pools and relus (``feat_2.1`` is its first fire).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.functional import batch_norm

# backend -> (psp_size, deep_features_size)
BACKBONE_FEATURES = {"densenet": (1024, 512), "squeezenet": (512, 256)}

DENSENET121 = dict(growth_rate=32, block_config=(6, 12, 24, 16), num_init_features=64,
                   bn_size=4)


class _DenseLayer(nn.Module):
    def __init__(self, cin, growth_rate, bn_size):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm = nn.ModuleDict({"1": batch_norm(cin), "2": batch_norm(mid)})
        self.conv = nn.ModuleDict({"1": nn.Conv2d(cin, mid, 1, bias=False),
                                   "2": nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)})

    def forward(self, x):
        new = self.conv["1"](F.relu(self.norm["1"](x)))
        new = self.conv["2"](F.relu(self.norm["2"](new)))
        return torch.cat([x, new], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin, cout, downsample):
        super().__init__()
        self.norm = batch_norm(cin)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.downsample = downsample

    def forward(self, x):
        y = self.conv(F.relu(self.norm(x)))
        return F.avg_pool2d(y, 2) if self.downsample else y


class DenseNet121(nn.Module):
    def __init__(self, input_channel=3):
        super().__init__()
        cfg = DENSENET121
        g, c = cfg["growth_rate"], cfg["num_init_features"]
        self.start_features = nn.Sequential()
        self.start_features.add_module("conv0", nn.Conv2d(input_channel, c, 7, stride=2,
                                                          padding=3, bias=False))
        self.start_features.add_module("norm0", batch_norm(c))
        self.blocks = nn.ModuleList()
        n_blocks = len(cfg["block_config"])
        for bi, n_layers in enumerate(cfg["block_config"]):
            block = nn.Sequential()
            for li in range(n_layers):
                block.add_module(f"denselayer{li + 1}",
                                 _DenseLayer(c + li * g, g, cfg["bn_size"]))
            self.blocks.append(block)
            setattr(self, f"denseblock{bi + 1}", block)
            c += n_layers * g
            if bi != n_blocks - 1:
                trans = _Transition(c, c // 2, downsample=bi < 1)
                self.blocks.append(trans)
                setattr(self, f"transition{bi + 1}", trans)
                c //= 2

    def init_weights(self, gen):
        """N(0, sqrt(2/n)) convs (the JAX ``init_densenet121``), default BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                Init.conv_msra_(m, gen)
            elif isinstance(m, nn.BatchNorm2d):
                Init.bn_default_(m)

    def forward(self, x):
        y = F.relu(self.start_features.norm0(self.start_features.conv0(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        deep = None
        for i, block in enumerate(self.blocks):
            y = block(y)
            if i == 5:  # transition3
                deep = y
        return y, deep


class _Fire(nn.Module):
    def __init__(self, cin, squeeze, e1, e3, dilation):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, e1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, e3, 3, padding=dilation, dilation=dilation)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class _MaxPool(nn.Module):
    """3x3/s2 max pool with padding 1 (the JAX ``max_pool_3x3_s2_p1``)."""

    def forward(self, x):
        return F.max_pool2d(x, 3, stride=2, padding=1)


class SqueezeNet(nn.Module):
    # group: [(cin, squeeze, expand1x1, expand3x3, dilation)] of its fires
    FIRES = {
        "feat_2": [(64, 16, 64, 64, 1), (128, 16, 64, 64, 1)],
        "feat_3": [(128, 32, 128, 128, 2), (256, 32, 128, 128, 2)],
        "feat_4": [(256, 48, 192, 192, 4), (384, 48, 192, 192, 4), (384, 64, 256, 256, 4),
                   (512, 64, 256, 256, 4)],
    }

    def __init__(self, input_channel=3):
        super().__init__()
        self.feat_1 = nn.Sequential(nn.Conv2d(input_channel, 64, 3, stride=2, padding=1),
                                    nn.ReLU())
        for name, fires in self.FIRES.items():
            pool = [] if name == "feat_4" else [_MaxPool()]
            setattr(self, name, nn.Sequential(*pool, *(_Fire(*f) for f in fires)))

    def init_weights(self, gen):
        """The torch Conv2d default (the JAX ``init_squeezenet``)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                Init.conv_kaiming_uniform_(m, gen)

    def forward(self, x):
        f3 = self.feat_3(self.feat_2(self.feat_1(x)))
        return self.feat_4(f3), f3


BACKBONES = {"densenet": DenseNet121, "squeezenet": SqueezeNet}
