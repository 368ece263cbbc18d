"""Building blocks with torch semantics, NCHW (port of the plain part of
``arseg_tpu/nn/functional.py``: conv, batch norm, relu, bilinear resize).

The JAX package keeps parameters in a tree and collects BN statistics in a
context; here they are ``nn.Conv2d`` / ``nn.BatchNorm2d`` modules, so the
state-dict keys are the reference checkpoint's. BatchNorm uses its running
statistics in eval mode; the pipeline runs models in eval mode only.
The s2d/s2d4 stems of the JAX file are TPU layout rewrites of the plain
7x7/s2 conv and are not ported.
"""

import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def resize_bilinear_nchw(x, hw, align_corners):
    """Bilinear resize of an NCHW tensor to hw (F.interpolate semantics);
    the input itself when it already has that size."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


def batch_norm(c):
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNReLU(nn.Module):
    """conv (no bias) -> BN -> relu; keys ``conv.*``, ``bn.*``."""

    def __init__(self, cin, cout, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ks, stride=stride, padding=padding, bias=False)
        self.bn = batch_norm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

