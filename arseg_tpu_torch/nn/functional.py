"""Building blocks with torch semantics, NCHW (port of the plain part of
``arseg_tpu/nn/functional.py``: conv, batch norm, relu, bilinear resize,
channel dropout).

The JAX package keeps parameters in a tree and collects BN statistics in a
context; here they are ``nn.Conv2d`` / ``nn.BatchNorm2d`` modules, so the
state-dict keys are the reference checkpoint's. Train and eval mode are
torch's own ``.train()`` / ``.eval()``. In eval mode BatchNorm normalises
with its running statistics. In train mode it normalises with the biased
batch statistics and moves the running statistics towards the unbiased ones
with momentum 0.1, which is the JAX ``batch_norm`` followed by
``apply_bn_updates``. The serving pipeline and the eval engines run copies
of the models in eval mode; training runs them in train mode.
``Dropout2d`` draws its masks from an explicit generator, as the JAX
``dropout2d`` draws them from the context's key.
The s2d/s2d4 stems of the JAX file are TPU layout rewrites of the plain
7x7/s2 conv and are not ported.
"""

import torch
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



class Dropout2d(nn.Module):
    """Channel dropout (torch ``Dropout2d``): in train mode each [n, c]
    channel is zeroed with probability p and the others scaled by 1/(1-p);
    the identity in eval mode or at p = 0. The [N, C, 1, 1] masks are
    drawn from ``self.generator`` (a ``torch.Generator`` on the input's
    device; torch's default generator when None), which
    ``set_dropout_generator`` sets. Owns no state-dict keys."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty((x.shape[0], x.shape[1], 1, 1), device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        return x * mask.to(x.dtype) / keep


def set_dropout_generator(model, generator):
    """Every ``Dropout2d`` of ``model`` draws its masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
