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
Inside ``parallel.synced(group)`` (the data-parallel step's
``bn_mode="sync"``) a train-mode BatchNorm takes its statistics over the
whole batch of the group's ranks, as BN does under the JAX package's jitted
step over a sharded batch, and ``Dropout2d`` draws the whole batch's masks
and keeps this rank's rows, so that the ranks together compute what one
process computes on the whole batch. ``torch.nn.SyncBatchNorm`` is not used:
it refuses CPU tensors.
The s2d/s2d4 stems of the JAX file are TPU layout rewrites of the plain
7x7/s2 conv and are not ported.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from arseg_tpu_torch.ops.resize import interpolate_bilinear
from arseg_tpu_torch.parallel.group import all_reduce_sum, sync_group

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def resize_bilinear_nchw(x, hw, align_corners):
    """Bilinear resize of an NCHW tensor to hw (F.interpolate semantics,
    ``ops.resize.interpolate_bilinear``); the input itself when it already
    has that size."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return interpolate_bilinear(x, hw, align_corners)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same state-dict keys), whose train-mode
    statistics are the whole group's batch inside ``parallel.synced``."""

    def forward(self, x):
        group = sync_group()
        if not self.training or group is None:
            return super().forward(x)
        return _sync_batch_norm(self, x, group)


def _sync_batch_norm(bn, x, group):
    """Train-mode BN over every rank's rows: the mean, then the biased
    variance about it (two passes, as ``jnp.var``), each summed over the
    ranks by a differentiable all-reduce, in float32; the running
    statistics move towards the mean and the unbiased variance of the
    N = every rank's N*H*W values."""
    xf = x.float()
    dims = (0, 2, 3)
    local_n = xf.new_tensor([x.numel() // x.shape[1]])
    sums = all_reduce_sum(torch.cat([xf.sum(dims), local_n]), group)
    n = sums[-1].detach()
    mean = sums[:-1] / n
    centred = xf - mean.view(1, -1, 1, 1)
    var = all_reduce_sum((centred * centred).sum(dims), group) / n
    scale = torch.rsqrt(var + bn.eps)
    if bn.affine:
        scale = scale * bn.weight.float()
    out = centred * scale.view(1, -1, 1, 1)
    if bn.affine:
        out = out + bn.bias.float().view(1, -1, 1, 1)
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1 - m).add_(var.detach() * (n / (n - 1).clamp(min=1)), alpha=m)
            bn.num_batches_tracked.add_(1)
    return out.to(x.dtype)


def batch_norm(c):
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


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
    ``set_dropout_generator`` sets; inside ``parallel.synced`` the masks
    of the whole group's batch, of which this rank keeps its rows. Owns
    no state-dict keys."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        group = sync_group()
        n, rank = (x.shape[0], 0) if group is None else (x.shape[0] * group.size, group.rank)
        mask = torch.empty((n, x.shape[1], 1, 1), device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        mask = mask[rank * x.shape[0]:(rank + 1) * x.shape[0]]
        return x * mask.to(x.dtype) / keep


def set_dropout_generator(model, generator):
    """Every ``Dropout2d`` of ``model`` draws its masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
