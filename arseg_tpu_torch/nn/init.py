"""Parameter initialisers matching ``arseg_tpu/nn/init.py`` in distribution,
drawn from a ``torch.Generator`` on the CPU and copied to the module's
device (the JAX PRNG gives other numbers from the same seed; parity tests
load the JAX parameters instead)."""

import math

import torch
import torch.nn as nn


def _normal(shape, std, gen):
    return torch.randn(shape, generator=gen) * std


def _uniform(shape, bound, gen):
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def _fan_in(conv: nn.Conv2d):
    return conv.weight[0].numel()


@torch.no_grad()
def conv_kaiming_normal_a1_(conv: nn.Conv2d, gen: torch.Generator):
    """kaiming_normal_(a=1) + zero bias (BiSeNet/attention init_weight):
    std 1/sqrt(fan_in), fan_in = kh * kw * cin / groups, so depthwise,
    grouped and dense convs alike."""
    conv.weight.copy_(_normal(conv.weight.shape, 1.0 / math.sqrt(_fan_in(conv)), gen))
    if conv.bias is not None:
        conv.bias.zero_()


@torch.no_grad()
def conv_kaiming_uniform_(conv: nn.Conv2d, gen: torch.Generator):
    """torch Conv2d default init (kaiming_uniform_, a=sqrt(5))."""
    bound = 1.0 / math.sqrt(_fan_in(conv))
    conv.weight.copy_(_uniform(conv.weight.shape, bound, gen))
    if conv.bias is not None:
        conv.bias.copy_(_uniform(conv.bias.shape, bound, gen))


@torch.no_grad()
def conv_msra_(conv: nn.Conv2d, gen: torch.Generator):
    """N(0, sqrt(2/n)), n = kh*kw*cout (the dilated ResNet's init), zero
    bias."""
    kh, kw = conv.kernel_size
    conv.weight.copy_(_normal(conv.weight.shape, math.sqrt(2.0 / (kh * kw * conv.out_channels)),
                              gen))
    if conv.bias is not None:
        conv.bias.zero_()


@torch.no_grad()
def linear_default_(lin: nn.Linear, gen: torch.Generator):
    """torch Linear default init: weight and bias uniform(+-1/sqrt(in))."""
    bound = 1.0 / math.sqrt(lin.in_features)
    lin.weight.copy_(_uniform(lin.weight.shape, bound, gen))
    lin.bias.copy_(_uniform(lin.bias.shape, bound, gen))


@torch.no_grad()
def prelu_default_(prelu: nn.PReLU):
    prelu.weight.fill_(0.25)


@torch.no_grad()
def bn_default_(bn: nn.BatchNorm2d):
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.num_batches_tracked.zero_()


@torch.no_grad()
def randomize_bn_(model: nn.Module, gen: torch.Generator):
    """Random BN affine parameters and running statistics, so that a model
    with random weights has activations of varied scale per channel."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            m.weight.copy_(1.0 + 0.2 * _uniform((c,), 1.0, gen))
            m.bias.copy_(_normal((c,), 0.1, gen))
            m.running_mean.copy_(_normal((c,), 0.1, gen))
            m.running_var.copy_(0.5 + torch.rand((c,), generator=gen))


@torch.no_grad()
def mha_default_(mha: nn.MultiheadAttention, gen: torch.Generator):
    """The JAX ``Init.mha_default`` (torch's own MultiheadAttention init):
    in_proj_weight [3E, E] xavier-uniform, out_proj weight uniform
    +-1/sqrt(E), zero biases."""
    e = mha.embed_dim
    mha.in_proj_weight.copy_(_uniform((3 * e, e), math.sqrt(6.0 / (4 * e)), gen))
    mha.in_proj_bias.zero_()
    mha.out_proj.weight.copy_(_uniform((e, e), 1.0 / math.sqrt(e), gen))
    mha.out_proj.bias.zero_()
