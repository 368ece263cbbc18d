"""Weights and inputs made from ``--seed`` on the device, with one
``torch.Generator`` per stream and a few large draws each.

Weights: every conv weight N(0, 1/fan_in) (kaiming_normal, a=1), conv
biases N(0, 0.1^2), BatchNorm scale 1 + U(-0.2, 0.2), shift and running
mean N(0, 0.1^2), running variance 0.5 + U(0, 1), so that random weights
give activations of varied scale per channel, as a trained model's do.
The keys are the reference checkpoint's, with the head's second names
(``feat_conv_out``, ``final_conv``) that the program's modules carry.
"""

import math

import torch

ALIASES = (("conv_out.conv.", "feat_conv_out."), ("conv_out.conv_out.", "final_conv."))


def generator(seed, stream, device):
    """A generator on ``device`` for one named stream of one seed."""
    sub = (int(seed) * 1_000_003 + sum(ord(c) * 31 ** i for i, c in enumerate(stream)))
    return torch.Generator(device=device).manual_seed(sub % (2 ** 63 - 1))


def state_dict(template, seed, stream, device):
    """A float32 state dict for ``template`` (a module, on any device,
    meta included), drawn from (seed, stream) on ``device``."""
    shapes = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    normal_keys, uniform_keys = [], []
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_var", ".weight")) and len(shape) == 1:
            uniform_keys.append(k)
        else:
            normal_keys.append(k)
    gen = generator(seed, stream, device)
    numel = lambda keys: sum(math.prod(shapes[k]) for k in keys)
    normal = torch.randn(numel(normal_keys), generator=gen, device=device)
    uniform = torch.rand(numel(uniform_keys), generator=gen, device=device)
    out, at = {}, 0
    for k in normal_keys:
        n = math.prod(shapes[k])
        v = normal[at:at + n].view(shapes[k])
        at += n
        out[k] = v / math.sqrt(math.prod(shapes[k][1:])) if len(shapes[k]) == 4 else v * 0.1
    at = 0
    for k in uniform_keys:
        n = math.prod(shapes[k])
        v = uniform[at:at + n].view(shapes[k])
        at += n
        out[k] = 0.5 + v if k.endswith("running_var") else 0.8 + 0.4 * v
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(shape, dtype=torch.long, device=device)
    return with_aliases(out)


def with_aliases(sd):
    """sd with the head's second names added (the same tensors)."""
    sd = dict(sd)
    for name, alias in ALIASES:
        for k in [k for k in sd if k.startswith(name)]:
            sd[alias + k[len(name):]] = sd[k]
    return sd


def frames(seed, stream, n, hw, device):
    """n uint8 frames [n, H, W, 3], uniform noise."""
    gen = generator(seed, stream, device)
    return torch.randint(0, 256, (n, *hw, 3), generator=gen, device=device, dtype=torch.uint8)


def block_flows(seed, stream, n, hw, device, block=8, max_px=16):
    """n motion-vector fields [n, H, W, 2] in pixels (float32), one vector
    per block x block pixels, each component a whole number of quarter
    pixels uniform in [-max_px, max_px], as the MV bins of
    ``dataset/camvid.py`` read (int16 quarter pixels / 4)."""
    gen = generator(seed, stream, device)
    q = torch.randint(-4 * max_px, 4 * max_px + 1, (n, hw[0] // block, hw[1] // block, 2),
                      generator=gen, device=device, dtype=torch.int16)
    q = q.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return q.float() / 4.0


def labels(seed, stream, n, hw, n_classes, device, ignore=255, ignore_share=0.05):
    gen = generator(seed, stream, device)
    y = torch.randint(0, n_classes, (n, *hw), generator=gen, device=device, dtype=torch.int32)
    drop = torch.rand((n, *hw), generator=gen, device=device) < ignore_share
    return y.masked_fill(drop, ignore)
