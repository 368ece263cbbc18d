"""Plain float32 reference of AR-Seg's Cityscapes PSPNet-18 with the CReFF
``local`` fusion at the 512-channel ``cls[:-1]`` feature
(github.com/THU-LYJ-Lab/AR-Seg, ``model/pspnet_semseg.py:118-250``
``PSPNetWithFuse``; ``:12-30`` the PPM; ``:33-116`` the hszhao/semseg
PSPNet it extends, with the dilation surgery of ``:59-68``), in plain
PyTorch and written for this benchmark alone: it imports nothing of the
program under test and takes none of its weights or tables. From
``reference/model.py`` it takes the rounding convolution and BatchNorm (so
that ``lowp_mode`` covers this model too) and the CReFF ``local`` fusion.

State-dict keys are the reference checkpoint's (``layer0.{0,1}``,
``layer{1..4}``, ``ppm.features.{i}.{1,2}``, ``cls.{0,1,4}``,
``aux.{0,1,4}``, ``final_conv``, ``fuse_attention.*``), so one seeded
state dict loads into the program's model and into this one. Semantics
held:

- layer0: a 7x7/2 conv without bias, BN, relu, a 3x3/2 max pool;
- the semseg dilated ResNet-18 at output stride 8: layers of two basic
  blocks with strides (1, 2, 1, 1) and dilations (1, 1, 2, 4); after the
  surgery conv2 of every block of layers 3 and 4 is dilated, so the first
  block of a layer convolves at (1, d) and the second at (d, d)
  (padding = dilation); layer 3's output feeds the aux head alone;
- the PPM on layer 4's 512 channels: for each bin (1, 2, 3, 6) an adaptive
  average pool, a 1x1 conv without bias to 128, BN, relu, a bilinear
  resize back (align_corners=True); the input and the four concatenated
  to 1024 channels;
- ``cls``: a 3x3 conv 1024 -> 512 without bias, BN, relu, Dropout2d(0.1),
  a 1x1 conv 512 -> classes with bias; ``aux`` the same on layer 3
  (256 -> 256 -> classes), built for the state dict and not run in
  serving;
- the fusion: ``fuse_attention`` (``local`` 7x7) on p = ``cls[:4]``'s
  512-channel output at 1/8: the LR frame's p resized bilinearly
  (align_corners=True) to the warped keyframe p's grid, then the module;
  ``cls[4]`` on the fused feature; the logits resized to the frame
  (x8, align_corners=True).

Departures from ``model/pspnet_semseg.py``:

- ``final_conv`` is registered as the same module as ``cls[4]``, after
  ``cls``, as the program registers it, so the state dict holds both
  names and a strict load leaves the module holding ``final_conv.*``'s
  tensors in this model and in the program alike;
- the fusion is built whatever ``with_fuse`` says, as the program's
  registry builds this configuration, so that the HR state dict (drawn
  with ``with_fuse=False``) loads strictly into either;
- dropout is the identity (eval mode); the aux head is not run; the head
  returns logits (no ``log_softmax``: monotonic, the served class is the
  same). TF32 is switched off when a model is built.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Conv2d, LocalFusion, bn, up_to
from reference.pspnet import no_tf32


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, dil1=1, dil2=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=dil1, dilation=dil1,
                            bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dil2, dilation=dil2, bias=False)
        self.bn2 = bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(Conv2d(cin, planes, 1, stride=stride, bias=False),
                                            bn(planes))

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class PPM(nn.Module):
    def __init__(self, in_dim, reduction_dim, bins):
        super().__init__()
        self.features = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b), Conv2d(in_dim, reduction_dim, 1, bias=False),
                          bn(reduction_dim), nn.ReLU())
            for b in bins)

    def forward(self, x):
        hw = x.shape[-2:]
        return torch.cat([x] + [up_to(f(x), hw, True) for f in self.features], 1)


def head(cin, mid, n_classes):
    """3x3 conv (no bias), BN, relu, Dropout2d (the identity in eval mode),
    1x1 conv: keys 0, 1, 4."""
    return nn.Sequential(Conv2d(cin, mid, 3, padding=1, bias=False), bn(mid), nn.ReLU(),
                         nn.Dropout2d(0.1), Conv2d(mid, n_classes, 1))


class PSPNetSemsegAR(nn.Module):
    """The HR model and the AR model alike (the fusion is always built)."""

    def __init__(self, n_classes, with_fuse=False, bins=(1, 2, 3, 6), feat_dim=512, win=7):
        super().__init__()
        no_tf32()
        del with_fuse  # built in both, as the program's registry builds this model
        self.layer0 = nn.Sequential(Conv2d(3, 64, 7, stride=2, padding=3, bias=False), bn(64),
                                    nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1))
        cin = 64
        for i, (stride, dil) in enumerate(((1, 1), (2, 1), (1, 2), (1, 4))):
            planes = 64 * 2 ** i
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock(cin, planes, stride, 1, dil),
                                  BasicBlock(planes, planes, 1, dil, dil)))
            cin = planes
        self.ppm = PPM(feat_dim, feat_dim // len(bins), tuple(bins))
        self.cls = head(2 * feat_dim, 512, n_classes)
        self.aux = head(feat_dim // 2, 256, n_classes)
        self.final_conv = self.cls[4]
        self.fuse_attention = LocalFusion(512, win)

    def feature(self, x):
        """p: ``cls[:4]`` after the PPM, 512 channels at 1/8 of x."""
        x = self.layer2(self.layer1(self.layer0(x)))
        return self.cls[:4](self.ppm(self.layer4(self.layer3(x))))

    def key(self, x):
        """HR keyframe: (logits at the input's size, p)."""
        p = self.feature(x)
        return up_to(self.final_conv(p), x.shape[-2:], True), p

    def phase1(self, x):
        """(p,) at the LR input."""
        return (self.feature(x),)

    def phase2(self, mid, ref):
        """(logits at 8x ref's size, fused feature) from the LR frame's p
        and the warped keyframe p."""
        fused = self.fuse_attention(ref, mid)
        hw = (8 * ref.shape[-2], 8 * ref.shape[-1])
        return up_to(self.final_conv(fused), hw, True), fused
