"""CReFF fusion modules, NCHW — port of ``arseg_tpu/nn/attention.py``.

Only the production variant "local" (MyAttention: depthwise 3x3 Q/K/V convs,
k x k windowed attention, residual on the upsampled LR feature) is ported;
it runs through ``ops.creff_local_module_resize`` and so through K1.
"""

import torch.nn as nn

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.ops.local_attention import creff_local_module_resize


class LocalAttention(nn.Module):
    """MyAttention ("local"). forward(hr, lr): hr [N, C, H, W] (the warped
    keyframe feature), lr [N, C, h, w] (the LR feature) -> [N, C, H, W]."""

    def __init__(self, c, k=7):
        super().__init__()
        self.k = k
        self.lr_query_conv = nn.Conv2d(c, c, 3, padding=1, groups=c, bias=True)
        self.hr_key_conv = nn.Conv2d(c, c, 3, padding=1, groups=c, bias=True)
        self.hr_value_conv = nn.Conv2d(c, c, 3, padding=1, groups=c, bias=True)

    def init_weights(self, gen):
        for conv in (self.lr_query_conv, self.hr_key_conv, self.hr_value_conv):
            Init.conv_kaiming_normal_a1_(conv, gen)

    def forward(self, hr, lr):
        convs = (self.lr_query_conv, self.hr_key_conv, self.hr_value_conv)
        wb = [t for conv in convs for t in (conv.weight, conv.bias)]
        out = creff_local_module_resize(
            lr.permute(0, 2, 3, 1), hr.permute(0, 2, 3, 1), *wb, self.k, self.k
        )
        return out.permute(0, 3, 1, 2)


def get_fusion(attention_type: str, atten_k: int = 7):
    """Fusion module class for ``attention_type`` (reference registry
    names)."""
    if attention_type == "local":
        return lambda c: LocalAttention(c, atten_k)
    raise NotImplementedError(
        f"fusion variant {attention_type!r} is not ported yet (ROADMAP Queue A, "
        "remaining fusion variants)"
    )
