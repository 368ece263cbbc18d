"""CReFF fusion modules, NCHW — port of ``arseg_tpu/nn/attention.py``.

Every variant of the JAX ``get_fusion`` table, under the reference's
``attention_type`` names and state-dict keys. A module's
``forward(hr, lr)`` takes the warped keyframe feature hr [N, C, H, W] and
the LR feature lr [N, C, h, w] and returns the fused feature at hr's size
(except "no", which returns lr, as the reference does).

- "local" (MyAttention: depthwise 3x3 Q/K/V convs, k x k windowed
  attention, residual on the upsampled LR feature) runs through
  ``ops.creff_local_module_resize`` and so through K1.
- The rest of the local family ("localDup", "localNoGroup", "localOnly",
  "local2", "local3", and the strided "local4"/"local5"/"local6") computes
  Q, K, V with cuDNN convs and runs the window through
  ``ops.creff_attention`` and so through K4.
- "localNew" and the MultiheadAttention variants ("global", "globalOnly",
  "globalNoGroup", "self") use plain tensor ops, as the JAX package does.
  Their attention is ``nn.MultiheadAttention`` (one head), which scales q
  by 1/sqrt(E) before q . k; the JAX ``_mha`` scales the logits after it.
  The two agree within float32 rounding.
- "local1" maps to MyAttentionV1, which the reference lacks too: building
  it raises ``NotImplementedError``.
"""

import torch
import torch.nn as nn

from arseg_tpu_torch.nn import init as Init
from arseg_tpu_torch.nn.functional import resize_bilinear_nchw
from arseg_tpu_torch.ops.local_attention import (
    creff_attention,
    creff_local_module_resize,
    local_similar,
    local_weighting,
)
from arseg_tpu_torch.ops.resize import _nearest_index_on, resize_bilinear


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _up(lr, hw):
    """lr resized to hw, bilinear align_corners=True."""
    return resize_bilinear_nchw(lr, hw, True)


def _conv3(cin, cout, groups=1):
    return nn.Conv2d(cin, cout, 3, padding=1, groups=groups, bias=True)


def _tokens(x):
    """NCHW -> [N, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def _untokens(t, hw):
    """[N, H*W, C] -> NCHW."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], *hw)


class _Fusion(nn.Module):
    """Base: ``init_weights`` draws every conv kaiming_normal_(a=1) and every
    MultiheadAttention with the JAX ``mha_default``."""

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                Init.conv_kaiming_normal_a1_(m, gen)
            elif isinstance(m, nn.MultiheadAttention):
                Init.mha_default_(m, gen)


class LocalAttention(_Fusion):
    """The local family (``_make_local``): "local" (MyAttention), "localDup"
    (v = hr), "localNoGroup" (dense 3x3 convs), "localOnly" (no residual),
    "local2"/"local3" (8 groups, without/with a value conv)."""

    def __init__(self, c, k=7, with_value=True, groups=None, residual=True):
        super().__init__()
        g = c if groups is None else groups
        self.k = k
        self.with_value = with_value
        self.residual = residual
        # MyAttention itself: one fused kernel for convs, window and residual
        self.fused_module = with_value and residual and groups is None
        self.lr_query_conv = _conv3(c, c, g)
        self.hr_key_conv = _conv3(c, c, g)
        if with_value:
            self.hr_value_conv = _conv3(c, c, g)

    def qkv_weights(self):
        """The Q, K, V convs' weights and biases in ``pack_qkv``'s order:
        (q_w, q_b, k_w, k_b, v_w, v_b)."""
        convs = (self.lr_query_conv, self.hr_key_conv, self.hr_value_conv)
        return tuple(t for conv in convs for t in (conv.weight, conv.bias))

    def forward(self, hr, lr):
        if self.fused_module:
            out = creff_local_module_resize(_nhwc(lr), _nhwc(hr), *self.qkv_weights(), self.k,
                                            self.k)
            return _nchw(out)
        lr_up = _up(lr, hr.shape[-2:])
        q = self.lr_query_conv(lr_up)
        k = self.hr_key_conv(hr)
        v = self.hr_value_conv(hr) if self.with_value else hr
        attn = _nchw(creff_attention(_nhwc(q), _nhwc(k), _nhwc(v), self.k, self.k))
        return lr_up + attn if self.residual else attn


class LocalStridedAttention(_Fusion):
    """MyAttentionV4/V5/V6 (``_make_local_strided``): K and V resized to
    1/scale, each (i, j) query sub-grid attends to them (one K4 launch
    each), and the results are interleaved back. Where the scale does not
    divide hr's size the sub-grids and K/V differ in size and K4's wrapper
    raises, as the JAX package fails there."""

    def __init__(self, c, k, scale):
        super().__init__()
        self.k = k
        self.scale = scale
        self.lr_query_conv = _conv3(c, c, c)
        self.hr_key_conv = _conv3(c, c, c)
        self.hr_value_conv = _conv3(c, c, c)

    def forward(self, hr, lr):
        h, w = hr.shape[-2:]
        s = self.scale
        lr_up = _up(lr, (h, w))
        q = _nhwc(self.lr_query_conv(lr_up))
        kv_hw = (h // s, w // s)
        k = resize_bilinear(_nhwc(self.hr_key_conv(hr)), kv_hw, True)
        v = resize_bilinear(_nhwc(self.hr_value_conv(hr)), kv_hw, True)
        attn = torch.zeros_like(q)
        for i in range(s):
            for j in range(s):
                attn[:, i::s, j::s] = creff_attention(q[:, i::s, j::s], k, v, self.k, self.k)
        return lr_up + _nchw(attn)


class LocalNewAttention(_Fusion):
    """MyAttentionLocalNew (``_make_local_new``): the window logits at LR
    resolution, stretched to a window scaled by hr/lr (1-D nearest over the
    window, then bilinear to hr's size), softmax, and the weighting of hr
    at HR resolution. Plain tensor ops, as in the JAX package."""

    def __init__(self, c, k):
        super().__init__()
        self.k = k
        self.lr_query_conv = _conv3(c, c, c)
        self.hr_key_conv = _conv3(c, c, c)

    def forward(self, hr, lr):
        hh, wh = hr.shape[-2:]
        h, w = lr.shape[-2:]
        skh, skw = int(self.k * (hh / h)), int(self.k * (wh / w))
        k = _nhwc(self.hr_key_conv(_up(hr, (h, w))))
        q = _nhwc(self.lr_query_conv(lr))
        wgt = local_similar(q, k, self.k, self.k)  # [N, h, w, k*k]
        wgt = wgt.index_select(-1, _nearest_index_on(self.k * self.k, skh * skw, wgt.device))
        wgt = torch.softmax(resize_bilinear(wgt, (hh, wh), True), dim=-1)
        attn = local_weighting(_nhwc(hr), wgt, skh, skw)
        return _up(lr, (hh, wh)) + _nchw(attn)


class GlobalAttention(_Fusion):
    """One-head MultiheadAttention over K/V resized to 1/kscale, depthwise
    3x3 convs: "global" (MyAttentionGlobal, kscale = atten_k; hr is rebound
    to the value conv's output before the key conv, as in the reference),
    "globalOnly" (no residual, V from hr itself) and "self" (K, V from the
    upsampled LR feature)."""

    def __init__(self, c, mode, kscale):
        super().__init__()
        self.mode = mode
        self.kscale = kscale
        self.lr_query_conv = _conv3(c, c, c)
        self.hr_key_conv = _conv3(c, c, c)
        if mode == "global":
            self.hr_value_conv = _conv3(c, c, c)
        self.attention = nn.MultiheadAttention(c, 1, batch_first=True)

    def forward(self, hr, lr):
        hw = hr.shape[-2:]
        kv_hw = (hw[0] // self.kscale, hw[1] // self.kscale)
        lr_up = _up(lr, hw)
        if self.mode == "global":
            hr = self.hr_value_conv(hr)
        src = lr_up if self.mode == "self" else hr
        v = _tokens(_up(src, kv_hw))
        k = _tokens(_up(self.hr_key_conv(src), kv_hw))
        q = _tokens(self.lr_query_conv(lr_up))
        attn = _untokens(self.attention(q, k, v, need_weights=False)[0], hw)
        return attn if self.mode == "globalOnly" else lr_up + attn


class GlobalNoGroupAttention(_Fusion):
    """"globalNoGroup": dense 3x3 convs to C/4, MultiheadAttention at C/4
    over K/V resized to 1/16, a 1x1 conv back to C, residual."""

    def __init__(self, c):
        super().__init__()
        self.lr_query_conv = _conv3(c, c // 4)
        self.hr_key_conv = _conv3(c, c // 4)
        self.hr_value_conv = _conv3(c, c // 4)
        self.value_trans_conv = nn.Conv2d(c // 4, c, 1, bias=True)
        self.attention = nn.MultiheadAttention(c // 4, 1, batch_first=True)

    def forward(self, hr, lr):
        hw = hr.shape[-2:]
        kv_hw = (hw[0] // 16, hw[1] // 16)
        lr_up = _up(lr, hw)
        v = _tokens(_up(self.hr_value_conv(hr), kv_hw))
        k = _tokens(_up(self.hr_key_conv(hr), kv_hw))
        q = _tokens(self.lr_query_conv(lr_up))
        attn = _untokens(self.attention(q, k, v, need_weights=False)[0], hw)
        return lr_up + self.value_trans_conv(attn)


class IdentityFusion(_Fusion):
    """"no" (lr itself) and "upsample" (lr resized to hr's size). Both own
    the reference's unused conv and MultiheadAttention parameters, so that
    its checkpoints load strict."""

    def __init__(self, c, upsample):
        super().__init__()
        self.upsample = upsample
        self.lr_query_conv = _conv3(c, c, c)
        self.hr_key_conv = _conv3(c, c, c)
        self.attention = nn.MultiheadAttention(c, 1, batch_first=True)

    def forward(self, hr, lr):
        return _up(lr, hr.shape[-2:]) if self.upsample else lr


class ConvFusion(_Fusion):
    """"conv": a 3x3 conv of [upsampled lr, hr] to C channels."""

    def __init__(self, c):
        super().__init__()
        self.fusion_conv = _conv3(2 * c, c)

    def forward(self, hr, lr):
        return self.fusion_conv(torch.cat([_up(lr, hr.shape[-2:]), hr], dim=1))


def _local1(c):
    raise NotImplementedError(
        "'local1' maps to MyAttentionV1, which does not exist in the reference "
        "snapshot either (NameError at model/pspnet.py:140)"
    )


def get_fusion(attention_type: str, atten_k: int = 7):
    """Fusion module constructor (feature channels -> module) for
    ``attention_type``, named as the reference registry names them."""
    k = atten_k
    table = {
        "local": lambda c: LocalAttention(c, k),
        "localDup": lambda c: LocalAttention(c, k, with_value=False),
        "localNoGroup": lambda c: LocalAttention(c, k, groups=1),
        "localOnly": lambda c: LocalAttention(c, k, residual=False),
        "local1": _local1,
        "local2": lambda c: LocalAttention(c, k, with_value=False, groups=8),
        "local3": lambda c: LocalAttention(c, k, groups=8),
        "local4": lambda c: LocalStridedAttention(c, k, 4),
        "local5": lambda c: LocalStridedAttention(c, k, 2),
        "local6": lambda c: LocalStridedAttention(c, k, 1),
        "localNew": lambda c: LocalNewAttention(c, k),
        "global": lambda c: GlobalAttention(c, "global", k),
        "globalOnly": lambda c: GlobalAttention(c, "globalOnly", 16),
        "globalNoGroup": GlobalNoGroupAttention,
        "self": lambda c: GlobalAttention(c, "self", 16),
        "no": lambda c: IdentityFusion(c, upsample=False),
        "upsample": lambda c: IdentityFusion(c, upsample=True),
        "conv": ConvFusion,
    }
    if attention_type not in table:
        raise KeyError(f"unknown attention_type: {attention_type}")
    return table[attention_type]
