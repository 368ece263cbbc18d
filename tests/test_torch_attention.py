"""Parity of the port's CReFF fusion variants (arseg_tpu_torch.nn.attention),
K4's and K5's plain versions and the fused upsample head with the JAX
package on the CPU, float32 unless stated, TF32 off. JAX parameters go
through the port's ``state_dict_from_jax`` and load strict. The
kernel-versus-plain checks of K4 and K5 need a card and skip here."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.gop import ARPipeline as JPipeline
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.nn import attention as jattention
from arseg_tpu.nn.init import RngStream
from arseg_tpu.ops import creff_attention as j_creff_attention
from arseg_tpu.ops.pallas_creff import (
    creff_fused_pallas as j_creff_fused_pallas,
    creff_phase2_upsample_argmax as j_creff_phase2_upsample_argmax,
)

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.nn import bisenet
from arseg_tpu_torch.nn.attention import get_fusion
from arseg_tpu_torch.ops import _build, creff_attention_kernel, creff_kernel
from arseg_tpu_torch.ops import creff_upsample_head_kernel as k5
from arseg_tpu_torch.ops.local_attention import creff_attention, creff_reference
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import randomize_bn_tree  # noqa: E402

set_f32_parity_mode()

VARIANTS = ["local", "localDup", "localNoGroup", "localOnly", "local2", "local3", "local4",
            "local5", "local6", "localNew", "global", "globalOnly", "globalNoGroup", "self",
            "no", "upsample", "conv"]
C = 16  # local4's scale and globalNoGroup's C/4 divide the sizes below
HR_HW, LR_HW = (16, 24), (8, 12)
# float32; sums in another order than XLA's
REL_TOL = 1e-4
# bfloat16: p and the output are rounded to bf16 after float32 sums taken
# in another order: two units in the last place of the largest output
BF16_REL_TOL = 2.0 ** -6
AGREEMENT = {torch.float32: 0.9999, torch.bfloat16: 0.999}
CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _jtree(p, rng):
    """JAX parameters as numpy, every leaf moved by noise (so that zero
    biases and in_proj_bias are exercised too)."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*np.shape(a))).astype(np.float32), p)


def _fusion_pair(name, seed=0):
    init, apply = jattention.get_fusion(name, 7)
    params = _jtree(init(RngStream(jax.random.PRNGKey(seed)), C), np.random.RandomState(seed))
    module = get_fusion(name, 7)(C)
    # the converter takes model trees: wrap the fusion's tree as the model's
    sd = state_dict_from_jax({"fuse_attention": params}, "camvid-bise18")
    module.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    return apply, params, module.eval()


# ---------------------------------------------------------------- fusion variants


@pytest.mark.parametrize("name", VARIANTS)
def test_fusion_variant_matches_jax(name):
    apply, params, module = _fusion_pair(name)
    rng = np.random.RandomState(1)
    hr = rng.randn(2, *HR_HW, C).astype(np.float32)
    lr = rng.randn(2, *LR_HW, C).astype(np.float32)
    want = np.asarray(apply(params, jnp.asarray(hr), jnp.asarray(lr)))
    _build.LAUNCHES.clear()
    with torch.no_grad():
        got = module(_nchw(hr), _nchw(lr)).permute(0, 2, 3, 1).numpy()
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    assert got.shape == want.shape
    _close(got, want, REL_TOL)


def test_local1_raises_and_unknown_names_refused():
    with pytest.raises(NotImplementedError, match="MyAttentionV1"):
        get_fusion("local1")(C)
    with pytest.raises(KeyError):
        get_fusion("nope")
    with pytest.raises(NotImplementedError, match="MyAttentionV1"):
        build_model("camvid-bise18", fuse=True, attention_type="local1", device="cpu")


def test_local4_at_undivided_size_raises_as_jax_fails():
    """local4 at 18x24: the query sub-grids have 5 or 4 rows, K/V 4. The
    JAX CPU path fails on the broadcast; the port's K4 wrapper refuses the
    shapes."""
    apply, params, module = _fusion_pair("local4")
    rng = np.random.RandomState(2)
    hr = rng.randn(1, 18, 24, C).astype(np.float32)
    lr = rng.randn(1, 9, 12, C).astype(np.float32)
    with pytest.raises(TypeError):
        apply(params, jnp.asarray(hr), jnp.asarray(lr))
    with pytest.raises(ValueError, match="one NHWC shape"), torch.no_grad():
        module(_nchw(hr), _nchw(lr))


# ---------------------------------------------------------------- K4


def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 18, 21, 8), (1, 30, 17, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_plain_matches_pallas_interpret(shape, dtype):
    """K4's plain version against the TPU kernel in interpret mode at the
    shapes of tests/test_local_attention.py."""
    q, k, v = _qkv(3, shape)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_creff_fused_pallas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), 7, 7,
                                interpret=True)
    got = creff_attention_kernel.creff_attention(*(t(a).to(dtype) for a in (q, k, v)), 7, 7)
    assert got.dtype == dtype and tuple(got.shape) == shape
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           REL_TOL if dtype == torch.float32 else BF16_REL_TOL)


def test_k4_plain_matches_jax_creff_attention():
    q, k, v = _qkv(4, (2, 13, 19, 8))
    want = j_creff_attention(*(jnp.asarray(a) for a in (q, k, v)), 5, 5)
    got = creff_attention(*(t(a) for a in (q, k, v)), 5, 5)
    _close(got.numpy(), want, REL_TOL)
    # float32: the plain version is creff_reference itself
    assert torch.equal(got, creff_reference(*(t(a) for a in (q, k, v)), 5, 5))


def test_creff_attention_backward_matches_autograd():
    q, k, v = (t(a).requires_grad_(True) for a in _qkv(5, (1, 9, 10, 4)))
    g = t(np.random.RandomState(6).randn(1, 9, 10, 4).astype(np.float32))
    creff_attention(q, k, v, 3, 3).backward(g)
    got = [x.grad.clone() for x in (q, k, v)]
    q2, k2, v2 = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    creff_reference(q2, k2, v2, 3, 3).backward(g)
    for a, b in zip(got, (q2.grad, k2.grad, v2.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_k4_refuses_mismatched_shapes():
    q, k, v = (t(a) for a in _qkv(7, (1, 6, 8, 4)))
    with pytest.raises(ValueError, match="one NHWC shape"):
        creff_attention_kernel.creff_attention(q[:, :5], k, v, 7, 7)
    with pytest.raises(ValueError, match="one NHWC shape"):
        creff_attention_kernel.creff_attention(q, k, v[..., :2], 7, 7)


# ---------------------------------------------------------------- K5


def _head_case(seed, h, w, c, ncls, n=1):
    rng = np.random.RandomState(seed)
    lr_up = rng.randn(n, h, w, c).astype(np.float32)
    ref = rng.randn(n, h, w, c).astype(np.float32)
    convs = [(rng.randn(3, 3, 1, c).astype(np.float32), rng.randn(c).astype(np.float32))
             for _ in range(3)]
    fc_w = rng.randn(1, 1, c, ncls).astype(np.float32)
    fc_b = rng.randn(ncls).astype(np.float32)
    return lr_up, ref, convs, fc_w, fc_b


def _k5_args(convs, fc_w, fc_b, dtype):
    tc = [x.to(dtype) for w, b in convs for x in (t(w.transpose(3, 2, 0, 1)), t(b))]
    taps, bias = creff_kernel.pack_qkv(*tc)
    fcw, fcb = k5.pack_upsample_head(t(fc_w.transpose(3, 2, 0, 1)), t(fc_b), dtype)
    return taps, bias, fcw, fcb


@pytest.mark.parametrize("case", [(12, 17, 30), (24, 20, 8)], ids=["h12w17", "h24w20_3tiles"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_plain_matches_pallas_interpret(case, dtype):
    """K5's plain version against the TPU kernel in interpret mode: the case
    of tests/test_local_attention.py (h=12, w=17, C=8, 5 classes) and a
    taller one of three row tiles."""
    h, w, th = case
    lr_up, ref, convs, fc_w, fc_b = _head_case(13, h, w, 8, 5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = [{"weight": jnp.asarray(a), "bias": jnp.asarray(b)} for a, b in convs]
    fc = {"weight": jnp.asarray(fc_w), "bias": jnp.asarray(fc_b)}
    want = np.asarray(j_creff_phase2_upsample_argmax(
        jnp.asarray(lr_up).astype(jdt), jnp.asarray(ref).astype(jdt), *jc, fc, 7, 7, 8, th,
        interpret=True))
    got = k5.creff_phase2_upsample_argmax(t(lr_up).to(dtype), t(ref).to(dtype),
                                          *_k5_args(convs, fc_w, fc_b, dtype), 7, 7)
    assert got.dtype == torch.int32 and got.shape == want.shape == (1, 8 * h, 8 * w)
    assert np.mean(got.numpy() == want) >= AGREEMENT[dtype]


def _x8_lerp(x, axis):
    """x8 align_corners=False resize along `axis` in float32, written out:
    src = max((o + 0.5) / 8 - 0.5, 0), (1 - w) x[i0] + w x[i1] with
    i1 = min(i0 + 1, n - 1), and w = 0 where the clamp folds i1 onto i0."""
    n = x.shape[axis]
    src = ((torch.arange(8 * n, dtype=torch.float32) + 0.5) / 8 - 0.5).clamp(min=0)
    i0 = src.floor().long().clamp(max=n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    wt = torch.where(i1 == i0, torch.zeros_like(src), src - i0.float())
    shape = [1] * x.dim()
    shape[axis] = -1
    wt = wt.reshape(shape)
    return x.index_select(axis, i0) * (1 - wt) + x.index_select(axis, i1) * wt


def test_k5_plain_rounds_logits_not_the_fused_feature():
    """K5's plain version, the yardstick the card holds the kernel to,
    takes the 1x1 conv on the float32 fused feature and rounds only the
    logits (the TPU kernel's jnp.sum(fused * wc) before .astype): it equals
    that composition written out, and differs from the one that rounds the
    fused feature to bf16 first (K3's rounding point)."""
    lr_up, ref, convs, fc_w, fc_b = _head_case(15, 6, 7, 64, 19)
    dt = torch.bfloat16
    args = (t(lr_up).to(dt), t(ref).to(dt), *_k5_args(convs, fc_w, fc_b, dt), 7, 7)
    got = k5.upsampled_logits_plain(*args)
    taps, bias, fcw, fcb = args[2:6]
    fused = creff_kernel.creff_module_f32_plain(args[0], args[1], taps, bias, 7, 7)

    def compose(feature):
        logits = torch.matmul(feature, fcw).to(dt).float()
        return _x8_lerp(_x8_lerp(logits, 2).to(dt).float(), 1) + fcb

    assert fused.dtype == torch.float32 and got.shape == (1, 48, 56, 19)
    torch.testing.assert_close(got, compose(fused), rtol=0, atol=0)
    assert bool((got != compose(fused.to(dt).float())).any())


def test_bisenet_fused_upsample_head_matches_planes_head(monkeypatch):
    """forward_phase2_argmax with USE_FUSED_UPSAMPLE_HEAD on (K5's plain
    version) against the planes head of the same model; the fused feature
    it returns beside the maps is the module's."""
    tm = build_model("camvid-bise18", fuse=True, seed=5, device="cpu")
    rng = np.random.RandomState(9)
    mid = t(rng.randn(2, 256, 4, 6).astype(np.float32))
    ref = t(rng.randn(2, 256, 8, 12).astype(np.float32))
    with torch.no_grad():
        planes, fused = tm.forward_phase2_argmax(mid, ref, return_fused=True)
        monkeypatch.setattr(bisenet, "USE_FUSED_UPSAMPLE_HEAD", True)
        _build.LAUNCHES.clear()
        fused_head, fused2 = tm.forward_phase2_argmax(mid, ref, return_fused=True)
        alone = tm.forward_phase2_argmax(mid, ref)
    assert sum(_build.LAUNCHES.values()) == 0
    assert fused_head.dtype == torch.int32 and fused_head.shape == planes.shape == (2, 64, 96)
    assert np.mean(fused_head.numpy() == planes.numpy()) >= 0.999
    torch.testing.assert_close(fused2, fused, rtol=0, atol=0)
    assert torch.equal(alone, fused_head)


# ---------------------------------------------------------------- pipeline


def test_gop_step_local_no_group_matches_jax():
    """One camvid-bise18 GOP with the localNoGroup fusion (K4's path)
    through the port's ARPipeline against the JAX ARPipeline at 64x96, GOP 3."""
    h, w, g = 64, 96, 3
    models, params = [], []
    for seed, fuse in ((0, False), (1, True)):
        kw = dict(attention_type="localNoGroup") if fuse else {}
        jm = j_build_model("camvid-bise18", fuse=fuse, **kw)
        p = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                              np.random.RandomState(seed))
        tm = build_model("camvid-bise18", fuse=fuse, device="cpu", **kw)
        tm.load_state_dict(state_dict_from_jax(p, "camvid-bise18"), strict=True)
        models.append((jm, tm))
        params.append(p)
    rng = np.random.RandomState(7)
    kf = rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
    fr = rng.randint(0, 256, (g - 1, h, w, 3)).astype(np.uint8)
    fx, fy = (rng.uniform(-16, 16, (g - 1, h, w)).astype(np.float32) for _ in range(2))
    norm = (CAMVID_MEAN, CAMVID_STD)
    jpipe = JPipeline(models[0][0], models[1][0], scale=0.5, normalize=norm)
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(kf), jnp.asarray(fr),
                            (jnp.asarray(fx), jnp.asarray(fy))))
    tpipe = ARPipeline(models[0][1], models[1][1], scale=0.5, normalize=norm, device="cpu")
    _build.LAUNCHES.clear()
    got = tpipe.gop_step(t(kf), t(fr), (t(fx), t(fy)))
    assert sum(_build.LAUNCHES.values()) == 0
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (g, h, w)
    assert np.mean(got.numpy() == want) >= 0.999


# ---------------------------------------------------------------- card only


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_kernel_matches_plain_on_card(dtype):
    needs_card()
    q, k, v = (t(a).cuda().to(dtype) for a in _qkv(8, (2, 13, 37, 32)))
    got = creff_attention_kernel.creff_attention(q, k, v, 7, 7).float().cpu().numpy()
    want = creff_attention_kernel.creff_attention_plain(q, k, v, 7, 7).float().cpu().numpy()
    _close(got, want, 5e-5 if dtype == torch.float32 else BF16_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_kernel_matches_plain_on_card(dtype):
    needs_card()
    lr_up, ref, convs, fc_w, fc_b = _head_case(14, 21, 37, 32, 12)
    args = (t(lr_up).cuda().to(dtype), t(ref).cuda().to(dtype),
            *(x.cuda() for x in _k5_args(convs, fc_w, fc_b, dtype)), 7, 7)
    got = k5.creff_phase2_upsample_argmax(*args).cpu().numpy()
    want = k5.creff_phase2_upsample_argmax_plain(*args).cpu().numpy()
    assert np.mean(got == want) >= AGREEMENT[dtype]


# bf16 edge shapes (n, h, w, c, window): sizes that are no multiple of the
# 16 x 16 tile or of K5's 14-pixel interior, a single row or column (the
# upsample's clamp folds i1 onto i0), C of 16 to 256, each window
BF16_EDGE_SHAPES = [(1, 13, 37, 16, 3), (2, 15, 29, 64, 5), (1, 1, 5, 64, 7), (1, 7, 1, 16, 3),
                    (1, 29, 43, 256, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k4_bf16_kernel_matches_plain_on_card_edge_shapes(shape):
    needs_card()
    n, h, w, c, win = shape
    q, k, v = (t(a).cuda().to(torch.bfloat16) for a in _qkv(16, (n, h, w, c)))
    got = creff_attention_kernel.creff_attention(q, k, v, win, win).float().cpu().numpy()
    want = creff_attention_kernel.creff_attention_plain(q, k, v, win, win).float().cpu().numpy()
    _close(got, want, BF16_REL_TOL)


@pytest.mark.cuda
def test_k4_bf16_kernel_refuses_misaligned_data():
    needs_card()
    q, k, v = (t(a).cuda().to(torch.bfloat16) for a in _qkv(17, (1, 8, 16, 16)))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(q.shape)  # contiguous, its data 2 bytes past 16
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16 bytes"):
        creff_attention_kernel.creff_attention(shifted, k, v, 7, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [12, 19])
@pytest.mark.parametrize("shape", BF16_EDGE_SHAPES[:4], ids=lambda s: "x".join(map(str, s)))
def test_k5_bf16_kernel_matches_plain_on_card_edge_shapes(shape, n_classes):
    needs_card()
    n, h, w, c, win = shape
    lr_up, ref, convs, fc_w, fc_b = _head_case(18, h, w, c, n_classes, n)
    dt = torch.bfloat16
    args = (t(lr_up).cuda().to(dt), t(ref).cuda().to(dt),
            *(x.cuda() for x in _k5_args(convs, fc_w, fc_b, dt)), win, win)
    got = k5.creff_phase2_upsample_argmax(*args).cpu().numpy()
    want = k5.creff_phase2_upsample_argmax_plain(*args).cpu().numpy()
    assert got.shape == want.shape == (n, 8 * h, 8 * w)
    assert np.mean(got == want) >= AGREEMENT[dt]


@pytest.mark.cuda
def test_k5_bf16_kernel_takes_lowest_index_of_a_tie_on_card():
    needs_card()
    lr_up, ref, convs, fc_w, fc_b = _head_case(19, 13, 37, 64, 12)
    fc_w[..., 9] = fc_w[..., 2]
    fc_b[2] = fc_b[9] = 50.0
    dt = torch.bfloat16
    args = (t(lr_up).cuda().to(dt), t(ref).cuda().to(dt),
            *(x.cuda() for x in _k5_args(convs, fc_w, fc_b, dt)), 7, 7)
    assert bool((k5.creff_phase2_upsample_argmax(*args) == 2).all())
