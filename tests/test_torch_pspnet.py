"""Parity of the port's camvid-psp18 (arseg_tpu_torch.nn.pspnet, K3's plain
version, the GOP pipeline for V1 and V2) with the JAX package on the CPU,
float32, TF32 off, at 64x96. JAX parameters (BN statistics randomised with
numpy) go through the port's ``state_dict_from_jax`` and load strict;
outputs are compared NCHW against NHWC transposed. The kernel-versus-plain
check of K3 needs a card and skips here."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.gop import ARPipeline as JPipeline
from arseg_tpu.gop.pipeline import _resize_flow_planes as j_resize_flow_planes
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.nn import functional as JFn
from arseg_tpu.nn.resnet import resnet_apply, resnet_stem
from arseg_tpu.ops import resize as jresize
from arseg_tpu.ops import resize_bilinear as j_resize_bilinear, warp_feature as j_warp_feature
from arseg_tpu.ops.pallas_creff import creff_phase2_argmax as j_creff_phase2_argmax
from arseg_tpu.utils.torch_convert import export_state_dict

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.models import build_model, phase2_argmax_head
from arseg_tpu_torch.ops import _build, creff_head_kernel, creff_kernel
from arseg_tpu_torch.ops import resize as tresize
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import few_threads, randomize_bn_tree  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

H, W, G = 64, 96, 3
# float32; convolutions sum in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-4)
AGREEMENT = 0.999
CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _pair(fuse_version, seed=0):
    fuse = fuse_version > 0
    kw = dict(fuse_version=fuse_version) if fuse else {}
    jm = j_build_model("camvid-psp18", fuse=fuse, **kw)
    params = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                               np.random.RandomState(seed))
    tm = build_model("camvid-psp18", fuse=fuse, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params, "camvid-psp18"), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module", params=[0, 1, 2, 3], ids=lambda v: f"V{v}")
def pair(request):
    return (request.param, *_pair(request.param, seed=request.param))


# ---------------------------------------------------------------- converter


@pytest.mark.parametrize("fuse_version", [0, 1, 2, 3])
def test_state_dict_from_jax_equals_export_state_dict(fuse_version):
    """The port's converter gives exactly the keys and tensors of the JAX
    package's exporter (PReLU slopes [1], linear weights transposed), and
    they load strict into the port's model."""
    fuse = fuse_version > 0
    kw = dict(fuse_version=fuse_version) if fuse else {}
    jm = j_build_model("camvid-psp18", fuse=fuse, **kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    ours = state_dict_from_jax(params, "camvid-psp18")
    theirs = export_state_dict(params, "camvid-psp18")
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    tm = build_model("camvid-psp18", fuse=fuse, device="cpu", **kw)
    tm.load_state_dict(ours, strict=True)
    assert set(tm.state_dict()) == set(ours)
    assert tuple(ours["up_1.conv.2.weight"].shape) == (1,)
    assert tuple(ours["classifier.0.weight"].shape) == (256, 256)
    assert tuple(ours["psp.stages.3.1.weight"].shape) == (512, 512, 1, 1)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("in_hw,size", [((8, 12), 1), ((8, 12), 2), ((8, 12), 3), ((9, 13), 6)])
def test_adaptive_pools_match_jax(in_hw, size):
    x = np.random.RandomState(0).randn(2, *in_hw, 5).astype(np.float32)
    want = np.asarray(jresize.adaptive_avg_pool(jnp.asarray(x), (size, size)))
    np.testing.assert_allclose(tresize.adaptive_avg_pool(t(x), (size, size)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tresize._adaptive_avg_matrix(in_hw[1], size),
                                  jresize._adaptive_avg_matrix(in_hw[1], size))
    np.testing.assert_array_equal(tresize.adaptive_max_pool_11(t(x)).numpy(),
                                  np.asarray(jresize.adaptive_max_pool_11(jnp.asarray(x))))


def test_resnet_arseg_stages_match_jax():
    """The dilated "arseg" ResNet-18: stem, (x4, x3), per-layer access."""
    jm, params, tm = _pair(0, seed=5)
    x = np.random.RandomState(6).randn(1, H, W, 3).astype(np.float32)
    ctx = JFn.Ctx()
    x4, x3 = resnet_apply(params["feats"], jnp.asarray(x), jm.cfg, ctx, "feats.")
    stem = resnet_stem(params["feats"], jnp.asarray(x), ctx, "feats.")
    with torch.no_grad():
        t4, t3 = tm.feats(_nchw(x), return_stages=False)
        tstem = tm.feats.stem(_nchw(x))
    np.testing.assert_allclose(_nhwc(tstem), np.asarray(stem), **TOL)
    np.testing.assert_allclose(_nhwc(t3), np.asarray(x3), **TOL)
    np.testing.assert_allclose(_nhwc(t4), np.asarray(x4), **TOL)
    assert t4.shape[-2:] == (H // 8, W // 8) and t4.shape[1] == 512
    blocks = [tm.feats.layer3[1], tm.feats.layer4[0], tm.feats.layer4[1]]
    assert [(b.conv1.dilation[0], b.conv2.dilation[0]) for b in blocks] == [(2, 2), (1, 1), (4, 4)]


# ---------------------------------------------------------------- model


def test_pspnet_forward_and_key_match_jax(pair):
    fv, jm, params, tm = pair
    x = np.random.RandomState(2).randn(1, H, W, 3).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
        key_logits, mid = tm.forward_key(_nchw(x))
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(_nhwc(got[2]), np.asarray(want[2]), **TOL)
    np.testing.assert_allclose(torch.log_softmax(key_logits, 1).numpy(), got[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mid.numpy(), got[2].numpy())


def _phase2_inputs(fv, rng):
    """(LR frames, warped keyframe feature) at the shapes of the pipeline."""
    x = rng.randn(2, H // 2, W // 2, 3).astype(np.float32)
    ref_hw, ref_c = {1: ((H, W), 64), 2: ((H // 8, W // 8), 512), 3: ((H // 4, W // 4), 64)}[fv]
    return x, rng.randn(2, *ref_hw, ref_c).astype(np.float32)


def test_pspnet_phase1_and_phase2_match_jax(pair):
    fv, jm, params, tm = pair
    if fv == 0:
        with pytest.raises(ValueError, match="fuse variant"):
            tm.forward_phase2(torch.zeros(1, 64, 4, 4), torch.zeros(1, 64, 4, 4))
        return
    x, ref = _phase2_inputs(fv, np.random.RandomState(3))
    want = jm.forward_phase1(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.forward_phase1(_nchw(x))
        mid = tm.forward_phase1(_nchw(x), with_aux=False)
    assert len(got) == len(want) == (1 if fv == 3 else 2)
    if fv != 3:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(_nhwc(got[-1]), np.asarray(want[-1]), **TOL)
    np.testing.assert_array_equal(mid.numpy(), got[-1].numpy())

    mid_j = want[-1]
    out_j = jm.forward_phase2(params, mid_j, jnp.asarray(ref))
    with torch.no_grad():
        out_t = tm.forward_phase2(_nchw(mid_j), _nchw(ref))
        pred_t = tm.forward_phase2_argmax(_nchw(mid_j), _nchw(ref))
    assert len(out_t) == len(out_j) == (3 if fv == 3 else 2)
    np.testing.assert_allclose(_nhwc(out_t[0]), np.asarray(out_j[0]), **TOL)
    np.testing.assert_allclose(_nhwc(out_t[-1]), np.asarray(out_j[-1]), **TOL)
    if fv == 3:
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), **TOL)
        return
    pred_j = np.asarray(jm.forward_phase2_argmax(params, mid_j, jnp.asarray(ref)))
    assert pred_t.dtype == torch.int32 and pred_t.shape == pred_j.shape
    assert np.mean(pred_t.numpy() == pred_j) >= AGREEMENT


def test_registry_dispatch_and_seeded_init():
    v1 = build_model("camvid-psp18", fuse=True, seed=3, device="cpu")
    assert v1.fuse_version == 1 and v1.middle_dim == 64
    assert phase2_argmax_head(v1, (H, W), (H, W)) == v1.forward_phase2_argmax
    assert phase2_argmax_head(v1, (H // 8, W // 8), (H, W)) is None
    again = build_model("camvid-psp18", fuse=True, seed=3, device="cpu").state_dict()
    other = build_model("camvid-psp18", fuse=True, seed=4, device="cpu").state_dict()
    sd = v1.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["feats.conv1.weight"], other["feats.conv1.weight"])
    assert torch.all(sd["up_2.conv.2.weight"] == 0.25)
    # msra init of the backbone: std sqrt(2 / (3 * 3 * 512))
    assert abs(sd["feats.layer4.1.conv2.weight"].std().item() - (2 / 4608) ** 0.5) < 2e-3
    with pytest.raises(NotImplementedError, match="MyAttentionV1"):
        build_model("camvid-psp18", fuse=True, attention_type="local1", device="cpu")


# ---------------------------------------------------------------- K3


def _head_case(seed, n, h, w, c, ncls):
    rng = np.random.RandomState(seed)
    lr_up = rng.randn(n, h, w, c).astype(np.float32)
    ref = rng.randn(n, h, w, c).astype(np.float32)
    convs = [(rng.randn(3, 3, 1, c).astype(np.float32) * 0.5, rng.randn(c).astype(np.float32) * 0.1)
             for _ in range(3)]
    fc_w = rng.randn(1, 1, c, ncls).astype(np.float32) * 0.3
    fc_b = rng.randn(ncls).astype(np.float32) * 0.1
    return lr_up, ref, convs, fc_w, fc_b


def _torch_head_args(convs, fc_w, fc_b, dtype):
    tc = [x.to(dtype) for w, b in convs for x in (t(w.transpose(3, 2, 0, 1)), t(b))]
    taps, bias = creff_kernel.pack_qkv(*tc)
    fcw, fcb = creff_head_kernel.pack_head(t(fc_w.transpose(3, 2, 0, 1)), t(fc_b), dtype)
    return taps, bias, fcw, fcb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_plain_matches_pallas_interpret(dtype):
    """K3's plain version against the TPU kernel in interpret mode, as
    tests/test_local_attention.py runs it: maps equal in float32, agreement
    >= 0.999 in bfloat16 (the kernels round Q, K, V, p and the fused feature
    to bf16 after float32 sums taken in another order)."""
    lr_up, ref, convs, fc_w, fc_b = _head_case(11, 2, 24, 40, 16, 12)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = [{"weight": jnp.asarray(w), "bias": jnp.asarray(b)} for w, b in convs]
    fc = {"weight": jnp.asarray(fc_w), "bias": jnp.asarray(fc_b)}
    want = np.asarray(j_creff_phase2_argmax(jnp.asarray(lr_up).astype(jdt),
                                            jnp.asarray(ref).astype(jdt), *jc, fc, 7, 7,
                                            interpret=True))
    args = _torch_head_args(convs, fc_w, fc_b, dtype)
    got = creff_head_kernel.creff_phase2_argmax(t(lr_up).to(dtype), t(ref).to(dtype), *args, 7, 7)
    assert got.dtype == torch.int32 and got.shape == want.shape == (2, 24, 40)
    if dtype == torch.float32:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.mean(got.numpy() == want) >= AGREEMENT


def test_k3_plain_matches_composed_forward_phase2():
    """K3's plain version through PSPNet.forward_phase2_argmax (V1, "local")
    against the composed forward_phase2 -> argmax of the same model."""
    _, _, tm = _pair(1, seed=7)
    rng = np.random.RandomState(8)
    mid = t(rng.randn(2, 64, H // 2, W // 2).astype(np.float32))
    ref = t(rng.randn(2, 64, H, W).astype(np.float32))
    _build.LAUNCHES.clear()
    with torch.no_grad():
        pred, fused = tm.forward_phase2_argmax(mid, ref, return_fused=True)
        logits, fused_c = tm.forward_phase2(mid, ref, log_probs=False)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions, no launch
    np.testing.assert_allclose(fused.numpy(), fused_c.numpy(), **TOL)
    assert np.mean(pred.numpy() == logits.argmax(1).to(torch.int32).numpy()) >= AGREEMENT


def test_k3_ties_take_the_lowest_index():
    """Equal logits: the first class wins, as jnp.argmax picks it."""
    lr_up, ref, convs, fc_w, fc_b = _head_case(12, 1, 6, 8, 16, 5)
    fc_w[..., 3] = fc_w[..., 1]
    fc_b[3] = fc_b[1] = 50.0  # classes 1 and 3 tie above the others
    args = _torch_head_args(convs, fc_w, fc_b, torch.float32)
    got = creff_head_kernel.creff_phase2_argmax(t(lr_up), t(ref), *args, 7, 7)
    assert torch.all(got == 1)


def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    lr_up, ref, convs, fc_w, fc_b = _head_case(13, 1, 4, 4, 16, 20)
    args = list(_torch_head_args(convs, fc_w, fc_b, torch.float32))
    meta = torch.empty(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError, match="classes"):
        creff_head_kernel.creff_phase2_argmax(meta, meta, *[a.to("meta") for a in args], 7, 7)
    with pytest.raises(ValueError, match="square"):
        creff_head_kernel.creff_phase2_argmax(meta, meta, *[a.to("meta") for a in args], 7, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,ncls,k", [(2, 37, 45, 32, 12, 7), (1, 13, 37, 16, 19, 3),
                                            (1, 1, 5, 64, 12, 5), (1, 45, 60, 512, 19, 7)])
def test_k3_kernel_matches_plain_on_card(n, h, w, c, ncls, k):
    """bfloat16 runs the tensor-core body (with the 1x1 conv on the tensor
    cores), float32 the CUDA-core one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    lr_up, ref, convs, fc_w, fc_b = _head_case(14, n, h, w, c, ncls)
    for dtype, agree in ((torch.float32, 0.9999), (torch.bfloat16, 0.999)):
        args = [a.cuda() for a in _torch_head_args(convs, fc_w, fc_b, dtype)]
        a, b = t(lr_up).cuda().to(dtype), t(ref).cuda().to(dtype)
        got = creff_head_kernel.creff_phase2_argmax(a, b, *args, k, k)
        want = creff_head_kernel.creff_phase2_argmax_plain(a, b, *args, k, k)
        assert (got == want).float().mean().item() >= agree


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_kernel_ties_take_the_lowest_index_on_card(dtype):
    """Classes 2 and 9 (in different n8 tiles of the bfloat16 head) tie
    above the others: the kernel takes class 2 everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    lr_up, ref, convs, fc_w, fc_b = _head_case(15, 1, 13, 37, 64, 12)
    fc_w[..., 9] = fc_w[..., 2]
    fc_b[2] = fc_b[9] = 50.0
    args = [a.cuda() for a in _torch_head_args(convs, fc_w, fc_b, dtype)]
    a, b = t(lr_up).cuda().to(dtype), t(ref).cuda().to(dtype)
    assert torch.all(creff_head_kernel.creff_phase2_argmax(a, b, *args, 7, 7) == 2)


# ---------------------------------------------------------------- pipeline


@pytest.fixture(scope="module", params=[1, 2], ids=lambda v: f"V{v}")
def pipes(request):
    """HR and LR models of camvid-psp18 V1 (HR plain) or V2 (HR V2 too, as
    bench.py builds it), both frameworks, and a clip of 2 GOPs."""
    fv = request.param
    hr_fv = 0 if fv == 1 else 2
    models, params = [], []
    for seed, v in ((0, hr_fv), (1, fv)):
        jm, p, tm = _pair(v, seed=10 + seed)
        models.append((jm, tm))
        params.append(p)
    rng = np.random.RandomState(9)
    data = dict(
        kf=rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8),
        fr=rng.randint(0, 256, (2, G - 1, H, W, 3)).astype(np.uint8),
        fx=rng.uniform(-8, 8, (2, G - 1, H, W)).astype(np.float32),
        fy=rng.uniform(-8, 8, (2, G - 1, H, W)).astype(np.float32),
    )
    norm = (CAMVID_MEAN, CAMVID_STD)
    jpipe = JPipeline(models[0][0], models[1][0], scale=0.5, normalize=norm)
    tpipe = ARPipeline(models[0][1], models[1][1], scale=0.5, normalize=norm, device="cpu")
    return fv, models, params, data, jpipe, tpipe


def _jax_fused(models, params, kf_u8, fr_u8, fx, fy):
    """The fused features of the JAX GOP step, built from its stages."""
    (jhr, _), (jlr, _) = models
    hp, lp = params
    norm = lambda x: (jnp.asarray(x, jnp.float32) / 255.0 - jnp.asarray(CAMVID_MEAN)) / jnp.asarray(CAMVID_STD)
    ref = jhr.apply(hp, norm(kf_u8))[-1]
    fxr, fyr = j_resize_flow_planes((jnp.asarray(fx), jnp.asarray(fy)), ref.shape[1:3])
    x_lr = j_resize_bilinear(norm(fr_u8), (H // 2, W // 2), align_corners=True)
    feat = jlr.forward_phase1(lp, x_lr)[-1]
    warped = j_warp_feature(jnp.broadcast_to(ref, (G - 1,) + ref.shape[1:]), (fxr, fyr))
    return np.asarray(jlr.fuse_apply(lp["fuse_attention"], warped, feat))


def test_gop_and_scan_step_match_jax(pipes):
    fv, models, params, data, jpipe, tpipe = pipes
    kf, fr, fx, fy = data["kf"][:1], data["fr"][0], data["fx"][0], data["fy"][0]
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(kf), jnp.asarray(fr),
                            (jnp.asarray(fx), jnp.asarray(fy))))
    got, fused = tpipe.gop_step(t(kf), t(fr), (t(fx), t(fy)), return_fused=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (G, H, W)
    assert np.mean(got.numpy() == want) >= AGREEMENT
    assert tuple(fused.shape) == ((G - 1, H, W, 64) if fv == 1 else (G - 1, H // 8, W // 8, 512))
    # within 1e-4 of the feature's scale: V2's fused feature is the 512-ch
    # backbone output, 20 float32 convolutions deep, whose sums run in
    # another order than XLA's (observed 6e-4 at max |fused| ~ 20)
    want_fused = _jax_fused(models, params, kf, fr, fx, fy)
    scale = max(1.0, float(np.abs(want_fused).max()))
    assert np.abs(fused.numpy() - want_fused).max() <= 1e-4 * scale
    # without return_fused the same maps, and the scan over two GOPs repeats
    # the GOP step
    np.testing.assert_array_equal(tpipe(t(kf), t(fr), (t(fx), t(fy))).numpy(), got.numpy())
    clip = tpipe.scan_step(*(t(data[k]) for k in ("kf", "fr", "fx", "fy")))
    assert tuple(clip.shape) == (2, G, H, W)
    np.testing.assert_array_equal(clip[0].numpy(), got.numpy())
    want1 = np.asarray(jpipe(params[0], params[1], jnp.asarray(data["kf"][1:]),
                             jnp.asarray(data["fr"][1]),
                             (jnp.asarray(data["fx"][1]), jnp.asarray(data["fy"][1]))))
    assert np.mean(clip[1].numpy() == want1) >= AGREEMENT
