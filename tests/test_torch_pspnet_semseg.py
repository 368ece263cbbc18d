"""Parity of the port's cityscapes-psp18 (arseg_tpu_torch.nn.pspnet_semseg:
the "semseg" ResNet, the PPM, the model's entry points, the converter and
one AR GOP) with the JAX package on the CPU, float32, TF32 off, at 128x256
frames, so that the LR feature (8x16) still holds the PPM's 6x6 bins. JAX
parameters (BN statistics randomised with numpy) go through the port's
``state_dict_from_jax`` and load strict; outputs are compared NCHW against
NHWC transposed."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.gop import ARPipeline as JPipeline
from arseg_tpu.gop.pipeline import _resize_flow_planes as j_resize_flow_planes
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.nn import functional as JFn
from arseg_tpu.nn.pspnet_semseg import apply_ppm
from arseg_tpu.nn.resnet import make_resnet_config, resnet_apply
from arseg_tpu.ops import resize_bilinear as j_resize_bilinear, warp_feature as j_warp_feature
from arseg_tpu.utils.torch_convert import export_state_dict

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.models import build_model, phase2_argmax_head
from arseg_tpu_torch.nn.pspnet_semseg import PSPNetSemseg
from arseg_tpu_torch.nn.resnet import ResNet
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import few_threads, randomize_bn_tree  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

BACKEND = "cityscapes-psp18"
H, W, G = 128, 256, 3
# float32; convolutions sum in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-4)
AGREEMENT = 0.999
# the reference's Cityscapes normalisation (ImageNet mean/std)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _pair(seed):
    jm = j_build_model(BACKEND, fuse=True)
    params = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                               np.random.RandomState(seed))
    tm = build_model(BACKEND, fuse=True, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, BACKEND), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(0)


def _scaled_max_diff(got, want):
    """max |got - want| over max(1, max |want|)."""
    return np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))


# ---------------------------------------------------------------- converter and registry


def test_state_dict_from_jax_equals_export_state_dict():
    """The port's converter gives exactly the keys and tensors of the JAX
    package's exporter (backbone.* -> layer0.{0,1} / layerN, cls.4 also as
    final_conv), and they load strict into the port's model."""
    jm = j_build_model(BACKEND, fuse=True)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    ours = state_dict_from_jax(params, BACKEND)
    theirs = export_state_dict(params, BACKEND)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    tm = build_model(BACKEND, fuse=True, device="cpu")
    tm.load_state_dict(ours, strict=True)
    assert set(tm.state_dict()) == set(ours)
    assert tuple(ours["layer0.0.weight"].shape) == (64, 3, 7, 7)
    assert tuple(ours["ppm.features.3.1.weight"].shape) == (128, 512, 1, 1)
    assert tuple(ours["final_conv.weight"].shape) == (19, 512, 1, 1)
    assert tuple(ours["aux.0.weight"].shape) == (256, 256, 3, 3)


def test_registry_builds_cityscapes_psp18():
    """cityscapes-psp18 builds with the fusion for both values of fuse (as
    the reference's two registries do), 19 classes, final_conv shared with
    cls[4], a seeded init, and no forward_phase2_argmax: serving and eval
    take forward_phase2 -> resize -> argmax."""
    for fuse in (False, True):
        m = build_model(BACKEND, fuse=fuse, seed=3, device="cpu")
        assert isinstance(m, PSPNetSemseg) and m.with_fuse and m.n_classes == 19
        assert m.final_conv is m.cls[4] and not m.training
        assert phase2_argmax_head(m, (H // 8, W // 8), (H, W)) is None
    a = build_model(BACKEND, seed=3, device="cpu").state_dict()
    b = build_model(BACKEND, seed=3, device="cpu").state_dict()
    c = build_model(BACKEND, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer1.0.conv1.weight"], c["layer1.0.conv1.weight"])
    assert a["final_conv.weight"].data_ptr() == a["cls.4.weight"].data_ptr()


# ---------------------------------------------------------------- modules


def test_resnet_semseg_stages_match_jax():
    """The "semseg" ResNet-18: block 0 of layers 3 and 4 dilates conv2 only;
    (x4, x3) against ``resnet_apply`` with the semseg config."""
    jm, params, tm = _pair(5)
    x = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    cfg = make_resnet_config(18, "semseg")
    x4, x3 = resnet_apply(params["backbone"], jnp.asarray(x), cfg, JFn.Ctx(), "backbone.")
    with torch.no_grad():
        t3, t4 = tm._trunk(_nchw(x))
    np.testing.assert_allclose(_nhwc(t3), np.asarray(x3), **TOL)
    np.testing.assert_allclose(_nhwc(t4), np.asarray(x4), **TOL)
    blocks = [tm.layer3[0], tm.layer3[1], tm.layer4[0], tm.layer4[1], tm.layer2[0]]
    assert [(b.conv1.dilation[0], b.conv2.dilation[0]) for b in blocks] == [
        (1, 2), (2, 2), (1, 4), (4, 4), (1, 1)]
    assert [b.conv2.padding[0] for b in blocks] == [2, 2, 4, 4, 1]
    arseg = ResNet(18, variant="arseg")
    assert (arseg.layer3[0].conv1.dilation[0], arseg.layer3[0].conv2.dilation[0]) == (1, 1)


def test_ppm_matches_jax(pair):
    jm, params, tm = pair
    x = np.random.RandomState(7).randn(2, 8, 16, 512).astype(np.float32)
    want = apply_ppm(params["ppm"], jnp.asarray(x), jm.bins, JFn.Ctx())
    with torch.no_grad():
        got = tm.ppm(_nchw(x))
    assert got.shape[1] == 1024
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_forward_and_key_match_jax(pair):
    jm, params, tm = pair
    x = np.random.RandomState(2).randn(1, H, W, 3).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
        key_logits, feat = tm.forward_key(_nchw(x))
    assert len(got) == len(want) == 3
    assert tuple(got[0].shape) == (1, 19, H, W) and tuple(got[2].shape) == (1, 512, H // 8, W // 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)
    np.testing.assert_array_equal(key_logits.numpy(), got[0].numpy())
    np.testing.assert_array_equal(feat.numpy(), got[2].numpy())


def test_phase1_and_phase2_match_jax(pair):
    jm, params, tm = pair
    rng = np.random.RandomState(3)
    x = rng.randn(2, H // 2, W // 2, 3).astype(np.float32)
    ref = rng.randn(2, H // 8, W // 8, 512).astype(np.float32)
    x_tmp_j, feat_j = jm.forward_phase1(params, jnp.asarray(x))
    with torch.no_grad():
        x_tmp, feat = tm.forward_phase1(_nchw(x))
        alone = tm.forward_phase1(_nchw(x), with_aux=False)
        out, fused = tm.forward_phase2(_nchw(feat_j), _nchw(ref))
    np.testing.assert_allclose(_nhwc(x_tmp), np.asarray(x_tmp_j), **TOL)
    np.testing.assert_allclose(_nhwc(feat), np.asarray(feat_j), **TOL)
    np.testing.assert_array_equal(alone.numpy(), feat.numpy())
    out_j, fused_j = jm.forward_phase2(params, feat_j, jnp.asarray(ref))
    assert tuple(out.shape) == (2, 19, H // 8, W // 8)
    np.testing.assert_allclose(_nhwc(out), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(_nhwc(fused), np.asarray(fused_j), **TOL)


# ---------------------------------------------------------------- pipeline


def test_gop_matches_jax():
    """One GOP (keyframe + 2 frames) of raw uint8 frames, normalised on the
    device, against the JAX ARPipeline: maps agree, and the fused features
    (K1's plain version here) agree within 1e-4 of their scale."""
    models, params = [], []
    for seed in (10, 11):
        jm, p, tm = _pair(seed)
        models.append((jm, tm))
        params.append(p)
    rng = np.random.RandomState(9)
    kf = rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8)
    fr = rng.randint(0, 256, (G - 1, H, W, 3)).astype(np.uint8)
    fx, fy = (rng.uniform(-16, 16, (G - 1, H, W)).astype(np.float32) for _ in range(2))
    jpipe = JPipeline(models[0][0], models[1][0], scale=0.5, normalize=(MEAN, STD))
    tpipe = ARPipeline(models[0][1], models[1][1], scale=0.5, normalize=(MEAN, STD), device="cpu")
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(kf), jnp.asarray(fr),
                            (jnp.asarray(fx), jnp.asarray(fy))))
    got, fused = tpipe.gop_step(t(kf), t(fr), (t(fx), t(fy)), return_fused=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (G, H, W)
    assert np.mean(got.numpy() == want) >= AGREEMENT

    (jhr, _), (jlr, _) = models
    norm = lambda u8: (jnp.asarray(u8, jnp.float32) / 255.0 - jnp.asarray(MEAN)) / jnp.asarray(STD)
    ref = jhr.apply(params[0], norm(kf))[-1]
    fxr, fyr = j_resize_flow_planes((jnp.asarray(fx), jnp.asarray(fy)), ref.shape[1:3])
    feat = jlr.forward_phase1(params[1], j_resize_bilinear(norm(fr), (H // 2, W // 2), True))[-1]
    warped = j_warp_feature(jnp.broadcast_to(ref, (G - 1,) + ref.shape[1:]), (fxr, fyr))
    want_fused = np.asarray(jlr.forward_phase2(params[1], feat, warped)[1])
    assert tuple(fused.shape) == (G - 1, H // 8, W // 8, 512)
    assert _scaled_max_diff(fused.numpy(), want_fused) <= 1e-4
