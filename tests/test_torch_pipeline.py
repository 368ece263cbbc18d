"""Parity of the port's GOP pipeline (arseg_tpu_torch.gop.ARPipeline) with
the JAX ARPipeline for camvid-bise18 on the CPU, float32, TF32 off, at a
small size: 64x96 frames, GOP 3, LR scale 0.5, raw uint8 frames normalised
on the device with the CamVid mean/std."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.gop import ARPipeline as JPipeline
from arseg_tpu.gop.pipeline import _resize_flow_planes as j_resize_flow_planes
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.ops import resize_bilinear as j_resize_bilinear, warp_feature as j_warp_feature

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.gop.pipeline import _resize_flow_planes
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import randomize_bn_tree  # noqa: E402

set_f32_parity_mode()

H, W, G, K = 64, 96, 3, 2
CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)
AGREEMENT = 0.999


@pytest.fixture(scope="module")
def setup():
    models, params = [], []
    for seed, fuse in ((0, False), (1, True)):
        jm = j_build_model("camvid-bise18", fuse=fuse)
        p = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                              np.random.RandomState(seed))
        tm = build_model("camvid-bise18", fuse=fuse, device="cpu")
        tm.load_state_dict(state_dict_from_jax(p, "camvid-bise18"), strict=True)
        models.append((jm, tm))
        params.append(p)
    rng = np.random.RandomState(7)
    data = dict(
        kf=rng.randint(0, 256, (K, H, W, 3)).astype(np.uint8),
        fr=rng.randint(0, 256, (K, G - 1, H, W, 3)).astype(np.uint8),
        fx=rng.uniform(-16, 16, (K, G - 1, H, W)).astype(np.float32),
        fy=rng.uniform(-16, 16, (K, G - 1, H, W)).astype(np.float32),
    )
    jpipe = JPipeline(models[0][0], models[1][0], scale=0.5, normalize=(CAMVID_MEAN, CAMVID_STD))
    tpipe = ARPipeline(models[0][1], models[1][1], scale=0.5, normalize=(CAMVID_MEAN, CAMVID_STD),
                       device="cpu")
    return models, params, data, jpipe, tpipe


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


def test_resize_flow_planes_matches_jax():
    rng = np.random.RandomState(8)
    fx, fy = (rng.uniform(-16, 16, (3, 48, 64)).astype(np.float32) for _ in range(2))
    want = j_resize_flow_planes((jnp.asarray(fx), jnp.asarray(fy)), (6, 8))
    got = _resize_flow_planes((torch.from_numpy(fx), torch.from_numpy(fy)), (6, 8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gop_step_matches_jax(setup):
    models, params, data, jpipe, tpipe = setup
    kf, fr, fx, fy = data["kf"][:1], data["fr"][0], data["fx"][0], data["fy"][0]
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(kf), jnp.asarray(fr),
                            (jnp.asarray(fx), jnp.asarray(fy))))
    got, fused = tpipe.gop_step(torch.from_numpy(kf), torch.from_numpy(fr),
                                (torch.from_numpy(fx), torch.from_numpy(fy)), return_fused=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (G, H, W)
    assert np.mean(got.numpy() == want) >= AGREEMENT
    np.testing.assert_allclose(fused.numpy(), _jax_fused(models, params, kf, fr, fx, fy),
                               **FUSED_TOL)
    # packed [..., 2] flows are the same planes
    packed = tpipe(torch.from_numpy(kf), torch.from_numpy(fr),
                   torch.from_numpy(np.stack([fx, fy], -1)))
    np.testing.assert_array_equal(packed.numpy(), got.numpy())


def test_gop_step_off_grid_size_matches_jax(setup):
    """60x92 frames: the fused features (8x12) times 8 miss the frame size, so
    both pipelines take forward_phase2 -> resize -> argmax instead of the
    planes head."""
    models, params, data, jpipe, tpipe = setup
    h, w = 60, 92
    kf, fr = data["kf"][:1, :h, :w], data["fr"][0, :, :h, :w]
    fx, fy = data["fx"][0, :, :h, :w], data["fy"][0, :, :h, :w]
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(kf), jnp.asarray(fr),
                            (jnp.asarray(fx), jnp.asarray(fy))))
    got = tpipe(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (kf, fr)),
                (torch.from_numpy(np.ascontiguousarray(fx)), torch.from_numpy(np.ascontiguousarray(fy))))
    assert tuple(got.shape) == want.shape == (G, h, w)
    assert np.mean(got.numpy() == want) >= AGREEMENT


def test_scan_step_matches_jax_per_gop(setup):
    models, params, data, jpipe, tpipe = setup
    clip = tpipe.scan_step(*(torch.from_numpy(data[k]) for k in ("kf", "fr", "fx", "fy")))
    assert tuple(clip.shape) == (K, G, H, W)
    for k in range(K):
        want = np.asarray(jpipe(params[0], params[1], jnp.asarray(data["kf"][k : k + 1]),
                                jnp.asarray(data["fr"][k]),
                                (jnp.asarray(data["fx"][k]), jnp.asarray(data["fy"][k]))))
        assert np.mean(clip[k].numpy() == want) >= AGREEMENT


def test_bf16_pipeline_runs_and_mostly_agrees(setup):
    """dtype=bfloat16 casts the models and frames at the boundary; on random
    weights bf16 flips only a small share of argmax decisions (the bar of
    tests/test_gop_pipeline.py::test_bf16_mode_runs_and_mostly_agrees)."""
    models, _, data, _, tpipe = setup
    b16 = ARPipeline(models[0][1], models[1][1], scale=0.5, dtype=torch.bfloat16,
                     normalize=(CAMVID_MEAN, CAMVID_STD), device="cpu")
    args = (torch.from_numpy(data["kf"][:1]), torch.from_numpy(data["fr"][0]),
            (torch.from_numpy(data["fx"][0]), torch.from_numpy(data["fy"][0])))
    a, b = tpipe(*args), b16(*args)
    assert b.dtype == torch.int32 and b.shape == a.shape
    assert (a == b).float().mean().item() > 0.9
    # the caller's modules stay float32
    assert next(models[1][1].parameters()).dtype == torch.float32


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    hr = build_model("camvid-bise18", fuse=False, device="cpu")
    lr = build_model("camvid-bise18", fuse=True, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ARPipeline(hr, lr)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("camvid-bise18")
