"""Parity of the port's serving modes with the JAX ARPipeline on the CPU,
float32, TF32 off, GOP 3, raw uint8 frames normalised on the device:
one cityscapes-bise18 GOP at 128x256, the multi-GOP step (5-D frames) of
camvid-bise18 and camvid-psp18 V1 at 64x96, and the streaming step; and
K2 with one source per GOP (its plain version here; the kernel on the
card, which skips without one)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.gop import ARPipeline as JPipeline
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.ops import warp_feature as j_warp_feature

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.ops import _build, warp_kernel
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import randomize_bn_tree  # noqa: E402

set_f32_parity_mode()

G, B = 3, 2
AGREEMENT = 0.999
CAMVID_NORM = ((0.39068785, 0.40521392, 0.41434407), (0.29652068, 0.30514979, 0.30080369))
# the reference's Cityscapes normalisation for BiSeNet
CITYSCAPES_BISENET_NORM = ((0.3257, 0.3690, 0.3223), (0.2112, 0.2148, 0.2115))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pipes(backend, hr_kw, lr_kw, norm):
    """Both frameworks' pipelines over one pair of HR / LR models (JAX
    parameters, BN statistics randomised, loaded strict into the port)."""
    models, params = [], []
    for seed, (fuse, kw) in ((0, hr_kw), (1, lr_kw)):
        jm = j_build_model(backend, fuse=fuse, **kw)
        p = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                              np.random.RandomState(seed))
        tm = build_model(backend, fuse=fuse, device="cpu", **kw)
        tm.load_state_dict(state_dict_from_jax(p, backend), strict=True)
        models.append((jm, tm))
        params.append(p)
    jpipe = JPipeline(models[0][0], models[1][0], scale=0.5, normalize=norm)
    tpipe = ARPipeline(models[0][1], models[1][1], scale=0.5, normalize=norm, device="cpu")
    return params, jpipe, tpipe


def _clip(b, h, w, seed, mag=16):
    rng = np.random.RandomState(seed)
    return dict(
        kf=rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        fr=rng.randint(0, 256, (b, G - 1, h, w, 3)).astype(np.uint8),
        fx=rng.uniform(-mag, mag, (b, G - 1, h, w)).astype(np.float32),
        fy=rng.uniform(-mag, mag, (b, G - 1, h, w)).astype(np.float32),
    )


CAMVID = {
    "camvid-bise18": ((False, {}), (True, {})),
    "camvid-psp18-V1": ((False, {}), (True, {"fuse_version": 1})),
}


@pytest.fixture(scope="module", params=sorted(CAMVID))
def camvid(request):
    backend = request.param.replace("-V1", "")
    params, jpipe, tpipe = _pipes(backend, *CAMVID[request.param], CAMVID_NORM)
    return params, jpipe, tpipe, _clip(B, 64, 96, 7, mag=8)


# ---------------------------------------------------------------- cityscapes-bise18


def test_cityscapes_bise18_gop_matches_jax():
    """cityscapes-bise18 fuses at 1/8 like camvid-bise18 and takes the
    planes head (19 classes)."""
    params, jpipe, tpipe = _pipes("cityscapes-bise18", (False, {}), (True, {}),
                                  CITYSCAPES_BISENET_NORM)
    d = _clip(1, 128, 256, 5)
    kf, fr, fx, fy = d["kf"], d["fr"][0], d["fx"][0], d["fy"][0]
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(kf), jnp.asarray(fr),
                            (jnp.asarray(fx), jnp.asarray(fy))))
    got, fused = tpipe.gop_step(t(kf), t(fr), (t(fx), t(fy)), return_fused=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (G, 128, 256)
    assert np.mean(got.numpy() == want) >= AGREEMENT
    assert int(got.max()) < 19 and tuple(fused.shape) == (G - 1, 16, 32, 256)
    # the fused feature against the JAX stages: HR feature, flows, phase 1, CReFF
    from arseg_tpu.gop.pipeline import _resize_flow_planes as j_resize_flow_planes
    from arseg_tpu.ops import resize_bilinear as j_resize_bilinear

    jhr, jlr = jpipe.hr_model, jpipe.lr_model
    mean, std = (jnp.asarray(v) for v in CITYSCAPES_BISENET_NORM)
    norm = lambda u8: (jnp.asarray(u8, jnp.float32) / 255.0 - mean) / std
    ref = jax.jit(lambda p, x: jhr.apply(p, x)[-1])(params[0], norm(kf))
    fxr, fyr = j_resize_flow_planes((jnp.asarray(fx), jnp.asarray(fy)), ref.shape[1:3])
    feat = jax.jit(lambda p, x: jlr.forward_phase1(p, x)[-1])(
        params[1], j_resize_bilinear(norm(fr), (64, 128), True))
    warped = j_warp_feature(jnp.broadcast_to(ref, (G - 1,) + ref.shape[1:]), (fxr, fyr))
    want_fused = np.asarray(jlr.fuse_apply(params[1]["fuse_attention"], warped, feat))
    np.testing.assert_allclose(fused.numpy(), want_fused, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- multi-GOP


def test_multi_gop_matches_jax(camvid):
    """B GOPs in one step (5-D frames) against the JAX 5-D call; the same
    maps through multi_gop_step, and through gop_step GOP by GOP."""
    params, jpipe, tpipe, d = camvid
    want = np.asarray(jpipe(params[0], params[1], jnp.asarray(d["kf"]), jnp.asarray(d["fr"]),
                            (jnp.asarray(d["fx"]), jnp.asarray(d["fy"]))))
    got = tpipe.gop_step(t(d["kf"]), t(d["fr"]), (t(d["fx"]), t(d["fy"])))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (B, G, 64, 96)
    assert np.mean(got.numpy() == want) >= AGREEMENT
    packed = tpipe.multi_gop_step(t(d["kf"]), t(d["fr"]), t(np.stack([d["fx"], d["fy"]], -1)))
    np.testing.assert_array_equal(packed.numpy(), got.numpy())
    per_gop = tpipe.scan_step(*(t(d[k]) for k in ("kf", "fr", "fx", "fy")))
    assert np.mean(per_gop.numpy() == got.numpy()) >= AGREEMENT


def test_multi_gop_reads_each_keyframe_feature(camvid):
    """GOP i's frames are fused with GOP i's keyframe (K2 with one source
    per GOP): swapping the two keyframes swaps the keyframe maps, and GOP
    1's fused features equal those of gop_step on GOP 1 alone."""
    _, _, tpipe, d = camvid
    args = (t(d["fr"]), (t(d["fx"]), t(d["fy"])))
    a, fa = tpipe.multi_gop_step(t(d["kf"]), *args, return_fused=True)
    b, fb = tpipe.multi_gop_step(t(d["kf"]).flip(0), *args, return_fused=True)
    np.testing.assert_array_equal(a[:, 0].numpy(), b[:, 0].flip(0).numpy())
    assert fa.shape == fb.shape and fa.shape[0] == B * (G - 1)
    one = tpipe.gop_step(t(d["kf"][1:]), t(d["fr"][1]), (t(d["fx"][1]), t(d["fy"][1])),
                         return_fused=True)[1]
    assert (fa[G - 1 :] - one).abs().max().item() <= 1e-4 * max(1.0, one.abs().max().item())


# ---------------------------------------------------------------- streaming


@pytest.mark.parametrize("camvid", ["camvid-bise18"], indirect=True)
def test_streaming_matches_jax_and_gop_step(camvid):
    """key_step + a frame_step per frame against the JAX streaming step, and
    against the port's gop_step on the same GOP; the keyframe feature is
    the state between calls. camvid-bise18 only: a frame_step takes the
    pipeline's _fuse_branch, which test_multi_gop_matches_jax holds for
    camvid-psp18 V1's K3 head."""
    params, jpipe, tpipe, d = camvid
    jkey, jframe = jpipe.streaming_step()
    key_step, frame_step = tpipe.streaming_step()
    kf = d["kf"][:1]
    jmap, jref = jkey(params[0], jnp.asarray(kf))
    kmap, ref = key_step(t(kf))
    assert kmap.dtype == torch.int32 and tuple(kmap.shape) == (1, 64, 96)
    assert np.mean(kmap.numpy() == np.asarray(jmap)) >= AGREEMENT
    maps = [kmap]
    for i in range(G - 1):
        fr = d["fr"][0, i : i + 1]
        flow = np.stack([d["fx"][0, i : i + 1], d["fy"][0, i : i + 1]], -1)
        want = np.asarray(jframe(params[1], jref, jnp.asarray(fr), jnp.asarray(flow)))
        got = frame_step(ref, t(fr), t(flow))
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (1, 64, 96)
        assert np.mean(got.numpy() == want) >= AGREEMENT
        planes = frame_step(ref, t(fr), (t(d["fx"][0, i : i + 1]), t(d["fy"][0, i : i + 1])))
        np.testing.assert_array_equal(planes.numpy(), got.numpy())
        maps.append(got)
    gop = tpipe.gop_step(t(kf), t(d["fr"][0]), (t(d["fx"][0]), t(d["fy"][0])))
    assert np.mean(torch.cat(maps).numpy() == gop.numpy()) >= AGREEMENT


def test_place_model_and_device_frames():
    """The helpers the pipeline and the eval engines share: a placed model
    is a copy in eval mode, cast only when a dtype is given; raw uint8
    frames are normalised, float frames pass as they are, and both come
    back NCHW, channels_last in memory."""
    from arseg_tpu_torch.gop.pipeline import device_frames, place_model

    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4)).train()
    placed = place_model(model, "cpu")
    assert placed is not model and not placed.training and model.training
    assert next(placed.parameters()).dtype == torch.float32
    assert next(place_model(model, "cpu", torch.bfloat16).parameters()).dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
    u8 = np.random.RandomState(0).randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    mean, std = (torch.tensor(v) for v in CAMVID_NORM)
    x = device_frames(t(u8), "cpu", normalize=(mean, std))
    want = (torch.from_numpy(u8).float() / 255.0 - mean) / std
    assert tuple(x.shape) == (2, 3, 5, 7) and x.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(x.permute(0, 2, 3, 1), want, rtol=0, atol=0)
    f = device_frames(want, "cpu", torch.bfloat16, normalize=(mean, std))
    assert f.dtype == torch.bfloat16
    torch.testing.assert_close(f.permute(0, 2, 3, 1), want.to(torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------- K2 with S sources


@pytest.mark.parametrize("s,n,c", [(2, 4, 16), (3, 33, 8), (5, 5, 24), (1, 3, 16)])
def test_warp_s_sources_plain_matches_jax_repeated(s, n, c):
    """Frame i reads source i // (n / S): the plain version against the JAX
    warp_feature on each source repeated n / S times, bit for bit."""
    rng = np.random.RandomState(s * 100 + n)
    src = rng.randn(s, 13, 21, c).astype(np.float32)
    fx, fy = (rng.uniform(-9, 9, (n, 13, 21)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_warp_feature(jnp.asarray(np.repeat(src, n // s, axis=0)),
                                     (jnp.asarray(fx), jnp.asarray(fy))))
    got = warp_kernel.warp_bilinear(t(src), t(fx), t(fy))
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_refuses_sources_that_do_not_divide_the_frames():
    src = torch.zeros(3, 5, 7, 8)
    for n in (4, 2):
        fx = torch.zeros(n, 5, 7)
        with pytest.raises(ValueError, match="S dividing"):
            warp_kernel.warp_bilinear(src, fx, fx)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_s_sources_kernel_matches_plain_on_card(dtype):
    """K2 with S sources equals its plain version: 3 sources for 33 frames
    at C 8, 64 and 136, S = n, and 8 sources for 88 frames at the
    multi-GOP shape; and it refuses an n that S does not divide."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    for s, n, h, w, c in ((3, 33, 13, 37, 8), (3, 33, 13, 37, 64), (3, 33, 13, 37, 136),
                          (4, 4, 29, 43, 64), (8, 88, 90, 120, 256)):
        src = t(rng.randn(s, h, w, c).astype(np.float32)).cuda().to(dtype)
        fx, fy = (t(rng.uniform(-16, 16, (n, h, w)).astype(np.float32)).cuda() for _ in range(2))
        got = warp_kernel.warp_bilinear(src, fx, fy)
        assert torch.equal(got, warp_kernel.warp_bilinear_plain(src, fx, fy)), (s, n, h, w, c)
    with pytest.raises(ValueError):
        warp_kernel.warp_bilinear(src, fx[:87], fy[:87])
