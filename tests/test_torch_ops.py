"""Parity of the PyTorch port's ops (arseg_tpu_torch.ops) with the JAX
package on the CPU: resize, the MV warp (K2's function) and the CReFF
module (K1's function), in float32 with TF32 off. Inputs come from numpy
with a seed and go to both frameworks. Kernel-versus-plain checks need a
card and skip here."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.ops import resize as jresize
from arseg_tpu.ops import warp as jwarp
from arseg_tpu.ops import local_attention as jla
from arseg_tpu.ops.pallas_creff import creff_qkv_fused as j_creff_qkv_fused
from arseg_tpu.ops.pallas_warp import warp_feature_blocked, BR, BC

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.ops import resize as tresize
from arseg_tpu_torch.ops import warp as twarp
from arseg_tpu_torch.ops import local_attention as tla
from arseg_tpu_torch.ops import creff_kernel, warp_kernel, _build

from torch_parity import few_threads  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

# float32 on both sides; sums in another order than XLA's
WARP_TOL = dict(rtol=1e-5, atol=1e-5)
CREFF_TOL = dict(rtol=2e-4, atol=2e-4)  # as tests/test_local_attention.py


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (15, 20)), ((24, 32), (11, 13)), ((6, 10), (48, 80))])
def test_resize_bilinear_matches_jax(align_corners, in_hw, out_hw):
    x = np.random.RandomState(0).randn(2, *in_hw, 5).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners))
    got = tresize.resize_bilinear(t(x), out_hw, align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (10, 14)), ((12, 15), (24, 30)), ((9, 13), (4, 5))])
def test_resize_nearest_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(1).randn(1, *in_hw, 3).astype(np.float32)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(tresize.resize_nearest(t(x), out_hw).numpy(), want)


@pytest.mark.parametrize("args", [(7, 15, True), (15, 7, False), (90, 720, False), (720, 90, True)])
def test_linear_tables_equal_jax(args):
    np.testing.assert_array_equal(tresize._linear_matrix(*args), jresize._linear_matrix(*args))
    for a, b in zip(tresize._linear_gather(*args), jresize._linear_gather(*args)):
        np.testing.assert_array_equal(a, b)


def test_flow_plane_resize_bitwise_equal_jax():
    x = np.random.RandomState(2).uniform(-16, 16, (3, 48, 64)).astype(np.float32)
    want = np.asarray(jwarp._resize_plane_bilinear(jnp.asarray(x), (6, 8), True))
    np.testing.assert_array_equal(twarp._resize_plane_bilinear(t(x), (6, 8), True).numpy(), want)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_scale_and_resize_flow_matches_jax(mode):
    fl = np.random.RandomState(3).uniform(-8, 8, (2, 32, 48, 2)).astype(np.float32)
    want = np.asarray(jwarp.scale_and_resize_flow(jnp.asarray(fl), (8, 12), mode))
    got = twarp.scale_and_resize_flow(t(fl), (8, 12), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- warp


def _warp_case(seed, n, h, w, c, lo, hi, ns=None):
    rng = np.random.RandomState(seed)
    feat = rng.randn(ns or n, h, w, c).astype(np.float32)
    fx = rng.uniform(lo, hi, (n, h, w)).astype(np.float32)
    fy = rng.uniform(lo, hi, (n, h, w)).astype(np.float32)
    return feat, fx, fy


@pytest.mark.parametrize("lo,hi", [(-3.0, 3.0), (-40.0, 40.0), (-0.5, 0.5), (-60.0, 60.0)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_feature_matches_jax(lo, hi, align_corners):
    feat, fx, fy = _warp_case(4, 2, 12, 17, 8, lo, hi)
    want = np.asarray(jwarp.warp_feature(jnp.asarray(feat), (jnp.asarray(fx), jnp.asarray(fy)),
                                         align_corners=align_corners))
    got = twarp.warp_feature(t(feat), (t(fx), t(fy)), align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, **WARP_TOL)


def test_warp_feature_broadcast_source_and_prepadded():
    """One keyframe feature warped to every frame (the GOP form), plain and
    prepadded, against the JAX warp of the repeated source."""
    feat, fx, fy = _warp_case(5, 3, 10, 14, 16, -4, 4, ns=1)
    rep = np.repeat(feat, 3, axis=0)
    want = np.asarray(jwarp.warp_feature(jnp.asarray(rep), (jnp.asarray(fx), jnp.asarray(fy))))
    got = twarp.warp_feature(t(feat), (t(fx), t(fy))).numpy()
    np.testing.assert_allclose(got, want, **WARP_TOL)
    pre = twarp.warp_feature(twarp.pad_for_warp(t(feat)), (t(fx), t(fy)), prepadded=True)
    np.testing.assert_array_equal(pre.numpy(), got)
    packed = twarp.warp_feature(t(feat), t(np.stack([fx, fy], -1)))
    np.testing.assert_array_equal(packed.numpy(), got)


@pytest.mark.parametrize("jitter,lo,hi", [(0.0, -6.0, 6.0), (0.45, -6.0, 6.0), (0.0, -40.0, 40.0)])
def test_warp_feature_matches_pallas_blocked_interpret(jitter, lo, hi):
    """Block-coherent flows (one MV per 4x8 block, the HEVC motion-field
    shape), the cases of tests/test_pallas_warp.py, against the TPU blocked
    warp kernel run in interpret mode."""
    rng = np.random.RandomState(6)
    h, w, c = 16, 32, 16
    feat = rng.randn(1, h, w, c).astype(np.float32)
    fb = rng.uniform(lo, hi, (2, 1, h // BR, w // BC)).astype(np.float32)
    f = np.repeat(np.repeat(fb, BR, axis=2), BC, axis=3)
    if jitter:
        f = f + rng.uniform(-jitter, jitter, f.shape).astype(np.float32)
    want = np.asarray(warp_feature_blocked(jnp.asarray(feat), (jnp.asarray(f[0]), jnp.asarray(f[1])),
                                           interpret=True))
    got = twarp.warp_feature(t(feat), (t(f[0]), t(f[1]))).numpy()
    np.testing.assert_allclose(got, want, **WARP_TOL)


@pytest.mark.parametrize("name", ["coherent", "coherent_jitter", "out_of_image", "discontinuity",
                                  "over_budget", "scene", "small_reach", "cross_tile", "random_8",
                                  "gop_11", "per_frame", "row", "column", "reach_60"])
def test_warp_plain_matches_jax_on_warp_kernel_cases(name):
    """K2's plain version against the JAX warp on the flow cases of
    tests/test_pallas_warp*.py and at the edges of K2's tiling, at C = 16
    and 512 (chip_smoke.py holds the kernel to the plain version on the same
    cases on the card): motion discontinuities inside blocks, per-pixel
    random flows past the TPU kernel's correction budget, scene flows, reach
    beyond one tile, 11 frames from one source at a size off the kernel's
    tiles, one source per frame, a single row or column, and flows of
    +-60."""
    from chip_smoke import warp_edge_cases

    for c in (16, 512):
        cases = warp_edge_cases(c)
        assert name in cases
        feat, fx, fy = cases[name]
        rep = feat if feat.shape[0] == fx.shape[0] else np.repeat(feat, fx.shape[0], axis=0)
        want = np.asarray(jwarp.warp_feature(jnp.asarray(rep), (jnp.asarray(fx), jnp.asarray(fy))))
        got = warp_kernel.warp_bilinear_plain(t(feat), t(fx), t(fy)).numpy()
        np.testing.assert_allclose(got, want, **WARP_TOL)


# ---------------------------------------------------------------- CReFF


def _creff_case(seed, n, h, w, c):
    rng = np.random.RandomState(seed)
    lr_up = rng.randn(n, h, w, c).astype(np.float32)
    ref = rng.randn(n, h, w, c).astype(np.float32)
    convs = [(rng.randn(3, 3, 1, c).astype(np.float32), rng.randn(c).astype(np.float32))
             for _ in range(3)]
    return lr_up, ref, convs


def _torch_convs(convs):
    """JAX HWIO depthwise [3,3,1,C] -> torch [C,1,3,3] weight + bias."""
    return [x for w, b in convs for x in (t(w.transpose(3, 2, 0, 1)), t(b))]


def _jax_convs(convs):
    return [{"weight": jnp.asarray(w), "bias": jnp.asarray(b)} for w, b in convs]


@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7), (5, 3)])
def test_local_similar_and_weighting_match_jax(kh, kw):
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 9, 11, 6).astype(np.float32) for _ in range(3))
    wgt = rng.randn(2, 9, 11, kh * kw).astype(np.float32)
    np.testing.assert_allclose(tla.local_similar(t(q), t(k), kh, kw).numpy(),
                               np.asarray(jla.local_similar(jnp.asarray(q), jnp.asarray(k), kh, kw)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tla.local_weighting(t(v), t(wgt), kh, kw).numpy(),
                               np.asarray(jla.local_weighting(jnp.asarray(v), jnp.asarray(wgt), kh, kw)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 21, 27, 8), (2, 5, 6, 16)])
def test_creff_module_matches_pallas_interpret_and_composed(shape):
    """The port's module (K1's plain version on the CPU) against the TPU
    kernel in interpret mode and the composed JAX module. 5x6 frames put
    every 7x7 window partly outside the image."""
    lr_up, ref, convs = _creff_case(8, *shape)
    jc = _jax_convs(convs)
    pallas = np.asarray(j_creff_qkv_fused(jnp.asarray(lr_up), jnp.asarray(ref), *jc, 7, 7,
                                          interpret=True))
    composed = np.asarray(jla._module_composed(jnp.asarray(lr_up), jnp.asarray(ref), *jc, 7, 7))
    got = tla.creff_local_module(t(lr_up), t(ref), *_torch_convs(convs), 7, 7).numpy()
    np.testing.assert_allclose(got, pallas, **CREFF_TOL)
    np.testing.assert_allclose(got, composed, **CREFF_TOL)


def test_creff_kernel_plain_matches_composed_torch():
    """K1's plain version (kernel arithmetic: dwconv taps in the kernel's
    order, masks, float32 softmax) equals the composed module in float32,
    up to the order of the sums."""
    lr_up, ref, convs = _creff_case(9, 2, 11, 13, 16)
    tc = _torch_convs(convs)
    taps, bias = creff_kernel.pack_qkv(*tc)
    plain = creff_kernel.creff_qkv_fused_plain(t(lr_up), t(ref), taps, bias, 7, 7)
    composed = tla.module_composed(t(lr_up), t(ref), *tc, 7, 7)
    np.testing.assert_allclose(plain.numpy(), composed.numpy(), **CREFF_TOL)


def test_creff_module_resize_forward_and_grads_match_jax():
    """creff_local_module_resize: forward against the JAX op, and the
    backward (composed ops, as the JAX custom_vjp) against jax.vjp."""
    rng = np.random.RandomState(10)
    c = 8
    lr = rng.randn(1, 5, 7, c).astype(np.float32)
    ref = rng.randn(1, 10, 14, c).astype(np.float32)
    convs = [(rng.randn(3, 3, 1, c).astype(np.float32) * 0.5, rng.randn(c).astype(np.float32) * 0.1)
             for _ in range(3)]
    g = rng.randn(1, 10, 14, c).astype(np.float32)
    jc = _jax_convs(convs)

    def jfn(a, b, cq, ck, cv):
        return jla.creff_local_module_resize(a, b, cq, ck, cv, 7, 7)

    want, vjp = jax.vjp(jfn, jnp.asarray(lr), jnp.asarray(ref), *jc)
    jg = vjp(jnp.asarray(g))
    targs = [x.requires_grad_(True) for x in [t(lr), t(ref), *_torch_convs(convs)]]
    got = tla.creff_local_module_resize(*targs, 7, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CREFF_TOL)
    got.backward(t(g))
    np.testing.assert_allclose(targs[0].grad.numpy(), np.asarray(jg[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(targs[1].grad.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-4)
    for i, name in enumerate(("q", "k", "v")):
        wgrad = targs[2 + 2 * i].grad.numpy().transpose(2, 3, 1, 0)
        np.testing.assert_allclose(wgrad, np.asarray(jg[2 + i]["weight"]), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(targs[3 + 2 * i].grad.numpy(), np.asarray(jg[2 + i]["bias"]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_cpu_tensors_take_plain_versions_without_launch():
    """On the CPU the wrappers take the plain versions: no build, no launch."""
    _build.LAUNCHES.clear()
    feat, fx, fy = _warp_case(11, 1, 6, 8, 8, -2, 2)
    warp_kernel.warp_bilinear(t(feat), t(fx), t(fy))
    lr_up, ref, convs = _creff_case(12, 1, 6, 8, 16)
    taps, bias = creff_kernel.pack_qkv(*_torch_convs(convs))
    creff_kernel.creff_qkv_fused(t(lr_up), t(ref), taps, bias, 7, 7)
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_matches_plain_on_card(dtype):
    """The kernel repeats its plain version's arithmetic, so the two are
    equal: at sizes off its 32-pixel sets and 32- to 128-pixel blocks, 11
    frames from one source, one source per frame, a single row or column,
    C of 8 to 512 (one, two or four warps a set), flows of +-60, and a
    source too large for half the L2 (the frames-innermost block order)."""
    needs_card()
    # (n, sources, h, w, c, flow range)
    for n, ns, h, w, c, mag in ((3, 1, 18, 24, 32, 3), (3, 1, 18, 24, 32, 60),
                                (11, 1, 13, 37, 512, 16), (3, 3, 29, 43, 64, 16),
                                (2, 1, 1, 45, 8, 8), (2, 1, 45, 1, 256, 8), (1, 1, 29, 43, 64, 60),
                                (2, 1, 13, 37, 136, 16), (3, 1, 723, 965, 64, 16)):
        feat, fx, fy = _warp_case(13, n, h, w, c, -mag, mag, ns=ns)
        src = t(feat).cuda().to(dtype)
        fxc, fyc = t(fx).cuda(), t(fy).cuda()
        got = warp_kernel.warp_bilinear(src, fxc, fyc)
        assert torch.equal(got, warp_kernel.warp_bilinear_plain(src, fxc, fyc)), (n, ns, h, w, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("n,h,w,c,k", [(2, 13, 37, 32, 7), (1, 1, 5, 16, 5), (1, 45, 60, 512, 7),
                                       (3, 13, 37, 64, 3)])
def test_creff_kernel_matches_plain_on_card(dtype, tol, n, h, w, c, k):
    """bfloat16 runs the tensor-core body, float32 the CUDA-core one; sizes
    that are no multiple of the tile, one row, n = 1, C of 16 to 512 and
    every window."""
    needs_card()
    lr_up, ref, convs = _creff_case(14, n, h, w, c)
    taps, bias = creff_kernel.pack_qkv(*_torch_convs(convs))
    a, b = t(lr_up).cuda().to(dtype), t(ref).cuda().to(dtype)
    got = creff_kernel.creff_qkv_fused(a, b, taps.cuda(), bias.cuda(), k, k).float()
    want = creff_kernel.creff_qkv_fused_plain(a, b, taps.cuda(), bias.cuda(), k, k).float()
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def test_aligned16_copies_only_misaligned_data():
    """The bfloat16 body stages with 16-byte copies: the wrappers hand it
    data that starts on 16 bytes, copying a view that does not."""
    base = torch.arange(40, dtype=torch.float32).to(torch.bfloat16)
    view = base[1:33]
    assert view.data_ptr() % 16 != 0
    fixed = creff_kernel.aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    assert creff_kernel.aligned16(base) is base


def test_build_hash_covers_every_kernel_source_and_header():
    """The library's name hashes KERNEL_SOURCES and HEADERS: each file of
    csrc must be listed, or an edit to it would load a stale library."""
    files = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.KERNEL_SOURCES) == {f for f in files if f.endswith(".cu")}
    assert set(_build.HEADERS) == {f for f in files if f.endswith((".cuh", ".h"))}
    assert "creff_module_mma.cuh" in _build.HEADERS


# ---------------------------------------------------------------- package rules


def test_port_imports_without_jax_and_names_no_jax_package():
    """arseg_tpu_torch imports every module with jax blocked, and no source
    file of the port (or chip_smoke.py) names the JAX package."""
    root = Path(__file__).resolve().parents[1]
    pkg = root / "arseg_tpu_torch"
    mods = sorted(
        "arseg_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py")
    )
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'arseg_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'arseg_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    for path in list(pkg.rglob("*.py")) + list((pkg / "csrc").glob("*")) + [root / "chip_smoke.py"]:
        text = path.read_text()
        assert "arseg_tpu." not in text and "import arseg_tpu\n" not in text, path
        assert "import jax" not in text and "from jax" not in text, path
        assert "import triton" not in text.split("def ", 1)[0], path


def test_cached_tables_made_in_inference_mode_serve_autograd():
    """The device tables of the resize, pool and flow ops are cached per
    shape; one first made under torch.inference_mode (serving, eval) must
    still serve a training step of that shape in the same process, which
    saves it for the backward. (When it was an inference tensor, the
    training parity tests failed whenever a serving test of their shapes
    ran before them in one pytest-xdist worker.) Shapes no other test
    uses, so that this test makes each table first."""
    x = torch.randn(1, 13, 11, 3, dtype=torch.float64)
    planes = torch.randn(1, 13, 11, dtype=torch.float64)
    ops = (lambda t: tresize.adaptive_avg_pool(t, (5, 4)),
           lambda t: twarp._resize_plane_bilinear(t, (17, 19), True),
           lambda t: twarp._resize_plane_nearest(t, (7, 6)))
    inputs = (x, planes, planes)
    with torch.inference_mode():
        want = [op(t) for op, t in zip(ops, inputs)]
    for op, t, w in zip(ops, inputs, want):
        t = t.clone().requires_grad_(True)
        y = op(t)
        y.sum().backward()
        assert torch.equal(y.detach(), w) and t.grad is not None
