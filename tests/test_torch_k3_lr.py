"""K3's LR form (``ops/creff_head_kernel.py``): K3 fed the LR feature at its
own size, the bilinear ``align_corners=True`` resize to ref's size built
inside the kernel. On the CPU: the wrapper's routing by shape and dtype
(through a recording fake library on meta tensors), the plain version
against ``resize_bilinear`` and K3's plain version, and
``PSPNet.forward_phase2_argmax`` against the path that resized first. On a
card (``-m cuda``): the LR form's maps against K3 over ``resize_bilinear``,
bit for bit, at the camvid-psp18 chunk's shape, at other ratios, at
ragged tiles and at windows 3, 5 and 7. Imports no JAX."""

import ctypes
import types

import pytest
import torch

from arseg_tpu_torch.nn import pspnet
from arseg_tpu_torch.ops import _build, creff_head_kernel as k3, creff_kernel
from arseg_tpu_torch.ops.resize import resize_bilinear

from torch_parity import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")


def _head(c, n_classes, dtype, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    convs = [t for _ in range(3) for t in (torch.randn(c, 1, 3, 3, generator=g) * 0.3,
                                           torch.randn(c, generator=g) * 0.1)]
    taps, bias = creff_kernel.pack_qkv(*convs)
    fc_w, fc_b = k3.pack_head(torch.randn(n_classes, c, 1, 1, generator=g) / c ** 0.5,
                              torch.randn(n_classes, generator=g) * 0.1, dtype)
    return tuple(t.to(device) for t in (taps, bias, fc_w, fc_b))


def _inputs(n, hw_in, hw, c, dtype, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    lr = torch.randn(n, *hw_in, c, generator=g).to(dtype).to(device)
    ref = torch.randn(n, *hw, c, generator=g).to(dtype).to(device)
    return lr, ref


class _FakeLibrary:
    """Records (C name, arguments) of each call and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=1))
    _build.LAUNCHES.clear()
    yield lib
    _build.LAUNCHES.clear()


# (LR feature's H x W, dtype, channels) -> the launcher and the sizes it is
# given; the route is by size and dtype alone: a bfloat16 LR feature of
# more than 64 channels too goes to the LR form, whose launcher refuses it
ROUTES = [
    ((16, 24), torch.bfloat16, 32, "arseg_creff_phase2_argmax", (16, 24)),
    ((8, 12), torch.bfloat16, 32, "arseg_creff_phase2_argmax_lr", (8, 12, 16, 24)),
    ((16, 12), torch.bfloat16, 32, "arseg_creff_phase2_argmax_lr", (16, 12, 16, 24)),
    ((8, 12), torch.bfloat16, 80, "arseg_creff_phase2_argmax_lr", (8, 12, 16, 24)),
    ((8, 12), torch.float32, 32, "arseg_creff_phase2_argmax", (16, 24)),
    ((16, 24), torch.float32, 32, "arseg_creff_phase2_argmax", (16, 24)),
]


@pytest.mark.parametrize("hw_in,dtype,c,launcher,sizes", ROUTES)
def test_the_wrapper_routes_by_shape_and_dtype(fake_library, hw_in, dtype, c, launcher, sizes):
    """lr_up at ref's size: K3; a smaller bfloat16 LR feature: the LR form
    with both sizes; a smaller float32 one: resized, then K3."""
    _route(fake_library, hw_in, dtype, c, launcher, sizes)


def _route(lib, hw_in, dtype, c, launcher, sizes):
    lr = torch.empty(3, *hw_in, c, dtype=dtype, device="meta")
    ref = torch.empty(3, 16, 24, c, dtype=dtype, device="meta")
    taps, bias, fc_w, fc_b = (t.to("meta") for t in _head(c, 12, dtype))
    out = k3.creff_phase2_argmax(lr, ref, taps, bias, fc_w, fc_b, 5, 5)
    assert tuple(out.shape) == (3, 16, 24) and out.dtype == torch.int32
    (name, args), = lib.calls
    assert name == launcher
    ints = [a.value for a in args if isinstance(a, ctypes.c_int)]
    # n, the sizes, c, classes, window, window, dtype code
    assert ints[-(len(sizes) + 6):] == [3, *sizes, c, 12, 5, 5, 1 if dtype == torch.bfloat16
                                        else 0]
    assert dict(_build.LAUNCHES) == {launcher[len("arseg_"):]: 1}


def test_a_taller_lr_is_refused(fake_library):
    lr = torch.empty(1, 20, 12, 16, device="meta")
    ref = torch.empty(1, 16, 24, 16, device="meta")
    with pytest.raises(ValueError, match="one NHWC shape"):
        k3.creff_phase2_argmax(lr, ref, *(t.to("meta") for t in _head(16, 12, torch.float32)),
                               7, 7)
    assert fake_library.calls == []


# (n, LR H x W, H x W, c, window): x2, 0.7x, ragged, W alone smaller, a row
PLAIN_CASES = [(2, (8, 12), (16, 24), 16, 7), (1, (11, 16), (16, 23), 32, 5),
               (2, (5, 7), (13, 19), 16, 3), (1, (9, 5), (9, 13), 16, 5),
               (1, (1, 6), (1, 13), 16, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw_in,hw,c,k", PLAIN_CASES)
def test_the_lr_form_on_the_cpu_is_the_resize_and_k3s_plain_version(n, hw_in, hw, c, k, dtype):
    lr, ref = _inputs(n, hw_in, hw, c, dtype)
    head = (*_head(c, 12, dtype), k, k)
    got = k3.creff_phase2_argmax(lr, ref, *head)
    want = k3.creff_phase2_argmax_plain(resize_bilinear(lr, hw, align_corners=True), ref, *head)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(k3.creff_phase2_argmax_lr_plain(lr, ref, *head), want)


def _v1(seed=0):
    model = pspnet.PSPNet(n_classes=12, psp_size=512, deep_features_size=256, fuse_version=1,
                          generator=torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    return model, torch.randn(5, 64, 8, 12, generator=g), torch.randn(5, 64, 16, 24, generator=g)


def test_phase2_argmax_equals_the_path_that_resized_first():
    """V1's maps and fused features, float32 on the CPU, against K3 over
    the LR feature resized first (the path before the LR form) and the
    fusion module itself: bit-equal."""
    model, mid, ref = _v1()
    fa = model.fuse_attention
    taps, bias = creff_kernel.pack_qkv(*fa.qkv_weights())
    fc_w, fc_b = k3.pack_head(model.final_conv.weight, model.final_conv.bias, mid.dtype)
    with torch.no_grad():
        maps, fused = model.forward_phase2_argmax(mid, ref, return_fused=True)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        lr_up = resize_bilinear(nhwc(mid), ref.shape[-2:], align_corners=True)
        want = k3.creff_phase2_argmax(lr_up, nhwc(ref), taps, bias, fc_w, fc_b, model.atten_k,
                                      model.atten_k)
        want_fused = fa(ref, mid)
    assert torch.equal(maps, want)
    assert torch.equal(fused, want_fused)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# (n, LR H x W, H x W, c, classes, window): the camvid-psp18 chunk, 0.7x of
# 720x960, x2 onto sizes off the 16-pixel tile, a ratio of 7, one close to
# 1, W or H alone smaller, a single row
CARD_CASES = [(44, (360, 480), (720, 960), 64, 12, 7), (4, (504, 672), (720, 960), 64, 12, 7),
              (2, (36, 51), (71, 101), 64, 19, 5), (3, (50, 70), (99, 131), 16, 12, 3),
              (2, (7, 9), (50, 70), 32, 12, 7), (2, (60, 80), (61, 81), 16, 12, 5),
              (1, (37, 20), (37, 45), 64, 12, 7), (1, (19, 37), (45, 37), 16, 19, 3),
              (1, (1, 6), (1, 37), 16, 12, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw_in,hw,c,n_classes,k", CARD_CASES)
def test_the_lr_form_equals_k3_over_the_resize_on_a_card(n, hw_in, hw, c, n_classes, k):
    """bfloat16: the LR form's maps equal K3's over ``resize_bilinear``
    (F.interpolate on the card) bit for bit, one launch of each."""
    _card()
    lr, ref = _inputs(n, hw_in, hw, c, torch.bfloat16, "cuda")
    head = (*_head(c, n_classes, torch.bfloat16, "cuda"), k, k)
    _build.LAUNCHES.clear()
    got = k3.creff_phase2_argmax(lr, ref, *head)
    assert dict(_build.LAUNCHES) == {k3.NAME_LR: 1}
    want = k3.creff_phase2_argmax(resize_bilinear(lr, hw, align_corners=True), ref, *head)
    assert _build.LAUNCHES[k3.NAME] == 1
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_a_float32_lr_feature_takes_the_resize_and_k3_on_a_card():
    _card()
    lr, ref = _inputs(2, (8, 12), (16, 24), 16, torch.float32, "cuda")
    head = (*_head(16, 12, torch.float32, "cuda"), 7, 7)
    _build.LAUNCHES.clear()
    got = k3.creff_phase2_argmax(lr, ref, *head)
    assert dict(_build.LAUNCHES) == {k3.NAME: 1}
    want = k3.creff_phase2_argmax(resize_bilinear(lr, (16, 24), align_corners=True), ref, *head)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_the_lr_launcher_refuses_a_taller_lr_on_a_card():
    """The C launcher's own check: an LR feature taller than ref."""
    _card()
    lr, ref = _inputs(1, (20, 12), (16, 24), 16, torch.bfloat16, "cuda")
    with pytest.raises(RuntimeError, match="creff_phase2_argmax_lr launch failed"):
        k3.launch_lr(lr, ref, *_head(16, 12, torch.bfloat16, "cuda"), 7, 7)


@pytest.mark.cuda
def test_the_lr_launcher_refuses_more_than_64_channels_on_a_card():
    """The C launcher's own check: shared memory holds 64 channels of lr_up
    interiors."""
    _card()
    lr, ref = _inputs(1, (8, 12), (16, 24), 80, torch.bfloat16, "cuda")
    with pytest.raises(RuntimeError, match="creff_phase2_argmax_lr launch failed"):
        k3.creff_phase2_argmax(lr, ref, *_head(80, 12, torch.bfloat16, "cuda"), 7, 7)
