"""The seam between the port's kernel wrappers and its CUDA library, on the
CPU: the one input check of the CReFF kernels (K1, K1B, K3, K4, K5) and
``_build.launch``'s calls held to ``csrc/kernels.h``. Meta tensors take the
wrappers' kernel path without a card; a fake library stands in for the
built one and records each call. Imports no JAX."""

import ctypes
import re
import types

import pytest
import torch

from arseg_tpu_torch.ops import (_build, creff_attention_kernel, creff_backward_kernel,
                                 creff_head_kernel, creff_kernel, creff_upsample_head_kernel,
                                 resize_argmax_kernel, resize_kernel, warp_kernel)

from torch_parity import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

META = "meta"


def _nhwc(c=16, dtype=torch.float32, n=1, h=4, w=4):
    return torch.empty(n, h, w, c, dtype=dtype, device=META)


def _packed(c=16, taps_c=None):
    taps_c = c if taps_c is None else taps_c
    return (torch.empty(3, 9, taps_c, device=META), torch.empty(3, taps_c, device=META),
            torch.empty(c, 12, device=META), torch.empty(12, device=META))


def _call(kernel, a, b, kh=7, kw=7, taps_c=None):
    """Run one CReFF wrapper on NHWC ``a`` and ``b`` (its other NHWC input
    shaped and typed as ``a``)."""
    taps, bias, fc_w, fc_b = _packed(a.shape[-1], taps_c)
    if kernel == "K1":
        return creff_kernel.creff_qkv_fused(a, b, taps, bias, kh, kw)
    if kernel == "K1B":
        return creff_backward_kernel.creff_qkv_fused_backward(a, b, torch.empty_like(a), taps,
                                                              bias, kh, kw)
    if kernel == "K3":
        return creff_head_kernel.creff_phase2_argmax(a, b, taps, bias, fc_w, fc_b, kh, kw)
    if kernel == "K4":
        return creff_attention_kernel.creff_attention(a, b, torch.empty_like(a), kh, kw)
    return creff_upsample_head_kernel.creff_phase2_upsample_argmax(a, b, taps, bias, fc_w, fc_b,
                                                                   kh, kw)


NAMES = {"K1": creff_kernel.NAME, "K1B": creff_backward_kernel.NAME, "K3": creff_head_kernel.NAME,
         "K4": creff_attention_kernel.NAME, "K5": creff_upsample_head_kernel.NAME}
# fault -> (exception, message with the wrapper's name, the call that makes it)
FAULTS = {
    "mixed dtypes": (TypeError, "{name} takes float32 or bfloat16 inputs of one dtype",
                     lambda k: _call(k, _nhwc(), _nhwc(dtype=torch.bfloat16))),
    "C not a multiple of 16": (ValueError, "{name} needs C % 16 == 0, got C=8",
                               lambda k: _call(k, _nhwc(8), _nhwc(8))),
    "a 7x5 window": (ValueError, "{name} is built for square 3, 5 or 7 windows, got 7x5",
                     lambda k: _call(k, _nhwc(), _nhwc(), 7, 5)),
    "taps not from pack_qkv": (ValueError, "taps/bias must come from pack_qkv",
                               lambda k: _call(k, _nhwc(), _nhwc(), taps_c=32)),
}
CASES = [(k, f) for k in NAMES for f in FAULTS if not (k == "K4" and f == "taps not from pack_qkv")]


@pytest.mark.parametrize("kernel,fault", CASES)
def test_creff_wrappers_refuse_alike(kernel, fault):
    """Each CReFF wrapper refuses what its kernel does not take through the
    one check, with one message (its own name in it)."""
    exc, message, call = FAULTS[fault]
    with pytest.raises(exc) as e:
        call(kernel)
    assert str(e.value) == message.format(name=NAMES[kernel])


@pytest.mark.parametrize("kernel", list(NAMES))
def test_creff_wrappers_refuse_mismatched_shapes(kernel):
    """The first input shorter than the second; for K3, whose shorter first
    input is the LR feature of its LR form, taller."""
    a, b = (_nhwc(h=5), _nhwc()) if kernel == "K3" else (_nhwc(), _nhwc(h=5))
    with pytest.raises(ValueError, match="one NHWC shape"):
        _call(kernel, a, b)


@pytest.mark.parametrize("kernel", [k for k in NAMES if k != "K3"])
def test_creff_wrappers_refuse_a_taller_first_input(kernel):
    with pytest.raises(ValueError, match="one NHWC shape"):
        _call(kernel, _nhwc(h=5), _nhwc())


@pytest.mark.parametrize("lr_shape,dtype", [((2, 2, 4, 16), torch.bfloat16),
                                            ((1, 2, 4, 32), torch.bfloat16),
                                            ((1, 2, 4, 16), torch.float32)])
def test_k3_lr_form_refuses_an_lr_feature_unlike_ref(lr_shape, dtype):
    """The LR form takes ref's frames, channels and dtype."""
    taps, bias, fc_w, fc_b = _packed()
    lr = torch.empty(*lr_shape, dtype=dtype, device=META)
    with pytest.raises(ValueError, match="creff_phase2_argmax_lr: lr .* must hold ref's frames"):
        creff_head_kernel.launch_lr(lr, _nhwc(dtype=torch.bfloat16), taps, bias, fc_w, fc_b, 7, 7)


def _declarations():
    """kernels.h's launchers: C name -> [(parameter, is a pointer)]."""
    text = (_build.CSRC / "kernels.h").read_text()
    decls = {}
    for name, params in re.findall(r"\b(?:int|size_t)\s+(arseg_\w+)\(([^)]*)\);", text):
        decls[name] = [(p.strip(), "*" in p) for p in params.split(",")]
    return decls


class _FakeLibrary:
    """Records (C name, arguments) of each call; returns ``rc`` (the size
    ``WORKSPACE`` for the workspace query). Its functions take a
    ``restype``, as ctypes' do."""

    WORKSPACE = 256

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return self.WORKSPACE if name.endswith("_workspace") else self.rc
        return fn


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=12345))
    _build.LAUNCHES.clear()
    yield lib
    _build.LAUNCHES.clear()


def _every_wrapper():
    """One call of each kernel wrapper on meta tensors (the resize backward
    in both layouts, the resize-and-argmax head on NCHW bfloat16 logits)
    -> the C launchers they should reach, in order."""
    a, b = _nhwc(64), _nhwc(64)
    for kernel in NAMES:
        _call(kernel, a, b)
    src = _nhwc(8)
    fx = torch.empty(2, 4, 4, device=META)
    warp_kernel.warp_bilinear(src, fx, fx)
    g = torch.empty(2, 16, 8, 8, device=META)
    resize_kernel.resize_bilinear_backward(g, (4, 4), False)
    resize_kernel.resize_bilinear_backward(g.contiguous(memory_format=torch.channels_last),
                                           (4, 4), True)
    # K3's LR form: a bfloat16 LR feature smaller than ref
    taps, bias, fc_w, fc_b = _packed(64)
    creff_head_kernel.creff_phase2_argmax(_nhwc(64, torch.bfloat16, h=2, w=3),
                                          _nhwc(64, torch.bfloat16), taps, bias, fc_w, fc_b, 7, 7)
    resize_argmax_kernel.resized_argmax(torch.empty(2, 19, 4, 8, dtype=torch.bfloat16,
                                                    device=META), (32, 64), False)
    return ([NAMES[k] for k in NAMES] + [warp_kernel.NAME] + [resize_kernel.NAME] * 2
            + [creff_head_kernel.NAME_LR, resize_argmax_kernel.NAME])


def test_every_launch_matches_its_declaration_in_kernels_h(fake_library):
    """Each wrapper reaches a launcher that kernels.h declares, with as many
    arguments as the declaration and the stream last: a pointer (or null)
    for each pointer parameter, a C int for each int."""
    decls = _declarations()
    want = _every_wrapper()
    launches = [(n, a) for n, a in fake_library.calls if not n.endswith("_workspace")]
    assert [n for n, _ in launches] == [f"arseg_{n}" for n in want]
    for name, args in fake_library.calls:
        assert name in decls, f"{name} is not declared in kernels.h"
        params = decls[name]
        assert len(args) == len(params), f"{name}: {len(args)} arguments for {params}"
        for arg, (param, pointer) in zip(args, params):
            if name.endswith("_workspace"):
                assert isinstance(arg, int) and not pointer, (name, param, arg)
            elif pointer:
                assert arg is None or isinstance(arg, ctypes.c_void_p), (name, param, arg)
            else:
                assert isinstance(arg, ctypes.c_int), (name, param, arg)
        if not name.endswith("_workspace"):
            assert params[-1][0] == "void* stream" and args[-1].value == 12345
    assert dict(_build.LAUNCHES) == {n: want.count(n) for n in want}
    # every launcher kernels.h declares is reached, the workspace query by K1B
    assert {n for n, _ in fake_library.calls} == set(decls)


def test_launch_passes_dtypes_and_a_null_d_ref(fake_library):
    """The dtype code (0 float32, 1 bfloat16) and K1B's d_ref, null where
    the gradient of ref is not wanted."""
    a = _nhwc(dtype=torch.bfloat16)
    taps, bias, _, _ = _packed()
    creff_backward_kernel.creff_qkv_fused_backward(a, a, a, taps, bias, 5, 5, need_ref=False)
    (_, ws_args), (name, args) = fake_library.calls
    assert ws_args == (1, 4, 4, 16, 5, 1)
    assert name == "arseg_creff_qkv_fused_backward"
    assert args[1] is None and args[-2].value == 1
    creff_kernel.creff_qkv_fused(_nhwc(), _nhwc(), taps, bias, 3, 3)
    assert fake_library.calls[-1][1][-2].value == 0


def test_launch_raises_on_a_cuda_error_and_counts_only_launches(fake_library):
    fake_library.rc = 700
    q = _nhwc()
    with pytest.raises(RuntimeError, match=r"^creff_attention launch failed: CUDA error 700$"):
        creff_attention_kernel.creff_attention(q, q, q, 7, 7)
    assert _build.LAUNCHES[creff_attention_kernel.NAME] == 0
    fake_library.rc = 0
    creff_attention_kernel.creff_attention(q, q, q, 7, 7)
    assert _build.LAUNCHES[creff_attention_kernel.NAME] == 1


def test_build_names_no_kernel_outside_its_sources():
    """``_build.py`` knows the kernels only as ``KERNEL_SOURCES``: the C
    interface is kernels.h's alone."""
    text = (_build.CSRC.parent / "ops" / "_build.py").read_text()
    sources = text[text.index("KERNEL_SOURCES = ("):]
    sources = sources[:sources.index(")") + 1]
    rest = text.replace(sources, "")
    for name in _declarations():
        assert name[len("arseg_"):] not in rest, name
