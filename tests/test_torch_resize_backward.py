"""The backward of bilinear resize in gather form (``ops/resize_kernel.py``):
its plain version against autograd over ``F.interpolate`` on the CPU, the
routing of training's resizes (``ops/resize.interpolate_bilinear``), and
the kernel against the plain version and against ``F.interpolate``'s
backward on a card. This file imports no JAX, so its card tests also run on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_resize_backward.py -m cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from arseg_tpu_torch.nn import bisenet
from arseg_tpu_torch.nn.functional import resize_bilinear_nchw
from arseg_tpu_torch.ops import _build, resize_kernel
from arseg_tpu_torch.ops.resize import _linear_matrix, interpolate_bilinear, resize_bilinear
from arseg_tpu_torch.train import objectives

from torch_parity import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

# (input [N, C, H, W], output size, align_corners): x2, x8 and x16 in both
# modes, the non-integer ratios of the FST step's OHEM resizes (360 -> 720
# and 368 -> 720, align True; W cut to keep the CPU quick), K1's 46x60 ->
# 90x120, a resize to a smaller size (inputs no output reads) and a 1x1 input
CASES = [
    ((2, 3, 6, 7), (12, 14), False), ((2, 3, 6, 7), (12, 14), True),
    ((2, 3, 5, 7), (40, 56), False), ((2, 3, 5, 7), (40, 56), True),
    ((1, 2, 4, 3), (64, 48), False), ((1, 2, 4, 3), (64, 48), True),
    ((2, 2, 360, 8), (720, 16), True), ((2, 2, 368, 8), (720, 16), True),
    ((2, 4, 46, 60), (90, 120), True),
    ((2, 2, 10, 13), (4, 5), False), ((2, 2, 10, 13), (4, 5), True),
    ((1, 2, 1, 1), (3, 4), True),
]

# Relative max error of the plain version (float32 sums over the transposed
# tables, W then H) against autograd over F.interpolate in float32, whose
# CPU backward sums the same products in another order: observed at most
# 1.3e-6 over CASES. float64 (tables and sums in float64, as torch computes
# float64): observed at most 2.3e-15.
CPU_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _autograd(x, g, size, align):
    x = x.detach().clone().requires_grad_(True)
    (d,) = torch.autograd.grad(F.interpolate(x, size, mode="bilinear", align_corners=align), x, g)
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,size,align", CASES)
def test_plain_matches_autograd(shape, size, align, channels_last, dtype):
    """The plain version, and BilinearResize's backward on the CPU, against
    autograd over F.interpolate; the gradient comes in the incoming
    gradient's layout and the input's type, and the forward is
    F.interpolate's tensor bit for bit."""
    gen = torch.Generator().manual_seed(sum(shape) + size[0])
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn(shape, generator=gen, dtype=dtype).contiguous(memory_format=fmt)
    g = torch.randn(shape[:2] + size, generator=gen, dtype=dtype).contiguous(memory_format=fmt)
    want = _autograd(x, g, size, align)
    err = _rel(resize_kernel.resize_bilinear_backward_plain(g, shape[2:], align), want)
    assert err <= CPU_TOL[dtype], f"plain: relative max error {err:.3e}"

    xr = x.detach().clone().requires_grad_(True)
    y = resize_kernel.BilinearResize.apply(xr, size, align)
    assert torch.equal(y, F.interpolate(x, size, mode="bilinear", align_corners=align))
    assert y.grad_fn.name() == "BilinearResizeBackward"
    y.backward(g)
    assert xr.grad.dtype == dtype and xr.grad.shape == x.shape
    assert xr.grad.is_contiguous(memory_format=fmt)
    assert _rel(xr.grad, want) <= CPU_TOL[dtype]


def test_plain_bfloat16_rounds_once():
    """bfloat16: float32 sums, one rounding; so within half a bf16 unit of
    the float32 gradient of the same values (2^-9 relative to each element,
    here at most 2^-8 of the largest)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 3, 23, 30, generator=gen).to(torch.bfloat16)
    g = torch.randn(2, 3, 368, 480, generator=gen).to(torch.bfloat16)
    got = resize_kernel.resize_bilinear_backward_plain(g, (23, 30), False)
    want = _autograd(x.float(), g.float(), (368, 480), False)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 2.0 ** -8


@pytest.mark.parametrize("in_size,out_size", [(90, 720), (23, 368), (368, 720), (360, 720),
                                              (46, 90), (24, 23), (45, 46), (10, 3), (1, 5),
                                              (5, 1), (7, 7)])
@pytest.mark.parametrize("align", [False, True])
def test_tables_are_the_forward_transposed(in_size, out_size, align):
    """Each input index's run and weights, laid back into an [out, in]
    matrix, are the forward's interpolation matrix exactly; runs never hold
    an output that does not read the index."""
    runs, wt = resize_kernel.transposed_tables(in_size, out_size, align)
    m = np.zeros((out_size, in_size), np.float32)
    for j, (lo, n) in enumerate(runs):
        m[lo : lo + n, j] = wt[j, :n]
        assert not wt[j, n:].any()
    assert np.array_equal(m, _linear_matrix(in_size, out_size, align))


@pytest.mark.parametrize("nhwc", [False, True])
def test_plan_fits_shared_memory(nhwc):
    """The launch plan at the FST step's shapes (and NHWC at C = 256, where
    the x8 resizes take narrower tiles): NCHW chunks within the shared
    memory the plan aims at and whole registers' loads, enough blocks; NHWC
    bands within the output rows they were sized for."""
    for (hin, win), (hout, wout), align in (((90, 120), (720, 960), False),
                                            ((23, 30), (368, 480), False),
                                            ((368, 480), (720, 960), True),
                                            ((46, 60), (90, 120), True)):
        c = 256 if nhwc else 12
        bh, rmax, tile = resize_kernel.plan(nhwc, 16, c, (hin, win), (hout, wout), 8, align)
        assert tile >= 1 and 1 <= bh <= hin
        if not nhwc:
            lh = resize_kernel.transposed_tables(hin, hout, align)[1].shape[1]
            lw = resize_kernel.transposed_tables(win, wout, align)[1].shape[1]
            assert 4 * resize_kernel._nchw_floats(win, wout, lh, lw, tile) <= (
                resize_kernel.SMEM_TARGET)
            assert tile * wout // 8 <= resize_kernel.LOADS_PER_BLOCK
            assert 16 * c * -(-hin // bh) >= min(resize_kernel.BLOCKS, 16 * c * hin)
            continue
        assert rmax == resize_kernel.band_rows(hin, hout, align, bh)
        runs = resize_kernel.transposed_tables(hin, hout, align)[0]
        for b in range(0, hin, bh):
            lo, n = runs[b : b + bh, 0], runs[b : b + bh, 1]
            assert (lo + n).max() - lo.min() <= rmax


def _helpers():
    """The routing entry point and the four helpers that training reaches,
    each with its F.interpolate arguments and a call on an NCHW input."""
    nhwc = lambda x: resize_bilinear(x.permute(0, 2, 3, 1), (18, 24), True).permute(0, 3, 1, 2)
    return [
        ("resize.interpolate_bilinear", (9, 13), True,
         lambda x: interpolate_bilinear(x, (9, 13), True)),
        ("bisenet._upsample", (16, 24), False, lambda x: bisenet._upsample(x, 2)),
        ("objectives._resize", (17, 23), True, lambda x: objectives._resize(x, (17, 23))),
        ("resize.resize_bilinear", (18, 24), True, nhwc),
        ("functional.resize_bilinear_nchw", (5, 7), False,
         lambda x: resize_bilinear_nchw(x, (5, 7), False)),
    ]


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_requires_grad"])
def test_routing_without_autograd_is_interpolate(mode, monkeypatch):
    """Where autograd records nothing (serving, eval, a frozen input) each
    helper is F.interpolate itself: the same tensor, no backward node, and
    BilinearResize is never applied."""
    monkeypatch.setattr(resize_kernel.BilinearResize, "apply",
                        lambda *a: pytest.fail("BilinearResize applied without autograd"))
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_requires_grad": torch.enable_grad}[mode]
    _build.LAUNCHES.clear()
    for name, size, align, call in _helpers():
        x = torch.randn(2, 3, 8, 12, requires_grad=mode != "no_requires_grad")
        with ctx():
            got = call(x)
            want = F.interpolate(x, size, mode="bilinear", align_corners=align)
        assert got.grad_fn is None, name
        assert torch.equal(got, want), name
    assert sum(_build.LAUNCHES.values()) == 0


def test_routing_under_autograd_is_bilinear_resize():
    """Under autograd each helper's forward is F.interpolate's bit for bit,
    and its backward node is BilinearResizeBackward."""
    for name, size, align, call in _helpers():
        x = torch.randn(2, 3, 8, 12, requires_grad=True)
        got = call(x)
        assert torch.equal(got, F.interpolate(x, size, mode="bilinear", align_corners=align)), name
        node = got.grad_fn
        while node.name() != "BilinearResizeBackward":  # through the NHWC helper's permutes
            node = node.next_functions[0][0]
        got.sum().backward()
        assert _rel(x.grad, _autograd(x, torch.ones_like(got), size, align)) <= 1e-5, name


def _count_backwards(monkeypatch):
    calls = []
    run = resize_kernel.resize_bilinear_backward

    def counted(g, in_hw, align):
        calls.append((tuple(g.shape), tuple(in_hw), align))
        return run(g, in_hw, align)

    monkeypatch.setattr(resize_kernel, "resize_bilinear_backward", counted)
    return calls


# The resizes one FST stage-2 step of camvid-bise18 at 720x960 takes a
# gradient through (batch first, then the output's gradient shape, the
# input's size, align_corners): the context path's 24x30 -> 23x30 and the
# spatial path's 45x60 -> 46x60 (ResNet-18 at 360x480 gives 23 and 46 rows),
# K1's lr at 46x60 -> 90x120, the main head's x8, the heads' x8 and x16 and
# the two OHEM resizes to 720x960
STEP_RESIZES = sorted([
    ((12, 720, 960), (90, 120), False), ((12, 368, 480), (46, 60), False),
    ((12, 368, 480), (23, 30), False), ((12, 720, 960), (368, 480), True),
    ((12, 720, 960), (368, 480), True), ((256, 90, 120), (46, 60), True),
    ((128, 23, 30), (24, 30), True), ((128, 46, 60), (45, 60), True),
])


def _stage2_step(device, dtype, batch):
    """camvid-bise18's FST phase-2 stage-2 step at 720x960 (the trainers'
    objective and step; channels_last on a card, as the trainers place it)
    and a batch for it."""
    from arseg_tpu_torch.train.objectives import build_phase2_loss
    from arseg_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
    from arseg_tpu_torch.train.trainer import FINAL_CONV_PATH, build_train_model

    teacher = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=0)
    student = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=1).to(device)
    if device != "cpu":
        student = student.to(memory_format=torch.channels_last)
    teacher = teacher_copy(teacher, device, dtype)
    params = trainable_parameters(student, (FINAL_CONV_PATH[("bisenet", "camvid")],))
    opt = make_optimizer("sgd", cosine_schedule(1e-3, 1000), params)
    step = make_train_step(build_phase2_loss("bisenet", "camvid", (960, 720), 0.5, stage2=True),
                           opt, compute_dtype=dtype, device=device)
    rng = np.random.RandomState(0)
    b = dict(image=rng.randn(batch, 720, 960, 3).astype(np.float32),
             ref_image=rng.randn(batch, 720, 960, 3).astype(np.float32),
             label=rng.randint(0, 12, (batch, 720, 960)).astype(np.int32),
             flow=rng.uniform(-8, 8, (batch, 720, 960, 2)).astype(np.float32))
    return student, teacher, step, {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def test_stage2_step_takes_eight_resize_backwards(monkeypatch):
    """One FST stage-2 step at 720x960 on the CPU runs the gather backward
    once for each resize that takes a gradient, at these shapes."""
    calls = _count_backwards(monkeypatch)
    student, teacher, step, batch = _stage2_step("cpu", None, 2)
    step(student, teacher, batch)
    assert sorted((s[1:], hw, a) for s, hw, a in calls) == STEP_RESIZES


# ---------------------------------------------------------------- card only


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")


# The shapes one FST stage-2 step at batch 16 gives the kernel (NCHW unless
# marked; K1's lr and the context and spatial paths' resizes arrive
# channels_last), and 360x480 and 45x60 variants of the aux head's and
# K1's inputs
CARD_CASES = [
    ((16, 12, 90, 120), (720, 960), False, False), ((16, 12, 46, 60), (368, 480), False, False),
    ((16, 12, 368, 480), (720, 960), True, False), ((16, 12, 23, 30), (368, 480), False, False),
    ((16, 12, 360, 480), (720, 960), True, False), ((16, 12, 45, 60), (360, 480), False, False),
    ((16, 256, 46, 60), (90, 120), True, True), ((16, 256, 45, 60), (90, 120), True, True),
    ((16, 128, 24, 30), (23, 30), True, True), ((16, 128, 45, 60), (46, 60), True, True),
    # the same resizes in the other layout, and edges: widths that are no
    # multiple of 16 bytes (scalar loads), channels that fill no vector
    # (NCHW in place of channels_last), a smaller size, a 1x1 input, one row
    ((2, 12, 90, 120), (720, 960), False, True), ((2, 256, 46, 60), (90, 120), True, False),
    ((2, 3, 13, 17), (104, 135), False, False), ((2, 3, 13, 17), (101, 135), True, True),
    ((2, 12, 10, 13), (4, 5), True, False), ((2, 16, 10, 13), (4, 5), False, True),
    ((1, 8, 1, 1), (3, 4), True, False), ((3, 16, 1, 37), (1, 300), False, True),
]
# Kernel against plain version, relative to max |plain|: float32 sums of
# the same products in another order (observed below 1e-6 on the card);
# bfloat16 both round float32 sums once, so they differ by at most one unit
# in the last place of an element (2^-7 of it) where the sums straddle a
# rounding point.
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,size,align,channels_last", CARD_CASES)
def test_kernel_matches_plain_on_card(shape, size, align, channels_last, dtype):
    """The kernel against its plain version (on the CPU, from the same
    values), in the layout it returns, and in float32 against
    F.interpolate's own backward on the card."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    g = torch.randn(shape[:2] + size, device="cuda", generator=gen).to(dtype)
    g = g.contiguous(memory_format=fmt)
    _build.LAUNCHES.clear()
    got = resize_kernel.resize_bilinear_backward(g, shape[2:], align)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[resize_kernel.NAME] == 1
    vec = 16 // g.element_size()
    want_fmt = fmt if shape[1] % vec == 0 else torch.contiguous_format
    assert got.dtype == dtype and got.shape == shape and got.is_contiguous(memory_format=want_fmt)
    assert bool(torch.isfinite(got.float()).all())
    want = resize_kernel.resize_bilinear_backward_plain(g.cpu(), shape[2:], align)
    err = _rel(got.cpu(), want)
    assert err <= CARD_TOL[dtype], f"{dtype}: max|d| / max|plain| {err:.3e}"
    if dtype == torch.float32:
        x = torch.zeros(shape, device="cuda").contiguous(memory_format=fmt)
        err = _rel(got, _autograd(x, g, size, align))
        assert err <= CARD_TOL[dtype], f"against F.interpolate's backward: {err:.3e}"


@pytest.mark.cuda
def test_kernel_two_launches_bit_equal():
    """No atomics: two launches on the same gradient give the same bits."""
    needs_card()
    g = torch.randn(4, 12, 368, 480, device="cuda").to(torch.bfloat16)
    a = resize_kernel.resize_bilinear_backward(g, (23, 30), False)
    b = resize_kernel.resize_bilinear_backward(g, (23, 30), False)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    needs_card()
    with pytest.raises(TypeError):
        resize_kernel.resize_bilinear_backward(torch.zeros(1, 1, 4, 4, device="cuda",
                                                           dtype=torch.float16), (2, 2), False)


@pytest.mark.cuda
def test_launches_in_training_and_serving():
    """A bf16 FST stage-2 step on the card launches the kernel once for
    each of its eight resizes that take a gradient; a serving multi-GOP
    step launches it never."""
    needs_card()
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.models import build_model

    student, teacher, step, batch = _stage2_step("cuda", torch.bfloat16, 2)
    _build.LAUNCHES.clear()
    step(student, teacher, batch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[resize_kernel.NAME] == len(STEP_RESIZES)

    hr, lr = (build_model("camvid-bise18", fuse=f, seed=s, device="cpu")
              for s, f in ((0, False), (1, True)))
    pipe = ARPipeline(hr, lr, scale=0.5, dtype=torch.bfloat16, device="cuda")
    rng = np.random.RandomState(1)
    keys = torch.as_tensor(rng.randint(0, 256, (2, 720, 960, 3), dtype=np.uint8), device="cuda")
    frames = torch.as_tensor(rng.randint(0, 256, (2, 11, 720, 960, 3), dtype=np.uint8),
                             device="cuda")
    flows = torch.as_tensor(rng.uniform(-8, 8, (2, 11, 720, 960, 2)).astype(np.float32),
                            device="cuda")
    _build.LAUNCHES.clear()
    pipe.multi_gop_step(keys, frames, flows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[resize_kernel.NAME] == 0
    assert _build.LAUNCHES["creff_qkv_fused"] == 1
