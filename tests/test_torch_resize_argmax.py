"""The resize-and-argmax head (``ops/resize_argmax_kernel.py``): its plain
version against ``F.interpolate`` and ``argmax`` on the CPU, the routing of
the two heads that call it (the pipeline's fallback head and BiSeNet's
planes head), and on a card the kernel's maps against ``F.interpolate`` and
``argmax`` there, bit for bit. This file imports no JAX, so its card tests
also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_resize_argmax.py -m cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from arseg_tpu_torch.gop import ARPipeline, pipeline
from arseg_tpu_torch.models.registry import build_model
from arseg_tpu_torch.nn import bisenet, functional
from arseg_tpu_torch.ops import _build, resize_argmax_kernel

from torch_parity import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

# (logits [N, C, h, w], output size): x8 (the heads'), a ratio that is not
# whole, a resize to a smaller size, a single row and column, one class
CPU_CASES = [((2, 19, 4, 6), (32, 48)), ((3, 5, 7, 9), (30, 41)), ((1, 4, 12, 10), (5, 7)),
             ((2, 3, 1, 1), (3, 4)), ((1, 1, 3, 5), (9, 15))]


def _pair(x, size, align):
    """What the head was before the kernel: the resize, then the argmax."""
    up = F.interpolate(x, size=size, mode="bilinear", align_corners=align)
    return up.argmax(dim=1).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape,size", CPU_CASES)
def test_plain_is_interpolate_and_argmax(shape, size, align, dtype):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape))).to(dtype)
    got = resize_argmax_kernel.resized_argmax_plain(x, size, align)
    assert got.dtype == torch.int32 and got.shape == (shape[0], *size)
    assert torch.equal(got, _pair(x, size, align))


def test_plain_chunks_frames_and_opens_a_span_a_chunk(monkeypatch):
    """With room for 2 frames a chunk, 5 frames take 3 chunks and 3 spans,
    and the maps are one resize's."""
    x = torch.randn(5, 3, 4, 5, generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(functional, "CHUNK_ELEMENTS", 2 * 3 * 32 * 40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = resize_argmax_kernel.resized_argmax_plain(x, (32, 40), True)
    assert [e.name for e in prof.events()].count("gop.head_chunk") == 3
    assert torch.equal(got, _pair(x, (32, 40), True))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refused(*a):
        raise AssertionError("the kernel launched for a CPU tensor")

    monkeypatch.setattr(_build, "launch", refused)
    x = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(2))
    got = resize_argmax_kernel.resized_argmax(x, (24, 40), False)
    assert torch.equal(got, _pair(x, (24, 40), False))


def _recorded(monkeypatch, target):
    calls = []
    orig = resize_argmax_kernel.resized_argmax

    def record(logits, out_hw, align_corners):
        calls.append((tuple(logits.shape), tuple(out_hw), align_corners))
        return orig(logits, out_hw, align_corners)

    monkeypatch.setattr(target, "resized_argmax", record)
    return calls


def test_the_fallback_head_routes_through_the_wrapper(monkeypatch):
    calls = _recorded(monkeypatch, pipeline)
    x = torch.randn(3, 19, 4, 8, generator=torch.Generator().manual_seed(3))
    got = ARPipeline._resized_argmax(x, (32, 64))
    assert calls == [((3, 19, 4, 8), (32, 64), True)]
    assert torch.equal(got, _pair(x, (32, 64), True))


def _bise_head():
    model = build_model("camvid-bise18", fuse=True, device="cpu")
    gen = torch.Generator().manual_seed(4)
    mid = torch.randn(2, 256, 6, 8, generator=gen)
    ref = torch.randn(2, 256, 6, 8, generator=gen)
    return model, mid, ref


def test_bisenet_planes_head_routes_through_the_wrapper(monkeypatch):
    """The planes head: x8, align_corners=False, the maps those of the
    resize and argmax of the 1x1 conv's logits; return_fused unchanged."""
    model, mid, ref = _bise_head()
    calls = _recorded(monkeypatch, resize_argmax_kernel)
    with torch.no_grad():
        pred, fused = model.forward_phase2_argmax(mid, ref, return_fused=True)
        logits, fused_want = model.forward_phase2(mid, ref)
    assert calls == [((2, 12, 6, 8), (48, 64), False)]
    assert torch.equal(pred, logits.argmax(dim=1).to(torch.int32))
    assert torch.equal(fused, fused_want)


def test_the_fused_upsample_head_does_not_take_the_wrapper(monkeypatch):
    """Under USE_FUSED_UPSAMPLE_HEAD K5 takes the whole head."""
    model, mid, ref = _bise_head()
    calls = _recorded(monkeypatch, resize_argmax_kernel)
    monkeypatch.setattr(bisenet, "USE_FUSED_UPSAMPLE_HEAD", True)
    with torch.no_grad():
        model.forward_phase2_argmax(mid, ref)
    assert calls == []


META = "meta"


@pytest.mark.parametrize("shape", [(2, 19, 4, 5), (2, 19, 1, 1), (1, 19, 4, 5), (2, 1, 4, 5),
                                   (2, 19, 1, 5), (2, 19, 4, 1)])
def test_layout_is_read_as_pytorch_suggests_it(shape):
    """The layout the wrapper tells the kernel to match: PyTorch's own
    suggestion for NCHW and channels_last tensors, ambiguous ones included."""
    from torch._prims_common import suggest_memory_format

    for t in (torch.empty(shape), torch.empty(shape).contiguous(memory_format=torch.channels_last),
              torch.empty(shape[0], shape[2], shape[3], shape[1]).permute(0, 3, 1, 2)):
        want = suggest_memory_format(t) == torch.channels_last
        assert resize_argmax_kernel._reads_as_channels_last(t) is want, t.stride()


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="resize_bilinear_argmax takes NCHW logits"):
        resize_argmax_kernel.resized_argmax(torch.empty(2, 3, 4, device=META), (8, 8), True)
    with pytest.raises(TypeError, match="resize_bilinear_argmax takes float32 or bfloat16"):
        resize_argmax_kernel.resized_argmax(torch.empty(1, 2, 3, 4, dtype=torch.float16,
                                                        device=META), (8, 8), True)


# ---- on a card


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against F.interpolate and argmax there)")


def _on_card(x, size, align):
    _build.LAUNCHES.clear()
    got = resize_argmax_kernel.resized_argmax(x, size, align)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[resize_argmax_kernel.NAME] == 1
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], *size)
    return got


def _logits(shape, dtype, channels_last, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x.contiguous(memory_format=torch.channels_last if channels_last else
                        torch.contiguous_format)


# (logits, size, align_corners): camvid's BiSeNet head (12 classes 90x120 ->
# 720x960), ragged sizes and ratios that are not whole, a resize to a
# smaller size, a single row and column, one class, and 150 classes (whose
# source window does not fit a block's shared memory: the lanes read the
# logits from device memory)
CARD_CASES = [((11, 12, 90, 120), (720, 960), False), ((11, 12, 90, 120), (720, 960), True),
              ((3, 19, 37, 53), (301, 411), False), ((3, 19, 37, 53), (301, 411), True),
              ((2, 7, 300, 401), (37, 53), False), ((2, 7, 300, 401), (37, 53), True),
              ((2, 19, 1, 1), (5, 9), True), ((2, 19, 1, 1), (5, 9), False),
              ((1, 1, 5, 6), (40, 48), False), ((2, 150, 16, 24), (128, 192), False),
              ((2, 150, 16, 24), (131, 190), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,size,align", CARD_CASES)
def test_kernel_is_interpolate_and_argmax_on_card(shape, size, align, dtype, channels_last):
    needs_card()
    x = _logits(shape, dtype, channels_last, sum(shape) + len(size))
    assert torch.equal(_on_card(x, size, align), _pair(x, size, align))


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("dtype,eps", [(torch.float32, 1e-6), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("classes", [2, 3, 4, 12, 16, 19])
def test_kernel_rounds_as_interpolate_at_near_ties_on_card(classes, dtype, eps, align,
                                                           channels_last):
    """Classes a few units in the last place of the logits' type apart, so
    that the argmax of most pixels turns on the last bit of the resized
    values: the kernel must round each lerp as F.interpolate does for that
    layout and class count."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(classes)
    base = torch.randn(2, 1, 37, 53, device="cuda", generator=gen)
    x = (base * (1 + eps * torch.randn(2, classes, 37, 53, device="cuda", generator=gen)))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last if channels_last else
                               torch.contiguous_format)
    assert torch.equal(_on_card(x, (301, 411), align), _pair(x, (301, 411), align))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames,align", [(44, False), (88, True)])
def test_kernel_at_the_cells_shapes_on_card(frames, align, dtype):
    """cityscapes-bise18's 44 LR frames (align_corners=False) and
    cityscapes-psp18's 88 (True, 3.5e9 resized values: one launch) of 19
    classes at 128x256 -> 1024x2048, against the resize and argmax over
    frame_chunks (F.interpolate refuses the 88 frames at once)."""
    needs_card()
    x = _logits((frames, 19, 128, 256), dtype, True, frames)
    got = _on_card(x, (1024, 2048), align)
    assert torch.equal(got, resize_argmax_kernel.resized_argmax_plain(x, (1024, 2048), align))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_the_lowest_class_of_a_tie_and_the_first_nan_on_card(dtype):
    """Classes 2 and 5 equal and above the rest everywhere: class 2; all
    classes equal: class 0; a NaN at class 3 of one source pixel: class 3
    where the resize reads it, as torch.argmax gives."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 7, 9, 11, device="cuda", generator=gen).to(dtype)
    x[:, 5] = x[:, 2] = x.amax(dim=1) + 1
    x[1] = 0.25
    x[0, 3, 4, 5] = float("nan")
    x = x.contiguous(memory_format=torch.channels_last)
    for align in (True, False):
        got = _on_card(x, (72, 88), align)
        want = _pair(x, (72, 88), align)
        assert torch.equal(got, want)
        assert set(got[0].unique().tolist()) <= {2, 3} and (got[0] == 3).any()
        assert (got[1] == 0).all()


@pytest.mark.cuda
def test_kernel_two_launches_bit_equal_on_card():
    needs_card()
    x = _logits((4, 19, 64, 128), torch.bfloat16, True, 6)
    assert torch.equal(_on_card(x, (512, 1024), True), _on_card(x, (512, 1024), True))


@pytest.mark.cuda
def test_bisenet_serves_eight_gops_of_1024x2048_on_card(monkeypatch):
    """cityscapes-bise18, 8 GOPs of 1024x2048 in one multi_gop_step (the
    planes head over 88 frames: 3.5e9 resized values, which F.interpolate
    refuses at once): one launch, the maps equal to the resize and argmax
    over frame_chunks."""
    needs_card()
    hr = build_model("cityscapes-bise18", fuse=False, device="cuda")
    lr = build_model("cityscapes-bise18", fuse=True, device="cuda")
    pipe = ARPipeline(hr, lr, scale=0.5, dtype=torch.bfloat16, device="cuda")
    rng = np.random.RandomState(7)
    keys = torch.as_tensor(rng.randint(0, 256, (8, 1024, 2048, 3), dtype=np.uint8), device="cuda")
    frames = keys[:, None].expand(8, 11, 1024, 2048, 3).contiguous()
    flows = torch.as_tensor(rng.uniform(-8, 8, (8, 11, 1024, 2048, 2)).astype(np.float32),
                            device="cuda")
    _build.LAUNCHES.clear()
    got = pipe.multi_gop_step(keys, frames, flows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[resize_argmax_kernel.NAME] == 1
    assert got.shape == (8, 12, 1024, 2048)
    monkeypatch.setattr(resize_argmax_kernel, "resized_argmax",
                        resize_argmax_kernel.resized_argmax_plain)
    assert torch.equal(got, pipe.multi_gop_step(keys, frames, flows))
