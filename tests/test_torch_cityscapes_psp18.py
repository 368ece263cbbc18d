"""cityscapes-psp18 (the semseg PSPNet-18, CReFF K1 at the 512-channel
``cls[:-1]`` feature, a 19-class x8 head) through the serving path against
the benchmark's plain reference (``h100_bench/reference/pspnet_semseg.py``);
the seeded state dict in both models; the pipeline's fallback head
(``forward_phase2`` -> x8 resize -> argmax) over ``nn/functional.frame_chunks``
against the one-shot head; and the spans this configuration opens. CPU,
float32, seeded, 64x128 frames, GOP 4, 2 GOPs."""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from arseg_tpu_torch.gop import ARPipeline, pipeline
from arseg_tpu_torch.nn import functional

from torch_parity import few_threads  # noqa: F401 (a fixture)

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import checks, manifest, models, seeded  # noqa: E402
from reference.model import flow_to_grid, warp  # noqa: E402
from reference.serve import gop_logits, normalized  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_threads")

HW, GOP, GOPS, SEED = (64, 128), 4, 2, 2 ** 31 + 23
CFG = {**manifest.config("cityscapes-psp18"), "frame_hw": list(HW), "gop": GOP}
N_LR = GOPS * (GOP - 1)
# float32 on both sides, the same operations in another order (the port's
# PPM pools are averaging-matrix products, its window K1's plain version,
# its resizes ``ops/resize``'s): they differ by float32 rounding, ~1e-6 of
# a logit's spread. A served class may differ from the reference's best
# only at such a near tie, so the widest gap below the best is held to 1e-4
# of the frame's logit standard deviation, and the fused features to 1e-4
# of their largest magnitude.
GAP_TOL = 1e-4
FUSED_TOL = 1e-4


def _weights():
    return (models.weights(CFG, SEED, "hr", False, "cpu"),
            models.weights(CFG, SEED, "ar", True, "cpu"))


def _pipeline(sd_hr, sd_ar):
    hr = models.loaded(models.port_model(CFG, False, "cpu"), sd_hr)
    ar = models.loaded(models.port_model(CFG, True, "cpu"), sd_ar)
    norm = (CFG["normalize"]["mean"], CFG["normalize"]["std"])
    return ARPipeline(hr, ar, scale=CFG["lr_scale"], dtype=torch.float32, normalize=norm,
                      device="cpu")


def _inputs():
    frames = seeded.frames(SEED, "frames", GOPS * GOP, HW, "cpu").view(GOPS, GOP, *HW, 3)
    flows = seeded.block_flows(SEED, "flows", N_LR, HW, "cpu")
    return frames, flows.view(GOPS, GOP - 1, *HW, 2)


@pytest.fixture(scope="module")
def served(few_threads):  # noqa: F811 (the fixture)
    """The seeded weights, the inputs, and the pipeline's maps and fused
    features over them."""
    sd_hr, sd_ar = _weights()
    frames, flows = _inputs()
    pipe = _pipeline(sd_hr, sd_ar)
    maps, fused = pipe.multi_gop_step(frames[:, 0], frames[:, 1:], flows, return_fused=True)
    return sd_hr, sd_ar, frames, flows, pipe, maps, fused


def test_multi_gop_step_matches_the_plain_reference(served):
    sd_hr, sd_ar, frames, flows, _, maps, fused = served
    assert maps.shape == (GOPS, GOP, *HW)
    rhr = models.loaded(models.reference_model(CFG, False, "cpu"), sd_hr).eval()
    rar = models.loaded(models.reference_model(CFG, True, "cpu"), sd_ar).eval()
    stats = checks.GapStats()
    for g in range(GOPS):
        fr = {p: frames[g, p][None] for p in range(1, GOP)}
        fl = {p: (flows[g, p - 1][None, ..., 0], flows[g, p - 1][None, ..., 1])
              for p in range(1, GOP)}
        for p, logits in gop_logits(rhr, rar, frames[g, 0][None], fr, fl, range(GOP), CFG):
            stats.add(logits, maps[g, p])
    got = stats.readings()
    assert got["frames_checked"] == GOPS * GOP
    assert got["gap_max"] <= GAP_TOL, got
    assert got["gap_q9999"] <= GAP_TOL, got

    # the fused features of the LR frames, against the reference's phase 2
    mean, std = CFG["normalize"]["mean"], CFG["normalize"]["std"]
    lr_hw = tuple(int(v * CFG["lr_scale"]) for v in HW)
    with torch.no_grad():
        key = rhr.key(normalized(frames[:, 0], mean, std))[1]
        lr = F.interpolate(normalized(frames[:, 1:].reshape(-1, *HW, 3), mean, std),
                           size=lr_hw, mode="bilinear", align_corners=True)
        mid = rar.phase1(lr)[-1]
        fx, fy = flow_to_grid(flows[..., 0].reshape(-1, *HW), flows[..., 1].reshape(-1, *HW),
                              key.shape[-2:], "bilinear")
        ref = warp(key.repeat_interleave(GOP - 1, 0), fx, fy)
        want = rar.phase2(mid, ref)[1].permute(0, 2, 3, 1)
    assert fused.shape == want.shape == (N_LR, HW[0] // 8, HW[1] // 8, 512)
    assert (fused - want).abs().max() <= FUSED_TOL * want.abs().max()


def test_the_seeded_state_dict_loads_strictly_and_both_heads_hold_final_conv():
    """The HR state dict is drawn with ``with_fuse=False`` and still holds
    the fusion, which the registry builds in both models; ``cls.4.*`` and
    ``final_conv.*`` are two draws of one module, which holds
    ``final_conv.*``'s after a strict load, in the port and the reference."""
    sd_hr, sd_ar = _weights()
    for sd, fuse in ((sd_hr, False), (sd_ar, True)):
        assert "fuse_attention.lr_query_conv.weight" in sd
        assert not torch.equal(sd["cls.4.weight"], sd["final_conv.weight"])
        port = models.loaded(models.port_model(CFG, fuse, "cpu"), sd)
        ref = models.loaded(models.reference_model(CFG, fuse, "cpu"), sd)
        for model in (port, ref):
            assert model.cls[4] is model.final_conv
            assert torch.equal(model.cls[4].weight, sd["final_conv.weight"])
            assert torch.equal(model.cls[4].bias, sd["final_conv.bias"])
        assert port.state_dict().keys() == ref.state_dict().keys()
        for k, v in port.state_dict().items():
            assert torch.equal(v, ref.state_dict()[k]), k


def _one_shot(logits, hw):
    """The head before chunking: one resize of all frames, then argmax."""
    up = F.interpolate(logits, size=hw, mode="bilinear", align_corners=True)
    return up.argmax(dim=1).to(torch.int32)


@pytest.mark.parametrize("per_chunk,chunks", [(N_LR, 1), (2, 3), (4, 2)])
def test_the_chunked_fallback_head_is_bit_equal_to_one_shot(monkeypatch, served, per_chunk,
                                                            chunks):
    """``CHUNK_ELEMENTS`` made room for ``per_chunk`` frames of 19 x 64 x
    128 logits: the maps bit-equal to one resize and argmax over all six LR
    frames, and to the unpatched step; the resize runs once a chunk."""
    *_, frames, flows, pipe, maps, _ = served
    frame = CFG["n_classes"] * HW[0] * HW[1]
    logits = torch.randn(N_LR, CFG["n_classes"], HW[0] // 8, HW[1] // 8,
                         generator=torch.Generator().manual_seed(SEED))
    want = _one_shot(logits, HW)
    monkeypatch.setattr(functional, "CHUNK_ELEMENTS", per_chunk * frame + 18)
    assert len(functional.frame_chunks(N_LR, frame)) == chunks
    seen = []
    orig = F.interpolate

    def counted(x, *a, **k):
        seen.append(x.shape[0])
        return orig(x, *a, **k)

    monkeypatch.setattr(pipeline.F, "interpolate", counted)
    got = pipe._resized_argmax(logits, HW)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert seen == [hi - lo for lo, hi in functional.frame_chunks(N_LR, frame)]
    assert torch.equal(pipe.multi_gop_step(frames[:, 0], frames[:, 1:], flows), maps)


def test_eight_gops_of_19_classes_at_1024x2048_take_two_chunks():
    """[88, 19, 1024, 2048] logits (3.49e9 elements) pass INT_MAX: two
    chunks of 44 frames, each under it; 4 GOPs (44 frames) stay one."""
    frame = 19 * 1024 * 2048
    assert functional.frame_chunks(88, frame) == [(0, 44), (44, 88)]
    assert functional.frame_chunks(44, frame) == [(0, 44)]
    assert all((hi - lo) * frame < 2 ** 31 - 1 for lo, hi in functional.frame_chunks(88, frame))


def test_the_step_opens_its_spans(monkeypatch, served):
    """One step: ``semseg.ppm_cls`` once for the keyframes and once for the
    LR frames; ``gop.head_chunk`` once a chunk (3 with room for 2 frames)."""
    *_, frames, flows, pipe, _, _ = served
    monkeypatch.setattr(functional, "CHUNK_ELEMENTS", 2 * CFG["n_classes"] * HW[0] * HW[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.multi_gop_step(frames[:, 0], frames[:, 1:], flows)
    names = [e.name for e in prof.events()]
    assert names.count("semseg.ppm_cls") == 2
    assert names.count("gop.head_chunk") == 3
    assert names.count("gop.fuse_head") == 1
