"""camvid-psp18 V1 (PSPNet-18, CReFF at the 64-channel decoder output at
full resolution) through the serving path, against the benchmark's plain
reference (``h100_bench/reference/pspnet.py``), and
``PSPNet.forward_phase2_argmax`` over chunks of frames (K3, which takes the
LR feature and resizes it x2, chunked where a full-resolution tensor would
pass ``nn/functional.CHUNK_ELEMENTS``) against the one-shot path. CPU, float32,
seeded; the ``cuda`` case counts the launches of K3's LR form on a card."""

import sys
from pathlib import Path

import pytest
import torch

from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.nn import functional, pspnet
from arseg_tpu_torch.ops import _build, creff_head_kernel

from torch_parity import few_threads  # noqa: F401 (a fixture)

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import checks, manifest, models, seeded  # noqa: E402
from reference.serve import gop_logits  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_threads")

HW, GOP, GOPS, SEED = (64, 96), 4, 2, 2 ** 31 + 7
CFG = {**manifest.config("camvid-psp18"), "frame_hw": list(HW), "gop": GOP}
# float32 on both sides, the same operations in another order (the port's
# PSP pools are averaging-matrix products, its window K1's plain version):
# they differ by float32 rounding, ~1e-6 of a logit's spread. A served class
# may differ from the reference's best only at such a near tie, so the
# widest gap below the best is held to 1e-4 of the frame's logit standard
# deviation, and the fused features to 1e-4 of their largest magnitude.
GAP_TOL = 1e-4
FUSED_TOL = 1e-4


def _weights(device="cpu"):
    return (models.weights(CFG, SEED, "hr", False, device),
            models.weights(CFG, SEED, "ar", True, device))


def _inputs(device="cpu"):
    frames = seeded.frames(SEED, "frames", GOPS * GOP, HW, device).view(GOPS, GOP, *HW, 3)
    flows = seeded.block_flows(SEED, "flows", GOPS * (GOP - 1), HW, device)
    return frames, flows.view(GOPS, GOP - 1, *HW, 2)


def test_multi_gop_step_matches_the_plain_reference():
    sd_hr, sd_ar = _weights()
    hr = models.loaded(models.port_model(CFG, False, "cpu"), sd_hr)
    ar = models.loaded(models.port_model(CFG, True, "cpu"), sd_ar)
    norm = (CFG["normalize"]["mean"], CFG["normalize"]["std"])
    pipe = ARPipeline(hr, ar, scale=CFG["lr_scale"], dtype=torch.float32, normalize=norm,
                      device="cpu")
    frames, flows = _inputs()
    maps, fused = pipe.multi_gop_step(frames[:, 0], frames[:, 1:], flows, return_fused=True)
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

    # the fused features of the LR frames, against the reference's phase 2
    mean, std = CFG["normalize"]["mean"], CFG["normalize"]["std"]
    from reference.model import flow_to_grid, warp
    from reference.serve import normalized

    with torch.no_grad():
        key = rhr.key(normalized(frames[:, 0], mean, std))[1]
        lr = torch.nn.functional.interpolate(
            normalized(frames[:, 1:].reshape(-1, *HW, 3), mean, std),
            size=tuple(int(v * CFG["lr_scale"]) for v in HW), mode="bilinear",
            align_corners=True)
        mid = rar.phase1(lr)[-1]
        fx, fy = flow_to_grid(flows[..., 0].reshape(-1, *HW), flows[..., 1].reshape(-1, *HW),
                              HW, "bilinear")
        ref = warp(key.repeat_interleave(GOP - 1, 0), fx, fy)
        want = rar.phase2(mid, ref)[1].permute(0, 2, 3, 1)
    assert fused.shape == want.shape
    assert (fused - want).abs().max() <= FUSED_TOL * want.abs().max()


def _v1(seed=0):
    model = pspnet.PSPNet(n_classes=12, psp_size=512, deep_features_size=256, fuse_version=1,
                          generator=torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    mid = torch.randn(5, 64, 8, 12, generator=g)
    ref = torch.randn(5, 64, 16, 24, generator=g)
    return model, mid, ref


@pytest.mark.parametrize("per_chunk,ranges", [
    (5, [(0, 5)]), (2, [(0, 2), (2, 4), (4, 5)]), (3, [(0, 3), (3, 5)]),
    (1, [(i, i + 1) for i in range(5)])])
def test_chunked_phase2_argmax_is_bit_equal_to_one_shot(monkeypatch, per_chunk, ranges):
    """``CHUNK_ELEMENTS`` made room for ``per_chunk`` frames of [16, 24, 64]:
    the maps and the fused features bit-equal to one call over all five,
    the resize and K3 run once a chunk, over ``ranges``."""
    model, mid, ref = _v1()
    with torch.no_grad():
        maps, fused = model.forward_phase2_argmax(mid, ref, return_fused=True)
    seen = []
    orig = creff_head_kernel.creff_phase2_argmax

    def counted(lr_up, *a):
        seen.append(lr_up.shape[0])
        return orig(lr_up, *a)

    monkeypatch.setattr(functional, "CHUNK_ELEMENTS", per_chunk * 16 * 24 * 64 + 63)
    monkeypatch.setattr(creff_head_kernel, "creff_phase2_argmax", counted)
    assert functional.frame_chunks(5, 16 * 24 * 64) == ranges
    with torch.no_grad():
        got_maps, got_fused = model.forward_phase2_argmax(mid, ref, return_fused=True)
        got_alone = model.forward_phase2_argmax(mid, ref)
    assert seen == [hi - lo for lo, hi in ranges] * 2
    assert torch.equal(got_maps, maps) and torch.equal(got_alone, maps)
    assert torch.equal(got_fused, fused)


def test_the_bound_keeps_eight_gops_of_720x960_in_two_chunks():
    """88 frames of [720, 960, 64]: two chunks of 44, each under INT_MAX
    elements; the frames of 4 GOPs (44) stay one chunk."""
    frame = 720 * 960 * 64
    assert functional.frame_chunks(88, frame) == [(0, 44), (44, 88)]
    assert functional.frame_chunks(44, frame) == [(0, 44)]
    assert all((hi - lo) * frame < 2 ** 31 - 1 for lo, hi in functional.frame_chunks(88, frame))


@pytest.mark.cuda
def test_k3_launches_once_a_chunk_on_a_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model, mid, ref = _v1()
    model = model.cuda().to(torch.bfloat16).to(memory_format=torch.channels_last)
    mid = mid.cuda().to(torch.bfloat16).to(memory_format=torch.channels_last)
    ref = ref.cuda().to(torch.bfloat16).to(memory_format=torch.channels_last)
    with torch.no_grad():
        maps = model.forward_phase2_argmax(mid, ref)
        monkeypatch.setattr(functional, "CHUNK_ELEMENTS", 2 * 16 * 24 * 64)
        _build.LAUNCHES.clear()
        got = model.forward_phase2_argmax(mid, ref)
    # bfloat16 LR features: K3's LR form, once a chunk; full-size K3 never
    assert _build.LAUNCHES[creff_head_kernel.NAME_LR] == 3
    assert _build.LAUNCHES[creff_head_kernel.NAME] == 0
    assert torch.equal(got, maps)
