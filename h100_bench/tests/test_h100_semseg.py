"""The ``cityscapes-psp18.batch8`` cell: its arithmetic
(``harness/arith_semseg.py``) against a hand count, its readers on a
synthetic trace and on a program without the span they read, a whole run at
a small size with the served path broken (``correct`` false for each fault
of ``test_h100_faults.py``), the control at a small size, and its metrics
on a card."""

import math
import types

import pytest
from conftest import SEED, SMALL
from test_h100_faults import batch_altered, batch_half, batch_one_slot
from test_h100_spans import launch, span

import control
import run
from harness import arith, arith_semseg, checks, manifest
from harness.trace import WINDOW, Trace

CELL = "cityscapes-psp18.batch8"
NEW = ["ppm_cls_ms.semseg", "mfu.semseg"]
# every per-layer metric the cell reports: the new ones and the serving
# cell's readers that it shares
LAYERS = [m["name"] for m in manifest.metrics_of(CELL, manifest.manifest(), "per_layer")]
K1 = "void creff_mma::module_kernel<(anonymous namespace)::StoreFused>(...)"


def read(name, trace, cfg=None, **host):
    return manifest.reader(name)(types.SimpleNamespace(trace=trace, host=host, cfg=cfg))


def conv(n, cout, cin, k, h, w):
    """FLOPs of a conv: a multiply and an add per weight per output pixel."""
    return 2 * n * cout * cin * k * k * h * w


def trunk(n, h, w):
    """layer0 and the dilated layers 1-4 at input h x w (stride 8)."""
    total = conv(n, 64, 3, 7, h // 2, w // 2)
    total += 4 * conv(n, 64, 64, 3, h // 4, w // 4)
    for cin, c in ((64, 128), (128, 256), (256, 512)):
        total += conv(n, c, cin, 3, h // 8, w // 8) + 3 * conv(n, c, c, 3, h // 8, w // 8)
        total += conv(n, c, cin, 1, h // 8, w // 8)  # the first block's projection
    return total


def ppm_cls(n, h, w):
    """The PPM's four 1x1 convs 512 -> 128 at b x b and ``cls``'s 3x3 conv
    1024 -> 512 at the 1/8 grid h x w."""
    ppm = sum(conv(n, 128, 512, 1, b, b) for b in (1, 2, 3, 6))
    return ppm + conv(n, 512, 1024, 3, h, w)


@pytest.mark.parametrize("hw", [(64, 128), (1024, 2048)])
def test_gop_flops_by_hand(hw):
    """The keyframe's trunk, PPM, ``cls`` and 1x1 head; G-1 LR frames'
    trunk, PPM and ``cls[:4]``; at the 1/8 grid three depthwise 3x3 convs,
    the 1x1 head, the window and the warp."""
    cfg = {**manifest.config("cityscapes-psp18"), "frame_hw": list(hw)}
    h, w = hw
    n, k = cfg["gop"] - 1, cfg["n_classes"]
    fh, fw = h // 8, w // 8
    key = trunk(1, h, w) + ppm_cls(1, fh, fw) + conv(1, k, 512, 1, fh, fw)
    lr = trunk(n, h // 2, w // 2) + ppm_cls(n, fh // 2, fw // 2)
    fusion = 3 * conv(n, 512, 1, 3, fh, fw) + conv(n, k, 512, 1, fh, fw)
    window = n * fh * fw * 512 * (arith.K1_WINDOW_FLOPS + arith.K2_FLOPS)
    assert arith_semseg.serve_flops_per_gop(cfg) == key + lr + fusion + window
    if hw == (1024, 2048):
        # the cls conv alone: 309 GFLOP of a keyframe's ~1080
        assert conv(1, 512, 1024, 3, fh, fw) == pytest.approx(309.2e9, rel=1e-3)
        assert 4.0e12 < arith_semseg.serve_flops_per_gop(cfg) < 4.2e12


def test_readers_on_a_synthetic_step():
    """One step of 2 GOPs of 12 frames: the PPM and cls launches under
    ``semseg.ppm_cls`` (nested in the stages), one K1 launch, the head's
    resize in two ``gop.head_chunk``s."""
    cfg = manifest.config("cityscapes-psp18")
    k1 = launch(4, 21_000, 1, 30_000, 10_000)
    k1[1]._name = K1
    events = [span(WINDOW, 0, 100_000), span("gop.hr_key", 1_000, 9_000),
              span("semseg.ppm_cls", 2_000, 5_000), span("gop.lr_phase1", 10_000, 9_000),
              span("semseg.ppm_cls", 12_000, 5_000), span("gop.fuse_head", 20_000, 30_000),
              span("gop.head_chunk", 22_000, 2_000), span("gop.head_chunk", 25_000, 2_000),
              *launch(1, 2_500, 1, 3_000, 4_000),       # keyframe cls: 4 us
              *launch(2, 9_000, 1, 9_500, 1_000),       # hr_key, outside ppm_cls
              *launch(3, 12_500, 1, 13_000, 6_000),     # LR cls: 6 us
              *k1,
              *launch(5, 22_500, 1, 41_000, 12_000),    # the resize of chunk 1
              *launch(6, 25_500, 1, 53_000, 12_000)]    # the resize of chunk 2
    t = Trace(events)
    host = dict(traced_steps=1, gops_per_step=2)
    assert read("ppm_cls_ms.semseg", t, cfg, **host) == pytest.approx(10_000e-6 / 2)
    assert read("fuse_head_ms.serve", t, cfg, **host) == pytest.approx(34_000e-6 / 2)
    assert read("lr_phase1_ms.serve", t, cfg, **host) == pytest.approx(6_000e-6 / 2)
    bound = arith.bound_s(*arith.k1_cost(22, 128, 256, 512))
    assert read("k1_roofline.serve", t, cfg, **host) == pytest.approx(100 * bound / 10_000e-9)
    mfu = 100 * 2 * arith_semseg.serve_flops_per_gop(cfg) / 100e-6 / arith.PEAK["bfloat16_flops"]
    assert read("mfu.semseg", t, cfg, **host) == pytest.approx(mfu)
    assert read("idle_share.serve", t, cfg, **host) == pytest.approx(100 * (1 - 45_000 / 100_000))


def test_a_program_without_the_span_reads_nothing():
    """The program before ``semseg.ppm_cls`` (the parent of this cell): no
    reading, and nothing raised; no trace: no reading of either new metric."""
    t = Trace([span(WINDOW, 0, 10_000), span("gop.hr_key", 1_000, 2_000),
               *launch(1, 1_100, 1, 1_500, 500)])
    host = dict(traced_steps=2, gops_per_step=2)
    cfg = manifest.config("cityscapes-psp18")
    assert read("ppm_cls_ms.semseg", t, cfg, **host) is None
    for name in NEW:
        assert read(name, None, cfg, **host) is None, name


CASES = [None, batch_altered, batch_one_slot, batch_half]


@pytest.mark.parametrize("fault", CASES, ids=[f.__name__ if f else "sound" for f in CASES])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    res, info = run.execute(CELL, SEED, 1.0, 0, "cpu", SMALL)
    assert res["correct"] is (fault is None), info["readings"]


def test_a_traced_cpu_run_reports_its_flops_and_no_device_time():
    res, _ = run.execute(CELL, SEED, 1.0, 1, "cpu", SMALL)
    assert res["correct"] and "mfu.semseg" in res["metrics"]
    # on the CPU no device operation runs: no device time is reported
    assert not any(k.startswith(("idle_share", "k1_", "k2_", "lr_", "fuse_", "ppm_cls"))
                   for k in res["metrics"])


def test_the_control_fails_at_a_small_size():
    """The reference in float8 in the program's place is not correct."""
    readings = control.readings(CELL, SEED, "cpu", overrides=SMALL, seconds=1.0)
    assert not checks.judge(readings["control_fp8"], manifest.limits(CELL))[0], readings


@pytest.mark.cuda
def test_a_traced_card_run_reports_every_metric(card):
    res, _ = run.execute(CELL, SEED, 1.0, 1, "cuda", SMALL)
    assert res["correct"]
    for name in LAYERS:
        assert name in res["metrics"], name
        assert math.isfinite(res["metrics"][name]["value"]), name
    for name in ("k1_roofline.serve", "k2_roofline.serve", "mfu.semseg"):
        assert 0 < res["metrics"][name]["value"] <= 100, name
