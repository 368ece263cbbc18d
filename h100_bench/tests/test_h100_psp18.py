"""The ``camvid-psp18.batch8`` cell: its arithmetic (``harness/arith_psp.py``)
against hand counts, its readers on synthetic traces and on a program
without the spans they read, a whole run at a small size with the served
path broken (``correct`` false for each fault), the control at a small
size, and its metrics on a card."""

import math
import types

import pytest
import torch
from conftest import SEED, SMALL
from test_h100_faults import batch_altered, batch_half, batch_one_slot
from test_h100_spans import Event, launch, span

import run
import control
from harness import arith, arith_psp, checks, manifest
from harness.trace import WINDOW, Trace

CELL = "camvid-psp18.batch8"
NEW = ["k3_roofline.psp", "mfu.psp", "decoder_ms.psp"]
# every per-layer metric the cell reports: the new ones and the serving
# cell's readers that it shares
LAYERS = [m["name"] for m in manifest.metrics_of(CELL, manifest.manifest(), "per_layer")]
SPANS = ["decoder_ms.psp"]  # the readers of spans this configuration adds
K3 = "void creff_mma::module_kernel<(anonymous namespace)::ArgmaxHeadMma>(...)"


def read(name, trace, cfg=None, **host):
    return manifest.reader(name)(types.SimpleNamespace(trace=trace, host=host, cfg=cfg))


def test_k3_cost_and_bound_by_hand():
    # [11, 720, 960, 64] bf16, 12 classes: lr_up and ref read, int32 maps
    # written; the bound of the kernel's source note (0.59 ms, bytes)
    px = 11 * 720 * 960
    flops, nbytes = arith_psp.k3_cost(11, 720, 960, 64, 12)
    assert flops == px * (64 * (251 + 24) + 12)
    assert nbytes == 2 * px * 64 * 2 + px * 4 + (27 * 64 + 3 * 64 + 64 * 12 + 12) * 4
    assert arith.bound_s(flops, nbytes) == pytest.approx(0.5901e-3, rel=1e-4)


def test_gop_flops_hold_the_window_and_the_decoder():
    cfg = {**manifest.config("camvid-psp18"), "frame_hw": [64, 96], "gop": 3}
    window = 2 * 64 * 96 * 64 * (arith.K1_WINDOW_FLOPS + arith.K2_FLOPS)
    # the three upsample convs of one frame at the LR scale alone
    up = 2 * (32 * 48 * 64 * 9 * 64 + 16 * 24 * 64 * 9 * 256 + 8 * 12 * 256 * 9 * 1024)
    assert arith_psp.serve_flops_per_gop(cfg) > window + 3 * up
    # 720x960: about 2.45 TFLOP a GOP
    full = arith_psp.serve_flops_per_gop(manifest.config("camvid-psp18"))
    assert 2.3e12 < full < 2.6e12


def test_readers_on_a_synthetic_step():
    """One step of 2 GOPs of 3 frames: the decoder's launches (under
    ``psp.decoder``, nested in the stages) and two K3 launches of 2 frames."""
    cfg = {**manifest.config("camvid-psp18"), "gop": 3}
    events = [span(WINDOW, 0, 100_000), span("gop.hr_key", 1_000, 9_000),
              span("psp.decoder", 2_000, 5_000), span("gop.fuse_head", 20_000, 30_000),
              *launch(1, 2_500, 1, 3_000, 4_000),       # decoder: 4 us
              *launch(2, 9_000, 1, 9_500, 1_000),       # hr_key, outside the decoder
              *launch(3, 21_000, 1, 30_000, 10_000),    # K3
              *launch(4, 22_000, 1, 41_000, 12_000)]    # K3
    events[-3]._name = events[-1]._name = K3
    t = Trace(events)
    host = dict(traced_steps=1, gops_per_step=2)
    assert read("decoder_ms.psp", t, cfg, **host) == pytest.approx(4_000e-6 / 2)
    assert read("fuse_head_ms.serve", t, cfg, **host) == pytest.approx(22_000e-6 / 2)
    bound = arith.bound_s(*arith_psp.k3_cost(2, 720, 960, 64, 12))
    assert read("k3_roofline.psp", t, cfg, **host) == pytest.approx(100 * bound / 11_000e-9)
    assert read("idle_share.serve", t, cfg, **host) == pytest.approx(100 * (1 - 27_000 / 100_000))


def test_a_program_without_the_spans_reads_nothing():
    """The program before ``psp.decoder`` (the parent of this cell) and a
    run that launched no K3: no reading, and nothing raised."""
    t = Trace([span(WINDOW, 0, 10_000), span("gop.hr_key", 1_000, 2_000),
               *launch(1, 1_100, 1, 1_500, 500)])
    host = dict(traced_steps=2, gops_per_step=2)
    cfg = manifest.config("camvid-psp18")
    for name in SPANS + ["k3_roofline.psp"]:
        assert read(name, t, cfg, **host) is None, name
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
    assert res["correct"] and "mfu.psp" in res["metrics"]
    # on the CPU no device operation runs: no device time is reported
    assert not any(k.startswith(("idle_share", "k2_", "k3_", "lr_", "fuse_", "decoder_"))
                   for k in res["metrics"])


def test_the_control_fails_at_a_small_size():
    """The reference in float8 in the program's place is not correct."""
    readings = control.readings(CELL, SEED, "cpu", overrides=SMALL, seconds=1.0)
    got = {name: not checks.judge(r, manifest.limits(CELL))[0] for name, r in readings.items()
           if name == "control_fp8"}
    assert got and all(got.values()), got


@pytest.mark.cuda
def test_a_traced_card_run_reports_every_new_metric(card):
    res, _ = run.execute(CELL, SEED, 1.0, 1, "cuda", SMALL)
    assert res["correct"]
    for name in LAYERS:
        assert name in res["metrics"], name
        assert math.isfinite(res["metrics"][name]["value"]), name
    assert 0 < res["metrics"]["k3_roofline.psp"]["value"] <= 100
