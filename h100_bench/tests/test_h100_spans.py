"""The readers of the program's own spans (``harness/spans.py`` and the
``feeder_*``, ``loader_stage_ms`` and ``train.*`` readers): on a synthetic
trace, in a traced CPU run of each cell, and on a card."""

import math
import time
import types

import pytest
import torch
from conftest import SEED, SMALL, TRAIN_SMALL

import run
from harness import manifest
from harness.trace import WINDOW, Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
FEEDER = ["feeder_wait_ms.serve", "feeder_starved_share.serve", "loader_stage_ms.serve",
          "feeder_idle_ms.serve"]
TRAIN = ["teacher_ms.train", "student_ms.train", "loss_ms.train", "backward_ms.train",
         "update_ms.train"]


class Event:
    """The part of a profiler event that ``Trace`` reads."""

    def __init__(self, name, start, dur, tid=1, corr=0, device=CPU, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._tid, self._corr, self._device, self._ann = tid, corr, device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._ann


def span(name, start, dur, tid=1):
    return Event(name, start, dur, tid=tid, annotation=True)


def launch(corr, at, tid, start, dur):
    """A launch on host thread ``tid`` at ``at`` and its device operation."""
    return [Event("cudaLaunchKernel", at, 1, tid=tid, corr=corr),
            Event(f"kernel{corr}", start, dur, corr=corr, device=CUDA)]


def read(name, trace, **host):
    return manifest.reader(name)(types.SimpleNamespace(trace=trace, host=host))


def test_backward_counts_a_launch_from_another_thread():
    """The backward's operations are launched from autograd's thread (2)
    while the loop's thread (1) holds ``train.backward`` open: they count
    by time; a launch after the span closed does not."""
    events = [span(WINDOW, 0, 10_000), span("train.backward", 1_000, 4_000),
              *launch(7, 2_000, 2, 2_500, 1_000),
              *launch(8, 3_000, 2, 3_600, 300),
              *launch(9, 6_000, 2, 6_100, 500)]
    t = Trace(events)
    assert t.span_device_s("train.backward") == 0  # by thread: nothing
    assert read("backward_ms.train", t, traced_steps=1) == pytest.approx((1_000 + 300) * 1e-6)
    assert read("backward_ms.train", t, traced_steps=2) == pytest.approx((1_000 + 300) * 0.5e-6)


def test_feed_readers_on_a_synthetic_step():
    """Two steps of 2 GOPs: one starved take of 3 us, two stagings of 1 us;
    the device idles 2 us inside the wait, 0.5 us inside each staging and
    0.5 us inside the benchmark's own span."""
    events = [span(WINDOW, 0, 20_000),
              span("bench.feed", 1_000, 6_000), span("feeder.wait", 2_000, 3_000),
              span("loader.stage", 5_500, 1_000), span("bench.feed", 10_000, 3_000),
              span("loader.stage", 11_000, 1_000),
              *launch(1, 100, 1, 0, 2_000),       # busy to 2 000
              *launch(2, 150, 1, 4_000, 2_000),   # idle 2 000-4 000 (feeder.wait)
              *launch(3, 160, 1, 6_500, 4_000),   # idle 6 000-6 500 (loader.stage)
              *launch(4, 170, 1, 11_500, 8_500)]  # idle 10 500-11 500 (both)
    t = Trace(events)
    host = dict(traced_steps=2, gops_per_step=2)
    assert read("feeder_wait_ms.serve", t, **host) == pytest.approx(3_000e-6 / 2)
    assert read("feeder_starved_share.serve", t, **host) == pytest.approx(100 / 4)
    assert read("loader_stage_ms.serve", t, **host) == pytest.approx(2_000e-6 / 2)
    assert read("feeder_idle_ms.serve", t, **host) == pytest.approx(3_000e-6 / 2)


def test_a_program_without_the_spans_reads_nothing():
    """A trace whose program marks neither its feed nor its training stages
    (the program before these spans) gives no reading, and raises nothing."""
    t = Trace([span(WINDOW, 0, 10_000), span("bench.feed", 1_000, 2_000),
               *launch(1, 100, 1, 0, 500)])
    host = dict(traced_steps=2, gops_per_step=2)
    for name in FEEDER + TRAIN:
        assert read(name, t, **host) is None, name
        assert read(name, None, **host) is None, name


class SlowPool:
    """The serving cell's sequence with every GOP's keyframe read slowly
    (0.2 s), so that the loop waits for the feeder on the CPU."""

    def __init__(self, seq):
        self.seq = seq

    def __getattr__(self, name):
        return getattr(self.seq, name)

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, i):
        if self.seq.locate(i)[1] == 0:
            time.sleep(0.2)
        return self.seq[i]


def test_a_traced_cpu_run_reports_the_feed_waits(monkeypatch):
    from drivers import gop_batch

    pool = gop_batch.pool
    monkeypatch.setattr(gop_batch, "pool", lambda ctx: SlowPool(pool(ctx)))
    # the steps after the first, once the GOPs assembled ahead are spent
    small = {**SMALL, "traffic": {**SMALL["traffic"], "trace_from_step": 1, "trace_steps": 2}}
    res, _ = run.execute("cityscapes-bise18.batch4", SEED, 1.5, 1, "cpu", small)
    m = res["metrics"]
    assert {"feeder_wait_ms.serve", "feeder_starved_share.serve"} <= set(m)
    assert m["feeder_wait_ms.serve"]["unit"] == "ms/step"
    assert 0 < m["feeder_wait_ms.serve"]["value"] < math.inf
    assert 0 < m["feeder_starved_share.serve"]["value"] <= 100
    # no staging on the CPU, and no device operation to be idle between
    assert not {"loader_stage_ms.serve", "feeder_idle_ms.serve"} & set(m)


def test_idle_host_splits_the_feed_by_the_loops_operations(monkeypatch):
    """``idle_host.py`` on a traced CPU run: no device operation, so the
    whole window is one gap; what it charges to ``feeder.wait`` is the
    span's time, cut into the loop's operations and no op."""
    import idle_host
    from drivers import gop_batch

    pool = gop_batch.pool
    monkeypatch.setattr(gop_batch, "pool", lambda ctx: SlowPool(pool(ctx)))
    small = {**SMALL, "traffic": {**SMALL["traffic"], "trace_from_step": 1, "trace_steps": 2}}
    metrics, t, raw, steps = idle_host.traced_run("cityscapes-bise18.batch4", SEED, 1.5, "cpu",
                                                  small)
    assert steps == 2 and metrics["feeder_wait_ms.serve"] > 0
    rep = idle_host.report(t, raw, steps)
    wait = rep["idle_in"]["feeder.wait"]
    assert wait["ms_per_step"] == pytest.approx(rep["inside"]["feeder.wait"]["ms_per_step"])
    assert wait["ms_per_step"] == pytest.approx(metrics["feeder_wait_ms.serve"])
    assert 0 <= wait["no_op_ms_per_step"] <= wait["ms_per_step"]
    assert wait["no_op_ms_per_step"] + sum(v for _, v in wait["ops"]) == pytest.approx(
        wait["ms_per_step"])
    assert "bench.feed" in rep["inside"]


def test_a_traced_cpu_training_run_reports_no_device_time():
    res, _ = run.execute("camvid-bise18.train16", SEED, 0.5, 1, "cpu", TRAIN_SMALL)
    assert not set(TRAIN) & set(res["metrics"])
    assert res["correct"]


# the training loop stages two batches ahead, and the window opens and
# closes as batches are drawn: a window of 4 draws holds the first 2 steps
TRAIN_TRACED = {**TRAIN_SMALL, "traffic": {**TRAIN_SMALL["traffic"], "trace_steps": 4}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,small,names", [
    ("cityscapes-bise18.batch4", SMALL, FEEDER),
    ("camvid-bise18.train16", TRAIN_TRACED, TRAIN)])
def test_a_traced_card_run_reports_every_new_metric(card, cell, small, names):
    res, _ = run.execute(cell, SEED, 1.0, 1, "cuda", small)
    for name in names:
        assert name in res["metrics"], name
        assert math.isfinite(res["metrics"][name]["value"]), name
