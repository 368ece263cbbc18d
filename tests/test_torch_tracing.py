"""The port's own spans (``record_function``) on the CPU: the training
step's stages (``train/step.py``, ``train/objectives.py``), the feeder's
waits and assemblies (``gop/feeder.py``) as ``utils/profiling.trace``
writes them, and results bit-equal with a profiler running and without.
The staging span (``data/loader.py``) runs on a card only."""

import copy
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from arseg_tpu_torch.data.loader import device_prefetch
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.gop import feeder as feeder_mod
from arseg_tpu_torch.gop.feeder import GOPFeeder
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.train import optim as O
from arseg_tpu_torch.train.objectives import build_phase2_loss
from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
from arseg_tpu_torch.train.trainer import FINAL_CONV_PATH, TrainLoop, build_train_model
from arseg_tpu_torch.utils import profiling

from torch_parity import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

HW = (64, 64)
STAGES = ("train.teacher", "train.student", "train.loss", "train.backward", "train.update")
JOIN_TIMEOUT = 30  # seconds a released GOP may take to reach the consumer


def _spans(prof):
    """{name: [(start_ns, end_ns, thread id)]} of the profiler's host spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def _batch(seed, n=2):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 12, (n, *HW))
    label[rng.rand(n, *HW) < 0.05] = 255
    return {"image": rng.randn(n, *HW, 3).astype(np.float32),
            "ref_image": rng.randn(n, *HW, 3).astype(np.float32),
            "label": label.astype(np.int32),
            "flow": rng.uniform(-16, 16, (n, *HW, 2)).astype(np.float32)}


@pytest.fixture(scope="module")
def stage2():
    """A stage-2 student (its final conv the teacher's, frozen) and teacher."""
    student = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=3)
    teacher = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=4)
    fc = FINAL_CONV_PATH[("bisenet", "camvid")]
    student.get_submodule(fc).load_state_dict(teacher.get_submodule(fc).state_dict())
    return student, teacher_copy(teacher, "cpu")


def _train(stage2, batches, profiled):
    """Adam steps of FST stage 2 through ``TrainLoop.run_epoch``, a batch
    an epoch: (losses, final parameters, the profiler or None)."""
    student = copy.deepcopy(stage2[0])
    params = trainable_parameters(student, (FINAL_CONV_PATH[("bisenet", "camvid")],))
    opt = O.make_optimizer("adam", O.cosine_schedule(1e-3, 10), params)
    step = make_train_step(build_phase2_loss("bisenet", "camvid", HW[::-1], 0.5, stage2=True),
                           opt, device="cpu")
    loop = TrainLoop("cpu", verbose=False)
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.start()
    losses = [loop.run_epoch(step, student, stage2[1], [b], 0) for b in batches]
    if prof is not None:
        prof.stop()
    return losses, [p.detach().clone() for p in student.parameters()], prof


def test_training_stages_nest_in_each_step_in_order(stage2):
    """Each step opens every ``train.*`` span once, inside its
    ``train.step``, teacher, student, loss, backward, update in turn; the
    losses and the parameters are bit-equal to an unprofiled run's."""
    batches = [_batch(5), _batch(6)]
    losses, params, prof = _train(stage2, batches, profiled=True)
    spans = _spans(prof)
    steps = sorted(spans["train.step"])
    assert len(steps) == len(batches)
    for s0, s1, tid in steps:
        inside = []
        for name in STAGES:
            got = [sp for sp in spans.get(name, []) if s0 <= sp[0] and sp[1] <= s1]
            assert len(got) == 1, (name, got)
            assert got[0][2] == tid, name
            inside.append(got[0])
        for a, b in zip(inside, inside[1:]):
            assert a[1] <= b[0]
    for name in STAGES:
        assert len(spans[name]) == len(batches), name
    # the profiler records and changes nothing
    plain_losses, plain_params, _ = _train(stage2, batches, profiled=False)
    assert losses == plain_losses
    assert all(torch.equal(a, b) for a, b in zip(params, plain_params))


# ------------------------------------------------------------------- feeder

G = 2
N_GOPS = 5
# the GOPs whose frames are held until the consumer waits for them: GOP 0,
# since the feeder starts its threads at the first take, and the last,
# which no later GOP's first read can show assembled
SLOW = {0, 2, N_GOPS - 1}
FH, FW = 64, 96


class HeldSequence:
    """A sequence of N_GOPS GOPs of G frames, read in order by one worker:
    a SLOW GOP's frames are read only once ``release[gop]`` is set, and
    ``asked[gop]`` is set when the GOP's first frame is asked for, which
    the worker does only after it handed the consumer the GOP before."""

    def __init__(self):
        self.release = {k: threading.Event() for k in range(N_GOPS)}
        self.asked = {k: threading.Event() for k in range(N_GOPS)}
        for k in set(range(N_GOPS)) - SLOW:
            self.release[k].set()

    def __len__(self):
        return N_GOPS * G

    def _frame(self, i):
        return np.full((FH, FW, 3), i, np.uint8), np.full((FH, FW, 2), i % 7 - 3, np.float32)

    def __getitem__(self, i):
        gop = i // G
        if i % G == 0:
            self.asked[gop].set()
        assert self.release[gop].wait(JOIN_TIMEOUT)
        img, flow = self._frame(i)
        return {"image": img, "flow": flow}


class HeldSource(HeldSequence):
    """The same GOPs from a sequential source (``iter_gops``)."""

    def iter_gops(self, alloc):
        for gop in range(N_GOPS):
            frames = [self[gop * G + k] for k in range(G)]
            kf, kf_np = alloc((1, FH, FW, 3), np.uint8)
            fr, fr_np = alloc((G - 1, FH, FW, 3), np.uint8)
            fx, fx_np = alloc((G - 1, FH, FW), np.float32)
            fy, fy_np = alloc((G - 1, FH, FW), np.float32)
            kf_np[0] = frames[0]["image"]
            for k, f in enumerate(frames[1:]):
                fr_np[k], fx_np[k], fy_np[k] = f["image"], f["flow"][..., 0], f["flow"][..., 1]
            yield kf, fr, fx, fy


def _take_all(feeder, ds, monkeypatch, step=None):
    """Every GOP, each under a ``test.take<k>`` span. A SLOW GOP is released
    by the consumer's own entry into ``feeder.wait``; any other is taken
    once the worker has asked for the next GOP, so after it was handed over.
    Returns the yielded GOPs (and ``step``'s maps of each)."""
    take = [None]

    def span(name):
        if name == "feeder.wait":
            ds.release[take[0]].set()
        return record_function(name)

    monkeypatch.setattr(feeder_mod, "record_function", span)
    out = []
    it = iter(feeder)
    for k in range(N_GOPS):
        take[0] = k
        # should no wait open, the GOP is released late and the test fails
        # on its spans, not by hanging
        late = threading.Timer(JOIN_TIMEOUT / 2, ds.release[k].set)
        late.start()
        if k not in SLOW:
            assert ds.asked[k + 1].wait(JOIN_TIMEOUT)
        with record_function(f"test.take{k}"):
            gi, kf, fr, (fx, fy) = next(it)
        late.cancel()
        assert gi == k
        item = [np.array(a) for a in (kf, fr, fx, fy)]
        if step is not None:
            item.append(step(kf, fr, (fx, fy)).numpy())
        out.append(item)
    with pytest.raises(StopIteration):
        next(it)
    return out


@pytest.mark.parametrize("cls", [HeldSequence, HeldSource], ids=["random_access", "sequential"])
def test_feeder_spans_mark_starved_takes_and_every_assembly(cls, tmp_path, monkeypatch):
    """``feeder.wait`` opens on the consumer's thread for exactly the GOPs
    that were not assembled when asked for; ``feeder.assemble`` once a GOP
    on the worker's thread (once a call into a sequential source), in
    ``profiling.trace``'s Chrome trace."""
    ds = cls()
    feeder = GOPFeeder(ds, G, num_workers=1, depth=N_GOPS, stage=False)
    with profiling.trace(tmp_path / "tr"):
        _take_all(feeder, ds, monkeypatch)
    events = [e for e in json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    takes = {int(e["name"][len("test.take"):]): e for e in events
             if e["name"].startswith("test.take")}
    consumer = {e["tid"] for e in takes.values()}
    assert sorted(takes) == list(range(N_GOPS)) and len(consumer) == 1
    waits = [e for e in events if e["name"] == "feeder.wait"]
    assert {e["tid"] for e in waits} <= consumer
    starved = sorted(k for k, t in takes.items() for w in waits
                     if t["ts"] <= w["ts"] and w["ts"] + w["dur"] <= t["ts"] + t["dur"])
    assert starved == sorted(SLOW) and len(waits) == len(SLOW)
    assembled = [e for e in events if e["name"] == "feeder.assemble"]
    # a sequential source's last call finds its end
    assert len(assembled) == N_GOPS + (cls is HeldSource)
    assert not {e["tid"] for e in assembled} & consumer


def test_feeder_and_maps_bit_equal_under_a_profiler(tmp_path, monkeypatch):
    """The same GOPs and the same class maps of a GOP step with a profiler
    recording every thread and without one."""
    hr = build_model("camvid-bise18", fuse=False, seed=1, device="cpu")
    ar = build_model("camvid-bise18", fuse=True, seed=2, device="cpu")
    pipe = ARPipeline(hr, ar, scale=0.5, device="cpu")

    def step(kf, fr, flows):
        with torch.no_grad():
            return pipe.gop_step(torch.as_tensor(kf), torch.as_tensor(fr),
                                 tuple(torch.as_tensor(f) for f in flows))

    def run():
        ds = HeldSequence()
        return _take_all(GOPFeeder(ds, G, num_workers=1, depth=N_GOPS, stage=False), ds,
                         monkeypatch, step)

    with profiling.trace(tmp_path / "tr"):
        traced = run()
    plain = run()
    for a, b in zip(traced, plain):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.cuda
def test_one_stage_span_per_staged_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the staging runs on the CUDA path only)")
    batches = [{"x": np.full((4, 8), i, np.float32), "rows": [np.ones(3), np.zeros(3)]}
               for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = [b["x"].cpu() for b in device_prefetch(iter(batches), "cuda", size=2)]
        torch.cuda.synchronize()
    assert [float(x[0, 0]) for x in got] == list(range(5))
    assert len(_spans(prof)["loader.stage"]) == len(batches)
