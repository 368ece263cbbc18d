"""A whole run on the CPU at a small size, with the timed path broken
underneath: for each fault a cell can have, ``correct`` comes out false;
unbroken, it comes out true. One chip and no exchange between chips, so
that fault does not arise."""

import pytest
import torch
from conftest import SEED, SMALL, TRAIN_SMALL

import run
from arseg_tpu_torch.gop import pipeline
from arseg_tpu_torch.train import optim, step


def altered(maps):
    """A quarter of each map moved to the next class."""
    out = maps.clone()
    h = out.shape[-2] // 2
    w = out.shape[-1] // 2
    out[..., :h, :w] = (out[..., :h, :w] + 1) % 12
    return out


def batch_altered(monkeypatch):
    orig = pipeline.ARPipeline.multi_gop_step
    monkeypatch.setattr(pipeline.ARPipeline, "multi_gop_step",
                        lambda self, *a, **k: altered(orig(self, *a, **k)))


def batch_one_slot(monkeypatch):
    """The last GOP of each step altered, the others served right."""
    orig = pipeline.ARPipeline.multi_gop_step

    def last_altered(self, *a, **k):
        maps = orig(self, *a, **k)
        return torch.cat([maps[:-1], altered(maps[-1:])])

    monkeypatch.setattr(pipeline.ARPipeline, "multi_gop_step", last_altered)


def batch_half(monkeypatch):
    orig = pipeline.ARPipeline.multi_gop_step

    def half(self, keyframes, frames, flows, return_fused=False):
        b = frames.shape[0] // 2
        maps = orig(self, keyframes[:b], frames[:b], tuple(f[:b] for f in flows))
        return torch.cat([maps, maps])

    monkeypatch.setattr(pipeline.ARPipeline, "multi_gop_step", half)


def train_state_unchanged(monkeypatch):
    def no_update(self):
        for group in self.optimizer.param_groups:
            group["updates"] += 1

    monkeypatch.setattr(optim.ScheduledOptimizer, "step", no_update)


def train_half(monkeypatch):
    orig = step.make_train_step

    def make(*a, **k):
        fn = orig(*a, **k)

        def half(model, teacher, batch, generator=None):
            return fn(model, teacher, {key: v[: v.shape[0] // 2] for key, v in batch.items()},
                      generator)

        return half

    monkeypatch.setattr(step, "make_train_step", make)


CASES = [
    ("cityscapes-bise18.batch4", SMALL, None),
    ("cityscapes-bise18.batch4", SMALL, batch_altered),
    ("cityscapes-bise18.batch4", SMALL, batch_one_slot),
    ("cityscapes-bise18.batch4", SMALL, batch_half),
    ("camvid-bise18.train16", TRAIN_SMALL, None),
    ("camvid-bise18.train16", TRAIN_SMALL, train_state_unchanged),
    ("camvid-bise18.train16", TRAIN_SMALL, train_half),
]


@pytest.mark.parametrize("cell,small,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, _, f in CASES])
def test_a_broken_path_is_not_correct(monkeypatch, cell, small, fault):
    if fault is not None:
        fault(monkeypatch)
    res, info = run.execute(cell, SEED, 1.0, 0, "cpu", small)
    assert res["correct"] is (fault is None), info["readings"]
