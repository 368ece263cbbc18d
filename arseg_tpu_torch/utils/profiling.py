"""Tracing and step timing — port of ``arseg_tpu/utils/profiling.py``.

``trace(log_dir)`` records a ``torch.profiler`` trace of the host and the
card and writes it as a Chrome trace (``chrome://tracing``, Perfetto);
``annotate(name)`` is a named span in it (``record_function``);
``StepTimer`` times steps on the host clock and reports frames/s.

The host clock measures the card's work only when the step waits for it:
the caller ends the timed block with one synchronising read, such as one
element's ``.item()`` of the step's output or the stream's
``synchronize()``, once a step, never once a frame.
"""

import contextlib
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block (the CPU, and the card when there is one) and
    write ``log_dir/trace.json``:

    with profiling.trace("/tmp/arseg-trace"):
        pipe.gop_step(keyframe, frames, flows)
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(os.fspath(log_dir), "trace.json"))


def annotate(name):
    """Named region in traces (``torch.profiler.record_function``)."""
    return record_function(name)


class StepTimer:
    """Wall-clock per-step timing with frames/s reporting (module
    docstring: the caller synchronises inside the step)."""

    def __init__(self, frames_per_step=1):
        self.frames_per_step = frames_per_step
        self.times = []
        self.frames = []
        self._t0 = None
        self._next_frames = None

    def step(self, frames):
        """Context for a step covering `frames` frames (variable-size steps,
        e.g. multi-GOP stacks + a single-GOP tail): `with timer.step(n): ...`"""
        self._next_frames = frames
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self.frames.append(
            self.frames_per_step if self._next_frames is None else self._next_frames
        )
        self._next_frames = None

    @property
    def fps(self):
        if not self.times:
            return 0.0
        return sum(self.frames) / sum(self.times)

    def summary(self, skip_warmup=1):
        """steps, mean/min/p50/p95/max ms per step and frames/s, the first
        ``skip_warmup`` steps left out of all but ``steps`` (kept when they
        are all there is)."""
        ts = self.times[skip_warmup:] or self.times
        fs = self.frames[skip_warmup:] or self.frames
        srt = sorted(ts)
        return {
            "steps": len(self.times),
            "mean_ms": 1e3 * sum(ts) / len(ts),
            "min_ms": 1e3 * min(ts),
            "p50_ms": 1e3 * srt[len(srt) // 2],
            "p95_ms": 1e3 * srt[min(len(srt) - 1, int(len(srt) * 0.95))],
            "max_ms": 1e3 * max(ts),
            "frames_per_sec": sum(fs) / sum(ts),
        }

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.summary(), f)
