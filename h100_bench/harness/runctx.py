"""What a driver is given and what it hands back."""

import dataclasses
import random
import time

import torch


@dataclasses.dataclass
class Ctx:
    workload: dict
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at process start
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, name):
        """Seconds from process start to the end of a set-up phase."""
        self.marks[name] = time.perf_counter() - self.t_start

    def rng(self, stream):
        """A host RNG for the sample plans of one stream of this seed."""
        return random.Random(f"{self.seed}/{stream}")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self):
        return time.perf_counter()


@dataclasses.dataclass
class Outcome:
    e2e: dict  # end-to-end metric -> value (setup_s included)
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: dict  # the numbers the check compares
    info: dict  # printed on an earlier line
    host: dict  # host-clock data for the per-layer readers
    trace: object = None  # harness.trace.Trace of a --trace 1 run


def memory_peak(device):
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def no_tf32():
    """Float32 matmuls and convolutions in full float32 (the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
