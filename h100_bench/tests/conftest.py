"""Tests of the benchmark's harness. They run on the CPU at small sizes;
those marked ``cuda`` run on a card and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny shapes at which a whole run fits a CPU test
SMALL = {
    "config": {"frame_hw": [64, 96], "gop": 3},
    "traffic": {"gop_batch": 2, "io_workers": 2, "warmup_steps": 1, "check_first_steps": 1,
                "check_steps": 1, "check_gops": 1, "check_frames": 3, "trace_from_step": 0,
                "trace_steps": 1, "batch": 4, "pool_batches": 3},
}
TRAIN_SMALL = {"config": {**SMALL["config"], "dtype": "float32"},
               "traffic": {**SMALL["traffic"], "check_steps": 3}}
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
