"""The control (the reference in float8, one precision below the
configuration's bfloat16, in the program's place) comes out not correct:
at a small size on the CPU, and at each cell's own size on a card. The
training fault "half of the batch left out", planted in the reference, too."""

import pytest
from conftest import SEED, SMALL, TRAIN_SMALL

import control
from harness import checks, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


def failing(cell, readings):
    return {name: not checks.judge(r, manifest.limits(cell))[0] for name, r in readings.items()
            if name in ("control_fp8", "fault_half_batch")}


@pytest.mark.parametrize("cell", ["cityscapes-bise18.batch4", "camvid-bise18.train16"])
def test_control_fails_at_a_small_size(cell):
    small = TRAIN_SMALL if "train" in cell else SMALL
    got = failing(cell, control.readings(cell, SEED, "cpu", overrides=small, seconds=1.0))
    assert got and all(got.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(card, cell):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        got = failing(cell, control.readings(cell, seed, str(card)))
        assert got and all(got.values()), (seed, got)
