"""``resize_argmax_ms.serve``: the device time under the program's
``gop.head_chunk`` spans per GOP, on a synthetic trace of the kernel's one
launch a step, of the chunked head of a program without it, and of a
program that opens no such span."""

import types

import pytest
from test_h100_spans import launch, span

from harness import manifest
from harness.trace import WINDOW, Trace

NAME = "resize_argmax_ms.serve"


def read(trace, **host):
    return manifest.reader(NAME)(types.SimpleNamespace(trace=trace, host=host, cfg=None))


def test_listed_for_the_two_cells_whose_head_it_reads():
    m = next(m for m in manifest.manifest()["per_layer"] if m["name"] == NAME)
    assert m["workloads"] == ["cityscapes-bise18.batch4", "cityscapes-psp18.batch8"]
    assert (m["unit"], m["better"], m["moves"], m["layer"]) == ("ms/GOP", "lower",
                                                                "frames_per_s", "ops")


def test_one_launch_a_step():
    """Two steps of 4 GOPs, one launch under ``gop.head_chunk`` in each
    (inside ``gop.fuse_head``); the fusion's launch outside it is not
    counted."""
    events = [span(WINDOW, 0, 100_000),
              span("gop.fuse_head", 1_000, 9_000), span("gop.head_chunk", 5_000, 1_000),
              span("gop.fuse_head", 51_000, 9_000), span("gop.head_chunk", 55_000, 1_000),
              *launch(1, 2_000, 1, 10_000, 7_000),      # the fusion (K1)
              *launch(2, 5_500, 1, 20_000, 1_500),      # the head, step 1
              *launch(3, 52_000, 1, 60_000, 7_000),
              *launch(4, 55_500, 1, 70_000, 1_700)]     # the head, step 2
    got = read(Trace(events), traced_steps=2, gops_per_step=4)
    assert got == pytest.approx(1e3 * 3_200e-9 / 8)


def test_the_chunked_head_of_a_program_without_the_kernel():
    """A program without the kernel: the resize and the argmax of each of
    two chunks under their own span, all counted."""
    events = [span(WINDOW, 0, 100_000), span("gop.head_chunk", 1_000, 2_000),
              span("gop.head_chunk", 4_000, 2_000),
              *launch(1, 1_100, 1, 10_000, 5_000), *launch(2, 1_200, 1, 15_000, 6_000),
              *launch(3, 4_100, 1, 21_000, 5_000), *launch(4, 4_200, 1, 26_000, 6_000)]
    got = read(Trace(events), traced_steps=1, gops_per_step=8)
    assert got == pytest.approx(1e3 * 22_000e-9 / 8)


def test_a_program_without_the_span_reads_nothing():
    """BiSeNet's head before the kernel opened no ``gop.head_chunk``: no
    reading, and nothing raised; no trace: none either."""
    t = Trace([span(WINDOW, 0, 10_000), span("gop.fuse_head", 1_000, 2_000),
               *launch(1, 1_100, 1, 1_500, 500)])
    assert read(t, traced_steps=2, gops_per_step=4) is None
    assert read(None, traced_steps=2, gops_per_step=4) is None
