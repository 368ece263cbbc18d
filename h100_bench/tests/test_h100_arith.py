"""The frozen roofline and FLOP arithmetic against hand counts."""

import torch

from harness import arith


def test_k1_cost_and_bound_by_hand():
    # [88, 90, 120, 256] bf16: 243302400 elements; 3 tensors of 2 bytes,
    # taps and biases in float32
    flops, nbytes = arith.k1_cost(88, 90, 120, 256)
    assert flops == 243302400 * 251
    assert nbytes == 3 * 243302400 * 2 + (27 * 256 + 3 * 256) * 4
    assert abs(arith.bound_s(flops, nbytes) - nbytes / 3.35e12) < 1e-15  # bytes bound it


def test_k2_cost_by_hand():
    # 8 sources warped to 88 frames: sources, two float32 planes, output
    flops, nbytes = arith.k2_cost(88, 8, 90, 120, 256)
    out = 88 * 90 * 120 * 256
    assert flops == 7 * out
    assert nbytes == 8 * 90 * 120 * 256 * 2 + 2 * 88 * 90 * 120 * 4 + out * 2


def test_bound_takes_the_larger_side():
    assert arith.bound_s(989e12, 1.0) == 1.0
    assert arith.bound_s(1.0, 3.35e12) == 1.0


def test_counted_flops_of_a_conv_by_hand():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False, device="meta")
    got = arith._counted(lambda: conv(torch.empty(2, 3, 16, 16, device="meta")))
    assert got == 2 * (2 * 8 * 16 * 16) * (3 * 9)


def test_gop_and_step_counts_hold_the_window_terms():
    cfg = {"frame_hw": [64, 96], "lr_scale": 0.5, "n_classes": 12, "atten_k": 7,
           "feature_stride": 8, "gop": 3, "middle_dim": 256}
    # 2 frames of [8, 12, 256] past the keyframe: the window and the warp
    window = 2 * 8 * 12 * 256 * (arith.K1_WINDOW_FLOPS + arith.K2_FLOPS)
    # a training step runs the window's forward once and backward twice
    step_window = 2 * 8 * 12 * 256 * (3 * arith.K1_WINDOW_FLOPS + arith.K2_FLOPS)
    assert arith.serve_flops_per_gop(cfg) > window
    assert arith.train_flops_per_step(cfg, 2) > step_window
