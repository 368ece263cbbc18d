"""camvid-bise18's phase-2 objective (arseg_tpu_torch.train.objectives)
against the JAX package's on the CPU, float32: stage 1 (normal mode) and
stage 2 (the teacher's keyframe feature warped by nearest-resized flows
through K2's plain version, the student in merge mode through K1's plain
version and its composed backward), the loss and every gradient, with BN on
its running statistics, at batch 2 (train mode: test_torch_train_bn.py).
Also the stage-2 warp against the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arseg_tpu.train.objectives import build_phase2_loss as j_phase2_loss

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.ops.warp import scale_and_resize_flow, warp_feature
from arseg_tpu_torch.train.objectives import build_phase2_loss

from train_parity import check_objective, make_batch, models_pair

from torch_parity import few_threads  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

BACKEND, HW, CROP_WH = "camvid-bise18", (64, 64), (64, 64)


@pytest.fixture(scope="module")
def bise18():
    return models_pair(BACKEND)


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
def test_phase2_objective_matches_jax(bise18, stage2):
    m = bise18
    batch = make_batch(2, HW, seed=3)
    jloss = j_phase2_loss(m["js"], m["jt"], "bisenet", "camvid", CROP_WH, 0.5, stage2=stage2)
    ploss = build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5, stage2=stage2)
    _, grads = check_objective(jloss, ploss, m["sp"], m["tp"], m["student"], m["teacher"], batch,
                               False, BACKEND)
    assert any(k.startswith("fuse_attention") for k in grads) == stage2


def test_stage2_warp_is_the_nearest_flow_warp():
    """The stage-2 warp: flows rescaled to the feature grid then resized
    nearest, as train_pair.py:345-348, through warp_feature."""
    from arseg_tpu.ops import scale_and_resize_flow as j_scale, warp_feature as j_warp

    rng = np.random.RandomState(1)
    feat = rng.randn(2, 8, 8, 16).astype(np.float32)
    flow = rng.uniform(-16, 16, (2, 64, 64, 2)).astype(np.float32)
    fx, fy = scale_and_resize_flow(torch.from_numpy(flow), (8, 8), mode="nearest", split=True)
    got = warp_feature(torch.from_numpy(feat), (fx, fy))
    jf = j_scale(jnp.asarray(flow), (8, 8), mode="nearest", split=True)
    want = j_warp(jnp.asarray(feat), jf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
