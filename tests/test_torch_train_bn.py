"""camvid-bise18's phase-2 objective with BatchNorm in train mode, the
port's against the JAX package's on the CPU, float32, batch 8: the loss
and every gradient, each held to the larger of 1e-4 and 4 x its own
float32 error (``train_parity.py`` says why), stage 1 and stage 2."""

import pytest

from arseg_tpu.train.objectives import build_phase2_loss as j_phase2_loss

from arseg_tpu_torch import set_f32_parity_mode
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
def test_train_mode_objective_matches_jax(bise18, stage2):
    m = bise18
    batch = make_batch(8, HW, seed=3)
    jloss = j_phase2_loss(m["js"], m["jt"], "bisenet", "camvid", CROP_WH, 0.5, stage2=stage2)
    ploss = build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5, stage2=stage2)
    check_objective(jloss, ploss, m["sp"], m["tp"], m["student"], m["teacher"], batch, True,
                    BACKEND)
