"""camvid-psp18's objectives, the port's against the JAX package's on the
CPU, float32, with dropout neutralised on both sides (the JAX
``dropout2d`` patched to the identity, p = 0 in the port's modules): V1
phase 1 (NLL + class-presence BCE + the feature MSE to a teacher) and
phase-2 stage 2 (merge mode: K2's and K1's plain versions at full
resolution); the loss and every gradient, BN in train mode at batch 2
(``train_parity.py``). cityscapes-psp18: test_torch_train_semseg.py."""

import pytest

from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.train.objectives import build_phase1_loss as j_phase1_loss

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.train.objectives import build_phase1_loss
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from train_parity import (check_objective, check_stage2, jax_params, make_batch, models_pair,
                          no_dropout)  # noqa: F401 (a fixture)

from torch_parity import few_threads  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

HW, CROP_WH = (64, 64), (64, 64)


def test_camvid_psp18_phase1_matches_jax(no_dropout):
    """Phase 1 of the plain camvid-psp18 at 0.5x with feat_loss="mse" to a
    teacher of the same class."""
    m = models_pair("camvid-psp18", fuse_version=1)
    js = j_build_model("camvid-psp18", fuse=False)
    sp = jax_params(js, 2)
    student = build_model("camvid-psp18", fuse=False, device="cpu")
    student.load_state_dict(state_dict_from_jax(sp, "camvid-psp18"), strict=True)
    batch = make_batch(2, HW, seed=7)
    jloss = j_phase1_loss(js, "pspnet", "camvid", CROP_WH, 0.5, feat_loss="mse",
                          teacher_model=m["jt"])
    ploss = build_phase1_loss("pspnet", "camvid", CROP_WH, 0.5, feat_loss="mse")
    check_objective(jloss, ploss, sp, m["tp"], no_dropout(student), m["teacher"], batch, True,
                    "camvid-psp18")


def test_camvid_psp18_phase2_stage2_matches_jax(no_dropout):
    """camvid-psp18 has no BN on pooled values, so batch 2 is well
    conditioned."""
    check_stage2(no_dropout, "camvid-psp18", 2, 12, fuse_version=1)
