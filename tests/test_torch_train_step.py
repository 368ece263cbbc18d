"""A whole camvid-bise18 phase-2 stage-2 SGD step of the port's
``make_train_step`` against the JAX package's (un-jitted) on the CPU,
float32, BN in train mode at batch 8 a forward (``train_parity.py``): the
loss, every BN running statistic and every parameter after the update;
then accum_steps=2."""

import jax
import numpy as np
import pytest
import torch

from arseg_tpu.train import optim as JO
from arseg_tpu.train.objectives import build_phase2_loss as j_phase2_loss
from arseg_tpu.train.step import make_train_step as j_make_train_step
from arseg_tpu.train.step import masked_optimizer as j_masked_optimizer

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.train import optim as O
from arseg_tpu_torch.train.objectives import build_phase2_loss
from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
from arseg_tpu_torch.train.trainer import FINAL_CONV_PATH
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from train_parity import GRAD_ERR_FACTOR, make_batch, models_pair, port_loss_grads

set_f32_parity_mode()

BACKEND, HW, CROP_WH = "camvid-bise18", (64, 64), (64, 64)
FC = FINAL_CONV_PATH[("bisenet", "camvid")]


@pytest.fixture(scope="module")
def bise18():
    return models_pair(BACKEND)


def _jax_step(m, kind, accum_steps, frozen=(FC,)):
    opt = j_masked_optimizer(JO.make_optimizer(kind, JO.cosine_schedule(1e-2, 100)), m["sp"],
                             frozen)
    loss = j_phase2_loss(m["js"], m["jt"], "bisenet", "camvid", CROP_WH, 0.5, stage2=True)
    step = j_make_train_step(loss, opt, accum_steps=accum_steps)
    return step, opt


def _port_step(m, kind, accum_steps, compute_dtype=None):
    import copy

    student = copy.deepcopy(m["student"])
    opt = O.make_optimizer(kind, O.cosine_schedule(1e-2, 100), trainable_parameters(student, (FC,)))
    loss = build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5, stage2=True)
    step = make_train_step(loss, opt, accum_steps=accum_steps, compute_dtype=compute_dtype,
                           device="cpu")
    return step, opt, student, teacher_copy(m["teacher"], "cpu", compute_dtype)


def _grad_err(m, batch, accum_steps):
    """{name: max |float32 - float64 gradient|} of the port's stage-2
    objective, averaged over the micro-batches as the step averages."""
    loss = build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5, stage2=True)
    n = batch["image"].shape[0] // accum_steps
    micro = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(accum_steps)]
    g = {}
    for dt in (torch.float32, torch.float64):
        runs = [port_loss_grads(loss, m["student"], m["teacher"], b, True, dt)[2] for b in micro]
        g[dt] = {k: sum(r[k] for r in runs) / accum_steps for k in runs[0]}
    return {k: float(np.abs(v - g[torch.float64][k]).max()) for k, v in g[torch.float32].items()}


@pytest.mark.parametrize("accum_steps,n", [(1, 8), (2, 16)])
def test_sgd_step_matches_jax_make_train_step(bise18, accum_steps, n):
    """A whole stage-2 SGD step (train mode, batch 8 a forward:
    train_parity.py), un-jitted JAX against the port: the loss, every BN
    running statistic, and every parameter after the update, which may
    differ by lr x GRAD_ERR_FACTOR x its gradient's float32 error. With
    accum_steps=2 the batch of 16 runs as two micro-batches of 8, whose
    gradients are averaged and whose BN statistics the running statistics
    take once, averaged."""
    m = bise18
    batch = make_batch(n, HW, seed=4)
    jstep, jopt = _jax_step(m, "sgd", accum_steps)
    with jax.disable_jit():
        jparams, _, jmetrics = jstep(m["sp"], jopt.init(m["sp"]), m["tp"], batch,
                                     jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), BACKEND)
    step, opt, student, teacher = _port_step(m, "sgd", accum_steps)
    metrics = step(student, teacher, batch)
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5 * float(jmetrics["loss"])
    got = student.state_dict()
    before = state_dict_from_jax(m["sp"], BACKEND)
    err = _grad_err(m, batch, accum_steps)
    lr = O.cosine_schedule(1e-2, 100)(0)
    moved = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = want[k].numpy()
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            name = k if k in err else None
            tol = 5e-7 + (lr * GRAD_ERR_FACTOR * err[name] if name else 0.0)
            assert float(np.abs(v.numpy() - w).max()) <= tol, (k, np.abs(v.numpy() - w).max(), tol)
        moved += not np.array_equal(v.numpy(), before[k].numpy())
    assert moved > 100
    np.testing.assert_array_equal(got["final_conv.weight"].numpy(),
                                  before["final_conv.weight"].numpy())
