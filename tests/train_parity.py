"""Shared plumbing of the training parity tests (tests/test_torch_train*.py):
the same weights and batch through a JAX objective (un-jitted
``jax.value_and_grad``) and the port's, and the comparison of their losses
and gradients.

Train-mode BatchNorm amplifies float32 rounding where it normalises over
few values: BiSeNet's attention BNs normalise globally pooled features, one
value per image, and at 64x64 its bottom feature is 1x1. At batch 2 two
nearly equal values per channel give a normalised output and a gradient
that are mostly rounding: the port's float32 loss differs from its float64
loss by 1.3e-3 relative and its gradients by ~1 (measured on this test's
camvid-bise18 at 64x64); at batch 8 by 1e-7 and <= 1e-4. So train-mode
comparisons run at batch 8, and there the loss and each gradient are held to
the larger of LOSS_TOL or GRAD_TOL and GRAD_ERR_FACTOR x the port's own
float32 error of it (its float32 value against its float64 one). With BN on
its running statistics (eval mode) the comparison runs at batch 2 and holds
the loss to LOSS_TOL and every gradient to GRAD_TOL."""

import copy

import jax
import numpy as np
import pytest
import torch

from arseg_tpu.nn import functional as Fn
from arseg_tpu_torch.train.step import teacher_copy
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import randomize_bn_tree, rel_l2

LOSS_TOL, GRAD_TOL, GRAD_ERR_FACTOR = 1e-5, 1e-4, 4.0


def jax_params(jmodel, seed):
    return randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed))),
                             np.random.RandomState(seed))


def models_pair(backend, teacher_fuse=False, **kw):
    """The fused student and the teacher of ``backend``: JAX trees with
    randomised BN, and the port's models with the same weights."""
    from arseg_tpu.models import build_model as j_build_model
    from arseg_tpu_torch.models import build_model

    js, jt = j_build_model(backend, fuse=True, **kw), j_build_model(backend, fuse=teacher_fuse, **kw)
    sp, tp = jax_params(js, 0), jax_params(jt, 1)
    student = build_model(backend, fuse=True, device="cpu", **kw)
    student.load_state_dict(state_dict_from_jax(sp, backend), strict=True)
    teacher = build_model(backend, fuse=teacher_fuse, device="cpu", **kw)
    teacher.load_state_dict(state_dict_from_jax(tp, backend), strict=True)
    return dict(js=js, jt=jt, sp=sp, tp=tp, student=student, teacher=teacher)


def make_batch(n, hw, seed, n_classes=12, ignore_share=0.05):
    """Normalised-looking images and keyframes, labels with some ignored
    pixels, the class-presence vector, flows uniform(-16, 16)."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, n_classes, (n, *hw))
    label[rng.rand(n, *hw) < ignore_share] = 255
    existence = np.stack([np.isin(np.arange(n_classes), lb) for lb in label]).astype(np.float32)
    return dict(image=rng.randn(n, *hw, 3).astype(np.float32), label=label.astype(np.int32),
                existence=existence, ref_image=rng.randn(n, *hw, 3).astype(np.float32),
                flow=rng.uniform(-16, 16, (n, *hw, 2)).astype(np.float32))


def jax_loss_grads(loss_fn, params, tparams, batch, train, backend):
    """(loss, metrics, gradients under the reference's keys) of a JAX
    objective, un-jitted."""

    def wrapped(p):
        return loss_fn(p, tparams, batch, Fn.Ctx(train=train, rng=jax.random.PRNGKey(0)))

    (loss, metrics), g = jax.value_and_grad(wrapped, has_aux=True)(params)
    grads = {k: v.numpy() for k, v in
             state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g), backend).items()}
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_loss_grads(loss_fn, model, teacher, batch, train, dtype=torch.float32):
    """(loss, metrics, {name: gradient}) of the port's objective on copies
    of the models in dtype."""
    m = copy.deepcopy(model).to(dtype).train(train)
    t = teacher_copy(teacher, "cpu", None if dtype == torch.float32 else dtype)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("image", "ref_image"):
        b[k] = b[k].to(dtype)
    loss, metrics = loss_fn(m, t, b)
    loss.backward()
    grads = {n: p.grad.double().numpy() for n, p in m.named_parameters() if p.grad is not None}
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def bounds(ploss, model, teacher, batch, train):
    """(the loss's bound, {name: that gradient's bound}) (module docstring):
    LOSS_TOL and GRAD_TOL in eval mode; in train mode each the larger of
    those and GRAD_ERR_FACTOR x the port's own float32 error of it."""
    if not train:
        return LOSS_TOL, {}
    l32, _, g32 = port_loss_grads(ploss, model, teacher, batch, train)
    l64, _, g64 = port_loss_grads(ploss, model, teacher, batch, train, torch.float64)
    loss_tol = max(LOSS_TOL, GRAD_ERR_FACTOR * abs(l32 - l64) / abs(l64))
    return loss_tol, {n: max(GRAD_TOL, GRAD_ERR_FACTOR * rel_l2(g, g64[n])) for n, g in g32.items()}


def check_objective(jloss, ploss, params, tparams, model, teacher, batch, train, backend):
    """The port's loss within LOSS_TOL and each gradient within its bound
    (module docstring) of the JAX objective's; every parameter the JAX
    gradient reaches gets one."""
    jl, jm, jg = jax_loss_grads(jloss, params, tparams, batch, train, backend)
    pl, pm, pg = port_loss_grads(ploss, model, teacher, batch, train)
    loss_tol, grad_tol = bounds(ploss, model, teacher, batch, train)
    assert abs(pl - jl) <= loss_tol * abs(jl), (pl, jl, loss_tol)
    for k in jm:  # each term of the loss within the loss's own bound
        assert abs(pm[k] - jm[k]) <= loss_tol * abs(jl), (k, pm[k], jm[k], loss_tol)
    reached = {n for n, g in jg.items() if np.any(g)} & {n for n, _ in model.named_parameters()}
    assert reached <= set(pg), sorted(reached - set(pg))[:5]
    worst = []
    for n, g in pg.items():
        tol = grad_tol.get(n, GRAD_TOL)
        d = rel_l2(g, jg[n])
        if d > tol:
            worst.append((n, d, tol))
    assert not worst, worst[:6]
    return pl, pg


@pytest.fixture
def no_dropout(monkeypatch):
    """The JAX dropout2d patched to the identity; returns a function that
    sets p = 0 in a port model's Dropout2d modules."""
    import arseg_tpu.nn.functional as JFn
    from arseg_tpu_torch.nn.functional import Dropout2d

    monkeypatch.setattr(JFn, "dropout2d", lambda x, p, ctx: x)

    def off(model):
        for mod in model.modules():
            if isinstance(mod, Dropout2d):
                mod.p = 0.0
        return model

    return off


def check_stage2(no_dropout, backend, n, n_classes, **kw):
    """check_objective of a PSPNet's phase-2 stage 2 in train mode."""
    from arseg_tpu.train.objectives import build_phase2_loss as j_phase2_loss
    from arseg_tpu_torch.train.objectives import build_phase2_loss

    m = models_pair(backend, teacher_fuse=True, **kw)
    dataset = backend.split("-")[0]
    batch = make_batch(n, (64, 64), seed=8, n_classes=n_classes)
    jloss = j_phase2_loss(m["js"], m["jt"], "pspnet", dataset, (64, 64), 0.5, stage2=True)
    ploss = build_phase2_loss("pspnet", dataset, (64, 64), 0.5, stage2=True)
    _, grads = check_objective(jloss, ploss, m["sp"], m["tp"], no_dropout(m["student"]),
                               m["teacher"], batch, True, backend)
    assert any(k.startswith("fuse_attention") for k in grads)
