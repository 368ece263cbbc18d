"""The port's training (arseg_tpu_torch.train) against the JAX package's on
the CPU: the losses (every OHEM case), the schedules and one update of each
optimizer, bf16 training, the frozen final conv, dropout, both trainers end
to end on a synthetic CamVid tree, and the checkpoints. Whole steps against
the JAX ``make_train_step``: test_torch_train_step.py; the objectives'
losses and gradients: test_torch_train_objectives.py, _bn.py, _psp.py and
_semseg.py."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arseg_tpu.train import losses as JL
from arseg_tpu.train import optim as JO
from arseg_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from arseg_tpu.utils.torch_convert import load_torch_checkpoint

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.train import losses as L
from arseg_tpu_torch.train import optim as O
from arseg_tpu_torch.train.objectives import build_phase2_loss
from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
from arseg_tpu_torch.train import trainer
from arseg_tpu_torch.train.trainer import (FINAL_CONV_PATH, build_train_model, graft_final_conv,
                                           train_phase1, train_phase2)
from arseg_tpu_torch.utils.checkpoint import load_checkpoint, load_weights, save_checkpoint
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from synthetic_data import make_camvid_tree
from train_parity import make_batch, models_pair

from torch_parity import few_threads  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

BACKEND, HW, CROP_WH = "camvid-bise18", (64, 64), (64, 64)
FC = FINAL_CONV_PATH[("bisenet", "camvid")]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- losses


def _ohem_cases():
    """(logits NHWC, labels) for each case the JAX fixed-shape OHEM names."""
    rng = np.random.RandomState(0)
    n, h, w, c = 2, 16, 16, 12
    cases = {}
    cases["enough hard"] = (rng.randn(n, h, w, c) * 2, rng.randint(0, c, (n, h, w)))
    # every pixel easy (CE < -log 0.7): top n_min of tied and spread values
    lab = rng.randint(0, c, (n, h, w))
    easy = np.eye(c)[lab] * 6.0 + rng.rand(n, h, w, c) * 0.01
    cases["all easy"] = (easy, lab)
    # ties at the kth value: few hard pixels, the rest one tied easy loss
    tied = np.eye(c)[lab] * 4.0
    tied[0, 0, :5] = 0.0  # 5 hard pixels (uniform logits), n_min = 32
    cases["ties at kth"] = (tied, lab)
    # kth == 0: fewer positive losses than n_min (confident logits give a
    # CE of exactly 0 in float32), and ignored pixels' zero losses besides
    zero = np.eye(c)[lab] * 100.0
    zero[1, 3, :4] = 0.0
    lab0 = lab.copy()
    lab0[0, :4] = 255
    cases["kth == 0"] = (zero, lab0)
    cases["every pixel ignored"] = (rng.randn(n, h, w, c), np.full((n, h, w), 255))
    few = np.full((n, h, w), 255)
    few[0, 0, :10] = 1  # 10 kept pixels: n_min = 0
    cases["n_min == 0"] = (rng.randn(n, h, w, c), few)
    return {k: (v[0].astype(np.float32), v[1].astype(np.int32)) for k, v in cases.items()}


OHEM_CASES = _ohem_cases()


@pytest.mark.parametrize("case", sorted(OHEM_CASES))
def test_ohem_matches_jax(case):
    logits, labels = OHEM_CASES[case]
    want = float(JL.ohem_ce(jnp.asarray(logits), jnp.asarray(labels)))
    x = nchw(logits).requires_grad_(True)
    got = L.ohem_ce(x, t(labels))
    assert abs(got.item() - want) <= 1e-6 * max(1.0, abs(want)), (got.item(), want)
    got.backward()
    gj = np.asarray(jax.grad(lambda z: JL.ohem_ce(z, jnp.asarray(labels)))(jnp.asarray(logits)))
    gt = x.grad.permute(0, 2, 3, 1).numpy()
    if case == "ties at kth":
        # the kth value's gradient goes to whichever tied pixel each sort
        # puts at position n_min - 1; its total is the same
        np.testing.assert_allclose(gt.sum(), gj.sum(), atol=1e-7)
        np.testing.assert_allclose(np.abs(gt).sum(), np.abs(gj).sum(), rtol=1e-5)
    else:
        np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-9)
    if case == "every pixel ignored":
        assert float(got) == 0.0


def test_jax_ohem_tie_gradient_differs_from_topk():
    """A JAX-side fact the port keeps: with ties at the kth loss, the JAX
    fixed-shape OHEM gives the same value as the reference's
    topk(n_min).mean(), but its gradient puts the tied slots' whole weight
    on one pixel, where topk spreads 1/n_min over the pixels it picked."""
    logits, labels = OHEM_CASES["ties at kth"]
    x = nchw(logits).requires_grad_(True)
    losses = torch.nn.functional.cross_entropy(x, t(labels).long(), ignore_index=255,
                                               reduction="none").reshape(-1)
    n_min = int((t(labels) != 255).sum()) // 16
    ref = losses.topk(n_min).values.mean()
    ref.backward()
    gj = np.asarray(jax.grad(lambda z: JL.ohem_ce(z, jnp.asarray(labels)))(jnp.asarray(logits)))
    want = float(JL.ohem_ce(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(ref.item() - want) <= 1e-6
    g_ref = x.grad.permute(0, 2, 3, 1).numpy()
    touched = lambda g: int((np.abs(g).sum(-1) > 0).sum())  # noqa: E731
    assert touched(g_ref) == n_min > touched(gj)
    np.testing.assert_allclose(g_ref.sum(), gj.sum(), atol=1e-7)


def test_other_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 8, 10, 12).astype(np.float32) * 3
    labels = rng.randint(0, 12, (2, 8, 10)).astype(np.int32)
    labels[0, :2] = 255
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    cls, tgt = rng.randn(3, 12).astype(np.float32) * 4, (rng.rand(3, 12) > 0.5).astype(np.float32)
    a, b = rng.randn(2, 5, 6, 7).astype(np.float32), rng.randn(2, 5, 6, 7).astype(np.float32)
    pairs = [
        (L.nll_loss(nchw(logp), t(labels)), JL.nll_loss(logp, labels)),
        (L.cross_entropy(nchw(logits), t(labels)), JL.cross_entropy(logits, labels)),
        (L.cross_entropy(nchw(logits), t(np.full_like(labels, 255))),
         JL.cross_entropy(logits, np.full_like(labels, 255))),
        (L.bce_with_logits(t(cls), t(tgt)), JL.bce_with_logits(cls, tgt)),
        (L.mse(t(a), t(b)), JL.mse(a, b)),
        (L.kl_div_log_target(t(a), t(b)), JL.kl_div_log_target(a, b)),
        (L.mse(t(a).bfloat16(), t(b).bfloat16()), JL.mse(jnp.asarray(a, jnp.bfloat16),
                                                          jnp.asarray(b, jnp.bfloat16))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


# ---------------------------------------------------------------- optim


def test_schedules_match_jax():
    steps = np.arange(0, 130)
    pairs = [
        (O.cosine_schedule(1e-3, 100), JO.cosine_schedule(1e-3, 100)),
        (O.warmup_cosine_schedule(1e-3, 1e-5, 20, 100), JO.warmup_cosine_schedule(1e-3, 1e-5, 20, 100)),
    ]
    for got, want in pairs:
        g = np.array([got(int(s)) for s in steps])
        w = np.array([float(want(jnp.int32(s))) for s in steps])
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-10)
    assert O.t_max_for(3, 37, 4) == JO.t_max_for(3, 37, 4) == 30


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_updates_match_optax(kind):
    """Two updates from the same parameters and gradients: the update of
    each against optax's chain at schedule(0) and schedule(1)."""
    rng = np.random.RandomState(2)
    params = {"a": rng.randn(4, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    sched = (1e-2, 50)
    jopt = JO.make_optimizer(kind, JO.cosine_schedule(*sched))
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(t(v.copy())) for k, v in params.items()}
    opt = O.make_optimizer(kind, O.cosine_schedule(*sched), tp.values())
    for g in grads:
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
        for k in params:
            # the updates (~lr) agree to float32 rounding of the parameter
            # they are added to (~1): a few units in its last place
            assert np.abs(np.asarray(upd[k])).max() > 1e-3
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=5e-7)
    assert opt.updates == 2 and opt.param_groups[0]["lr"] == O.cosine_schedule(*sched)(1)


# ---------------------------------------------------------------- objectives


@pytest.fixture(scope="module")
def bise18():
    return models_pair(BACKEND)


def _port_step(m, kind, accum_steps, compute_dtype=None):
    student = copy.deepcopy(m["student"])
    opt = O.make_optimizer(kind, O.cosine_schedule(1e-2, 100), trainable_parameters(student, (FC,)))
    loss = build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5, stage2=True)
    step = make_train_step(loss, opt, accum_steps=accum_steps, compute_dtype=compute_dtype,
                           device="cpu")
    return step, opt, student, teacher_copy(m["teacher"], "cpu", compute_dtype)


def test_bf16_step_keeps_float32_master_state(bise18):
    """compute_dtype=bfloat16: the parameters, the optimizer state and the
    BN running statistics stay float32, the loss is within 5% of the
    float32 step's on the same batch, and falls over three steps."""
    m = bise18
    batch = make_batch(2, HW, seed=5)
    step32, _, s32, t32 = _port_step(m, "sgd", 1)
    l32 = float(step32(s32, t32, batch)["loss"])
    step16, opt, student, teacher = _port_step(m, "sgd", 1, torch.bfloat16)
    assert next(teacher.parameters()).dtype == torch.bfloat16
    losses = [float(step16(student, teacher, batch)["loss"]) for _ in range(3)]
    floats = list(student.parameters()) + [b for b in student.buffers() if b.is_floating_point()]
    floats += [v for st in opt.optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.is_floating_point()]
    assert floats and all(x.dtype == torch.float32 for x in floats)
    assert abs(losses[0] - l32) / l32 < 0.05
    assert losses[-1] < losses[0]
    assert all(isinstance(p, torch.nn.Parameter) for p in student.parameters())


def test_frozen_final_conv(bise18):
    """FST freezes the final conv under both of its names; it leaves the
    optimizer and keeps the teacher's weights through Adam steps."""
    m = bise18
    student = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=3)
    teacher = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=4)
    graft_final_conv(student, teacher, FC)
    params = trainable_parameters(student, (FC,))
    assert student.final_conv is student.conv_out.conv_out
    assert not student.final_conv.weight.requires_grad
    assert all(p is not student.final_conv.weight for p in params)
    assert len(params) == len({id(p) for p in params})
    opt = O.make_optimizer("adam", O.cosine_schedule(1e-3, 10), params)
    step = make_train_step(build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5, stage2=True), opt,
                           device="cpu")
    w0 = student.cp.conv_avg.conv.weight.detach().clone()
    for _ in range(2):
        step(student, teacher_copy(teacher, "cpu"), make_batch(2, HW, seed=6))
    assert torch.equal(student.final_conv.weight, teacher.final_conv.weight)
    assert torch.equal(student.final_conv.bias, teacher.final_conv.bias)
    assert not torch.equal(student.cp.conv_avg.conv.weight, w0)


def test_step_refuses_what_is_not_ported():
    """What the step refuses, as the JAX step does: a mesh that is not a
    DataGroup, bn_mode="master" without a mesh, accum_steps > 1 on more
    than one rank or in master mode, an unknown bn_mode; and the CUDA
    default without a card."""
    from arseg_tpu_torch.parallel import DataGroup

    loss = build_phase2_loss("bisenet", "camvid", CROP_WH, 0.5)
    opt = O.make_optimizer("sgd", O.cosine_schedule(1e-3, 10), [torch.nn.Parameter(torch.ones(1))])
    with pytest.raises(TypeError, match="DataGroup"):
        make_train_step(loss, opt, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(loss, opt, bn_mode="master", device="cpu")
    two = DataGroup(None, 0, 2, torch.device("cpu"))
    for mode in ("sync", "master"):
        with pytest.raises(ValueError, match="single-device path"):
            make_train_step(loss, opt, mesh=two, bn_mode=mode, accum_steps=2, device="cpu")
    with pytest.raises(ValueError):
        make_train_step(loss, opt, bn_mode="other", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(loss, opt)


def test_dropout_draws_from_its_generator():
    from arseg_tpu_torch.nn.functional import Dropout2d, set_dropout_generator

    d = Dropout2d(0.3)
    x = torch.ones(4, 8, 3, 5)
    assert torch.equal(d.eval()(x), x)
    d.train()
    set_dropout_generator(d, torch.Generator().manual_seed(1))
    a = d(x)
    set_dropout_generator(d, torch.Generator().manual_seed(1))
    assert torch.equal(a, d(x))
    # whole channels are kept (scaled by 1/keep) or zeroed
    per_channel = a.reshape(4, 8, -1)
    assert torch.all((per_channel == 0).all(-1) | (per_channel == 1 / 0.7).all(-1))
    assert d.state_dict() == {}


# ---------------------------------------------------------------- trainers and checkpoints


@pytest.fixture(scope="module")
def camvid_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("camvid_train")
    make_camvid_tree(str(root), gop=2, splits=("train", "val", "test"), flow_shape=(96, 128, 2))
    seq = root / "camvid-sequence"
    return dict(seq=str(seq), data=str(seq / "3M-GOP2" / "decoded_GOP2_dist_1"))


TRAIN_KW = dict(backend="resnet18", batch_size=2, scale=0.5, model_type="bisenet",
                dataset="camvid", num_workers=2, verbose=False, cropsize=(64, 48),
                randomscale=(1.0,), device="cpu")


def test_train_phase1_end_to_end(camvid_tree, tmp_path):
    model, history = train_phase1(camvid_tree["data"], str(tmp_path / "exp"), epochs=1,
                                  **TRAIN_KW)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert model.training
    files = os.listdir(tmp_path / "exp")
    assert files == ["PSPNet_resnet18_0.5_1_.pth"]


def _phase2(camvid_tree, models_path, teacher_path, **kw):
    return train_phase2(camvid_tree["data"], camvid_tree["seq"], models_path,
                        teacher_snapshot=teacher_path, ref_gap=2, bitrate=3,
                        flow_shape=(96, 128, 2), **{**TRAIN_KW, **kw})


def test_train_phase2_both_stages_and_resume(camvid_tree, tmp_path):
    """Stage 1 then stage 2 (K1 and K2's plain versions) with the final
    conv frozen at the teacher's; then a resume restores the weights, the
    optimizer (with its update count) and the epoch and best-mIoU
    cursors."""
    teacher = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=False, seed=9)
    tpath = str(tmp_path / "teacher.pth")
    save_checkpoint(tpath, teacher)
    exp = str(tmp_path / "exp")
    model, history = _phase2(camvid_tree, exp, tpath, epochs=2, stage1_epoch=1)
    assert [h["stage"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert torch.equal(model.final_conv.weight, teacher.final_conv.weight)
    saved = sorted(os.listdir(exp))
    assert saved and all(f.startswith("PSPNet_resnet18_0.5_") for f in saved)
    ck = load_checkpoint(os.path.join(exp, saved[-1]))
    epoch = ck["metadata"]["epoch"]
    updates = ck["optimizer"]["param_groups"][0]["updates"]
    assert updates == epoch * 1  # one batch of 2 per epoch (3 frames, drop_last)
    for k, v in ck["state_dict"].items():
        if epoch == 2:
            assert torch.equal(v, model.state_dict()[k]), k

    # what a resume restores: the weights, the optimizer state with its
    # update count, and the cursors
    fresh = build_train_model("bisenet", "camvid", "resnet18", 12, fuse=True, seed=1)
    opt = O.make_optimizer("adam", O.cosine_schedule(1e-3, 10),
                           trainable_parameters(fresh, (FC,)))
    start_epoch, max_miou = trainer._resume(os.path.join(exp, saved[-1]), fresh, opt, False)
    assert (start_epoch, max_miou) == (epoch, ck["metadata"]["miou"])
    assert opt.updates == updates
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, ck["state_dict"][k]), k
    saved_state = ck["optimizer"]["state"]
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, saved_state[i][k]), (i, k)

    exp2 = str(tmp_path / "exp2")
    _, resumed = _phase2(camvid_tree, exp2, tpath, epochs=epoch + 1, stage1_epoch=1,
                         resume=os.path.join(exp, saved[-1]))
    assert [h["epoch"] for h in resumed] == [epoch]
    with pytest.raises(ValueError, match="mutually exclusive"):
        _phase2(camvid_tree, exp2, tpath, resume="a.pth", snapshot="b.pth")


def test_checkpoints_cross_load(bise18, tmp_path):
    """A port checkpoint loads through the JAX package's
    load_torch_checkpoint; a JAX .npz loads into the port."""
    m = bise18
    path = str(tmp_path / "PSPNet_resnet18_0.5_3_.pth")
    opt = O.make_optimizer("adam", O.cosine_schedule(1e-3, 10), m["student"].parameters())
    save_checkpoint(path, m["student"], opt, dict(epoch=3, miou=0.25))
    tree = load_torch_checkpoint(path, BACKEND)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), BACKEND)
    for k, v in m["student"].state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    ck = load_checkpoint(path)
    assert ck["metadata"] == {"epoch": 3, "miou": 0.25} and ck["optimizer"] is not None

    npz = str(tmp_path / "jax.npz")
    j_save_checkpoint(npz, m["tp"], metadata={"scale": 1.0})
    fresh = build_model(BACKEND, fuse=False, device="cpu", seed=7)
    ck = load_weights(fresh, npz, BACKEND)
    assert ck["metadata"] == {"scale": 1.0}
    for k, v in state_dict_from_jax(m["tp"], BACKEND).items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(KeyError):
        load_weights(build_model(BACKEND, fuse=True, device="cpu"), npz, BACKEND)
