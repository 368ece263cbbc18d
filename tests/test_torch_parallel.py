"""The port's data-parallel layer (``arseg_tpu_torch/parallel``) in a
``gloo`` group of 2 CPU ranks, against the JAX package's mesh paths on a
2-device CPU mesh (``conftest.py`` gives 8 devices).

The ranks are two processes running ``tests/_torch_parallel_worker.py``,
which imports torch and the port only; this process writes their inputs,
computes the JAX side while they run, and compares. camvid-bise18 with JAX
weights (BN statistics randomised) loaded into the port, float32:

- a phase-2 stage-2 step at 64x64, global batch 8 (4 a rank), train mode,
  against ``make_train_step(mesh=data_mesh(2), bn_mode="sync")``: the loss
  and every gradient within ``train_parity.py``'s bounds (from the port's
  own float32 error on the whole batch), the BN running statistics within
  rtol 1e-5, atol 1e-6; and ``bn_mode="master"``: replica 0's running
  statistics, as ``tests/test_parallel_eval_train.py`` holds the JAX one,
  within rtol 1e-4, atol 1e-5; the loss and the gradients, averaged over
  the ranks, within the bounds of each rank's own rows (the JAX gradient
  divided by 2: its master step sums the replicas' gradients, a JAX-side
  fact that ``test_jax_master_gradient_is_world_times_the_mean`` shows);
- OHEM over the whole batch, on batches where each rank's own OHEM gives
  another gradient: the value within 1e-6 relative and each rank's logits'
  gradient within 1e-5 relative L2 of the JAX ``ohem_ce`` of the whole batch;
- both eval engines with a mesh against the JAX sharded engines, a
  ragged last batch included: histograms equal;
- ``sharded_step`` (2 streams) and ``gop_parallel_step`` (3 frames, padded
  to 4) against the JAX ones at 64x96: class maps agree >= 0.999, as the
  pipeline parity tests hold a GOP, and equal to the port's own
  ``gop_step`` on each stream and on the GOP;
- ``data_group`` clamping, and the loader's rank slices, whose union is the
  one-process batch, augmentation included;
- ``train_phase1`` on 2 ranks: the same history on both, its loss within
  1e-5 relative of one process's, one checkpoint written (by rank 0);
- ``run_protocol`` on 2 ranks: one process's numbers and files.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arseg_tpu.eval import engine as jengine
from arseg_tpu.gop import ARPipeline as JPipeline
from arseg_tpu.parallel import data_mesh, shard_batch
from arseg_tpu.train import losses as JL
from arseg_tpu.train.objectives import build_phase2_loss as j_phase2_loss
from arseg_tpu.train.step import make_train_step as j_make_train_step

from arseg_tpu_torch.data import CamVid, Loader
from arseg_tpu_torch.data.transform import SampleRng
from arseg_tpu_torch.eval.protocol import run_protocol
from arseg_tpu_torch.parallel import DataGroup, data_group
from arseg_tpu_torch.train.objectives import build_phase2_loss
from arseg_tpu_torch.train.trainer import train_phase1
from arseg_tpu_torch.utils.checkpoint import save_checkpoint
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from synthetic_data import FLOW_SHAPE, make_camvid_tree
from torch_parity import free_port, rel_l2
from train_parity import bounds, make_batch, models_pair

REPO = Path(__file__).resolve().parents[1]
WORLD, BACKEND, HW, N_CLASSES, IGNORE = 2, "camvid-bise18", (64, 64), 12, 255
G, PIPE_HW = 3, (64, 96)
AGREEMENT = 0.999
RANK_TIMEOUT = 300  # seconds a rank may take; the ranks run while this process computes JAX
PROTOCOL_KW = dict(dataset="camvid", backbone="bise18", gop=2, test_scale=0.5, batch_size=1,
                   num_workers=2, verbose=False, flow_shape=FLOW_SHAPE, device="cpu")
TRAIN_KW = dict(backend="resnet18", batch_size=8, epochs=1, scale=0.5, model_type="bisenet",
                num_workers=2, verbose=False, cropsize=(64, 48), randomscale=(1.0,),
                device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ohem_cases(seed=11):
    """Logits NHWC [8, 16, 16, 12] and labels, every pixel confident but a
    share of 'hard' ones confidently wrong (loss ~8 > -log 0.7): 'enough'
    has 2% hard on rank 0's rows (fewer than its n_min) and 50% on rank
    1's, enough over the whole batch; 'top' has none on rank 0's rows and
    10% on rank 1's (enough there), too few over the whole batch, so the
    kth largest loss decides. Each rank's own OHEM then takes the other
    branch from the whole batch's."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, N_CLASSES, (8, 16, 16)).astype(np.int32)
    labels[rng.rand(8, 16, 16) < 0.1] = IGNORE
    target = np.where(labels == IGNORE, 0, labels)
    cases = {}
    for case, shares in (("enough", (0.02, 0.5)), ("top", (0.0, 0.1))):
        hard = rng.rand(8, 16, 16) < np.repeat(shares, 4).reshape(8, 1, 1)
        cls = np.where(hard, (target + 1) % N_CLASSES, target)
        logits = 0.1 * rng.randn(8, 16, 16, N_CLASSES) + 8.0 * np.eye(N_CLASSES)[cls]
        cases[case] = (logits.astype(np.float32), labels)
    return cases


def _eval_batches(seed=3):
    """Two batches, of 4 and 3 frames (the last ragged over 2 ranks)."""
    rng = np.random.RandomState(seed)
    out = []
    for b in (4, 3):
        label = rng.randint(0, N_CLASSES, (b, *HW)).astype(np.int32)
        label[rng.rand(b, *HW) < 0.05] = IGNORE
        out.append(dict(image=rng.randn(b, *HW, 3).astype(np.float32), label=label,
                        ref_image=rng.randn(b, *HW, 3).astype(np.float32),
                        flow=rng.uniform(-16, 16, (b, *HW, 2)).astype(np.float32)))
    return out


def _pipe_inputs(seed=5):
    rng = np.random.RandomState(seed)
    h, w = PIPE_HW
    streams = dict(kf=rng.randn(2, h, w, 3), fr=rng.randn(2, G - 1, h, w, 3),
                   fx=rng.uniform(-4, 4, (2, G - 1, h, w)), fy=rng.uniform(-4, 4, (2, G - 1, h, w)))
    gop = dict(kf=rng.randn(1, h, w, 3), fr=rng.randn(3, h, w, 3), fx=rng.uniform(-4, 4, (3, h, w)),
               fy=rng.uniform(-4, 4, (3, h, w)))
    as32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return as32(streams), as32(gop)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write the inputs, start the 2 ranks; ``run["ranks"]()`` waits for
    them and returns their results. This process's torch runs on 2 threads
    meanwhile (restored after the module): with the ranks and the other
    test workers on the same cores, torch's default of a thread per core
    made this file's small ops an order of magnitude slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("parallel")
    # 8 training frames (two loader batches of 4, one step of 8), and 2
    # validation and test frames
    tree = make_camvid_tree(str(root / "camvid"), gop=2, splits=("train",),
                            dataset_idxs=[6690 + 10 * i for i in range(8)])
    make_camvid_tree(str(root / "camvid"), gop=2, splits=("val", "test"),
                     dataset_idxs=[6770, 6780])
    m = models_pair(BACKEND)
    for mode, model, scale in (("HR", m["teacher"], "1.0"), ("AR", m["student"], "0.5"),
                               ("LR", m["student"], "0.5")):
        save_checkpoint(str(root / "ckpt" / BACKEND / mode / f"PSPNet_resnet18_{scale}_1_.pth"),
                        model)
    batch = make_batch(8, HW, seed=4)
    # rows of very different scale, so that each rank's own BN statistics differ
    batch["image"] *= np.linspace(0.2, 3.0, 8, dtype=np.float32).reshape(8, 1, 1, 1)
    streams, gop = _pipe_inputs()
    inputs = dict(student=m["student"].state_dict(), teacher=m["teacher"].state_dict(),
                  crop_wh=HW, batch={k: _t(v) for k, v in batch.items()},
                  ohem={k: (_t(x).permute(0, 3, 1, 2).contiguous(), _t(y))
                        for k, (x, y) in _ohem_cases().items()},
                  eval_batches=[{k: _t(v) for k, v in b.items()} for b in _eval_batches()],
                  streams={k: _t(v) for k, v in streams.items()},
                  gop={k: _t(v) for k, v in gop.items()},
                  camvid=os.path.join(tree, "decoded_GOP2_dist_1"),
                  protocol=dict(PROTOCOL_KW, data_root=str(root / "camvid"),
                                ckpt_root=str(root / "ckpt")))
    torch.save(inputs, root / "inputs.pt")
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_parallel_worker.py"),
                               str(r), str(WORLD), str(port), str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    results = []

    def ranks():
        if not results:
            for r, p in enumerate(procs):
                try:
                    log, _ = p.communicate(timeout=RANK_TIMEOUT)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    raise AssertionError(f"rank {r} did not finish in {RANK_TIMEOUT} s")
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            results.extend(torch.load(root / f"rank{r}.pt") for r in range(WORLD))
        return results

    yield dict(m=m, batch=batch, streams=streams, gop=gop, tree=tree, root=root, ranks=ranks,
               protocol=inputs["protocol"])
    torch.set_num_threads(threads)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _capture():
    """An optax transformation that applies no update and keeps the
    gradient as its state: the JAX step then returns its gradients."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _jax_step(run, bn_mode):
    """(loss, {name: gradient}, {name: running statistic}) of the JAX step
    over data_mesh(2) on the sharded batch."""
    m, mesh = run["m"], data_mesh(2)
    loss = j_phase2_loss(m["js"], m["jt"], "bisenet", "camvid", HW, 0.5, stage2=True)
    opt = _capture()
    step = j_make_train_step(loss, opt, mesh=mesh, bn_mode=bn_mode)
    params, grads, metrics = step(m["sp"], opt.init(m["sp"]), m["tp"],
                                  shard_batch(run["batch"], mesh), jax.random.PRNGKey(0))
    sd = lambda t: {k: v.numpy() for k, v in
                    state_dict_from_jax(jax.tree_util.tree_map(np.asarray, t), BACKEND).items()}
    return float(metrics["loss"]), sd(grads), {k: v for k, v in sd(params).items()
                                               if "running" in k}


def _check_step(got, jloss, jgrads, loss_tol, grad_tol):
    assert abs(got["loss"] - jloss) <= loss_tol * abs(jloss), (got["loss"], jloss, loss_tol)
    worst = [(n, d, grad_tol[n]) for n, g in got["grads"].items()
             if (d := rel_l2(g.double().numpy(), jgrads[n])) > grad_tol[n]]
    assert not worst, worst[:6]
    assert len(got["grads"]) > 100


def test_sync_step_matches_jax(run):
    m = run["m"]
    jloss, jgrads, jstats = _jax_step(run, "sync")
    ploss = build_phase2_loss("bisenet", "camvid", HW, 0.5, stage2=True)
    loss_tol, grad_tol = bounds(ploss, m["student"], m["teacher"], run["batch"], True)
    ranks = run["ranks"]()
    for r in ranks:  # the ranks' reduced loss and gradients are the same on both
        assert r["sync"]["loss"] == ranks[0]["sync"]["loss"]
        for n, g in r["sync"]["grads"].items():
            assert torch.equal(g, ranks[0]["sync"]["grads"][n]), n
        _check_step(r["sync"], jloss, jgrads, loss_tol, grad_tol)
        for n, s in r["sync"]["stats"].items():
            np.testing.assert_allclose(s.numpy(), jstats[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_master_step_keeps_replica0_stats_as_jax(run):
    m = run["m"]
    jloss, jgrads, jstats = _jax_step(run, "master")
    ploss = build_phase2_loss("bisenet", "camvid", HW, 0.5, stage2=True)
    halves = [{k: v[4 * i:4 * (i + 1)] for k, v in run["batch"].items()} for i in range(2)]
    per_rank = [bounds(ploss, m["student"], m["teacher"], h, True) for h in halves]
    loss_tol = max(b[0] for b in per_rank)
    grad_tol = {n: max(b[1][n] for b in per_rank) for n in per_rank[0][1]}
    # the JAX master step's gradient is WORLD x the mean of the replicas'
    # (test_jax_master_gradient_is_world_times_the_mean); the port's is the mean
    jgrads = {n: g / WORLD for n, g in jgrads.items()}
    ranks = run["ranks"]()
    for r in ranks:
        _check_step(r["master"], jloss, jgrads, loss_tol, grad_tol)
        for n, s in r["master"]["stats"].items():
            np.testing.assert_allclose(s.numpy(), jstats[n], rtol=1e-4, atol=1e-5, err_msg=n)
            assert torch.equal(s, ranks[0]["master"]["stats"][n]), n
    # replica 0's statistics are not the whole batch's
    diffs = [float((s - ranks[0]["sync"]["stats"][n]).abs().max())
             for n, s in ranks[0]["master"]["stats"].items()]
    assert max(diffs) > 1e-3, max(diffs)


def test_jax_master_gradient_is_world_times_the_mean():
    """A JAX-side fact the port does not copy: inside the JAX master step's
    shard_map, the gradient of a replicated parameter is already summed over
    the devices (the transpose of its implicit broadcast), so the step's
    pmean returns the sum of the replicas' gradients, not their mean
    (``arseg_tpu/train/step.py:118-121``). The port's master step averages
    them, as nn.DataParallel's gradient of the whole batch's mean is."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(w, x):
        return jax.lax.pmean(jax.grad(lambda w: jnp.mean(w * x))(w), "data")

    x = jnp.arange(4.0)
    step = jax.jit(shard_map(local, mesh=data_mesh(WORLD), in_specs=(P(), P("data")),
                             out_specs=P()))
    assert float(step(jnp.float32(1.0), x)) == WORLD * float(x.mean())


@pytest.mark.parametrize("case", ["enough", "top"])
def test_global_ohem_matches_jax_on_the_whole_batch(run, case):
    logits, labels = _ohem_cases()[case]
    loss, grad = jax.value_and_grad(lambda x: JL.ohem_ce(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    want_grad = np.asarray(grad).transpose(0, 3, 1, 2)
    for i, r in enumerate(run["ranks"]()):
        got, want = r["ohem"][case], want_grad[4 * i:4 * (i + 1)]
        assert abs(got["loss"] - float(loss)) <= 1e-6 * abs(float(loss)), (got["loss"], float(loss))
        assert rel_l2(got["grad"].double().numpy(), want) <= 1e-5
        # each rank's own OHEM of its rows (averaged over the ranks) would
        # give another gradient
        assert rel_l2(got["local_grad"].double().numpy(), want) > 0.1


def _jax_hist(step, args, batches):
    """The JAX sharded engine's histogram: each batch padded to a multiple
    of the mesh and to the first batch's rows, as the engine pads it."""
    hist = jnp.zeros((N_CLASSES, N_CLASSES), jnp.float32)
    padded = (jengine._pad_to_multiple(b, 2, "label", IGNORE) for b in batches)
    for batch in jengine._equalized(padded, "label", IGNORE):
        hist = step(*args, hist, *batch.values())
    return np.asarray(hist)


def test_sharded_eval_engines_match_jax(run):
    m, mesh = run["m"], data_mesh(2)
    batches = _eval_batches()
    const = jengine._const_step(m["jt"], 0.5, N_CLASSES, IGNORE, None, mesh)
    want_const = _jax_hist(const, (m["tp"],), [dict(image=b["image"], label=b["label"])
                                                for b in batches])
    alter = jengine._alter_step(m["jt"], m["js"], 0.5, N_CLASSES, IGNORE, None, mesh)
    want_alter = _jax_hist(alter, (m["tp"], m["sp"]), [
        dict(image=b["image"], label=b["label"], ref_image=b["ref_image"],
             fx=np.ascontiguousarray(b["flow"][..., 0]),
             fy=np.ascontiguousarray(b["flow"][..., 1])) for b in batches])
    scored = sum(int((b["label"] != IGNORE).sum()) for b in batches)
    for r in run["ranks"]():
        hist = r["serving"]["hist"]
        assert hist["const"].dtype == torch.int64 and int(hist["const"].sum()) == scored
        np.testing.assert_array_equal(hist["const"].numpy(), want_const)
        np.testing.assert_array_equal(hist["alter"].numpy(), want_alter)


def test_sharded_step_matches_jax(run):
    m, mesh, s = run["m"], data_mesh(2), run["streams"]
    jpipe = JPipeline(m["jt"], m["js"], scale=0.5)
    want = np.asarray(jpipe.sharded_step(mesh)(m["tp"], m["sp"], *(jnp.asarray(s[k]) for k in
                                                                     ("kf", "fr", "fx", "fy"))))
    ranks = run["ranks"]()
    for r in ranks:
        got = r["serving"]["sharded"]
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (2, G, *PIPE_HW)
        assert np.mean(got.numpy() == want) >= AGREEMENT
        assert torch.equal(got, ranks[0]["serving"]["per_stream"])


def test_gop_parallel_step_matches_jax(run):
    m, g = run["m"], run["gop"]
    jpipe = JPipeline(m["jt"], m["js"], scale=0.5)
    want = np.asarray(jpipe.gop_parallel_step(data_mesh(2))(
        m["tp"], m["sp"], jnp.asarray(g["kf"]), jnp.asarray(g["fr"]),
        (jnp.asarray(g["fx"]), jnp.asarray(g["fy"]))))
    ranks = run["ranks"]()
    for r in ranks:
        got = r["serving"]["gop_parallel"]
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (4, *PIPE_HW)
        assert np.mean(got.numpy() == want) >= AGREEMENT
        assert torch.equal(got, ranks[0]["serving"]["gop_step"])


def test_data_group_clamps_as_data_mesh(run):
    """8 rows take both ranks; 3 rows clamp to one rank (rank 1 is left
    out); n_devices=1 is rank 0 alone. Without a process group, one
    process is a group of one."""
    ranks = run["ranks"]()
    assert [r["group"] for r in ranks] == [(0, 2), (1, 2)]
    assert [r["clamped"] for r in ranks] == [(0, 1), None]
    assert [r["one"] for r in ranks] == [(0, 1), None]
    alone = data_group(None, 8, device="cpu")
    assert isinstance(alone, DataGroup) and (alone.rank, alone.size) == (0, 1)
    assert alone.process_group is None
    with pytest.raises(ValueError, match="ranks"):
        data_group(2, device="cpu")


@pytest.mark.parametrize("device, local_rank, want", [
    (None, None, 1), ("cuda", None, 1), ("cuda", "3", 1), ("cuda", "2", 0), ("cuda:0", "3", 0)])
def test_data_group_gives_a_cuda_device_its_index(monkeypatch, device, local_rank, want):
    """A CUDA device without an index (None, or "cuda" as users pass it)
    becomes cuda:{LOCAL_RANK modulo the cards}, else the current device;
    an index given is kept. The group's device is made the current one
    (torch.cuda.set_device refuses a device without an index). Two cards,
    current device 1, faked: this machine has none."""
    made_current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    group = data_group(device=device)
    assert group.device == torch.device("cuda", want)
    assert made_current == [torch.device("cuda", want)]


def test_loader_rank_slices_make_the_one_process_batch(run):
    """Two epochs of a shuffled CamVid loader with random scale, crop,
    flip and colour: the ranks' rows, put together, are the one-process
    loader's, sample for sample."""
    ds = CamVid(os.path.join(run["tree"], "decoded_GOP2_dist_1"), mode="train",
                cropsize=(64, 48), randomscale=(0.75, 1.0, 1.5), rng=SampleRng())
    loader = Loader(ds, batch_size=4, shuffle=True, num_workers=3, drop_last=True, seed=5)
    want = [[np.stack([b[k].reshape(4, -1).astype(np.float64).sum(1) for k in ("image", "label")])
             for b in loader] for _ in range(2)]
    ranks = run["ranks"]()
    assert len(want[0]) == 2
    for e in range(2):
        for i, w in enumerate(want[e]):
            got = np.concatenate([r["loader"][e][i].numpy() for r in ranks], axis=1)
            np.testing.assert_array_equal(got, w)
    assert not np.array_equal(want[0][0], want[1][0])  # another order and draw each epoch
    with pytest.raises(ValueError, match="seed"):
        Loader(ds, batch_size=4, drop_last=True, group=DataGroup(None, 0, 2, torch.device("cpu")))


def test_train_phase1_on_two_ranks(run):
    """train_phase1 with the default num_devices (both ranks): every rank
    has the same history (the loss all-reduced, validation's histogram
    summed), its loss is one process's, and rank 0 alone wrote its one
    checkpoint."""
    ranks = run["ranks"]()
    assert ranks[0]["history"] == ranks[1]["history"] and len(ranks[0]["history"]) == 1
    assert all(r["jax_imported"] == [] for r in ranks)
    _, one = train_phase1(os.path.join(run["tree"], "decoded_GOP2_dist_1"),
                          str(run["root"] / "train1"), **TRAIN_KW)
    got, want = ranks[0]["history"][0]["loss"], one[0]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert os.listdir(run["root"] / "train2") == ["PSPNet_resnet18_0.5_1_.pth"]


def test_protocol_on_two_ranks_writes_one_processs_files(run):
    """run_protocol with the group (HR, AR and LR over GOP 2): both ranks
    return the one-process numbers, and rank 0 alone wrote the files, equal
    to one process's."""
    ranks = run["ranks"]()
    want = run_protocol(**run["protocol"], result_dir=str(run["root"] / "protocol1"))
    assert ranks[0]["protocol"] == ranks[1]["protocol"] == want
    names = sorted(os.listdir(run["root"] / "protocol1"))
    assert len(names) == 3 and names == sorted(os.listdir(run["root"] / "protocol2"))
    for name in names:
        np.testing.assert_array_equal(np.loadtxt(run["root"] / "protocol2" / name),
                                      np.loadtxt(run["root"] / "protocol1" / name))
