"""One rank of tests/test_torch_parallel.py: run as

    python tests/_torch_parallel_worker.py RANK WORLD PORT DIR

with the repository root on PYTHONPATH. It joins a ``gloo`` group of WORLD
CPU ranks at tcp://127.0.0.1:PORT, reads the inputs the test wrote to
DIR/inputs.pt, drives the port's data-parallel entry points on them and
writes what it got to DIR/rank{RANK}.pt. It imports torch and the port,
never JAX or the JAX package."""

import sys

import numpy as np
import torch
import torch.distributed as dist

from arseg_tpu_torch.data import CamVid, Loader
from arseg_tpu_torch.data.transform import SampleRng
from arseg_tpu_torch.eval import EvalAlterRes, EvalConstRes
from arseg_tpu_torch.eval.protocol import run_protocol
from arseg_tpu_torch.gop import ARPipeline
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.parallel import data_group, shard_batch, synced
from arseg_tpu_torch.train import losses as L
from arseg_tpu_torch.train import optim as O
from arseg_tpu_torch.train.objectives import build_phase2_loss
from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
from arseg_tpu_torch.train.trainer import FINAL_CONV_PATH, train_phase1

BACKEND = "camvid-bise18"
FC = FINAL_CONV_PATH[("bisenet", "camvid")]


def models(inp):
    student = build_model(BACKEND, fuse=True, device="cpu")
    student.load_state_dict(inp["student"], strict=True)
    teacher = build_model(BACKEND, fuse=False, device="cpu")
    teacher.load_state_dict(inp["teacher"], strict=True)
    return student, teacher


def train_step(inp, group, bn_mode):
    """One stage-2 step on this rank's rows: the loss metric, the
    gradients after the ranks' reduction, and the BN running statistics."""
    student, teacher = models(inp)
    opt = O.make_optimizer("sgd", O.cosine_schedule(1e-2, 100), trainable_parameters(student, (FC,)))
    loss = build_phase2_loss("bisenet", "camvid", inp["crop_wh"], 0.5, stage2=True)
    step = make_train_step(loss, opt, mesh=group, bn_mode=bn_mode, device="cpu")
    metrics = step(student, teacher_copy(teacher, "cpu"), shard_batch(inp["batch"], group))
    return dict(loss=float(metrics["loss"]),
                grads={n: p.grad.clone() for n, p in student.named_parameters()
                       if p.grad is not None},
                stats={n: b.clone() for n, b in student.named_buffers() if "running" in n})


def ohem(inp, group):
    """Each case's OHEM: the ranks' shares summed (the whole batch's loss),
    this rank's logits' gradient, and that gradient were each rank to take
    the OHEM of its own rows and the ranks to average."""
    out = {}
    for case, (logits, labels) in inp["ohem"].items():
        mine = shard_batch(dict(x=logits, y=labels), group)
        x, own = (mine["x"].clone().requires_grad_(True) for _ in range(2))
        with synced(group):
            share = L.ohem_ce(x, mine["y"])
        share.backward()
        (L.ohem_ce(own, mine["y"]) / group.size).backward()
        total = share.detach().clone()
        dist.all_reduce(total)
        out[case] = dict(loss=float(total), grad=x.grad, local_grad=own.grad)
    return out


def serving(inp, group):
    student, teacher = models(inp)
    hist = dict(
        const=EvalConstRes(scale=0.5, mesh=group, device="cpu").histogram(
            teacher, inp["eval_batches"], 12),
        alter=EvalAlterRes(scale=0.5, mesh=group, device="cpu").histogram(
            teacher, student, inp["eval_batches"], 12))
    pipe = ARPipeline(teacher, student, scale=0.5, device="cpu")
    s = inp["streams"]
    out = dict(hist=hist, sharded=pipe.sharded_step(group)(s["kf"], s["fr"], s["fx"], s["fy"]))
    g = inp["gop"]
    out["gop_parallel"] = pipe.gop_parallel_step(group)(g["kf"], g["fr"], (g["fx"], g["fy"]))
    if group.rank == 0:  # the one-process paths, for the bit-equality checks
        out["per_stream"] = torch.stack([pipe.gop_step(s["kf"][i:i + 1], s["fr"][i],
                                                       (s["fx"][i], s["fy"][i]))
                                         for i in range(s["kf"].shape[0])])
        out["gop_step"] = pipe.gop_step(g["kf"], g["fr"], (g["fx"], g["fy"]))
    return out


def loader_rows(inp, group):
    """This rank's rows of two epochs of a shuffled, augmented CamVid
    loader (the image's sum per sample, and its label's)."""
    ds = CamVid(inp["camvid"], mode="train", cropsize=(64, 48), randomscale=(0.75, 1.0, 1.5),
                rng=SampleRng())
    loader = Loader(ds, batch_size=4, shuffle=True, num_workers=2, drop_last=True, seed=5,
                    group=group)
    return [[torch.from_numpy(np.stack([b[k].reshape(len(b[k]), -1).astype(np.float64).sum(1)
                                        for k in ("image", "label")]))
             for b in loader] for _ in range(2)]


def main():
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        inp = torch.load(f"{out_dir}/inputs.pt")
        group = data_group(None, 8, device="cpu")
        clamped = data_group(None, 3, device="cpu")
        res = dict(group=(group.rank, group.size),
                   clamped=None if clamped is None else (clamped.rank, clamped.size),
                   one=None if (g1 := data_group(1, device="cpu")) is None else (g1.rank, g1.size))
        res["sync"] = train_step(inp, group, "sync")
        res["master"] = train_step(inp, group, "master")
        res["ohem"] = ohem(inp, group)
        res["serving"] = serving(inp, group)
        res["loader"] = loader_rows(inp, group)
        _, history = train_phase1(inp["camvid"], f"{out_dir}/train2", backend="resnet18",
                                  batch_size=8, epochs=1, scale=0.5, model_type="bisenet",
                                  num_workers=2, verbose=False, cropsize=(64, 48),
                                  randomscale=(1.0,), device="cpu")
        res["history"] = history
        res["protocol"] = run_protocol(**inp["protocol"], mesh=group,
                                       result_dir=f"{out_dir}/protocol2")
        res["jax_imported"] = sorted(m for m in sys.modules if m in ("jax", "arseg_tpu")
                                     or m.startswith(("jax.", "arseg_tpu.")))
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
