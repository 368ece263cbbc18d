"""The port's command line (``arseg_tpu_torch/cli``) on the CPU.

- Flag parity: with the called function replaced by a recorder in both
  packages, the JAX command and the port's, given the same argv (the
  defaults, then every flag set), call ``train_phase1``, ``train_phase2``
  and ``run_protocol`` with the same arguments; ``dtype`` is the torch
  dtype of the same name, and ``device`` (default "cuda") is the port's
  own. ``--num_devices`` above 1 in one process is an error that says how
  to launch under torchrun.
- End to end, the port alone on a synthetic CamVid tree (96x128, GOP 2)
  with camvid-bise18: ``train`` for one epoch, then ``--resume`` for the
  second, as ``tests/test_training.py::test_train_cli_smoke`` checks the
  JAX command; ``train_pair`` stage 2 with that checkpoint as the teacher;
  ``evaluation`` over the two checkpoints, equal to ``run_protocol`` called
  directly; ``convert --to_torch`` and back, bit-equal; ``train
  --num_devices 2`` on two gloo ranks started as torchrun starts them.
- Convert against JAX, for camvid-bise18 and cityscapes-psp18: the port's
  ``--to_torch`` output read by the JAX ``load_torch_checkpoint`` is the
  JAX tree, and the JAX command's ``--to_torch`` output converted by the
  port loads strictly into the port's model with the same tensors.
- Importing each command pulls in neither ``jax`` nor ``arseg_tpu``, and
  ``python -m arseg_tpu_torch.cli.<name> --help`` exits 0.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from arseg_tpu.cli import convert as j_convert
from arseg_tpu.cli import evaluation as j_evaluation
from arseg_tpu.cli import train as j_train
from arseg_tpu.cli import train_pair as j_train_pair
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from arseg_tpu.utils.torch_convert import export_state_dict, load_torch_checkpoint

from arseg_tpu_torch.cli import convert, evaluation, train, train_pair
from arseg_tpu_torch.eval.protocol import run_protocol
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.train.trainer import DATASET_POLICY
from arseg_tpu_torch.utils.checkpoint import load_checkpoint, load_weights, save_checkpoint
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from synthetic_data import make_camvid_tree
from torch_parity import TEST_THREADS, few_threads, flatten, free_port, random_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 180  # seconds each gloo rank may take

# ------------------------------------------------------------- flag parity

TRAIN_ARGV = [
    "--backend", "resnet50", "--snapshot", "S.pth", "--resume", "R.pth", "--batch-size", "8",
    "--alpha", "0.5", "--epochs", "3", "--start-lr", "0.01", "--scale", "0.5",
    "--feat_loss", "mse", "--dataset", "cityscapes", "--model_type", "bisenet",
    "--teacher_snapshot", "T.pth", "--num_devices", "1", "--seed", "7", "--accum_steps", "2",
    "--bn_mode", "master", "--train_dtype", "bfloat16",
]
PARITY = {
    "train": (j_train, train, "train_phase1", ["--data-path", "D", "--models-path", "M"],
              TRAIN_ARGV + ["--cropsize", "64", "48"]),
    "train_pair": (j_train_pair, train_pair, "train_phase2",
                   ["--data-path", "D", "--sequence-path", "Q", "--models-path", "M",
                    "--teacher_snapshot", "T.pth"],
                   TRAIN_ARGV + ["--crop_x", "64", "--crop_y", "48", "--milestones", "1,2",
                                 "--atten_type", "localNoGroup", "--atten_k", "5",
                                 "--stage1_epoch", "1", "--ref_gap", "3", "--bitrate", "5",
                                 "--with_motion", "1", "--fuse_version", "2",
                                 "--flow_shape", "48", "64"]),
    "evaluation": (j_evaluation, evaluation, "run_protocol", [],
                   ["--mode", "1", "0", "1", "--result_dir", "R", "--ckpt_root", "C",
                    "--data_root", "D", "--dataset", "cityscapes", "--backbone", "bise18",
                    "--GOP", "6", "--test_scale", "0.75", "--batch_size", "2",
                    "--num_workers", "1", "--flow_shape", "48", "64", "--num_devices", "1",
                    "--dtype", "bfloat16"]),
}


def _record(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name, lambda **kw: calls.append(kw))
    return calls


@pytest.mark.parametrize("every_flag", [False, True], ids=["defaults", "every flag"])
@pytest.mark.parametrize("name", sorted(PARITY))
def test_flags_make_the_jax_commands_call(name, every_flag, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    j_cli, cli, fn, base, flags = PARITY[name]
    if name != "evaluation":
        base = base + (["--train_dtype", "float32"] if not every_flag else [])
    argv = base + (flags if every_flag else [])
    want, got = _record(monkeypatch, j_cli, fn), _record(monkeypatch, cli, fn)
    j_cli.main(argv)
    cli.main(argv)
    (want,), (got,) = want, got
    assert got.pop("device") == "cuda"
    if "dtype" in want:
        assert (want["dtype"] is None) == (got["dtype"] is None)
        if want["dtype"] is not None:
            assert str(got["dtype"]) == f"torch.{want['dtype']}"
        want.pop("dtype"), got.pop("dtype")
    assert got == want


@pytest.mark.parametrize("name", sorted(PARITY))
def test_num_devices_in_one_process_says_how_to_launch(name, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    _, cli, fn, base, _ = PARITY[name]
    calls = _record(monkeypatch, cli, fn)
    with pytest.raises(SystemExit, match=f"torchrun --nproc_per_node 2 -m "
                                         f"arseg_tpu_torch.cli.{name}"):
        cli.main(base + ["--num_devices", "2"])
    assert calls == []


# -------------------------------------------------------------- end to end


def _run(main, argv):
    """main(argv) with its standard output captured; returns the output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command on one synthetic tree, in the order a user runs them,
    with the camvid policy's crop (which ``train_pair`` takes, having no
    crop flag) cut to the tree's 96x128."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(DATASET_POLICY["camvid"], "cropsize", (128, 96))
        yield _run_all(tmp_path_factory.mktemp("cli"))


def _run_all(root):
    make_camvid_tree(str(root), gop=2, splits=("train", "val", "test"), flow_shape=(96, 128, 2))
    seq = root / "camvid-sequence"
    data = str(seq / "3M-GOP2" / "decoded_GOP2_dist_1")
    common = ["--data-path", data, "--models-path", str(root / "hr"), "--backend", "resnet18",
              "--batch-size", "2", "--model_type", "bisenet", "--cropsize", "64", "48",
              "--num_devices", "1", "--device", "cpu"]
    res = dict(root=root, data=data, common=common)
    res["train"] = _run(train.main, common + ["--epochs", "1"])
    res["hr_files"] = sorted(os.listdir(root / "hr"))
    res["resume"] = _run(train.main, common + ["--epochs", "2", "--resume",
                                               str(root / "hr" / res["hr_files"][0])])
    hr = root / "hr" / res["hr_files"][0]
    res["train_pair"] = _run(train_pair.main, [
        "--data-path", data, "--sequence-path", str(seq), "--models-path", str(root / "ar"),
        "--backend", "resnet18", "--batch-size", "2", "--epochs", "1", "--scale", "0.5",
        "--feat_loss", "mse", "--stage1_epoch", "0", "--with_motion", "1",
        "--model_type", "bisenet", "--teacher_snapshot", str(hr), "--flow_shape", "96", "128",
        "--device", "cpu"])
    res["ar_files"] = sorted(os.listdir(root / "ar"))
    ar = root / "ar" / res["ar_files"][0]
    for mode, src in (("HR", hr), ("AR", ar), ("LR", ar)):
        os.makedirs(root / "ckpt" / "camvid-bise18" / mode)
        os.link(src, root / "ckpt" / "camvid-bise18" / mode / src.name)
    protocol = dict(data_root=str(root), ckpt_root=str(root / "ckpt"), dataset="camvid",
                    backbone="bise18", mode=(1, 1, 1), gop=2, test_scale=0.5, batch_size=1,
                    num_workers=2, flow_shape=(96, 128, 2))
    res["evaluation"] = _run(evaluation.main, [
        "--data_root", str(root), "--ckpt_root", str(root / "ckpt"), "--result_dir",
        str(root / "eval"), "--dataset", "camvid", "--backbone", "bise18", "--mode", "1", "1",
        "1", "--GOP", "2", "--test_scale", "0.5", "--batch_size", "1", "--num_workers", "2",
        "--flow_shape", "96", "128", "--dtype", "float32", "--device", "cpu"])
    res["protocol"] = run_protocol(result_dir=str(root / "eval_direct"), verbose=False,
                                   device="cpu", **protocol)
    _run(convert.main, [str(ar), str(root / "ref.pth"), "--to_torch", "--data_parallel",
                        "--backend", "camvid-bise18"])
    _run(convert.main, [str(root / "ref.pth"), str(root / "back.pth"), "--backend",
                        "camvid-bise18", "--dataset", "camvid", "--scale", "0.5", "--epoch",
                        "1"])
    res["ar"] = ar
    return res


def test_train_cli_and_resume(runs):
    """One epoch writes the checkpoint; --resume runs epoch 2 only."""
    assert runs["hr_files"] == ["PSPNet_resnet18_1.0_1_.pth"]
    assert "[1] it" in runs["train"]
    out = runs["resume"]
    assert "resuming from" in out
    assert "[1] it" not in out, "resume must skip the already-trained epoch"
    assert "[2] it" in out, "resume must run the second epoch"
    ck = load_checkpoint(runs["root"] / "hr" / runs["hr_files"][0])
    assert ck["metadata"]["epoch"] == 1 and ck["optimizer"] is not None


def test_train_pair_cli_stage2(runs):
    assert runs["ar_files"] == ["PSPNet_resnet18_0.5_1_.pth"]
    ck = load_checkpoint(runs["ar"])
    assert ck["metadata"]["stage"] == 2 and ck["metadata"]["phase"] == 2
    # the student was built with the fusion, and its final conv is the teacher's
    teacher = load_checkpoint(runs["root"] / "hr" / runs["hr_files"][0])
    assert any(k.startswith("fuse_attention.") for k in ck["state_dict"])
    for k in ("conv_out.conv_out.weight", "conv_out.conv_out.bias"):
        assert torch.equal(ck["state_dict"][k], teacher["state_dict"][k]), k


def test_evaluation_cli_writes_the_protocols_files(runs):
    root = runs["root"]
    names = sorted(os.listdir(root / "eval"))
    assert names == sorted(os.listdir(root / "eval_direct"))
    assert names == [f"camvid-bise18-{m}-resolution-exp-GOP2-3M-evaluation.txt"
                     for m in ("0.5x", "1.0x", "AR-0.5x")]
    for name in names:
        np.testing.assert_array_equal(np.loadtxt(root / "eval" / name),
                                      np.loadtxt(root / "eval_direct" / name))


def test_convert_cli_round_trip(runs):
    root = runs["root"]
    ref = torch.load(root / "ref.pth", weights_only=True)
    assert all(k.startswith("module.") for k in ref)
    back = load_checkpoint(root / "back.pth")
    want = load_checkpoint(runs["ar"])["state_dict"]
    assert sorted(back["state_dict"]) == sorted(want)
    for k, v in want.items():
        assert torch.equal(back["state_dict"][k], v), k
    assert back["metadata"] == dict(backend="camvid-bise18", dataset="camvid", scale=0.5,
                                    epoch=1, source=str(root / "ref.pth"))


def test_train_cli_on_two_gloo_ranks(runs, tmp_path):
    """``--num_devices 2`` in two processes with torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): the command joins a gloo
    group, trains one epoch over both ranks, and rank 0 alone logs and
    writes the checkpoint."""
    common = [a if a != str(runs["root"] / "hr") else str(tmp_path / "m")
              for a in runs["common"]]
    common[common.index("--num_devices") + 1] = "2"
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": str(TEST_THREADS)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "arseg_tpu_torch.cli.train", *common, "--epochs", "1"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "[1] it 0" in logs[0] and "val mIoU" in logs[0]
    assert "[1] it" not in logs[1] and "val mIoU" not in logs[1]
    assert os.listdir(tmp_path / "m") == ["PSPNet_resnet18_1.0_1_.pth"]


# ---------------------------------------------------------- convert vs JAX


@pytest.fixture(scope="module", params=["camvid-bise18", "cityscapes-psp18"])
def jax_params(request):
    backend = request.param
    return backend, random_params(j_build_model(backend, fuse=True), seed=5)


def test_port_to_torch_reads_back_as_the_jax_tree(jax_params, tmp_path):
    backend, params = jax_params
    model = build_model(backend, fuse=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, backend), strict=True)
    save_checkpoint(tmp_path / "port.pth", model)
    _run(convert.main, [str(tmp_path / "port.pth"), str(tmp_path / "ref.pth"), "--to_torch",
                        "--backend", backend])
    got = flatten(load_torch_checkpoint(str(tmp_path / "ref.pth"), backend))
    want = flatten(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_jax_to_torch_converts_into_the_port_model(jax_params, tmp_path):
    backend, params = jax_params
    j_save_checkpoint(str(tmp_path / "jax.npz"), params, {"scale": 0.5})
    _run(j_convert.main, [str(tmp_path / "jax.npz"), str(tmp_path / "ref.pth"), "--to_torch",
                          "--backend", backend])
    _run(convert.main, [str(tmp_path / "ref.pth"), str(tmp_path / "port.pth"), "--backend",
                        backend])
    model = build_model(backend, fuse=True, device="cpu")
    load_weights(model, tmp_path / "port.pth")
    want = state_dict_from_jax(params, backend)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_convert_refuses_to_export_what_the_jax_exporter_refuses(tmp_path):
    with pytest.raises(NotImplementedError) as jax_err:
        export_state_dict({}, "psp-densenet")
    for backend in ("psp-densenet", "psp-squeezenet"):
        with pytest.raises(NotImplementedError) as err:
            convert.main(["unused.pth", str(tmp_path / "x.pth"), "--to_torch", "--backend",
                          backend])
        assert str(err.value) == str(jax_err.value).replace("psp-densenet", backend)


# ------------------------------------------------------------------ imports


COMMANDS = ("train", "train_pair", "evaluation", "convert")


@pytest.fixture(scope="module")
def help_runs():
    """Each command run as ``__main__`` with --help in one fresh process:
    {name: (its exit code, the jax and arseg_tpu modules imported by then,
    whether it printed its usage)}."""
    code = (
        "import contextlib, io, json, runpy, sys\n"
        "out = {}\n"
        f"for name in {COMMANDS!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module(f'arseg_tpu_torch.cli.{name}', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'arseg_tpu'))\n"
        "        out[name] = (e.code, bad, 'usage:' in buf.getvalue())\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", COMMANDS)
def test_command_imports_no_jax_and_prints_help(name, help_runs):
    assert help_runs[name] == [0, [], True]
