"""The reference agrees with the program's CPU path (its plain versions of
the kernels) at a small size, in float32: the same weights through
``load_state_dict``, the same inputs."""

import torch
from conftest import SEED, SMALL, TRAIN_SMALL

import run
from harness import models
from reference.model import BiSeNetV1


def small_float32(extra=None):
    return {"config": {**SMALL["config"], "dtype": "float32"},
            "traffic": {**SMALL["traffic"], **(extra or {})}}


def test_served_maps_agree_with_the_reference():
    _, info = run.execute("cityscapes-bise18.batch4", SEED, 0.5, 0, "cpu", small_float32())
    r = info["readings"]
    assert r["frames_checked"] >= 3
    assert r["gap_max"] < 1e-3 and r["disagree"] < 1e-3


def test_training_steps_agree_with_the_reference():
    _, info = run.execute("camvid-bise18.train16", SEED, 0.5, 0, "cpu", TRAIN_SMALL)
    r = info["readings"]
    assert r["loss_gap_first"] < 1e-5 and r["grad_gap"] < 1e-3 and r["grad_angle"] < 1e-6


def test_one_state_dict_loads_into_both_models():
    cfg = {**SMALL["config"], "port_backend": "camvid-bise18", "n_classes": 12,
           "reference": "reference.model.BiSeNetV1", "reference_kwargs": {"aux": True, "win": 7}}
    sd = models.weights(cfg, SEED, "ar", True, "cpu")
    port = models.loaded(models.port_model(cfg, True, "cpu"), sd)
    ref = models.loaded(BiSeNetV1(12, with_fuse=True), sd)
    x = torch.randn(1, 3, 64, 96)
    with torch.no_grad():
        assert torch.allclose(port.forward_key(x)[0], ref.eval().key(x)[0], atol=1e-4)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(run.BENCH) / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("arseg_tpu_torch", "arseg_tpu", "jax"), path
