"""The result line's keys, the guard against JAX and the JAX package, and
the refusal to run without a card."""

import subprocess
import sys
import types

from conftest import SEED, SMALL

import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_the_end_to_end_line():
    res, _ = run.execute("cityscapes-bise18.batch4", SEED, 0.5, 0, "cpu", SMALL)
    assert list(res) == KEYS + ["checks"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_the_traced_line():
    res, _ = run.execute("cityscapes-bise18.batch4", SEED, 0.5, 1, "cpu", SMALL)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    # on the CPU no device operation runs: no device share is reported
    assert not any(k.startswith(("idle_share", "k1_", "k2_", "lr_", "fuse_"))
                   for k in res["metrics"])


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "arseg_tpu_torchx", types.ModuleType("arseg_tpu_torchx"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(run.BENCH / "run.py"), "--workload",
                        "cityscapes-bise18.batch4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=run.ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
