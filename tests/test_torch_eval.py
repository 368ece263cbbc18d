"""Parity of the port's accuracy engines (arseg_tpu_torch.eval) with the JAX
package's on the CPU, float32, TF32 off: the confusion-histogram metrics,
and EvalConstRes / EvalAlterRes (camvid-bise18, and camvid-psp18 V1 whose
head is K3's plain version here) on 3 batches of 64x96 frames, the last one
ragged, labels with about 5% of pixels at the ignore label. The JAX engines
run with mesh=None, prefetch=0; their histogram is read through their step
function."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.eval import EvalAlterRes as JAlter, EvalConstRes as JConst
from arseg_tpu.eval import engine as jengine
from arseg_tpu.eval import metrics as jmetrics
from arseg_tpu.models import build_model as j_build_model

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.eval import (EvalAlterRes, EvalConstRes, confusion_update, iou_from_hist,
                                  miou_from_hist)
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import randomize_bn_tree  # noqa: E402

set_f32_parity_mode()

H, W, N_CLASSES, IGNORE = 64, 96, 12, 255
BATCHES = (2, 2, 1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _labels(rng, shape, n_classes, ignore_share=0.05):
    label = rng.randint(0, n_classes, shape)
    label[rng.rand(*shape) < ignore_share] = IGNORE
    return label.astype(np.int32)


# ---------------------------------------------------------------- metrics


def test_metrics_match_jax():
    """Histogram, IoU and mIoU against the JAX metrics: ignore pixels, a
    class absent from both label and prediction (NaN kept by the plain
    mean, skipped by nanmean), and a label past the classes, which the JAX
    scatter drops."""
    rng = np.random.RandomState(0)
    n = 6
    label = _labels(rng, (3, 17, 23), n)
    pred = rng.randint(0, n, label.shape).astype(np.int32)
    label[label == 4] = 0
    pred[pred == 4] = 1  # class 4 absent from both
    label[0, 0, :3] = n  # a label past the classes
    want = np.zeros((n, n), np.float32)
    hist = torch.zeros((n, n), dtype=torch.int64)
    for b in range(3):
        want = jmetrics.confusion_update(jnp.asarray(want), jnp.asarray(label[b]),
                                         jnp.asarray(pred[b]), n, IGNORE)
        hist = confusion_update(hist, t(label[b]), t(pred[b]), n, IGNORE)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want))
    assert hist.dtype == torch.int64
    assert int(hist.sum()) == int(((label != IGNORE) & (label < n)).sum())
    np.testing.assert_allclose(iou_from_hist(hist).numpy(), np.asarray(jmetrics.iou_from_hist(want)),
                               rtol=1e-6, equal_nan=True)
    assert np.isnan(float(miou_from_hist(hist))) and np.isnan(float(jmetrics.miou_from_hist(want)))
    np.testing.assert_allclose(float(miou_from_hist(hist, nanmean=True)),
                               float(jmetrics.miou_from_hist(want, nanmean=True)), rtol=1e-6)


# ---------------------------------------------------------------- engines


def _pair(backend, fuse, seed, **kw):
    jm = j_build_model(backend, fuse=fuse, **kw)
    p = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                          np.random.RandomState(seed))
    tm = build_model(backend, fuse=fuse, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(p, backend), strict=True)
    return jm, p, tm


def _loader(seed):
    """3 batches (2, 2, 1 frames) of normalised images, labels, keyframes and
    flows uniform(-16, 16) at the frames' size."""
    rng = np.random.RandomState(seed)
    return [dict(image=rng.randn(b, H, W, 3).astype(np.float32),
                 label=_labels(rng, (b, H, W), N_CLASSES),
                 ref_image=rng.randn(b, H, W, 3).astype(np.float32),
                 flow=rng.uniform(-16, 16, (b, H, W, 2)).astype(np.float32))
            for b in BATCHES]


def _jax_hist(step, args, batches):
    """The JAX engine's histogram: its step over the batches (dicts in the
    order of the step's arguments), the ragged one padded with ignore-label
    rows as the engine pads it."""
    hist = jnp.zeros((N_CLASSES, N_CLASSES), jnp.float32)
    for batch in jengine._equalized(batches, "label", IGNORE):
        hist = step(*args, hist, *batch.values())
    return np.asarray(hist)


@pytest.fixture(scope="module")
def bise18():
    return _pair("camvid-bise18", False, 0), _pair("camvid-bise18", True, 1)


def test_const_res_matches_jax(bise18):
    (jm, p, tm), _ = bise18
    loader = _loader(3)
    engine = EvalConstRes(scale=0.5, device="cpu")
    hist = engine.histogram(tm, loader, N_CLASSES)
    step = jengine._const_step(jm, 0.5, N_CLASSES, IGNORE, None, None)
    want = _jax_hist(step, (p,), [dict(image=b["image"], label=b["label"]) for b in loader])
    np.testing.assert_array_equal(hist.numpy(), want)
    assert int(hist.sum()) == sum(int((b["label"] != IGNORE).sum()) for b in loader)
    got = engine(tm, loader, N_CLASSES)
    jeng = JConst(scale=0.5, mesh=None, prefetch=0)
    assert abs(got - jeng(jm, p, loader, N_CLASSES)) <= 1e-6


@pytest.mark.parametrize("backend", ["camvid-bise18", "camvid-psp18-V1"])
def test_alter_res_matches_jax(backend, bise18):
    """The AR engine: the HR feature of each frame's keyframe, K2 with one
    source per frame, the LR phase 1, the head (camvid-bise18: the planes
    head; camvid-psp18 V1: K3), the histogram."""
    if backend == "camvid-bise18":
        (jhr, hp, thr), (jlr, lp, tlr) = bise18
    else:
        jhr, hp, thr = _pair("camvid-psp18", False, 2)
        jlr, lp, tlr = _pair("camvid-psp18", True, 3, fuse_version=1)
    loader = _loader(4)
    engine = EvalAlterRes(scale=0.5, device="cpu")
    calls = []
    hist = engine.histogram(thr, tlr, loader, N_CLASSES, progress=lambda: calls.append(1))
    assert len(calls) == len(BATCHES)
    step = jengine._alter_step(jhr, jlr, 0.5, N_CLASSES, IGNORE, None, None)
    want = _jax_hist(step, (hp, lp), [
        dict(image=b["image"], label=b["label"], ref_image=b["ref_image"],
             fx=np.ascontiguousarray(b["flow"][..., 0]),
             fy=np.ascontiguousarray(b["flow"][..., 1])) for b in loader])
    np.testing.assert_array_equal(hist.numpy(), want)
    got = engine(thr, tlr, loader, N_CLASSES)
    jeng = JAlter(scale=0.5, mesh=None, prefetch=0)
    assert abs(got - jeng(jhr, hp, jlr, lp, loader, N_CLASSES)) <= 1e-6
    # the caller's models are not changed: still float32, on the CPU
    assert next(tlr.parameters()).dtype == torch.float32


def test_alter_res_bf16_runs_and_mostly_agrees(bise18):
    """dtype=bfloat16 casts frames and copies of the models; the histogram
    still counts every non-ignored pixel, and most predictions hold."""
    (_, _, thr), (_, _, tlr) = bise18
    loader = _loader(5)[:1]
    f32 = EvalAlterRes(device="cpu").histogram(thr, tlr, loader, N_CLASSES)
    b16 = EvalAlterRes(dtype=torch.bfloat16, device="cpu").histogram(thr, tlr, loader, N_CLASSES)
    assert int(b16.sum()) == int(f32.sum()) == int((loader[0]["label"] != IGNORE).sum())
    assert b16.diagonal().sum() > 0


def test_engines_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for engine in (EvalConstRes, EvalAlterRes):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine()
