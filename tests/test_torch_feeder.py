"""The port's host stage of video inference on the CPU, against the JAX
package's: ``gop/feeder.py`` (``GOPFeeder``, ``AsyncWriter``; mirrors
``tests/test_gop_feeder.py``), ``gop/video_source.py`` (``VideoGOPSource``;
mirrors ``tests/test_video_source.py``, skipped like it when the native
library cannot be built), ``tools/video.py``'s loader, ``tools/labels.py``,
``data/camvid.CamVidWithFlowTest`` and ``utils/profiling.py``.

On the CPU the feeder's staging (pinned buffers, the side stream, the copy
events) is skipped: ``chip_smoke.py`` phase 15 drives it on the card. The
staging helper's CPU path (``data/loader.device_prefetch``) and the
allocator a sequential source writes into are held here."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from arseg_tpu.data.camvid import CamVidWithFlowTest as JCamVidWithFlowTest
from arseg_tpu.gop.feeder import _assemble as j_assemble
from arseg_tpu.tools import labels as jlabels
from arseg_tpu.utils.profiling import StepTimer as JStepTimer

from arseg_tpu_torch.data.camvid import CamVidWithFlowTest
from arseg_tpu_torch.data.loader import device_prefetch
from arseg_tpu_torch.gop.feeder import AsyncWriter, GOPFeeder, _assemble
from arseg_tpu_torch.tools import labels
from arseg_tpu_torch.tools import video as tvideo
from arseg_tpu_torch.utils import profiling

from torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

H, W = 24, 32
GAP = 4
N = 12  # three GOPs
JOIN_TIMEOUT = 30  # seconds a thread under test may take to finish


@pytest.fixture()
def seq_dir(tmp_path):
    rng = np.random.RandomState(0)
    data = tmp_path / "decoded"
    flows = tmp_path / "mv"
    data.mkdir()
    flows.mkdir()
    for i in range(N):
        Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8)).save(data / f"{i:05d}.png")
        rng.randint(-8, 8, (H // 2, W // 2, 2)).astype(np.int16).tofile(flows / f"{i:05d}.bin")
    return data, flows


def _dataset(seq_dir, cls=CamVidWithFlowTest):
    data, flows = seq_dir
    return cls(str(data), ref_gap=GAP, ref_path=str(data), flow_path=str(flows),
               flow_shape=(H // 2, W // 2, 2))


def _equal_items(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ readers


def test_camvid_with_flow_test_matches_jax(seq_dir):
    ds, jds = _dataset(seq_dir), _dataset(seq_dir, JCamVidWithFlowTest)
    assert ds.data == jds.data and len(ds) == N
    for i in (0, 5, N - 1):
        got, want = ds[i], jds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_labels_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 12, (9, 11)).astype(np.uint8)
    idx[0, :3] = 255
    np.testing.assert_array_equal(labels.index_to_rgb(idx), jlabels.index_to_rgb(idx))
    color = labels.index_to_rgb(idx)
    color[1, 1] = (1, 2, 3)  # a colour outside the map
    np.testing.assert_array_equal(labels.rgb_to_index(color), jlabels.rgb_to_index(color))
    assert labels.CAMVID_COLORMAP == jlabels.CAMVID_COLORMAP
    src = tmp_path / "rgb"
    src.mkdir()
    Image.fromarray(color).save(src / "a.png")
    out, jout = labels.convert_label_dir(str(src), str(tmp_path / "p")), \
        jlabels.convert_label_dir(str(src), str(tmp_path / "j"))
    np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(out, "a.png"))),
                                  np.asarray(Image.open(os.path.join(jout, "a.png"))))


@pytest.mark.parametrize("skip", [0, 1, 3])
def test_step_timer_summary_matches_jax(skip):
    times = [0.5, 0.012, 0.010, 0.031, 0.011, 0.015]
    frames = [12, 12, 24, 12, 12, 11]
    timer, jtimer = profiling.StepTimer(12), JStepTimer(12)
    for t in (timer, jtimer):
        t.times, t.frames = list(times), list(frames)
    got, want = timer.summary(skip), jtimer.summary(skip)
    assert sorted(got) == ["frames_per_sec", "max_ms", "mean_ms", "min_ms", "p50_ms", "p95_ms",
                           "steps"]
    assert got == want
    assert timer.fps == jtimer.fps


def test_step_timer_times_steps():
    timer = profiling.StepTimer(frames_per_step=12)
    for n in (12, 24):
        with timer.step(n):
            time.sleep(0.01)
    with timer:
        pass
    assert timer.frames == [12, 24, 12] and all(t >= 0 for t in timer.times)
    assert timer.times[0] >= 0.01


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        with profiling.annotate("gop.test_span"):
            torch.ones(4) + 1
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "gop.test_span" in text


# ------------------------------------------------------------------- feeder


@pytest.mark.parametrize("workers", [1, 3])
def test_feeder_matches_serial(seq_dir, workers):
    ds, jds = _dataset(seq_dir), _dataset(seq_dir, JCamVidWithFlowTest)
    feeder = GOPFeeder(ds, GAP, num_workers=workers, depth=2, stage=False)
    assert len(feeder) == N // GAP
    seen = []
    for gi, kf, fr, (fx, fy) in feeder:
        seen.append(gi)
        want = j_assemble(jds, gi * GAP, GAP)
        _equal_items((kf, fr, fx, fy), want)
        _equal_items(_assemble(ds, gi * GAP, GAP), want)
        assert kf.dtype == np.float32 and fx.flags.c_contiguous
    assert seen == list(range(N // GAP))


def test_feeder_stage_on_the_cpu_yields_host_arrays(seq_dir):
    """stage=True on the CPU device skips the card's staging: the items are
    the host arrays of stage=False."""
    ds = _dataset(seq_dir)
    out = list(GOPFeeder(ds, GAP, depth=2, stage=True, device="cpu"))
    assert [gi for gi, *_ in out] == list(range(N // GAP))
    for gi, kf, fr, (fx, fy) in out:
        assert isinstance(kf, np.ndarray)
        _equal_items((kf, fr, fx, fy), _assemble(ds, gi * GAP, GAP))


def test_feeder_stage_defaults_to_the_card(seq_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        GOPFeeder(_dataset(seq_dir), GAP, stage=True)


def test_feeder_gop_batch(seq_dir):
    """gop_batch=2 over 3 GOPs: one [2,...] stack + the tail as a single
    GOP, covering every frame exactly once in order."""
    ds = _dataset(seq_dir)
    out = list(GOPFeeder(ds, GAP, depth=2, stage=False, gop_batch=2))
    assert [gi for gi, *_ in out] == [0, 2]
    gi, kf, fr, (fx, fy) = out[0]
    assert kf.shape == (2, H, W, 3) and fr.shape == (2, GAP - 1, H, W, 3)
    assert fx.shape == (2, GAP - 1, H // 2, W // 2)
    for b in range(2):
        ekf, efr, efx, efy = _assemble(ds, b * GAP, GAP)
        _equal_items((kf[b], fr[b], fx[b], fy[b]), (ekf[0], efr, efx, efy))
    gi, kf, fr, _ = out[1]
    assert gi == 2 and kf.shape == (1, H, W, 3) and fr.shape == (GAP - 1, H, W, 3)
    np.testing.assert_array_equal(kf, _assemble(ds, 2 * GAP, GAP)[0])


class _Counting:
    """A sequence dataset of tiny frames that records the highest sample
    index read; ``fail_at`` raises there."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.read = n, fail_at, -1
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise RuntimeError("boom")
        with self.lock:
            self.read = max(self.read, i)
        return {"image": np.full((2, 3, 3), i, np.float32),
                "flow": np.full((2, 3, 2), i, np.float32)}


def test_feeder_error_propagates():
    with pytest.raises(RuntimeError, match="boom"):
        list(GOPFeeder(_Counting(8, fail_at=5), GAP, num_workers=2, stage=False))


def test_feeder_bounds_host_lookahead():
    """While the consumer holds GOP k, no worker assembles past GOP
    k + depth + num_workers."""
    depth, workers, g = 1, 2, 2
    ds = _Counting(40)
    it = iter(GOPFeeder(ds, g, num_workers=workers, depth=depth, stage=False))
    for k in range(3):
        gi, *_ = next(it)
        time.sleep(0.2)  # let the workers run ahead as far as they may
        assert ds.read // g <= gi + depth + workers, (gi, ds.read)
    it.close()


def test_feeder_stress_many_workers():
    """More workers than cores with a short switch interval: every GOP comes
    once, in order, with its own samples."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ds = _Counting(2 * 60)
        done = []

        def run():
            for gi, kf, fr, (fx, fy) in GOPFeeder(ds, 2, num_workers=16, depth=1, stage=False):
                assert kf[0, 0, 0, 0] == 2 * gi and fr[0, 0, 0, 0] == 2 * gi + 1
                assert fx[0, 0, 0] == 2 * gi + 1
                done.append(gi)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive(), "feeder deadlocked"
    finally:
        sys.setswitchinterval(old)
    assert done == list(range(60))


# ------------------------------------------------------------------- writer


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_async_writer(tmp_path, kind):
    out = tmp_path / "out"
    out.mkdir()
    rng = np.random.RandomState(1)
    preds = rng.randint(0, 12, (GAP, H, W)).astype(np.int32)
    w = AsyncWriter(str(out), colorize=False)
    w.put(preds if kind == "numpy" else torch.from_numpy(preds), [f"{i:05d}" for i in range(GAP)])
    w.close()
    for i in range(GAP):
        arr = np.asarray(Image.open(out / f"{i:05d}.png"))
        np.testing.assert_array_equal(arr, preds[i].astype(np.uint8))


def test_async_writer_colorize(tmp_path):
    rng = np.random.RandomState(3)
    preds = torch.from_numpy(rng.randint(0, 12, (2, H, W)).astype(np.int32))
    w = AsyncWriter(str(tmp_path), colorize=True)
    w.put(preds, ["a", "b"])
    w.close()
    for k, name in enumerate("ab"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"{name}.png")),
                                      jlabels.index_to_rgb(preds[k].numpy()))


def test_async_writer_error_surfaces_no_deadlock(tmp_path):
    """A failing writer (bad out_dir) must drain its bounded queue and
    re-raise at put()/close() instead of deadlocking the producer."""
    errors = []

    def run():
        w = AsyncWriter(str(tmp_path / "missing" / "dir"), colorize=False)
        preds = np.zeros((GAP, H, W), np.int32)
        try:
            for _ in range(8):  # > queue depth
                w.put(preds, [f"{j:05d}" for j in range(GAP)])
            w.close()
        except OSError as e:
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_TIMEOUT)
    assert not t.is_alive(), "writer deadlocked"
    assert errors and isinstance(errors[0], FileNotFoundError)


# ------------------------------------------------------------- native video


def test_load_native_says_why(tmp_path, monkeypatch):
    """A library that cannot be built: the error carries make's stderr."""
    native = tmp_path / "native"
    native.mkdir()
    (native / "Makefile").write_text("all:\n\t@echo no FFmpeg headers here >&2; exit 3\n")
    monkeypatch.setattr(tvideo, "_NATIVE_DIR", str(native))
    monkeypatch.setattr(tvideo, "_BUILD_DIR", str(native / "build"))
    monkeypatch.setattr(tvideo, "_LIB_PATH", str(native / "build" / "libarsegvid.so"))
    with pytest.raises(tvideo.NativeUnavailable, match="no FFmpeg headers here"):
        tvideo.load_native()
    with pytest.raises(tvideo.NativeUnavailable, match="not built"):
        tvideo.load_native(auto_build=False)
    (native / "build" / "libarsegvid.so").write_text("not a library")
    with pytest.raises(tvideo.NativeUnavailable, match="cannot load"):
        tvideo.load_native()


VH, VW, N_GOPS = 48, 64, 3
# the analysis sidecar's reader needs x265's 64-pixel CTU, which x265 keeps
# only for frames at least 64 pixels high
AH, AW = 64, 128
MEAN = (0.4, 0.45, 0.5)
STD = (0.3, 0.25, 0.2)


@pytest.fixture(scope="module")
def native():
    try:
        return tvideo.load_native()
    except tvideo.NativeUnavailable as e:
        pytest.skip(f"native lib unavailable: {e}")


def _frames(root, rng, n, h, w, width_pad):
    canvas = rng.randint(0, 255, (h, w + width_pad, 3), np.uint8).astype(np.int32)
    canvas = ((canvas + np.roll(canvas, 1, 0) + np.roll(canvas, 1, 1)) // 3).astype(np.uint8)
    paths = []
    for f in range(n):
        p = root / f"{f:03d}.png"
        Image.fromarray(canvas[:, 2 * f:2 * f + w]).save(p)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def streams(native, tmp_path_factory):
    """N_GOPS*GAP + 2 frames of textured sliding content (the +2 tail
    checks partial-GOP dropping) encoded as the HEVC stream + the H.264 MV
    carrier, plus the file-based decode/mvdump artifacts to compare with."""
    root = tmp_path_factory.mktemp("vidsrc")
    paths = _frames(root, np.random.RandomState(3), N_GOPS * GAP + 2, VH, VW, 64)
    hevc, carrier = str(root / "s.hevc"), str(root / "s.264")
    native.encode(paths, hevc, codec="libx265", gop=GAP, bitrate_kbps=2000)
    native.encode(paths, carrier, codec="libx264", gop=GAP, bitrate_kbps=2000)
    dec, mv = root / "dec", root / "mv"
    dec.mkdir()
    mv.mkdir()
    native.decode(hevc, str(dec))
    native.mvdump(carrier, str(mv))
    return root, hevc, carrier, dec, mv


def _video_items(hevc, mvs, **kw):
    from arseg_tpu.gop.video_source import VideoGOPSource as JVideoGOPSource

    from arseg_tpu_torch.gop.video_source import VideoGOPSource

    got = list(VideoGOPSource(hevc, mvs, GAP, MEAN, STD, **kw).iter_gops())
    want = list(JVideoGOPSource(hevc, mvs, GAP, MEAN, STD, **kw).iter_gops())
    return got, want


def test_iter_gops_matches_jax_and_file_artifacts(native, streams):
    from arseg_tpu_torch.data import transform as T

    root, hevc, carrier, dec, mv = streams
    gops, jgops = _video_items(hevc, carrier)
    assert len(gops) == len(jgops) == N_GOPS  # the 2-frame tail is dropped
    for gi, (item, jitem) in enumerate(zip(gops, jgops)):
        _equal_items(item, jitem)
        kf, frames, fx, fy = item
        assert kf.shape == (1, VH, VW, 3) and frames.shape == (GAP - 1, VH, VW, 3)
        assert fx.shape == (GAP - 1, VH, VW) and fx.dtype == np.float32
        for k in range(GAP):
            png = np.asarray(Image.open(dec / f"decoded-{gi * GAP + k + 1:03d}.png"))
            np.testing.assert_array_equal(kf[0] if k == 0 else frames[k - 1],
                                          T.normalize(png, MEAN, STD))
        bins = np.stack([np.fromfile(mv / f"test_{gi * GAP + d:03d}.bin", dtype=np.int16)
                         .reshape(VH, VW, 3) for d in range(1, GAP)])
        merged = native.merge_mv(bins, max_ref=GAP)
        np.testing.assert_array_equal(fx, merged[1:, ..., 0].astype(np.float32) / 4.0)
        np.testing.assert_array_equal(fy, merged[1:, ..., 1].astype(np.float32) / 4.0)


def test_analysis_mvs_match_jax_and_file_artifacts(native, tmp_path):
    """mv_kind="analysis": MVs from the HEVC encode's x265 analysis sidecar,
    equal to the JAX source's and to the merge of ``hevc_mvdump``'s bins."""
    paths = _frames(tmp_path, np.random.RandomState(4), 2 * GAP, AH, AW, 32)
    hevc = str(tmp_path / "a.hevc")
    native.encode_analysis(paths, hevc, hevc + ".analysis", gop=GAP, bitrate_kbps=2000)
    gops, jgops = _video_items(hevc, hevc + ".analysis", mv_kind="analysis")
    assert len(gops) == 2
    for item, jitem in zip(gops, jgops):
        _equal_items(item, jitem)
    mv = tmp_path / "mv"
    mv.mkdir()
    native.hevc_mvdump(hevc + ".analysis", str(mv))
    bins = np.stack([np.fromfile(mv / f"test_{GAP + d:03d}.bin", dtype=np.int16)
                     .reshape(AH, AW, 3) for d in range(1, GAP)])
    merged = native.merge_mv(bins, max_ref=GAP)
    np.testing.assert_array_equal(gops[1][2], merged[1:, ..., 0].astype(np.float32) / 4.0)


def test_iter_gops_writes_into_the_callers_buffers(streams):
    """iter_gops(alloc=...) fills the buffers alloc hands out (the feeder's
    pinned tensors when it stages) with the items of the default path."""
    from arseg_tpu_torch.gop.video_source import VideoGOPSource

    root, hevc, carrier, dec, mv = streams
    for device_normalize in (False, True):
        src = VideoGOPSource(hevc, carrier, GAP, MEAN, STD, device_normalize=device_normalize)
        handed = []

        def alloc(shape, dtype):
            t = torch.from_numpy(np.full(shape, 7, dtype))
            handed.append(t)
            return t, t.numpy()

        got = list(src.iter_gops(alloc=alloc))
        want = list(src.iter_gops())
        assert len(got) == len(want) == N_GOPS
        assert [id(t) for item in got for t in item] == [id(t) for t in handed]
        for item, witem in zip(got, want):
            for t, w in zip(item, witem):
                assert t.dtype == torch.from_numpy(w).dtype
                np.testing.assert_array_equal(t.numpy(), w)


def test_device_prefetch_stacks_lists_and_passes_other_values():
    """The staging helper GOPFeeder shares with training and eval, on the
    CPU: a tuple keeps its order, a list of arrays becomes one tensor
    stacked along a new first axis, an int passes unchanged."""
    rng = np.random.RandomState(0)
    items = [(k, rng.rand(2, 3).astype(np.float32),
              [rng.rand(2, 3).astype(np.float32) for _ in range(3)]) for k in range(4)]
    out = list(device_prefetch(iter(items), "cpu", size=2))
    assert len(out) == 4
    for (k, a, rows), (gk, ga, gstack) in zip(items, out):
        assert gk == k
        np.testing.assert_array_equal(ga.numpy(), a)
        assert gstack.shape == (3, 2, 3)
        np.testing.assert_array_equal(gstack.numpy(), np.stack(rows))


def test_gop_feeder_over_video_source(streams):
    """GOPFeeder drives sequential sources (iter_gops): ordered gi,
    identical items, gop_batch stacking with the ragged tail emitted
    GOP-at-a-time."""
    from arseg_tpu_torch.gop.video_source import VideoGOPSource

    root, hevc, carrier, dec, mv = streams
    direct = list(VideoGOPSource(hevc, carrier, GAP, MEAN, STD).iter_gops())
    items = list(GOPFeeder(VideoGOPSource(hevc, carrier, GAP, MEAN, STD), GAP, stage=False))
    assert [gi for gi, *_ in items] == list(range(N_GOPS))
    for (gi, kf, fr, (fx, fy)), want in zip(items, direct):
        _equal_items((kf, fr, fx, fy), want)
    batched = list(GOPFeeder(VideoGOPSource(hevc, carrier, GAP, MEAN, STD), GAP, stage=False,
                             gop_batch=2))
    assert len(batched) == 2
    gi0, kf0, fr0, _ = batched[0]
    assert gi0 == 0 and kf0.shape == (2, VH, VW, 3) and fr0.shape == (2, GAP - 1, VH, VW, 3)
    np.testing.assert_array_equal(kf0[1], direct[1][0][0])
    gi1, kf1, fr1, _ = batched[1]
    assert gi1 == 2 and fr1.shape == (GAP - 1, VH, VW, 3)


def test_mismatched_streams_error(native, streams, tmp_path):
    """A carrier with a different GOP count, or another resolution, must
    raise, not silently truncate."""
    from arseg_tpu_torch.gop.video_source import VideoGOPSource

    root, hevc, carrier, dec, mv = streams
    rng = np.random.RandomState(5)
    paths = []
    for f in range(GAP):  # one GOP only
        p = tmp_path / f"{f:03d}.png"
        Image.fromarray(rng.randint(0, 255, (VH, VW, 3), np.uint8)).save(p)
        paths.append(str(p))
    short = str(tmp_path / "short.264")
    native.encode(paths, short, codec="libx264", gop=GAP)
    with pytest.raises(RuntimeError, match="GOP counts differ"):
        list(VideoGOPSource(hevc, short, GAP, MEAN, STD).iter_gops())
    small = []
    for f in range(GAP):
        p = tmp_path / f"s{f:03d}.png"
        Image.fromarray(rng.randint(0, 255, (VH // 2, VW // 2, 3), np.uint8)).save(p)
        small.append(str(p))
    other = str(tmp_path / "small.264")
    native.encode(small, other, codec="libx264", gop=GAP)
    with pytest.raises(RuntimeError, match="resolutions differ"):
        list(VideoGOPSource(hevc, other, GAP, MEAN, STD).iter_gops())
    with pytest.raises(ValueError, match="carrier\\|analysis"):
        VideoGOPSource(hevc, carrier, GAP, MEAN, STD, mv_kind="other")


def test_device_normalize_matches_host(streams):
    """device_normalize=True (raw uint8 + ARPipeline(normalize=...)) must
    reproduce the host-normalised float32 feed bit for bit at float32:
    uint8->f32, /255, -mean, /std are exact IEEE ops on both sides."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.gop.video_source import VideoGOPSource
    from arseg_tpu_torch.models import build_model

    root, hevc, carrier, dec, mv = streams
    host = list(VideoGOPSource(hevc, carrier, GAP, MEAN, STD).iter_gops())
    raw = list(VideoGOPSource(hevc, carrier, GAP, MEAN, STD, device_normalize=True).iter_gops())
    assert raw[0][0].dtype == np.uint8
    pipe = ARPipeline(build_model("camvid-psp18", seed=0, device="cpu"),
                      build_model("camvid-psp18", fuse=True, seed=1, device="cpu"),
                      scale=0.5, normalize=(MEAN, STD), device="cpu")
    for (kf_h, fr_h, fx, fy), (kf_u, fr_u, _, _) in zip(host[:1], raw[:1]):
        np.testing.assert_array_equal(pipe._frames(fr_u).permute(0, 2, 3, 1).numpy(), fr_h)
        p_host = pipe.gop_step(kf_h, fr_h, (fx, fy))
        p_raw = pipe.gop_step(kf_u, fr_u, (fx, fy))
        assert torch.equal(p_host, p_raw)


def _wait_threads(before):
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    return threading.active_count()


def test_abandoned_iteration_stops_decode_threads(streams):
    """Breaking out of iter_gops early must stop both decode threads —
    closing the generator aborts the native decodes from their callbacks
    instead of leaking blocked producers; the same through GOPFeeder."""
    from arseg_tpu_torch.gop.video_source import VideoGOPSource

    root, hevc, carrier, dec, mv = streams
    before = threading.active_count()
    it = VideoGOPSource(hevc, carrier, GAP, MEAN, STD, lookahead=1).iter_gops()
    next(it)
    it.close()
    assert _wait_threads(before) <= before, "decode threads leaked"
    before = threading.active_count()
    feeder = iter(GOPFeeder(VideoGOPSource(hevc, carrier, GAP, MEAN, STD, lookahead=1), GAP,
                            stage=False))
    next(feeder)
    feeder.close()
    assert _wait_threads(before) <= before, "feeder producer leaked"
