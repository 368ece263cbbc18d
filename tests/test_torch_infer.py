"""The port's video-inference command (``arseg_tpu_torch.cli.infer_video``)
on the CPU, float32, against the JAX command (``arseg_tpu.cli.infer_video``)
on the same JAX ``.npz`` checkpoints and inputs (mirrors
``tests/test_infer_cli.py`` and ``tests/test_cli_errors.py``):

- camvid-bise18 and camvid-psp18 (V1, the command's default backend) over a
  synthetic decoded sequence, 48x64, GOP 4, 8 frames: the maps agree with
  the JAX command's on >= AGREEMENT of the pixels; ``--gop_batch 2``,
  ``--prefetch 0`` and a one-process ``--streams`` give the maps of the
  single-GOP run; ``--colorize`` writes ``index_to_rgb`` of them;
  ``--stats_json`` holds every ``StepTimer`` key and the loop's end-to-end
  keys;
- ``--streams --num_devices 2`` and ``--gop_devices 2`` on two gloo
  processes started with torchrun's environment: each stream's maps equal
  that stream served alone, and the frame-parallel maps the single run's;
- ``--video`` with ``--mv_carrier`` (and ``--gop_batch 2``) and with
  ``--mv_analysis``: the maps of the file-fed command over the same
  stream's decoded frames and merged MVs (skipped, as the JAX tests are,
  when the native library cannot be built);
- the flag errors, the JAX command's and the port's own (``--lr_chunk``,
  the torchrun hint);
- both eval engines' histograms with ``prefetch`` 0 and 2;
- importing the command and the host-stage modules loads neither ``jax``
  nor ``arseg_tpu``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from arseg_tpu.cli import infer_video as j_infer
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.cli import infer_video
from arseg_tpu_torch.tools.labels import index_to_rgb
from arseg_tpu_torch.tools.video import NativeUnavailable, load_native

from torch_parity import TEST_THREADS, few_threads, free_port, random_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

REPO = Path(__file__).resolve().parents[1]
H, W = 48, 64
GAP = 4
N = 8  # two GOPs
AGREEMENT = 0.999  # as tests/test_torch_pipeline.py: maps flip only at near ties
BACKENDS = ("camvid-bise18", "camvid-psp18")
RANK_TIMEOUT = 180  # seconds each gloo rank may take
FLOW = ["--flow_shape", str(H // 2), str(W // 2)]
STATS_KEYS = ["frames_per_sec", "max_ms", "mean_ms", "min_ms", "p50_ms", "p95_ms", "steps"]
LOOP_KEYS = ["loop_feed_wait_s", "loop_frames_per_sec", "loop_ms_per_step", "loop_s",
             "loop_steps", "loop_write_wait_s"]


def _sequence(root, seed, n=N, h=H, w=W):
    """n random frames NNNNN.png and int16 merged-MV bins at half size."""
    rng = np.random.RandomState(seed)
    data, flows = root / "decoded", root / "mv"
    data.mkdir(parents=True)
    flows.mkdir()
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(data / f"{i:05d}.png")
        rng.randint(-8, 8, (h // 2, w // 2, 2)).astype(np.int16).tofile(flows / f"{i:05d}.bin")
    return str(data), str(flows)


def _maps(out_dir, n=N):
    names = sorted(os.listdir(out_dir))
    assert names == [f"{i:05d}.png" for i in range(n)], names
    return np.stack([np.asarray(Image.open(os.path.join(out_dir, x))) for x in names])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per backend: JAX .npz checkpoints, the sequence, and the JAX
    command's maps over it (one JAX run per backend)."""
    root = tmp_path_factory.mktemp("infer")
    data, flows = _sequence(root / "seq", 0)
    out = {}
    for k, backend in enumerate(BACKENDS):
        hr, ar = root / f"{backend}-hr.npz", root / f"{backend}-ar.npz"
        j_save_checkpoint(str(hr), random_params(j_build_model(backend, fuse=False), 2 * k))
        j_save_checkpoint(str(ar), random_params(j_build_model(backend, fuse=True), 2 * k + 1))
        common = ["--hr_snapshot", str(hr), "--ar_snapshot", str(ar), "--backend", backend,
                  "--ref_gap", str(GAP), "--dtype", "float32"]
        files = ["--data_path", data, "--flow_path", flows] + FLOW
        j_infer.main(files + common + ["--out_dir", str(root / f"{backend}-jax")])
        infer_video.main(files + common + ["--out_dir", str(root / f"{backend}-port"),
                                           "--device", "cpu"])
        out[backend] = dict(root=root, common=common, files=files,
                            jax=_maps(root / f"{backend}-jax"),
                            port=_maps(root / f"{backend}-port"))
    return out


def _port(tmp_path, s, argv):
    out = tmp_path / "out"
    infer_video.main(argv + s["common"] + ["--out_dir", str(out), "--device", "cpu"])
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_command_matches_jax_command(served, backend):
    s = served[backend]
    assert s["port"].shape == (N, H, W) and s["port"].max() < 12
    assert np.mean(s["port"] == s["jax"]) >= AGREEMENT


@pytest.mark.parametrize("flags", [["--gop_batch", "2"], ["--prefetch", "0"],
                                   ["--io_workers", "1", "--prefetch", "1"]],
                         ids=["gop_batch", "prefetch0", "one_worker"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_modes_give_the_single_gop_maps(served, backend, flags, tmp_path):
    s = served[backend]
    np.testing.assert_array_equal(_maps(_port(tmp_path, s, s["files"] + flags)), s["port"])


def test_colorize_and_stats_json(served, tmp_path):
    s = served["camvid-bise18"]
    stats = tmp_path / "stats.json"
    out = _port(tmp_path, s, s["files"] + ["--colorize", "--stats_json", str(stats)])
    for i in range(N):
        np.testing.assert_array_equal(np.asarray(Image.open(out / f"{i:05d}.png")),
                                      index_to_rgb(s["port"][i]))
    got = json.loads(stats.read_text())
    assert sorted(got) == sorted(STATS_KEYS + LOOP_KEYS) and got["steps"] == N // GAP
    # the loop's clock starts after the warm-up step and ends after the last
    # PNG, so it spans at least the timed steps
    assert got["loop_steps"] == N // GAP - 1
    assert got["loop_s"] * 1e3 >= got["mean_ms"] * got["loop_steps"]
    waits = got["loop_feed_wait_s"] + got["loop_write_wait_s"]
    assert 0 <= waits <= got["loop_s"] - 1e-3 * got["mean_ms"] * got["loop_steps"] + 1e-6
    assert got["loop_frames_per_sec"] == pytest.approx(GAP * got["loop_steps"] / got["loop_s"])


def test_streams_in_one_process(served, tmp_path):
    """Two distinct streams (so crosswired outputs would show): each
    stream's maps equal that stream served alone."""
    s = served["camvid-psp18"]
    other = _sequence(tmp_path / "seq1", 1)
    out = _port(tmp_path, s, ["--streams", f"{s['files'][1]}:{s['files'][3]},"
                                           f"{other[0]}:{other[1]}"] + FLOW)
    np.testing.assert_array_equal(_maps(out / "s0"), s["port"])
    alone = _port(tmp_path / "alone", s, ["--data_path", other[0], "--flow_path", other[1]]
                  + FLOW)
    np.testing.assert_array_equal(_maps(out / "s1"), _maps(alone))


def _gloo_ranks(argv):
    """The command on two processes with torchrun's environment; returns
    their outputs."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": str(TEST_THREADS)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "arseg_tpu_torch.cli.infer_video", *argv, "--device", "cpu"],
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
    return logs


def test_streams_and_gop_devices_on_two_gloo_ranks(served, tmp_path):
    """--streams --num_devices 2: rank r serves and writes stream r alone;
    --gop_devices 2: the GOP's frames over both ranks, rank 0 writes."""
    s = served["camvid-bise18"]
    other = _sequence(tmp_path / "seq1", 1)
    streams = f"{s['files'][1]}:{s['files'][3]},{other[0]}:{other[1]}"
    logs = _gloo_ranks(["--streams", streams, "--num_devices", "2", "--out_dir",
                        str(tmp_path / "streams")] + FLOW + s["common"])
    assert "2 streams x 8 frames" in logs[0] and "streams x" not in logs[1]
    assert sorted(os.listdir(tmp_path / "streams")) == ["s0", "s1"]
    np.testing.assert_array_equal(_maps(tmp_path / "streams" / "s0"), s["port"])
    alone = _port(tmp_path / "alone", s, ["--data_path", other[0], "--flow_path", other[1]]
                  + FLOW)
    np.testing.assert_array_equal(_maps(tmp_path / "streams" / "s1"), _maps(alone))
    logs = _gloo_ranks(s["files"] + ["--gop_devices", "2", "--out_dir",
                                     str(tmp_path / "gop")] + s["common"])
    assert "8 frames ->" in logs[0] and "frames ->" not in logs[1]
    assert np.mean(_maps(tmp_path / "gop") == s["port"]) >= AGREEMENT


# ------------------------------------------------------------------- --video


@pytest.fixture(scope="module")
def native():
    try:
        return load_native()
    except NativeUnavailable as e:
        pytest.skip(f"native lib unavailable: {e}")


def _clip(native, root, n, h, w, analysis=False):
    """n frames of textured sliding content, encoded: (hevc, MV source)."""
    rng = np.random.RandomState(11)
    canvas = rng.randint(0, 255, (h, w + 32, 3), np.uint8).astype(np.int32)
    canvas = ((canvas + np.roll(canvas, 1, 0) + np.roll(canvas, 1, 1)) // 3).astype(np.uint8)
    root.mkdir()
    paths = []
    for i in range(n):
        p = root / f"{i:03d}.png"
        Image.fromarray(canvas[:, 2 * i:2 * i + w]).save(p)
        paths.append(str(p))
    hevc = str(root / "s.hevc")
    if analysis:
        native.encode_analysis(paths, hevc, hevc + ".analysis", gop=GAP, bitrate_kbps=2000)
        return hevc, hevc + ".analysis"
    native.encode(paths, hevc, codec="libx265", gop=GAP, bitrate_kbps=2000)
    native.encode(paths, str(root / "s.264"), codec="libx264", gop=GAP, bitrate_kbps=2000)
    return hevc, str(root / "s.264")


def _as_files(native, hevc, mvs, root, n, h, w, analysis=False):
    """The stream's decoded frames and merged MVs as the file-fed layout."""
    dec, mvdir, data, flows = (root / x for x in ("dec", "mvdump", "decoded", "mv"))
    for d in (dec, mvdir, data, flows):
        d.mkdir()
    native.decode(hevc, str(dec))
    (native.hevc_mvdump if analysis else native.mvdump)(mvs, str(mvdir))
    for i in range(n):
        os.rename(dec / f"decoded-{i + 1:03d}.png", data / f"{i:05d}.png")
    for g0 in range(0, n, GAP):
        bins = np.stack([np.fromfile(mvdir / f"test_{g0 + d:03d}.bin", np.int16).reshape(h, w, 3)
                         for d in range(1, GAP)])
        merged = native.merge_mv(bins, max_ref=GAP)
        for d in range(GAP):
            merged[d].tofile(flows / f"{g0 + d:05d}.bin")
    return ["--data_path", str(data), "--flow_path", str(flows), "--flow_shape", str(h), str(w)]


@pytest.mark.parametrize("mv_flag,h,w", [("--mv_carrier", H, W), ("--mv_analysis", 64, 128)],
                         ids=["carrier", "analysis"])
def test_video_gives_the_file_fed_maps(served, native, tmp_path, mv_flag, h, w):
    """--video: the HEVC stream and its MVs decoded in-process; the maps
    equal the file-fed command's over the same decoded frames and merged
    MVs, also with --gop_batch 2 (uint8 stacks normalised on the device).
    The x265 analysis sidecar needs frames 64 pixels high or more."""
    s = served["camvid-psp18"]
    analysis = mv_flag == "--mv_analysis"
    hevc, mvs = _clip(native, tmp_path / "clip", N, h, w, analysis)

    def run(name, argv):
        out = tmp_path / name
        infer_video.main(argv + s["common"] + ["--out_dir", str(out), "--device", "cpu"])
        return _maps(out)

    files = run("files", _as_files(native, hevc, mvs, tmp_path, N, h, w, analysis))
    np.testing.assert_array_equal(run("video", ["--video", hevc, mv_flag, mvs]), files)
    if not analysis:
        np.testing.assert_array_equal(
            run("video_b2", ["--video", hevc, mv_flag, mvs, "--gop_batch", "2"]), files)


# -------------------------------------------------------------- flag errors


BASE = ["--out_dir", "/tmp/x", "--hr_snapshot", "h", "--ar_snapshot", "a", "--device", "cpu"]
FILES = ["--data_path", "d", "--flow_path", "f"]
ERRORS = {
    "video_requires_carrier": ["--video", "s.hevc"],
    "video_excludes_data_path": ["--video", "s.hevc", "--mv_carrier", "s.264", "--data_path", "d"],
    "carrier_and_analysis": ["--video", "s.hevc", "--mv_carrier", "c", "--mv_analysis", "a"],
    "streams_exclude_video": ["--streams", "a:b", "--video", "s.hevc"],
    "streams_exclude_gop_batch": ["--streams", "a:b", "--gop_batch", "2"],
    "streams_exclude_gop_devices": ["--streams", "a:b", "--gop_devices", "2"],
    "gop_devices_exclude_gop_batch": ["--gop_devices", "2", "--gop_batch", "2"] + FILES,
    "missing_inputs": [],
    "lr_chunk": ["--lr_chunk", "2"] + FILES,
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_flag_errors_like_the_jax_command(name, capsys):
    """Each combination the JAX command refuses, the port refuses with the
    same message (argparse's usage line aside); --lr_chunk is the port's
    own refusal."""
    argv = ERRORS[name]
    with pytest.raises(SystemExit):
        infer_video.main(BASE + argv)
    got = capsys.readouterr().err.strip().splitlines()[-1]
    if name == "lr_chunk":
        assert "--lr_chunk must be 1" in got
        return
    with pytest.raises(SystemExit):
        j_infer.main(BASE[:-2] + argv)
    assert got == capsys.readouterr().err.strip().splitlines()[-1]


def test_video_stream_spec_file_not_found(tmp_path):
    with pytest.raises(SystemExit, match="not found"):
        infer_video.main(BASE + ["--streams", f"{tmp_path}/nope.hevc:{tmp_path}/nope.264"])


@pytest.mark.parametrize("flag", ["--gop_devices", "--num_devices"])
def test_several_devices_in_one_process_say_how_to_launch(flag, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = BASE + ([flag, "2"] + FILES if flag == "--gop_devices"
                   else ["--streams", "a:b,c:d", flag, "2"])
    with pytest.raises(SystemExit, match=f"{flag} 2 runs one process per device: launch with "
                                         "torchrun --nproc_per_node 2 -m "
                                         "arseg_tpu_torch.cli.infer_video"):
        infer_video.main(argv)


def test_default_device_needs_a_card(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    s = served["camvid-bise18"]
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        infer_video.main(s["files"] + s["common"] + ["--out_dir", str(tmp_path)])


# --------------------------------------------------------------- eval prefetch


def test_eval_engines_prefetch_leaves_histograms_unchanged():
    from arseg_tpu_torch.eval import EvalAlterRes, EvalConstRes
    from arseg_tpu_torch.models import build_model

    rng = np.random.RandomState(5)
    batches = []
    for b in (2, 1):
        label = rng.randint(0, 12, (b, H, W)).astype(np.int32)
        label[rng.rand(b, H, W) < 0.05] = 255
        batches.append({"image": rng.randn(b, H, W, 3).astype(np.float32), "label": label,
                        "ref_image": rng.randn(b, H, W, 3).astype(np.float32),
                        "flow": rng.uniform(-4, 4, (b, H, W, 2)).astype(np.float32)})
    hr = build_model("camvid-bise18", seed=0, device="cpu")
    ar = build_model("camvid-bise18", fuse=True, seed=1, device="cpu")
    for prefetch in (0, 2):
        assert EvalAlterRes(device="cpu", prefetch=prefetch).prefetch == prefetch
    const = [EvalConstRes(device="cpu", prefetch=p).histogram(hr, batches, 12) for p in (0, 2)]
    alter = [EvalAlterRes(device="cpu", prefetch=p).histogram(hr, ar, batches, 12)
             for p in (0, 2)]
    for a, b in (const, alter):
        assert int(a.sum()) == int((np.concatenate([x["label"] for x in batches]) != 255).sum())
        assert torch.equal(a, b)


# ------------------------------------------------------------------- imports


def test_imports_load_no_jax():
    """Importing the command and the host stage loads neither jax nor
    arseg_tpu."""
    code = (
        "import sys, json\n"
        "import arseg_tpu_torch.cli.infer_video, arseg_tpu_torch.gop.feeder\n"
        "import arseg_tpu_torch.gop.video_source, arseg_tpu_torch.tools.video\n"
        "import arseg_tpu_torch.tools.labels, arseg_tpu_torch.utils.profiling\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'arseg_tpu'))))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    r = subprocess.run([sys.executable, "-m", "arseg_tpu_torch.cli.infer_video", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0 and "--gop_devices" in r.stdout
