"""The port's dataset tools (``arseg_tpu_torch/tools``: ``synth_scenes``,
``mv_fidelity``, ``camvid_decode``, ``preprocess``) and its preprocess
command (``arseg_tpu_torch/cli/preprocess.py``) against the JAX package's.

- ``synth_scenes.generate`` writes the same files, byte for byte, as the
  JAX generator; one chapter's ground-truth merged MVs, warped by the
  port's K2 (its plain version here), beat no warp by more than 3 dB at
  every distance at the dataset's 720x960: the check ``chip_smoke.py``
  phase 16 (b) makes on the card, and where its margin comes from.
- ``mv_fidelity``: the synthetic GOP equal to the JAX one's; ``measure``
  and ``main`` give the JAX rows and meet ``tests/test_native_video.py``'s
  bars (median endpoint error <= 1 px at d 1-3, the warp > 3 dB over no
  warp at every d) with both MV sources.
- ``preprocess``: the output contract the JAX package's preprocessing
  tests check, for CamVid and Cityscapes, the tree loading through the
  port's reader, and every file of it equal to the JAX generator's.
- Codec determinism, checked before holding files equal: two runs of the
  JAX generator (and of ``measure``) over the same frames give the same
  decoded PNGs and MV bins byte for byte, with both x264 and x265, also
  with the CPU loaded by other processes; only x265's analysis sidecar
  (``*.hevc.analysis``, a file in the work directory, which the generators
  do not publish) differs from run to run. So the rows and published
  files are held bit-equal, and the sidecar is not compared.
- ``camvid_decode``: the rename and skip rules, through a stub library.
- Every tool that needs the native library lets ``NativeUnavailable``
  through with make's reason.
- ``cli.preprocess``: each subcommand's flags and defaults call the port's
  tools as the JAX command calls its own; ``labels`` writes the JAX
  command's index maps; the command and the tools import no JAX.

Tests that run the codec skip only when the port's ``load_native``
raises."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from arseg_tpu.cli import preprocess as j_cli
from arseg_tpu.tools import camvid_decode as j_decode
from arseg_tpu.tools import labels as j_labels
from arseg_tpu.tools import mv_fidelity as j_fidelity
from arseg_tpu.tools import preprocess as j_preprocess
from arseg_tpu.tools import synth_scenes as j_synth

from arseg_tpu_torch.cli import preprocess as cli
from arseg_tpu_torch.data.camvid import CamVidWithFlow
from arseg_tpu_torch.tools import camvid_decode, labels, mv_fidelity, preprocess, synth_scenes
from arseg_tpu_torch.tools import video as tvideo

from chip_smoke import PSNR_MARGIN, gt_warp_case, psnr_gains, warp_image
from torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = Path(__file__).resolve().parents[1]
SCENE = "0001TP"  # dataset_start 6690, encoded_start 31 -> offset 6659
H, W = 96, 128
GOP = 4


@pytest.fixture(scope="module")
def native():
    try:
        return tvideo.load_native()
    except tvideo.NativeUnavailable as e:
        pytest.skip(f"native lib unavailable: {e}")


def _files(root):
    """{path relative to root: its bytes, or ('link', its target relative
    to root) for a symbolic link}."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.path.relpath(os.path.realpath(p), os.path.realpath(root)))
            elif os.path.isfile(p):
                out[rel] = Path(p).read_bytes()
    return out


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k] == fb[k], k


# ------------------------------------------------------------ synth_scenes


def test_synth_scenes_writes_the_jax_files(tmp_path):
    kw = dict(n_train=1, n_val=1, n_test=2, h=48, w=64, seed=3, progress=None)
    got = synth_scenes.generate(str(tmp_path / "port"), **kw)
    want = j_synth.generate(str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    _same_tree(tmp_path / "port", tmp_path / "jax")
    names = _files(tmp_path / "port")
    # 4 chapters of 24 frames; test: every distance, train/val: gop - 1 only
    assert sum(k.startswith(os.path.join("camvid-sequence", "frames")) and k.endswith(".png")
               for k in names) == 4 * 24
    assert sum(k.endswith(".bin") for k in names) == 2 * 12 + 2


def test_gt_mv_warp_beats_no_warp(tmp_path):
    """chip_smoke.py phase 16 (b) on the CPU: chapter 0 of the test split at
    720x960, seed 0, each distance warped alone (the card warps all 11 in
    one call; frame i reads only source i, so the values are the same)."""
    synth_scenes.generate(str(tmp_path), n_train=0, n_val=0, n_test=1, h=720, w=960, seed=0,
                          progress=None)
    cur, keys, flows = gt_warp_case(str(tmp_path))
    assert keys.shape == (11, 720, 960, 3) and flows.shape == (11, 720, 960, 2)
    warped = np.concatenate([warp_image(keys[i:i + 1], flows[i:i + 1], "cpu")
                             for i in range(len(keys))])
    gains = psnr_gains(cur, keys, warped)
    assert min(gains) > PSNR_MARGIN, gains


# ------------------------------------------------------------ mv_fidelity


def test_synth_frames_equal_jax(tmp_path):
    paths, gt = mv_fidelity.synth_frames(str(tmp_path / "port"), n=6, h=96, w=160, seed=1)
    j_paths, j_gt = j_fidelity.synth_frames(str(tmp_path / "jax"), n=6, h=96, w=160, seed=1)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in j_paths]
    _same_tree(tmp_path / "port", tmp_path / "jax")
    np.testing.assert_array_equal(gt, j_gt)
    key, frame = (np.asarray(Image.open(p)) for p in (paths[0], paths[3]))
    np.testing.assert_array_equal(mv_fidelity._warp_np(key, gt[3]),
                                  j_fidelity._warp_np(key, gt[3]))
    assert mv_fidelity._psnr(key, frame) == j_fidelity._psnr(key, frame)


@pytest.mark.parametrize("mv_source", ["carrier", "hevc"])
def test_measure_gives_the_jax_rows(native, tmp_path, mv_source):
    paths, gt = mv_fidelity.synth_frames(str(tmp_path / "frames"), n=6, h=96, w=160, seed=1)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    rows = mv_fidelity.measure(paths, gop=6, bitrate_kbps=2000, gt=gt, mv_source=mv_source,
                               workdir=str(tmp_path / "port"))
    want = j_fidelity.measure(paths, gop=6, bitrate_kbps=2000, gt=gt, mv_source=mv_source,
                              workdir=str(tmp_path / "jax"))
    assert rows == want
    for d in ("port", "jax"):
        for f in os.listdir(tmp_path / d):
            if f.endswith(".analysis"):
                os.remove(tmp_path / d / f)  # x265's sidecar differs from run to run
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(rows) == 5
    for r in rows[:3]:
        assert r["epe_p50"] <= 1.0, r
    gains = [r["psnr_warp"] - r["psnr_nowarp"] for r in rows]
    assert min(gains) > 3.0, rows


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def test_mv_fidelity_main_prints_the_jax_rows(native):
    argv = ["--synthetic", "--gop", "6", "--size", "96", "160", "--seed", "1", "--bitrate",
            "2000", "--mv_source", "hevc"]
    got = _stdout(mv_fidelity.main, argv)
    assert got == _stdout(j_fidelity.main, argv)
    assert len(got) == 6 and got[-1]["summary"]["min_psnr_gain_db"] > 3.0


# -------------------------------------------------------------- preprocess


def _canvas(seed):
    rng = np.random.RandomState(seed)
    canvas = rng.randint(0, 255, (H, W + 64, 3), np.uint8).astype(np.int32)
    canvas = (canvas + np.roll(canvas, 1, 0) + np.roll(canvas, 1, 1)) // 3
    return canvas.astype(np.uint8), rng


def _camvid_raw(root):
    """The JAX preprocessing tests' raw tree: 16 video frames with
    global motion and one annotated test frame at encoded index 34
    (dataset index 6693)."""
    canvas, rng = _canvas(3)
    frames_dir = root / "seq" / "frames" / SCENE
    frames_dir.mkdir(parents=True)
    for i, enc in enumerate(range(31, 47)):
        Image.fromarray(canvas[:, 2 * i : 2 * i + W]).save(frames_dir / f"{SCENE}_{enc:06d}.png")
    camvid = root / "camvid"
    (camvid / "test").mkdir(parents=True)
    (camvid / "test_labels_with_ignored").mkdir()
    name = f"{SCENE}_006693.png"
    Image.fromarray(canvas[:, 6 : 6 + W]).save(camvid / "test" / name)
    Image.fromarray(rng.randint(0, 12, (H, W)).astype(np.uint8)).save(
        camvid / "test_labels_with_ignored" / name)


def test_generate_compressed_camvid_contract(native, tmp_path):
    outs = {}
    for side, gen in (("port", preprocess.generate_compressed_camvid),
                      ("jax", j_preprocess.generate_compressed_camvid)):
        root = tmp_path / side
        _camvid_raw(root)
        outs[side] = gen(str(root / "camvid"), str(root / "seq"), ref_gap=GOP, bitrate=1000,
                         splits=("test",), key_dists=(0, 3), progress=lambda *a: None)
    out_root = outs["port"]
    assert out_root == str(tmp_path / "port" / "seq" / f"1M-GOP{GOP}")
    name = f"{SCENE}_006693.png"
    for d in (0, 3):
        p = os.path.join(out_root, f"decoded_GOP{GOP}_dist_{d}", "test", name)
        assert Image.open(p).size == (W, H)
        assert os.path.exists(os.path.join(out_root, f"decoded_GOP{GOP}_dist_{d}",
                                           "test_labels_with_ignored", name))
    assert not os.path.exists(
        os.path.join(out_root, f"MVmap_GOP{GOP}_dist_0", SCENE, name[:-4] + ".bin"))
    mv = np.fromfile(os.path.join(out_root, f"MVmap_GOP{GOP}_dist_3", SCENE, name[:-4] + ".bin"),
                     np.int16)
    assert mv.size == H * W * 2
    assert os.path.exists(os.path.join(out_root, "frames", SCENE, f"{SCENE}_{34 - 3:06d}.png"))
    ds = CamVidWithFlow(os.path.join(out_root, f"decoded_GOP{GOP}_dist_3"), mode="test",
                        load_pair=True, ref_gap=GOP,
                        flow_path=os.path.join(out_root, f"MVmap_GOP{GOP}_dist_3"),
                        ref_path=os.path.join(out_root, "frames"), flow_shape=(H, W, 2))
    assert len(ds) == 1
    sample = ds[0]
    assert sample["image"].shape == sample["ref_image"].shape == (H, W, 3)
    assert sample["flow"].shape == (H, W, 2)
    _same_tree(outs["port"], outs["jax"])


def test_generate_compressed_cityscapes_contract(native, tmp_path):
    """The annotated frame is index 19 of each 30-frame snippet; a window
    ends at the annotated frame."""
    fn = "cityA_000000_000019_leftImg8bit.png"
    outs = {}
    for side, gen in (("port", preprocess.generate_compressed_cityscapes),
                      ("jax", j_preprocess.generate_compressed_cityscapes)):
        root = tmp_path / side
        canvas, _ = _canvas(5)
        (root / "leftImg8bit" / "val" / "cityA").mkdir(parents=True)
        Image.fromarray(canvas[:, :W]).save(root / "leftImg8bit" / "val" / "cityA" / fn)
        seq_city = root / "leftImg8bit_sequence" / "val" / "cityA"
        seq_city.mkdir(parents=True)
        for i, idx in enumerate(range(14, 22)):
            Image.fromarray(canvas[:, 2 * i : 2 * i + W]).save(
                seq_city / f"cityA_000000_{idx:06d}_leftImg8bit.png")
        outs[side] = gen(str(root), ref_gap=GOP, bitrate=1000, splits=("val",),
                         key_dists=(3,), progress=lambda *a: None)
    out_root = outs["port"]
    dec = os.path.join(out_root, f"decoded_GOP{GOP}_dist_3", "leftImg8bit", "val", "cityA", fn)
    assert Image.open(dec).size == (W, H)
    mv = np.fromfile(os.path.join(out_root, f"MVmap_GOP{GOP}_dist_3", "val", "cityA",
                                  fn[:-4] + ".bin"), np.int16)
    assert mv.size == H * W * 2
    assert os.path.exists(os.path.join(out_root, "frames", "val", "cityA",
                                       "cityA_000000_000016_leftImg8bit.png"))
    _same_tree(outs["port"], outs["jax"])


# ------------------------------------------------------------ camvid_decode


class _StubNative:
    """``decode`` writes `frames` 1-based ``decoded-NNN.png`` files, as the
    native decoder does, and records its calls."""

    def __init__(self, frames=3):
        self.frames = frames
        self.calls = []

    def decode(self, src, dst):
        self.calls.append(os.path.basename(src))
        for i in range(1, self.frames + 1):
            Image.fromarray(np.full((4, 6, 3), i, np.uint8)).save(
                os.path.join(dst, f"decoded-{i:03d}.png"))
        return self.frames


def test_camvid_decode_renames_and_skips_as_jax(tmp_path, monkeypatch):
    videos = tmp_path / "videos"
    videos.mkdir()
    for f in ("01TP_extract.avi", "05VD.MXF"):  # 0006R0 and 0016E5 missing
        (videos / f).write_bytes(b"")
    logs = {}
    for side, module in (("port", camvid_decode), ("jax", j_decode)):
        stub = _StubNative()
        monkeypatch.setattr(module, "load_native", lambda stub=stub: stub)
        logs[side] = []
        module.decode_camvid_videos(str(videos), str(tmp_path / side), progress=logs[side].append)
        assert stub.calls == ["01TP_extract.avi", "05VD.MXF"]
    assert logs["port"] == logs["jax"]
    assert [m.split(":")[0] for m in logs["port"]] == ["0001TP", "skip 0006R0", "skip 0016E5",
                                                       "Seq05VD"]
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port" / "frames" / "Seq05VD")) == \
        [f"Seq05VD_{i:06d}.png" for i in range(3)]


@pytest.fixture
def broken_native(tmp_path, monkeypatch):
    """The port's native build pointed at a Makefile that fails as make
    fails without the FFmpeg headers."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    (native_dir / "Makefile").write_text(
        "all:\n\t@echo 'arsegvid.cpp:1: fatal error: libavcodec/avcodec.h: No such file' >&2;"
        " exit 2\n")
    monkeypatch.setattr(tvideo, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(tvideo, "_BUILD_DIR", str(native_dir / "build"))
    monkeypatch.setattr(tvideo, "_LIB_PATH", str(native_dir / "build" / "libarsegvid.so"))
    return tmp_path


TOOL_CALLS = {
    "camvid_decode": lambda d: camvid_decode.decode_camvid_videos(str(d), str(d / "out")),
    "preprocess camvid": lambda d: preprocess.generate_compressed_camvid(str(d), str(d)),
    "preprocess cityscapes": lambda d: preprocess.generate_compressed_cityscapes(str(d)),
    "mv_fidelity": lambda d: mv_fidelity.measure([]),
}


@pytest.mark.parametrize("tool", sorted(TOOL_CALLS))
def test_tools_say_why_the_native_library_is_missing(broken_native, tool):
    with pytest.raises(tvideo.NativeUnavailable, match="libavcodec/avcodec.h: No such file"):
        TOOL_CALLS[tool](broken_native)


# ------------------------------------------------------------ cli.preprocess


CLI_CASES = {
    "camvid": (["camvid", "--camvid_root", "C", "--sequence_root", "S"],
               ["--gop", "6", "--bitrate", "1000", "--fps", "25", "--splits", "test",
                "--mv_source", "carrier"]),
    "cityscapes": (["cityscapes", "--cityscapes_root", "R"],
                   ["--gop", "6", "--bitrate", "2000", "--fps", "25", "--splits", "val",
                    "--mv_source", "carrier"]),
    "labels": (["labels", "L"], ["--out", "O"]),
    "decode": (["decode", "V", "O"], []),
}
# (command, the module it imports the function from, the function)
TARGETS = {
    "camvid": ("preprocess", "generate_compressed_camvid"),
    "cityscapes": ("preprocess", "generate_compressed_cityscapes"),
    "labels": ("labels", "convert_label_dir"),
    "decode": ("camvid_decode", "decode_camvid_videos"),
}


def _recorder(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append((a, kw)))
    return calls


@pytest.mark.parametrize("every_flag", [False, True], ids=["defaults", "every flag"])
@pytest.mark.parametrize("command", sorted(CLI_CASES))
def test_cli_calls_what_the_jax_command_calls(command, every_flag, monkeypatch):
    base, flags = CLI_CASES[command]
    module, name = TARGETS[command]
    port_module = {"preprocess": preprocess, "labels": labels, "camvid_decode": camvid_decode}
    jax_module = {"preprocess": j_preprocess, "labels": j_labels, "camvid_decode": j_decode}
    got = _recorder(monkeypatch, port_module[module], name)
    want = _recorder(monkeypatch, jax_module[module], name)
    argv = base + (flags if every_flag else [])
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
        j_cli.main(argv)
    assert len(got) == 1 and got == want


def test_cli_labels_writes_the_jax_index_maps(tmp_path):
    src = tmp_path / "rgb"
    src.mkdir()
    rng = np.random.RandomState(0)
    colors = np.array(list(labels.CAMVID_COLORMAP.values()) + [[17, 17, 17]], np.uint8)
    for i in range(2):
        Image.fromarray(colors[rng.randint(0, len(colors), (12, 16))]).save(src / f"{i}.png")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["labels", str(src), "--out", str(tmp_path / "port")])
        j_cli.main(["labels", str(src), "--out", str(tmp_path / "jax")])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port")) == 2


def test_tools_and_command_import_no_jax(tmp_path):
    """In one fresh process: the tools imported, ``python -m
    arseg_tpu_torch.cli.preprocess --help`` and ``... labels`` run as
    ``__main__``; then no ``jax`` or ``arseg_tpu`` module is loaded."""
    src = tmp_path / "rgb"
    src.mkdir()
    Image.fromarray(np.zeros((4, 6, 3), np.uint8)).save(src / "0.png")
    code = (
        "import contextlib, io, json, runpy, sys\n"
        "import arseg_tpu_torch.tools.synth_scenes, arseg_tpu_torch.tools.mv_fidelity\n"
        "import arseg_tpu_torch.tools.preprocess, arseg_tpu_torch.tools.camvid_decode\n"
        "codes = []\n"
        f"for argv in (['--help'], ['labels', {str(src)!r}]):\n"
        "    sys.argv = ['preprocess'] + argv\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(io.StringIO()):\n"
        "            runpy.run_module('arseg_tpu_torch.cli.preprocess', run_name='__main__')\n"
        "        codes.append(0)\n"
        "    except SystemExit as e:\n"
        "        codes.append(e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'arseg_tpu'))\n"
        "print(json.dumps([codes, bad]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120, check=True)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[0, 0], []]
    assert os.listdir(str(src) + "-idx-with-ignored") == ["0.png"]
