"""The port's readers and loader (arseg_tpu_torch.data) against the JAX
package's on synthetic CamVid and Cityscapes trees: every sample equal, in
val/test mode and in train mode with the augmentations drawn from one seed;
the Loader's order and batches for a seed; the device stage; and that
importing the port's training code imports neither PIL nor cv2."""

import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from arseg_tpu.data import CamVid as JCamVid, CamVidWithFlow as JCamVidWithFlow
from arseg_tpu.data import CityScapes as JCityScapes, CityScapesWithFlow as JCityScapesWithFlow
from arseg_tpu.data import Loader as JLoader
from arseg_tpu.data.camvid import read_flow_bin as j_read_flow_bin

from arseg_tpu_torch.data import (CamVid, CamVidWithFlow, CityScapes, CityScapesWithFlow, Loader,
                                  device_prefetch)
from arseg_tpu_torch.data.camvid import label_existence, read_flow_bin, ref_frame_path

from synthetic_data import CS_CITY, make_camvid_tree, make_cityscapes_tree

H, W = 96, 128
FLOW = (H, W, 2)  # flows at the frames' size, as the trainers read them
CROP = (64, 48)  # (W, H)
SCALES = (0.75, 1.0, 1.25)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def camvid(tmp_path_factory):
    root = tmp_path_factory.mktemp("camvid")
    make_camvid_tree(str(root), gop=2, splits=("train", "val", "test"), flow_shape=FLOW)
    seq = root / "camvid-sequence" / "3M-GOP2"
    return dict(data=str(seq / "decoded_GOP2_dist_1"), flow=str(seq / "MVmap_GOP2_dist_1"),
                ref=str(seq / "frames"))


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """The synthetic tree's val split, copied to a train split as well."""
    root = tmp_path_factory.mktemp("cityscapes")
    seq = make_cityscapes_tree(str(root), gop=2)
    data = os.path.join(seq, "decoded_GOP2_dist_1")
    for sub in ("leftImg8bit", "gtFine"):
        shutil.copytree(os.path.join(data, sub, "val"), os.path.join(data, sub, "train"))
    mv = os.path.join(seq, "MVmap_GOP2_dist_1")
    shutil.copytree(os.path.join(mv, "val"), os.path.join(mv, "train"))
    frames = os.path.join(seq, "frames")
    shutil.copytree(os.path.join(frames, "val"), os.path.join(frames, "train"))
    return dict(data=data, flow=mv, ref=frames)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _datasets(cls, jcls, *args, **kw):
    """The port's and the JAX package's dataset, each with its own
    random.Random(0)."""
    return cls(*args, rng=random.Random(0), **kw), jcls(*args, rng=random.Random(0), **kw)


CAMVID_CASES = {
    "val": dict(mode="val"),
    "train": dict(mode="train", cropsize=CROP, randomscale=SCALES),
    "pair-train": dict(mode="train", cropsize=CROP, randomscale=SCALES, load_pair=True,
                       ref_gap=2),
}


@pytest.mark.parametrize("case", sorted(CAMVID_CASES))
def test_camvid_matches_jax(camvid, case):
    kw = dict(CAMVID_CASES[case])
    if kw.get("load_pair"):
        kw["ref_path"] = camvid["ref"]
    ds, jds = _datasets(CamVid, JCamVid, camvid["data"], **kw)
    assert len(ds) == len(jds) > 0
    for _ in range(2):  # a second pass draws new augmentations
        for i in range(len(ds)):
            _same(ds[i], jds[i])


@pytest.mark.parametrize("mode", ["test", "train"])
def test_camvid_with_flow_matches_jax(camvid, mode):
    kw = dict(mode=mode, ref_gap=2, flow_path=camvid["flow"], ref_path=camvid["ref"],
              flow_shape=FLOW)
    if mode == "train":
        kw.update(cropsize=CROP, randomscale=SCALES)
    ds, jds = _datasets(CamVidWithFlow, JCamVidWithFlow, camvid["data"], **kw)
    for _ in range(2):
        for i in range(len(ds)):
            s = ds[i]
            _same(s, jds[i])
            assert s["flow"].shape[:2] == s["image"].shape[:2]


def test_camvid_helpers_match_jax(camvid, tmp_path):
    label = np.array([[0, 3, 255], [3, 11, 255]], np.int32)
    np.testing.assert_array_equal(label_existence(label, 12),
                                  np.eye(12, dtype=np.float32)[[0, 3, 11]].sum(0))
    frame = os.path.join(camvid["data"], "test", "0001TP_006720.png")
    assert ref_frame_path(camvid["ref"], frame, 2).endswith("0001TP/0001TP_000060.png")
    assert os.path.exists(ref_frame_path(camvid["ref"], frame, 2))
    flow = np.random.RandomState(0).randint(-50, 50, (4, 6, 2)).astype(np.int16)
    flow.tofile(tmp_path / "f.bin")
    np.testing.assert_array_equal(read_flow_bin(str(tmp_path / "f.bin"), (4, 6, 2)),
                                  j_read_flow_bin(str(tmp_path / "f.bin"), (4, 6, 2)))


@pytest.mark.parametrize("mode,model_type", [("val", "pspnet"), ("train", "bisenet")])
def test_cityscapes_matches_jax(cityscapes, mode, model_type):
    kw = dict(mode=mode, cropsize=CROP, randomscale=SCALES)
    ds, jds = _datasets(CityScapes, JCityScapes, cityscapes["data"], model_type, **kw)
    assert len(ds) == len(jds) == 2
    for i in range(len(ds)):
        _same(ds[i], jds[i])


@pytest.mark.parametrize("mode", ["val", "train"])
def test_cityscapes_with_flow_matches_jax(cityscapes, mode):
    kw = dict(mode=mode, cropsize=CROP, randomscale=SCALES, ref_gap=2,
              flow_path=cityscapes["flow"], ref_path=cityscapes["ref"], flow_shape=(48, 64, 2))
    ds, jds = _datasets(CityScapesWithFlow, JCityScapesWithFlow, cityscapes["data"], "pspnet",
                        **kw)
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    assert CS_CITY in ds.imnames[0]


class _Indexed:
    """A dataset whose sample i carries i."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
def test_loader_matches_jax(shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=3, drop_last=drop_last, seed=5)
    loader, jloader = Loader(_Indexed(), **kw), JLoader(_Indexed(), **kw)
    assert len(loader) == len(jloader) == (3 if drop_last else 4)
    for _ in range(2):  # the second epoch reshuffles alike
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for a, b in zip(got, want):
            _same(a, b)


def test_loader_over_a_reader(camvid):
    ds = CamVidWithFlow(camvid["data"], mode="test", ref_gap=2, flow_path=camvid["flow"],
                        ref_path=camvid["ref"], flow_shape=FLOW)
    jds = JCamVidWithFlow(camvid["data"], mode="test", ref_gap=2, flow_path=camvid["flow"],
                          ref_path=camvid["ref"], flow_shape=FLOW)
    for a, b in zip(Loader(ds, batch_size=2), JLoader(jds, batch_size=2)):
        _same(a, b)


def test_device_prefetch_on_the_cpu():
    batches = [{"x": np.full((2, 2), i, np.float32), "y": np.arange(i + 1)} for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu"))
    assert len(out) == 5
    for b, o in zip(batches, out):
        assert isinstance(o["x"], torch.Tensor) and o["x"].device.type == "cpu"
        np.testing.assert_array_equal(o["x"].numpy(), b["x"])
        np.testing.assert_array_equal(o["y"].numpy(), b["y"])
    assert list(device_prefetch(iter([]), "cpu")) == []


def test_port_imports_neither_pil_nor_cv2_nor_jax():
    code = ("import sys\n"
            "import arseg_tpu_torch.train, arseg_tpu_torch.train.trainer\n"
            "import arseg_tpu_torch.data, arseg_tpu_torch.eval.protocol\n"
            "import arseg_tpu_torch.utils.checkpoint\n"
            "bad = [m for m in ('PIL', 'cv2', 'jax') if m in sys.modules]\n"
            "bad += [m for m in sys.modules if m == 'arseg_tpu' or m.startswith('arseg_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout

