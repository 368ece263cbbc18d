"""CamVid compressed-video datasets (host-side, numpy NHWC outputs) — a
copy of ``arseg_tpu/data/camvid.py`` (the port imports nothing of the JAX
package): ``CamVid``, ``CamVidWithFlow`` and their helpers; the
bidirectional ``CamVidWithBiFlow``; ``CamVidWithFlowTest``, the label-free
sequence reader of video inference (``cli/infer_video.py``); and the
CU-map readers ``CamVidwithCUmap`` and ``CamVidwithCUmapSingleBranch``.
PIL and cv2 are imported where a file is opened, never when the module is
imported.

The reference loaders (``dataset/camvid.py``):
directory crawl (sorted os.walk), the annotated-frame <-> encoded-sequence
index bookkeeping via scene_length_info (`dataset/camvid.py:15-40`), the
decoded-keyframe lookup at `ref_gap-1` frames back, the int16 quarter-pel MV
`.bin` reader ([720, 960, 2] / 4, `dataset/camvid.py:624-626`), paired
augmentation (color jitter shared across the pair, then flow-aware geometric
transforms), and the class-presence vector.

Samples are dicts of numpy arrays; batching/prefetch lives in data/loader.py.
"""

import os
import random

import numpy as np

from arseg_tpu_torch.data import transform as T

SCENE_LENGTH_INFO = {
    "0001TP": dict(encoded_start_idx=31, encoded_end_idx=3721, dataset_start_idx=6690, dataset_end_idx=10380),
    "0006R0": dict(encoded_start_idx=932, encoded_end_idx=3932, dataset_start_idx=930, dataset_end_idx=3930),
    "0016E5": dict(encoded_start_idx=392, encoded_end_idx=8642, dataset_start_idx=390, dataset_end_idx=8640),
    "Seq05VD": dict(encoded_start_idx=32, encoded_end_idx=5102, dataset_start_idx=30, dataset_end_idx=5100),
}

CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)

CAMVID_CLASSES = 12
FLOW_SHAPE = (720, 960, 2)

SPLIT_DIRS = {
    "train": ("train", "train_labels_with_ignored"),
    "val": ("val", "val_labels_with_ignored"),
    "test": ("test", "test_labels_with_ignored"),
}


def get_files(folder, extension=".png"):
    if not os.path.isdir(folder):
        raise RuntimeError(f'"{folder}" is not a folder.')
    out = []
    for path, _, files in os.walk(folder):
        files.sort()
        for f in files:
            if f.endswith(extension):
                out.append(os.path.join(path, f))
    return out


def open_rgb(path, pil=False):
    """RGB image decode. PIL on the train path (the transform library is
    PIL-based); cv2 otherwise — ~1.4x faster PNG decode, bit-identical on
    the codec-produced frames. Labels are NOT loaded
    through this: paletted label PNGs must keep index semantics, which
    only PIL preserves."""
    if pil:
        from PIL import Image

        return Image.open(path)
    import cv2

    img = cv2.imread(os.fspath(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def dataset_frame_idx(basename, seq_name):
    """Frame index encoded in an annotated-frame filename
    (`dataset/camvid.py:407-413`): 0001TP/0016E5 use plain digits, the other
    scenes prefix an 'f'."""
    token = basename.split("_")[1]
    if seq_name in ("0001TP", "0016E5"):
        return int(token[:-4])
    return int(token[1:-4])


def decoded_basename(frame_idx, seq_name):
    return f"{seq_name}_{frame_idx:06d}.png"


def ref_frame_path(ref_path, data_path, ref_gap):
    """Decoded keyframe path for an annotated frame, `dataset/camvid.py:289-299`."""
    base = os.path.basename(data_path)
    seq = base.split("_")[0]
    info = SCENE_LENGTH_INFO[seq]
    data_idx = dataset_frame_idx(base, seq)
    decoded_idx = data_idx - info["dataset_start_idx"] + info["encoded_start_idx"]
    ref_idx = decoded_idx - (ref_gap - 1)
    return os.path.join(ref_path, seq, decoded_basename(ref_idx, seq))


def read_flow_bin(path, shape=FLOW_SHAPE):
    """int16 quarter-pel MV map -> float pixels (`dataset/camvid.py:624-626`)."""
    flow = np.fromfile(path, dtype=np.int16).reshape(shape)
    return flow.astype(np.float32) / 4.0


def open_label(path):
    """A label PNG through PIL, which keeps a paletted map's indices."""
    from PIL import Image

    return Image.open(path)


def label_existence(label, n_classes):
    out = np.zeros((n_classes,), dtype=np.float32)
    for v in np.unique(label):
        if v != 255:
            out[int(v)] = 1.0
    return out


class CamVid:
    """Single-frame loader; with load_pair=True also yields the decoded
    keyframe `ref_gap-1` frames back (`dataset/camvid.py:109-425`)."""

    def __init__(
        self,
        root_dir,
        mode="train",
        cropsize=(640, 480),
        randomscale=(0.5, 0.675, 0.75, 0.875, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5),
        load_pair=False,
        ref_gap=5,
        ref_path=None,
        rng=None,
    ):
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.load_pair = load_pair
        self.ref_gap = ref_gap
        self.ref_path = ref_path
        self.rng = rng or random.Random()

        img_dir, lbl_dir = SPLIT_DIRS[mode]
        self.data = get_files(os.path.join(root_dir, img_dir))
        self.labels = get_files(os.path.join(root_dir, lbl_dir))

        # Seq05VD_f00000 is the 2nd frame of its sequence and cannot satisfy
        # large ref_gap; dropped for training (`dataset/camvid.py:225-232`)
        if mode == "train" and len(self.data) != len(self.labels):
            self.labels = [x for x in self.labels if "Seq05VD_f00000" not in x]
        if mode == "train" and load_pair:
            self.data = [x for x in self.data if "Seq05VD_f00000" not in x]
            self.labels = [x for x in self.labels if "Seq05VD_f00000" not in x]

        if not load_pair:
            self.trans_train = T.Pipeline(
                [
                    T.ColorJitter(0.5, 0.5, 0.5, rng=self.rng),
                    T.HorizontalFlip(rng=self.rng),
                    T.RandomScale(randomscale, rng=self.rng),
                    T.RandomCrop(cropsize, rng=self.rng),
                ]
            )
        else:
            self.trans_train = None
            self.pair_trans = T.PairPipeline(
                [
                    T.PairColorJitter(0.5, 0.5, 0.5, rng=self.rng),
                    T.PairHorizontalFlip(rng=self.rng),
                    T.PairRandomScale(randomscale, rng=self.rng),
                    T.PairRandomCrop(cropsize, rng=self.rng),
                ]
            )

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        pil = self.mode == "train"  # the transform library is PIL-based
        img = open_rgb(self.data[index], pil)
        label = open_label(self.labels[index])

        ref_img = None
        if self.load_pair:
            ref_img = open_rgb(
                ref_frame_path(self.ref_path, self.data[index], self.ref_gap), pil
            )

        if self.mode == "train":
            if not self.load_pair:
                out = self.trans_train(dict(im=img, lb=label))
                img, label = out["im"], out["lb"]
            else:
                a, b = self.pair_trans(
                    dict(im=img, lb=label), dict(im=ref_img, lb=label)
                )
                img, label, ref_img = a["im"], a["lb"], b["im"]

        sample = {
            "image": T.normalize(img, CAMVID_MEAN, CAMVID_STD),
            "label": np.asarray(label, dtype=np.int32),
        }
        sample["existence"] = label_existence(sample["label"], CAMVID_CLASSES)
        if self.load_pair:
            sample["ref_image"] = T.normalize(ref_img, CAMVID_MEAN, CAMVID_STD)
        return sample


class CamVidWithFlow(CamVid):
    """Pair loader that also reads the merged MV map for the frame
    (`dataset/camvid.py:428-778`). Augmentation: shared color jitter, then
    flow-aware flip/scaleV2/crop."""

    def __init__(
        self,
        root_dir,
        mode="train",
        cropsize=(640, 480),
        randomscale=(0.5, 0.675, 0.75, 0.875, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5),
        load_pair=True,
        ref_gap=5,
        ref_path=None,
        flow_path=None,
        flow_shape=FLOW_SHAPE,
        rng=None,
    ):
        super().__init__(
            root_dir,
            mode=mode,
            cropsize=cropsize,
            randomscale=randomscale,
            load_pair=load_pair,
            ref_gap=ref_gap,
            ref_path=ref_path,
            rng=rng,
        )
        self.flow_path = flow_path
        self.flow_shape = flow_shape
        self.trans_color = T.PairColorJitter(0.5, 0.5, 0.5, rng=self.rng)
        self.trans_homo = T.PairPipeline(
            [
                T.PairOFHorizontalFlip(rng=self.rng),
                T.PairOFRandomScaleV2(randomscale, rng=self.rng),
                T.PairOFRandomCrop(cropsize, rng=self.rng),
            ]
        )

    def __getitem__(self, index):
        data_path = self.data[index]
        pil = self.mode == "train"
        img = open_rgb(data_path, pil)
        label = open_label(self.labels[index])

        seq = os.path.basename(data_path).split("_")[0]
        ref_img = open_rgb(ref_frame_path(self.ref_path, data_path, self.ref_gap), pil)
        flow = read_flow_bin(
            os.path.join(
                self.flow_path, seq, os.path.basename(data_path)[:-4] + ".bin"
            ),
            self.flow_shape,
        )

        if self.mode == "train":
            a, b = self.trans_color(dict(im=img, lb=label), dict(im=ref_img, lb=label))
            a, b = self.trans_homo(a, dict(im=b["im"], lb=flow))
            img, label = a["im"], a["lb"]
            ref_img, flow = b["im"], b["lb"]

        sample = {
            "image": T.normalize(img, CAMVID_MEAN, CAMVID_STD),
            "label": np.asarray(label, dtype=np.int32),
            "ref_image": T.normalize(ref_img, CAMVID_MEAN, CAMVID_STD),
            "flow": np.ascontiguousarray(flow, dtype=np.float32),
        }
        sample["existence"] = label_existence(sample["label"], CAMVID_CLASSES)
        return sample


class CamVidWithBiFlow(CamVidWithFlow):
    """Bidirectional variant (`dataset/camvid.py:782-1148`): two keyframes —
    past at `decoded_idx - ref_gap`, future at `decoded_idx + (12 - ref_gap)`
    — with flows from the `_last`/`_next` MV bins. Augmentation shares one
    draw across all three parties (the reference's triple/tripleOF family)."""

    def _ref_paths(self, data_path):
        base = os.path.basename(data_path)
        seq = base.split("_")[0]
        info = SCENE_LENGTH_INFO[seq]
        decoded_idx = (
            dataset_frame_idx(base, seq)
            - info["dataset_start_idx"]
            + info["encoded_start_idx"]
        )
        past = os.path.join(
            self.ref_path, seq, decoded_basename(decoded_idx - self.ref_gap, seq)
        )
        future = os.path.join(
            self.ref_path, seq, decoded_basename(decoded_idx + (12 - self.ref_gap), seq)
        )
        return seq, past, future

    def __getitem__(self, index):
        data_path = self.data[index]
        pil = self.mode == "train"
        img = open_rgb(data_path, pil)
        label = open_label(self.labels[index])
        seq, past_path, future_path = self._ref_paths(data_path)
        stem = os.path.basename(data_path)[:-4]
        ref_img = open_rgb(past_path, pil)
        ref_img2 = open_rgb(future_path, pil)
        flow = read_flow_bin(
            os.path.join(self.flow_path, seq, stem + "_last.bin"), self.flow_shape
        )
        flow2 = read_flow_bin(
            os.path.join(self.flow_path, seq, stem + "_next.bin"), self.flow_shape
        )

        if self.mode == "train":
            a, b, c = self.trans_color(
                dict(im=img, lb=label), dict(im=ref_img, lb=label), dict(im=ref_img2, lb=label)
            )
            a, b, c = self.trans_homo(
                a, dict(im=b["im"], lb=flow), dict(im=c["im"], lb=flow2)
            )
            img, label = a["im"], a["lb"]
            ref_img, flow = b["im"], b["lb"]
            ref_img2, flow2 = c["im"], c["lb"]

        sample = {
            "image": T.normalize(img, CAMVID_MEAN, CAMVID_STD),
            "label": np.asarray(label, dtype=np.int32),
            "ref_image": T.normalize(ref_img, CAMVID_MEAN, CAMVID_STD),
            "flow": np.ascontiguousarray(flow, dtype=np.float32),
            "ref_image2": T.normalize(ref_img2, CAMVID_MEAN, CAMVID_STD),
            "flow2": np.ascontiguousarray(flow2, dtype=np.float32),
        }
        sample["existence"] = label_existence(sample["label"], CAMVID_CLASSES)
        return sample


class CamVidWithFlowTest:
    """Label-free loader over a decoded sequence (`dataset/camvid.py:1153-1426`):
    frames named `%05d.png`, keyframe = `idx // ref_gap * ref_gap`, flow from
    `<flow_path>/<name>.bin`. Used to run AR inference over full videos."""

    def __init__(self, data_path, load_pair=True, ref_gap=12, ref_path=None,
                 flow_path=None, flow_shape=FLOW_SHAPE):
        self.data = get_files(data_path)
        self.load_pair = load_pair
        self.ref_gap = ref_gap
        self.ref_path = ref_path
        self.flow_path = flow_path
        self.flow_shape = flow_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        data_path = self.data[index]
        img = open_rgb(data_path)
        sample = {
            "image": T.normalize(img, CAMVID_MEAN, CAMVID_STD),
            "label": np.int32(0),
            "existence": np.float32(0),
        }
        if self.load_pair:
            idx = int(os.path.basename(data_path)[:-4])
            key_idx = idx // self.ref_gap * self.ref_gap
            ref_img = open_rgb(os.path.join(self.ref_path, f"{key_idx:05d}.png"))
            flow = read_flow_bin(
                os.path.join(
                    self.flow_path, os.path.basename(data_path)[:-4] + ".bin"
                ),
                self.flow_shape,
            )
            sample["ref_image"] = T.normalize(ref_img, CAMVID_MEAN, CAMVID_STD)
            sample["flow"] = np.ascontiguousarray(flow, dtype=np.float32)
        return sample


CUMAP_MEAN = (0.75,)
CUMAP_STD = (0.25,)


def _cumap_path(root_dir, data_path, cumap_dir="CUmap"):
    """CU-map filename quirks per scene (`dataset/camvid.py:1579-1594`):
    0016E5 gains an 'f' prefix on the frame token, Seq05VD loses its one."""
    base = os.path.basename(data_path)
    seq = base.split("_")[0]
    parts = base.split("_")
    if seq == "0016E5":
        parts[1] = "f" + parts[1]
    elif seq == "Seq05VD":
        parts[1] = parts[1][1:]
    return os.path.join(root_dir, cumap_dir, seq, "_".join(parts))


class CamVidwithCUmap(CamVid):
    """Single-frame loader that attaches the HEVC CU-partition map as a 4th
    input channel (`dataset/camvid.py:1430-1677`): CU map normalized with
    mean .75 / std .25, geometric augs applied jointly by riding the image's
    alpha channel."""

    concat = True  # False -> SingleBranch: CU map returned separately

    def __init__(self, root_dir, mode="train", cropsize=(640, 480),
                 randomscale=(0.5, 0.675, 0.75, 0.875, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5),
                 rng=None):
        super().__init__(root_dir, mode=mode, cropsize=cropsize,
                         randomscale=randomscale, rng=rng)
        self.root_dir = root_dir
        # the parent's train pipeline, split at the colour step
        self.color_trans = self.trans_train.ops[0]
        self.homo_trans = T.Pipeline(self.trans_train.ops[1:])

    def __getitem__(self, index):
        from PIL import Image

        img = open_rgb(self.data[index], pil=self.mode == "train")
        if self.mode == "train":
            img = img.convert("RGB")
        label = open_label(self.labels[index])
        cumap = Image.open(_cumap_path(self.root_dir, self.data[index])).convert("L")

        if self.mode == "train":
            out = self.color_trans(dict(im=img, lb=label))
            img = out["im"]
            img.putalpha(cumap)  # CU map rides alpha through the geometry augs
            out = self.homo_trans(dict(im=img, lb=out["lb"]))
            img, label = out["im"], out["lb"]
            cumap = img.split()[-1]
            img = Image.merge("RGB", img.split()[:-1])

        image = T.normalize(img, CAMVID_MEAN, CAMVID_STD)
        cu = T.normalize(cumap, CUMAP_MEAN, CUMAP_STD)[..., None]
        label_arr = np.asarray(label, dtype=np.int32)
        sample = {
            "label": label_arr,
            "existence": label_existence(label_arr, CAMVID_CLASSES),
        }
        if self.concat:
            sample["image"] = np.concatenate([image, cu], axis=-1)
        else:
            sample["image"] = image
            sample["cumap"] = np.ascontiguousarray(cu)
        return sample


class CamVidwithCUmapSingleBranch(CamVidwithCUmap):
    """CU map as a separate side input instead of a 4th channel
    (`dataset/camvid.py:1680-1870`)."""

    concat = False
