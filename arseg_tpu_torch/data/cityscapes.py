"""Cityscapes datasets (host-side, numpy NHWC outputs) — a copy of
``arseg_tpu/data/cityscapes.py`` (the port imports nothing of the JAX
package). PIL and cv2 are imported where a file is opened, never when the
module is imported.

The reference's ``dataset/cityscapes.py``: leftImg8bit/gtFine
crawl, the standard 35-entry id->trainId map (matching
`dataset/cityscapes_info.json`), per-model normalization (the pretrained
BiSeNet uses different statistics, `dataset/cityscapes.py:88-93`),
`CityScapesWithFlow` reading the reference frame from leftImg8bit_sequence at
`ref_gap-1` back plus the [1024, 2048, 2] quarter-pel MV bin
(`dataset/cityscapes.py:261-306`).
"""

import os
import random

import numpy as np

from arseg_tpu_torch.data import transform as T
from arseg_tpu_torch.data.camvid import open_label, open_rgb

# standard Cityscapes labelId -> trainId (== dataset/cityscapes_info.json)
ID_TO_TRAINID = {
    0: 255, 1: 255, 2: 255, 3: 255, 4: 255, 5: 255, 6: 255,
    7: 0, 8: 1, 9: 255, 10: 255, 11: 2, 12: 3, 13: 4, 14: 255, 15: 255,
    16: 255, 17: 5, 18: 255, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11,
    25: 12, 26: 13, 27: 14, 28: 15, 29: 255, 30: 255, 31: 16, 32: 17, 33: 18,
}

MEANS = {
    "bisenet": ((0.3257, 0.3690, 0.3223), (0.2112, 0.2148, 0.2115)),
    "pspnet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}

CITYSCAPES_CLASSES = 19
FLOW_SHAPE = (1024, 2048, 2)

_LUT = np.full(256, 255, dtype=np.int32)
for _id, _tid in ID_TO_TRAINID.items():
    _LUT[_id] = _tid


def convert_labels(label):
    return _LUT[label.astype(np.int64)].astype(np.int32)


def _crawl(rootpth, mode):
    imgs, names = {}, []
    impth = os.path.join(rootpth, "leftImg8bit", mode)
    for fd in os.listdir(impth):
        fdpth = os.path.join(impth, fd)
        im_names = os.listdir(fdpth)
        if im_names and "_gtFine_leftImg8bit" in im_names[0]:
            ns = [el.replace("_gtFine_leftImg8bit.png", "") for el in im_names]
        else:
            ns = [el.replace("_leftImg8bit.png", "") for el in im_names]
        names.extend(ns)
        imgs.update(dict(zip(ns, [os.path.join(fdpth, el) for el in im_names])))

    labels = {}
    gtpth = os.path.join(rootpth, "gtFine", mode)
    for fd in os.listdir(gtpth):
        fdpth = os.path.join(gtpth, fd)
        lbnames = [el for el in os.listdir(fdpth) if "labelIds" in el]
        ns = [el.replace("_gtFine_labelIds.png", "") for el in lbnames]
        labels.update(dict(zip(ns, [os.path.join(fdpth, el) for el in lbnames])))

    assert set(names) == set(labels.keys())
    return names, imgs, labels


def label_existence(label, n_classes=CITYSCAPES_CLASSES):
    out = np.zeros((n_classes,), dtype=np.float32)
    for v in np.unique(label):
        if v != 255:
            out[int(v)] = 1.0
    return out


class CityScapes:
    def __init__(
        self,
        rootpth,
        model_type,
        cropsize=(640, 480),
        mode="train",
        randomscale=(0.125, 0.25, 0.375, 0.5, 0.675, 0.75, 0.875, 1.0, 1.25, 1.5),
        rng=None,
    ):
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.rng = rng or random.Random()
        self.imnames, self.imgs, self.labels = _crawl(rootpth, mode)
        self.mean, self.std = MEANS[model_type]
        self.trans_train = T.Pipeline(
            [
                T.ColorJitter(0.4, 0.4, 0.4, rng=self.rng),
                T.HorizontalFlip(rng=self.rng),
                T.RandomScale(randomscale, rng=self.rng),
                T.RandomCrop(cropsize, rng=self.rng),
            ]
        )

    def __len__(self):
        return len(self.imnames)

    def __getitem__(self, idx):
        fn = self.imnames[idx]
        pil = self.mode == "train"
        img = open_rgb(self.imgs[fn], pil)
        if pil:
            img = img.convert("RGB")
        label = open_label(self.labels[fn])
        if self.mode == "train":
            out = self.trans_train(dict(im=img, lb=label))
            img, label = out["im"], out["lb"]
        label = convert_labels(np.asarray(label))
        return {
            "image": T.normalize(img, self.mean, self.std),
            "label": label,
            "existence": label_existence(label),
        }


class CityScapesWithFlow(CityScapes):
    def __init__(
        self,
        rootpth,
        model_type,
        cropsize=(640, 480),
        mode="train",
        randomscale=(0.125, 0.25, 0.375, 0.5, 0.675, 0.75, 0.875, 1.0, 1.25, 1.5),
        ref_gap=12,
        flow_path=None,
        ref_path=None,
        flow_shape=FLOW_SHAPE,
        rng=None,
    ):
        super().__init__(rootpth, model_type, cropsize, mode, randomscale, rng)
        self.ref_gap = ref_gap
        self.flow_path = flow_path
        self.flow_shape = tuple(flow_shape)
        self.ref_path = ref_path or os.path.join(rootpth, "leftImg8bit_sequence")
        self.trans_color = T.PairColorJitter(0.5, 0.5, 0.5, rng=self.rng)
        self.trans_homo = T.PairPipeline(
            [
                T.PairOFHorizontalFlip(rng=self.rng),
                T.PairOFRandomScaleV2(randomscale, rng=self.rng),
                T.PairOFRandomCrop(cropsize, rng=self.rng),
            ]
        )

    def __getitem__(self, idx):
        fn = self.imnames[idx]
        pil = self.mode == "train"
        img = open_rgb(self.imgs[fn], pil)
        if pil:
            img = img.convert("RGB")
        label = open_label(self.labels[fn])

        parts = fn.split("_")
        ref_idx = int(parts[-1]) - (self.ref_gap - 1)
        ref_fn = "_".join(parts[:-1] + [f"{ref_idx:06d}", "leftImg8bit.png"])
        scene = parts[0]
        ref_img = open_rgb(os.path.join(self.ref_path, self.mode, scene, ref_fn), pil)

        flow = np.fromfile(
            os.path.join(
                self.flow_path, self.mode, scene, fn + "_gtFine_leftImg8bit.bin"
            ),
            dtype=np.int16,
        ).reshape(self.flow_shape).astype(np.float32) / 4.0

        if self.mode == "train":
            a, b = self.trans_color(dict(im=img, lb=label), dict(im=ref_img, lb=label))
            a, b = self.trans_homo(a, dict(im=b["im"], lb=flow))
            img, label = a["im"], a["lb"]
            ref_img, flow = b["im"], b["lb"]

        label = convert_labels(np.asarray(label))
        return {
            "image": T.normalize(img, self.mean, self.std),
            "label": label,
            "existence": label_existence(label),
            "ref_image": T.normalize(ref_img, self.mean, self.std),
            "flow": np.ascontiguousarray(flow, dtype=np.float32),
        }
