"""The port's CamVid variants and N-ary transforms (arseg_tpu_torch.data)
against the JAX package's.

Mirrors ``tests/test_data_variants.py`` on the port (the bidirectional
sample, the CU-map sample with the map as a 4th channel and as a side
input, the triple transforms sharing one draw), then holds every sample of
``CamVidWithBiFlow``, ``CamVidwithCUmap`` and ``CamVidwithCUmapSingleBranch``
bit-equal to the JAX readers' in test and in train mode under the same
seeds, and ``MultiScale``, ``PairOFRandomScale`` and the geometric
transforms on a 4-band (RGBA) image, which is how the CU map rides through
the augmentations, bit-equal to the JAX transforms."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from arseg_tpu.data import CamVidWithBiFlow as JCamVidWithBiFlow
from arseg_tpu.data import CamVidwithCUmap as JCamVidwithCUmap
from arseg_tpu.data import CamVidwithCUmapSingleBranch as JCamVidwithCUmapSingleBranch
from arseg_tpu.data import transform as JT

from arseg_tpu_torch.data import (CamVidWithBiFlow, CamVidwithCUmap,
                                  CamVidwithCUmapSingleBranch)
from arseg_tpu_torch.data import transform as T

from synthetic_data import DATASET_IDXS, FLOW_SHAPE, H, W, make_camvid_tree
from torch_parity import few_threads  # noqa: F401
from variant_tree import add_variant_extras

pytestmark = pytest.mark.usefixtures("few_threads")

CROP = (64, 48)
GOP = 2
# 0.4 takes the frame below the crop, so RandomCrop resizes it up first
SCALES = (0.4, 0.75, 1.0, 1.25)
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``tests/test_data_variants.py``'s tree, with a test split as well."""
    root = tmp_path_factory.mktemp("camvid")
    seq_root = make_camvid_tree(str(root), gop=GOP, splits=("train", "test"))
    data_root = add_variant_extras(seq_root, GOP, H, W, FLOW_SHAPE)
    return dict(data=data_root, ref=os.path.join(seq_root, "frames"),
                flow=os.path.join(seq_root, f"MVmap_GOP{GOP}_dist_{GOP - 1}"))


def _biflow(cls, tree, mode, rng, scales=SCALES):
    return cls(tree["data"], mode=mode, cropsize=CROP, randomscale=scales, ref_gap=GOP,
               ref_path=tree["ref"], flow_path=tree["flow"], flow_shape=FLOW_SHAPE, rng=rng)


def _cumap(cls, tree, mode, rng, scales=SCALES):
    return cls(tree["data"], mode=mode, cropsize=CROP, randomscale=scales, rng=rng)


VARIANTS = {
    "biflow": (_biflow, CamVidWithBiFlow, JCamVidWithBiFlow),
    "cumap": (_cumap, CamVidwithCUmap, JCamVidwithCUmap),
    "cumap-single-branch": (_cumap, CamVidwithCUmapSingleBranch, JCamVidwithCUmapSingleBranch),
}


# ------------------------------------------- tests/test_data_variants.py


def test_biflow_sample(tree):
    ds = _biflow(CamVidWithBiFlow, tree, "train", random.Random(0), scales=(1.0,))
    assert len(ds) == len(DATASET_IDXS)
    s = ds[0]
    cw, ch = CROP
    for k in ("image", "ref_image", "ref_image2"):
        assert s[k].shape == (ch, cw, 3), k
    assert s["flow"].shape == (ch, cw, 2)
    assert s["flow2"].shape == (ch, cw, 2)
    assert s["label"].shape == (ch, cw)
    assert s["existence"].shape == (12,)


@pytest.mark.parametrize("cls,concat", [(CamVidwithCUmap, True),
                                        (CamVidwithCUmapSingleBranch, False)])
def test_cumap_sample(tree, cls, concat):
    s = _cumap(cls, tree, "train", random.Random(0), scales=(1.0,))[0]
    cw, ch = CROP
    if concat:
        assert s["image"].shape == (ch, cw, 4)
        # the CU map normalised with mean .75 / std .25 lies in [-3, 1]
        cu = s["image"][..., 3]
        assert cu.min() >= -3.001 and cu.max() <= 1.001
    else:
        assert s["image"].shape == (ch, cw, 3)
        assert s["cumap"].shape == (ch, cw, 1)


class _CountingRandom:
    """The draws the transforms take from a ``random.Random``, counted."""

    def __init__(self, seed):
        self._rng = random.Random(seed)
        self.draws = 0

    def __getattr__(self, name):  # random(), uniform(), choice()
        def draw(*args):
            self.draws += 1
            return getattr(self._rng, name)(*args)

        return draw


def test_triple_transforms_share_draws():
    """One draw applies to all parties (as many draws for three as for
    one); flow labels get the OF treatment (x negated on flip, magnitudes
    rescaled on scale)."""
    rng_img = np.random.RandomState(0)
    im = Image.fromarray(rng_img.randint(0, 255, (32, 48, 3), np.uint8))
    lb = Image.fromarray(rng_img.randint(0, 12, (32, 48), np.uint8))
    flow = rng_img.uniform(-4, 4, (32, 48, 2)).astype(np.float32)

    flip = T.TripleOFHorizontalFlip(p=1.1, rng=random.Random(0))  # always flip
    a, b, c = flip(dict(im=im, lb=lb), dict(im=im, lb=flow), dict(im=im, lb=flow))
    np.testing.assert_allclose(np.asarray(a["im"]), np.asarray(im)[:, ::-1])
    np.testing.assert_allclose(b["lb"][..., 0], -flow[:, ::-1, 0])
    np.testing.assert_allclose(c["lb"][..., 1], flow[:, ::-1, 1])

    scale = T.TripleOFRandomScaleV2((2.0,), rng=random.Random(0))
    a, b, c = scale(dict(im=im, lb=lb), dict(im=im, lb=flow), dict(im=im, lb=flow))
    assert a["im"].size == (96, 64)
    assert b["lb"].shape == (64, 96, 2)
    assert np.isclose(np.abs(b["lb"]).max(), 2 * np.abs(flow).max())

    crop = T.TripleOFRandomCrop((24, 16), rng=random.Random(0))
    a, b, c = crop(dict(im=im, lb=lb), dict(im=im, lb=flow), dict(im=im, lb=flow))
    assert a["im"].size == (24, 16)
    assert b["lb"].shape == (16, 24, 2)
    assert np.asarray(a["lb"]).shape == (16, 24)

    draws = []
    for n in (1, 3):
        rng = _CountingRandom(0)
        pipe = T.TriplePipeline([T.TripleColorJitter(0.5, 0.5, 0.5, rng=rng),
                                 T.TripleOFHorizontalFlip(rng=rng),
                                 T.TripleOFRandomScaleV2((0.75, 1.25), rng=rng),
                                 T.TripleOFRandomCrop((24, 16), rng=rng)])
        pipe(dict(im=im, lb=lb), *[dict(im=im, lb=flow)] * (n - 1))
        draws.append(rng.draws)
    assert draws[0] == draws[1] == 3 + 1 + 1 + 2


# ------------------------------------------------- against the JAX readers


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_samples_equal_jax(tree, variant, mode):
    """Every sample, under seeds 0-2 (train mode draws its augmentation
    from a ``random.Random`` of the seed in both packages)."""
    make, cls, jcls = VARIANTS[variant]
    for seed in SEEDS if mode == "train" else SEEDS[:1]:
        ds = make(cls, tree, mode, random.Random(seed))
        jds = make(jcls, tree, mode, random.Random(seed))
        assert len(ds) == len(jds) == len(DATASET_IDXS)
        for i in range(len(ds)):
            _same(ds[i], jds[i])


def _rgba():
    rng = np.random.RandomState(4)
    im = Image.fromarray(rng.randint(0, 255, (36, 52, 3), np.uint8))
    im.putalpha(Image.fromarray(rng.randint(0, 255, (36, 52), np.uint8)))
    lb = Image.fromarray(rng.randint(0, 12, (36, 52), np.uint8))
    flow = rng.uniform(-4, 4, (36, 52, 2)).astype(np.float32)
    return im, lb, flow


def _arrays(parties):
    return [np.asarray(v) for d in parties for v in (d["im"], d["lb"])]


@pytest.mark.parametrize("seed", SEEDS)
def test_transforms_equal_jax(seed):
    """MultiScale, PairOFRandomScale (flow resized, magnitudes kept) and
    the CU-map path's flip/scale/crop on a 4-band image."""
    im, lb, flow = _rgba()
    got = T.MultiScale((0.5, 0.75, 1.5))(im)
    want = JT.MultiScale((0.5, 0.75, 1.5))(im)
    assert [g.size for g in got] == [w.size for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    parties = (dict(im=im, lb=lb), dict(im=im, lb=flow))
    got = T.PairOFRandomScale(SCALES, rng=random.Random(seed))(*parties)
    want = JT.PairOFRandomScale(SCALES, rng=random.Random(seed))(*parties)
    for g, w in zip(_arrays(got), _arrays(want)):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[1]["lb"]).max() <= np.abs(flow).max()  # no magnitude rescale

    def pipeline(mod):
        rng = random.Random(seed)
        return mod.Pipeline([mod.HorizontalFlip(rng=rng), mod.RandomScale(SCALES, rng=rng),
                             mod.RandomCrop((40, 30), rng=rng)])

    got, want = pipeline(T)(dict(im=im, lb=lb)), pipeline(JT)(dict(im=im, lb=lb))
    assert got["im"].mode == want["im"].mode == "RGBA"
    for g, w in zip(_arrays([got]), _arrays([want])):
        np.testing.assert_array_equal(g, w)
