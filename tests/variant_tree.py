"""The extras that the CamVid variants read, added to a tree of
``synthetic_data.make_camvid_tree``: the keyframes that
``CamVidWithBiFlow`` looks up ``gop`` frames back and ``12 - gop`` ahead,
its ``_last``/``_next`` MV bins, and the ``CUmap/`` grey-scale maps of
``CamVidwithCUmap``. The draws are those of ``tests/test_data_variants.py``'s
fixture, at any frame and flow size. Imports neither torch nor JAX:
``chip_smoke.py`` builds the same tree at 720x960."""

import os

import numpy as np
from PIL import Image

from synthetic_data import DATASET_IDXS, SEQ


def add_variant_extras(seq_root, gop, h, w, flow_shape, seed=1):
    """Writes the extras into ``seq_root`` (the tree's
    ``camvid-sequence/<bitrate>-GOP<gop>``); returns the data root that
    holds ``CUmap/``."""
    rng = np.random.RandomState(seed)
    frame_dir = os.path.join(seq_root, "frames", SEQ)
    mv_dir = os.path.join(seq_root, f"MVmap_GOP{gop}_dist_{gop - 1}", SEQ)
    for d_idx in DATASET_IDXS:
        dec_idx = d_idx - 6690 + 31
        for idx in (dec_idx - gop, dec_idx + (12 - gop)):
            p = os.path.join(frame_dir, f"{SEQ}_{idx:06d}.png")
            if not os.path.exists(p):
                Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(p)
        for suffix in ("_last", "_next"):
            rng.randint(-8, 8, flow_shape).astype(np.int16).tofile(
                os.path.join(mv_dir, f"{SEQ}_{d_idx:06d}{suffix}.bin"))

    data_root = os.path.join(seq_root, f"decoded_GOP{gop}_dist_{gop - 1}")
    cu_dir = os.path.join(data_root, "CUmap", SEQ)
    os.makedirs(cu_dir, exist_ok=True)
    for d_idx in DATASET_IDXS:
        Image.fromarray(rng.randint(0, 255, (h, w), np.uint8)).save(
            os.path.join(cu_dir, f"{SEQ}_{d_idx:06d}.png"))
    return data_root
