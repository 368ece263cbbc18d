"""CamVid label preprocessing: RGB annotation PNGs -> index maps — a copy of
``arseg_tpu/tools/labels.py``.

Parity with reference pre-process/camvid-pre-process.py:18-54 (per-pixel
color -> class id, unknown colors -> 255), but vectorized: colors are packed
into a single int32 per pixel and mapped through a lookup table instead of a
Python dict loop over pixels.
"""

import os

import numpy as np

# class id -> RGB (reference camvid-pre-process.py:19-31)
CAMVID_COLORMAP = {
    0: (128, 128, 128),  # sky
    1: (128, 0, 0),      # building
    2: (192, 192, 128),  # column_pole
    3: (128, 64, 128),   # road
    4: (0, 0, 192),      # sidewalk
    5: (128, 128, 0),    # tree
    6: (192, 128, 128),  # sign_symbol
    7: (64, 64, 128),    # fence
    8: (64, 0, 128),     # car
    9: (64, 64, 0),      # pedestrian
    10: (0, 128, 192),   # bicyclist
    11: (0, 0, 0),       # void
}

IGNORE_LABEL = 255


def _pack(rgb):
    rgb = rgb.astype(np.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def rgb_to_index(color, colormap=CAMVID_COLORMAP, ignore=IGNORE_LABEL):
    """color: uint8 [H, W, 3] RGB. Returns uint8 [H, W] class indices with
    `ignore` for colors outside the map."""
    packed = _pack(np.asarray(color))
    keys = _pack(np.array(list(colormap.values()), dtype=np.int32))
    vals = np.array(list(colormap.keys()), dtype=np.uint8)
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    pos = np.searchsorted(keys, packed)
    pos = np.clip(pos, 0, len(keys) - 1)
    hit = keys[pos] == packed
    out = np.full(packed.shape, ignore, dtype=np.uint8)
    out[hit] = vals[pos[hit]]
    return out


def index_to_rgb(label, colormap=CAMVID_COLORMAP):
    """Inverse mapping for visualization; ignore pixels render black."""
    label = np.asarray(label)
    lut = np.zeros((256, 3), dtype=np.uint8)
    for cid, rgb in colormap.items():
        lut[cid] = rgb
    return lut[label]


def convert_label_dir(label_img_dir, output_dir=None):
    """Convert every RGB label PNG/JPG in a directory; output dir defaults
    to `<dir>-idx-with-ignored` (reference camvid-pre-process.py:38)."""
    from PIL import Image

    output_dir = output_dir or label_img_dir + "-idx-with-ignored"
    os.makedirs(output_dir, exist_ok=True)
    for name in sorted(os.listdir(label_img_dir)):
        if not name.endswith((".png", ".jpg")):
            continue
        color = np.asarray(Image.open(os.path.join(label_img_dir, name)).convert("RGB"))
        label = rgb_to_index(color)
        Image.fromarray(label).save(os.path.join(output_dir, name))
    return output_dir


if __name__ == "__main__":
    import sys

    convert_label_dir(sys.argv[1])
