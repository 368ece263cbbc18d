"""Labeled synthetic video scenes in the CamVid directory contract — a copy
of ``arseg_tpu/tools/synth_scenes.py`` (the port imports nothing of the JAX
package): with the same arguments it writes the same PNGs and ``.bin``
bytes. It needs no codec, so the tree's clean side (annotated frames,
source sequence, ground-truth merged MVs) can be built and scored on any
machine.

Purpose: demonstrate the AR-Seg accuracy mechanism end-to-end *in this
environment* (no real CamVid/Cityscapes exists here): texture classes whose
identity lives in fine detail (2-6 px periodic patterns) lose accuracy when
the frame is 0.5x-downsampled — exactly the LR degradation CReFF+FST
(reference `train_pair.py:290-429`) is designed to recover by warping the HR
keyframe feature along the codec motion field. The generator emits

  {camvid_root}/{split}/0001TP_{idx:06d}.png           clean annotated frames
  {camvid_root}/{split}_labels_with_ignored/...        index label PNGs
  {seq_root}/frames/0001TP/0001TP_{enc:06d}.png        full source sequence
  {seq_root}/{B}M-GOP{G}/MVmapGT_GOP{G}_dist_{d}/0001TP/{name}.bin
      ground-truth merged-MV maps (int16 quarter-pel, reference merged-map
      convention: current position + MV = keyframe position,
      `pre-process/generate_compressed_dataset_camvid.py:38-56`)

and the codec half of the tree (decoded_*/MVmap_*/frames keyframes) is then
produced by the real preprocessing generator
(`arseg_tpu_torch.tools.preprocess.generate_compressed_camvid`) through the
native x265 encode -> decode -> MV-dump -> chain-merge pipeline.

Scene structure: independent 24-frame "chapters", one annotated frame per
chapter at in-chapter position 11, so every protocol distance d in 0..11
keeps its GOP window [11-d, 23-d] inside one motion-coherent clip. All
motion is integer px/frame (positions rounded per frame), so the
ground-truth displacement field is exact and representable in quarter-pel
int16 — carrier-MV error is then attributable to the codec search alone.
"""

import os

import numpy as np

from arseg_tpu_torch.data.camvid import SCENE_LENGTH_INFO

SCENE = "0001TP"
CHAPTER = 24
ANNOT_POS = 11  # in-chapter index of the annotated frame
N_CLASSES = 12  # background=0 + 11 sprite classes (camvid model geometry)


def _grating(u, v, theta_deg, lam):
    t = np.deg2rad(theta_deg)
    phase = (u * np.cos(t) + v * np.sin(t)) * (2 * np.pi / lam)
    return 0.5 + 0.4 * np.sin(phase)


def _checker(u, v, cell):
    return 0.1 + 0.8 * (((u // cell) + (v // cell)) % 2)


def _dots(u, v, period):
    du = (u % period) - period / 2
    dv = (v % period) - period / 2
    r2 = (du**2 + dv**2) / (period / 2.2) ** 2
    return 0.15 + 0.7 * (r2 < 1.0)


def class_texture(cls, h, w, rng):
    """Texture for class `cls` in object-local coordinates. Classes are
    gray-scale patterns distinguished ONLY by fine structure (orientation /
    period), with a small per-instance brightness offset that carries no
    class information — so 0.5x downsampling, which aliases the short
    periods, genuinely removes class evidence."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    if cls == 0:  # background: smooth aperiodic noise (identifiable at any scale)
        img = np.zeros((h, w), np.float32)
        for octave, s in enumerate((32, 16, 8)):
            small = rng.rand(h // s + 2, w // s + 2).astype(np.float32)
            img += np.kron(small, np.ones((s, s), np.float32))[:h, :w] / (octave + 1)
        img -= img.min()
        img /= max(img.max(), 1e-6)
        base = 0.25 + 0.5 * img
    elif 1 <= cls <= 4:
        base = _grating(u, v, (cls - 1) * 45.0, lam=3.0)
    elif 5 <= cls <= 8:
        base = _grating(u, v, (cls - 5) * 45.0, lam=6.0)
    elif cls == 9:
        base = _checker(u, v, 2)
    elif cls == 10:
        base = _checker(u, v, 4)
    else:
        base = _dots(u, v, 5)
    base = base + rng.uniform(-0.08, 0.08)
    g = np.clip(base * 255.0, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def render_chapter(h, w, rng, n_frames=CHAPTER, n_sprites=(5, 8)):
    """One motion-coherent clip: panning textured background (class 0) +
    rigid sprites of distinct classes. Returns (frames uint8 [n,h,w,3],
    labels uint8 [n,h,w], offsets) where offsets lets gt_flow() derive the
    exact displacement field between any two frames."""
    pad = 40
    bg = class_texture(0, h + 2 * pad, w + 2 * pad, rng)
    gx, gy = rng.uniform(-1.5, 1.5, 2)

    n_spr = rng.randint(n_sprites[0], n_sprites[1] + 1)
    classes = rng.choice(np.arange(1, N_CLASSES), size=n_spr, replace=False)
    sprites = []
    for cls in classes:
        sh = rng.randint(h // 6, int(h // 2.5))
        sw = rng.randint(w // 6, int(w // 2.5))
        tex = class_texture(int(cls), sh, sw, rng)
        mask = np.ones((sh, sw), bool)
        if rng.rand() < 0.5:  # ellipse
            vv, uu = np.mgrid[0:sh, 0:sw].astype(np.float32)
            mask = ((vv - sh / 2) / (sh / 2)) ** 2 + ((uu - sw / 2) / (sw / 2)) ** 2 <= 1.0
        sprites.append(
            dict(
                cls=int(cls), tex=tex, mask=mask,
                x0=rng.randint(-sw // 4, w - 3 * sw // 4),
                y0=rng.randint(-sh // 4, h - 3 * sh // 4),
                vx=rng.uniform(-2.5, 2.5), vy=rng.uniform(-2.0, 2.0),
            )
        )

    frames = np.empty((n_frames, h, w, 3), np.uint8)
    labels = np.zeros((n_frames, h, w), np.uint8)
    offsets = dict(bg=[], spr=[[] for _ in sprites])
    for f in range(n_frames):
        ox = int(round(pad + gx * f))
        oy = int(round(pad + gy * f))
        offsets["bg"].append((ox, oy))
        frame = bg[oy : oy + h, ox : ox + w].copy()
        label = np.zeros((h, w), np.uint8)
        for si, s in enumerate(sprites):
            sx = int(round(s["x0"] + s["vx"] * f))
            sy = int(round(s["y0"] + s["vy"] * f))
            offsets["spr"][si].append((sx, sy))
            sh, sw = s["mask"].shape
            x1, y1 = max(sx, 0), max(sy, 0)
            x2, y2 = min(sx + sw, w), min(sy + sh, h)
            if x2 <= x1 or y2 <= y1:
                continue
            m = s["mask"][y1 - sy : y2 - sy, x1 - sx : x2 - sx]
            frame[y1:y2, x1:x2][m] = s["tex"][y1 - sy : y2 - sy, x1 - sx : x2 - sx][m]
            label[y1:y2, x1:x2][m] = s["cls"]
        frames[f] = frame
        labels[f] = label
    offsets["meta"] = [(s["cls"], s["mask"]) for s in sprites]
    return frames, labels, offsets


def gt_merged_map(offsets, sprites_meta, labels, cur, key, h, w):
    """Exact merged-MV map (current -> keyframe) honoring z-order: each
    pixel moves with the object visible at it in the CURRENT frame.
    sprites_meta: list of (cls, mask) in paint order."""
    flow = np.empty((h, w, 2), np.float32)
    bx_c, by_c = offsets["bg"][cur]
    bx_k, by_k = offsets["bg"][key]
    flow[..., 0] = bx_c - bx_k
    flow[..., 1] = by_c - by_k
    for si, (cls, mask) in enumerate(sprites_meta):
        sx_c, sy_c = offsets["spr"][si][cur]
        sx_k, sy_k = offsets["spr"][si][key]
        sh, sw = mask.shape
        x1, y1 = max(sx_c, 0), max(sy_c, 0)
        x2, y2 = min(sx_c + sw, w), min(sy_c + sh, h)
        if x2 <= x1 or y2 <= y1:
            continue
        m = mask[y1 - sy_c : y2 - sy_c, x1 - sx_c : x2 - sx_c].copy()
        # only pixels still owned by this sprite in the rendered label
        # (later sprites painted over it take their own motion)
        m &= labels[cur][y1:y2, x1:x2] == cls
        # content at x in `cur` (object-local u = x - s_c) sits at u + s_k in
        # the keyframe: MV = s_k - s_c (current + MV = keyframe position)
        flow[y1:y2, x1:x2, 0][m] = sx_k - sx_c
        flow[y1:y2, x1:x2, 1][m] = sy_k - sy_c
    return flow


def write_bin(path, flow):
    """int16 quarter-pel .bin in the dataset reader's layout
    (`dataset/camvid.py:624-626`: np.fromfile int16 [h,w,2] / 4)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    q = np.round(np.asarray(flow, np.float32) * 4.0)
    np.clip(q, -32768, 32767, out=q)
    q.astype(np.int16).tofile(path)


def generate(
    root,
    n_train=96,
    n_val=16,
    n_test=24,
    h=288,
    w=384,
    gop=12,
    bitrate=3000,
    seed=0,
    progress=print,
):
    """Build the clean side of the dataset: annotated splits, source frames,
    ground-truth merged-MV maps (test split: all distances; train/val:
    dist gop-1 only, mirroring what the codec tree provides)."""
    from PIL import Image

    assert gop == 12 and CHAPTER == 2 * gop, "chapter layout assumes GOP 12"
    info = SCENE_LENGTH_INFO[SCENE]
    offset = info["dataset_start_idx"] - info["encoded_start_idx"]
    camvid_root = os.path.join(root, "camvid")
    seq_root = os.path.join(root, "camvid-sequence")
    frames_dir = os.path.join(seq_root, "frames", SCENE)
    gt_root = os.path.join(seq_root, f"{bitrate // 1000}M-GOP{gop}")
    os.makedirs(frames_dir, exist_ok=True)

    split_of = (
        ["train"] * n_train + ["val"] * n_val + ["test"] * n_test
    )
    rng_master = np.random.RandomState(seed)
    for c, split in enumerate(split_of):
        rng = np.random.RandomState(rng_master.randint(0, 2**31 - 1))
        frames, labels, offsets = render_chapter(h, w, rng)
        sprites_meta = offsets["meta"]

        base_enc = info["encoded_start_idx"] + c * CHAPTER
        annot_enc = base_enc + ANNOT_POS
        annot_name = f"{SCENE}_{annot_enc + offset:06d}"

        for f in range(CHAPTER):
            Image.fromarray(frames[f]).save(
                os.path.join(frames_dir, f"{SCENE}_{base_enc + f:06d}.png")
            )

        img_dir = os.path.join(camvid_root, split)
        lbl_dir = os.path.join(camvid_root, f"{split}_labels_with_ignored")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        Image.fromarray(frames[ANNOT_POS]).save(os.path.join(img_dir, annot_name + ".png"))
        Image.fromarray(labels[ANNOT_POS]).save(os.path.join(lbl_dir, annot_name + ".png"))

        dists = range(gop) if split == "test" else (gop - 1,)
        for d in dists:
            key = ANNOT_POS - d
            flow = gt_merged_map(offsets, sprites_meta, labels, ANNOT_POS, key, h, w)
            write_bin(
                os.path.join(gt_root, f"MVmapGT_GOP{gop}_dist_{d}", SCENE, annot_name + ".bin"),
                flow,
            )
        if progress and (c + 1) % 16 == 0:
            progress(f"chapter {c + 1}/{len(split_of)} ({split})")
    return camvid_root, seq_root
