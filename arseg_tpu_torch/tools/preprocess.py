"""Compressed-dataset generation (CamVid / Cityscapes) — a copy of
``arseg_tpu/tools/preprocess.py`` over the port's binding of the native
library, whose ``NativeUnavailable`` says why it could not be built or
loaded.

Produces the exact directory/naming contract the datasets consume
(reference pre-process/generate_compressed_dataset_camvid.py:99-294 and
..._cityscapes.py:72-214):

    <root>/<B>M-GOP<G>/decoded_GOP<G>_dist_<d>/<split>/<annotated frame>.png
    <root>/<B>M-GOP<G>/MVmap_GOP<G>_dist_<d>/<scene>/<frame>.bin
    <root>/<B>M-GOP<G>/frames/<scene>/<keyframe>.png

but runs the whole codec chain in-process through the native arsegvid
library (one call per GOP window — encode HEVC, decode, dump + merge MVs)
instead of shelling out to ffmpeg/x265/dec265 per frame.

Train/val only need dist = ref_gap - 1 (the training keyframe gap); test
needs every distance for the mIoU_d protocol (reference ...camvid.py:105-109).
"""

import os
import shutil
import tempfile

from arseg_tpu_torch.data.camvid import SCENE_LENGTH_INFO, dataset_frame_idx
from arseg_tpu_torch.tools.video import load_native


def _window_pipeline(native, image_paths, workspace, fps, bitrate, gop, key_dist,
                     mv_source="hevc"):
    os.makedirs(workspace, exist_ok=True)
    native.gop_pipeline(
        image_paths, workspace, fps=fps, bitrate_kbps=bitrate, gop=gop,
        merge_upto=key_dist, mv_source=mv_source,
    )


def _collect(workspace, key_dist, decoded_dst, keyframe_dst, mv_dst):
    """Publish the three artifacts of one GOP window."""
    shutil.copy(os.path.join(workspace, f"decoded-{key_dist + 1:03d}.png"), decoded_dst)
    shutil.copy(os.path.join(workspace, "decoded-001.png"), keyframe_dst)
    if key_dist > 0 and mv_dst is not None:
        shutil.copy(os.path.join(workspace, f"merged_test_{key_dist:03d}.bin"), mv_dst)


def generate_compressed_camvid(
    camvid_root,
    sequence_root,
    ref_gap=12,
    bitrate=3000,
    fps=30,
    splits=("train", "val", "test"),
    key_dists=None,
    workspace=None,
    progress=print,
    mv_source="hevc",
):
    """CamVid: annotated frames live in `<camvid_root>/<split>/`, full video
    frames in `<sequence_root>/frames/<scene>/`. The annotated<->encoded
    index offset comes from SCENE_LENGTH_INFO (reference ...camvid.py:58-83,151).

    mv_source: 'hevc' (default) takes MVs from the HEVC encode's own
    analysis dump — the bitstream's actual PU motion field, equivalent to
    the reference's libde265-MV decode-side dump (.gitmodules:1-3);
    'carrier' keeps the legacy H.264 re-encode source."""
    native = load_native()  # raises NativeUnavailable with make's or the loader's reason

    out_root = os.path.join(sequence_root, f"{bitrate // 1000}M-GOP{ref_gap}")
    orig_dir = os.path.join(sequence_root, "frames")
    ws_root = workspace or tempfile.mkdtemp(prefix="arseg-pre-")

    for key_dist in key_dists if key_dists is not None else range(ref_gap):
        decoded_dir = os.path.join(out_root, f"decoded_GOP{ref_gap}_dist_{key_dist}")
        mv_dir = os.path.join(out_root, f"MVmap_GOP{ref_gap}_dist_{key_dist}")
        frames_dir = os.path.join(out_root, "frames")
        for split in splits:
            if split != "test" and key_dist != ref_gap - 1:
                continue
            # annotated labels ride along by symlink (reference ...camvid.py:111-121)
            src_labels = os.path.join(camvid_root, f"{split}_labels_with_ignored")
            dst_labels = os.path.join(decoded_dir, f"{split}_labels_with_ignored")
            os.makedirs(decoded_dir, exist_ok=True)
            if os.path.isdir(src_labels) and not os.path.exists(dst_labels):
                os.symlink(src_labels, dst_labels)

            annotated = set(os.listdir(os.path.join(camvid_root, split)))
            for scene in sorted(os.listdir(orig_dir)):
                scene_dir = os.path.join(orig_dir, scene)
                image_list = sorted(os.listdir(scene_dir))
                info = SCENE_LENGTH_INFO[scene]
                offset = info["dataset_start_idx"] - info["encoded_start_idx"]
                out_split_dir = os.path.join(decoded_dir, split)
                out_mv_dir = os.path.join(mv_dir, scene)
                out_frames_dir = os.path.join(frames_dir, scene)
                for d in (out_split_dir, out_mv_dir, out_frames_dir):
                    os.makedirs(d, exist_ok=True)

                for pos, name in enumerate(image_list):
                    # the annotated-dataset name this encoded frame maps to
                    enc_idx = dataset_frame_idx(name, scene)
                    parts = name.split("_")
                    parts[1] = _camvid_dst_token(scene, enc_idx + offset)
                    dst_name = "_".join(parts)
                    if dst_name not in annotated:
                        continue
                    lo, hi = pos - key_dist, pos - key_dist + ref_gap
                    if lo < 0 or hi > len(image_list):
                        continue
                    window = [os.path.join(scene_dir, n) for n in image_list[lo:hi]]
                    ws = os.path.join(ws_root, "gop")
                    shutil.rmtree(ws, ignore_errors=True)
                    _window_pipeline(native, window, ws, fps, bitrate,
                                     ref_gap, key_dist, mv_source)
                    key_idx = enc_idx - key_dist
                    _collect(
                        ws, key_dist,
                        decoded_dst=os.path.join(out_split_dir, dst_name),
                        keyframe_dst=os.path.join(out_frames_dir, f"{scene}_{key_idx:06d}.png"),
                        mv_dst=os.path.join(out_mv_dir, dst_name[:-4] + ".bin"),
                    )
                    progress(f"dist {key_dist} {split} {dst_name}")
    if workspace is None:
        shutil.rmtree(ws_root, ignore_errors=True)
    return out_root


def _camvid_dst_token(scene, idx):
    """Scene-specific frame-number token of annotated CamVid filenames
    (reference ...camvid.py:187-192)."""
    if scene == "0001TP":
        return f"{idx:06d}.png"
    if scene in ("0006R0", "Seq05VD"):
        return f"f{idx:05d}.png"
    if scene == "0016E5":
        return f"{idx:05d}.png"
    raise ValueError(f"unknown scene {scene}")


def generate_compressed_cityscapes(
    cityscapes_root,
    ref_gap=12,
    bitrate=5000,
    fps=30,
    splits=("train", "val"),
    key_dists=None,
    workspace=None,
    progress=print,
    mv_source="hevc",
):
    """Cityscapes: annotated frame is index 19 of each 30-frame snippet in
    `leftImg8bit_sequence/<split>/<city>/`; the GOP window ends at the
    annotated frame (reference ..._cityscapes.py:122-146). Only `val` needs
    every distance (reference ..._cityscapes.py:81)."""
    native = load_native()  # raises NativeUnavailable with make's or the loader's reason

    seq_root = os.path.join(cityscapes_root, "leftImg8bit_sequence")
    out_root = os.path.join(seq_root, f"{bitrate // 1000}M-GOP{ref_gap}")
    ws_root = workspace or tempfile.mkdtemp(prefix="arseg-pre-")

    for key_dist in key_dists if key_dists is not None else range(ref_gap):
        decoded_dir = os.path.join(
            out_root, f"decoded_GOP{ref_gap}_dist_{key_dist}", "leftImg8bit"
        )
        mv_dir = os.path.join(out_root, f"MVmap_GOP{ref_gap}_dist_{key_dist}")
        frames_dir = os.path.join(out_root, "frames")
        for split in splits:
            if split != "val" and key_dist != ref_gap - 1:
                continue
            split_dir = os.path.join(cityscapes_root, "leftImg8bit", split)
            if not os.path.isdir(split_dir):
                continue
            for city in sorted(os.listdir(split_dir)):
                seq_city = os.path.join(seq_root, split, city)
                out_img_dir = os.path.join(decoded_dir, split, city)
                out_mv_dir = os.path.join(mv_dir, split, city)
                out_frames_dir = os.path.join(frames_dir, split, city)
                for d in (out_img_dir, out_mv_dir, out_frames_dir):
                    os.makedirs(d, exist_ok=True)
                for fn in sorted(os.listdir(os.path.join(split_dir, city))):
                    # <city>_<seq>_<frame>_leftImg8bit.png
                    stem = fn.split("_")
                    frame_idx = int(stem[2])
                    start_idx = frame_idx - key_dist
                    window = [
                        os.path.join(
                            seq_city,
                            "_".join(stem[:2] + [f"{i:06d}", "leftImg8bit.png"]),
                        )
                        for i in range(start_idx, start_idx + ref_gap)
                    ]
                    if not all(os.path.exists(p) for p in window):
                        continue
                    ws = os.path.join(ws_root, "gop")
                    shutil.rmtree(ws, ignore_errors=True)
                    _window_pipeline(native, window, ws, fps, bitrate,
                                     ref_gap, key_dist, mv_source)
                    key_name = "_".join(stem[:2] + [f"{start_idx:06d}", "leftImg8bit.png"])
                    _collect(
                        ws, key_dist,
                        decoded_dst=os.path.join(out_img_dir, fn),
                        keyframe_dst=os.path.join(out_frames_dir, key_name),
                        mv_dst=os.path.join(out_mv_dir, fn[:-4] + ".bin"),
                    )
                    progress(f"dist {key_dist} {split} {fn}")
    if workspace is None:
        shutil.rmtree(ws_root, ignore_errors=True)
    return out_root
