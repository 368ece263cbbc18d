"""Extract the CamVid source videos to per-scene PNG frame directories — a
copy of ``arseg_tpu/tools/camvid_decode.py`` over the port's binding of the
native library, whose ``NativeUnavailable`` says why it could not be built
or loaded.

Equivalent of reference pre-process/camvid_decode.sh:1-12 (four ffmpeg CLI
calls), but runs through the native arsegvid decoder (libavformat handles the
source containers), since this image ships no ffmpeg binary.

Output naming matches the sequence layout the generators crawl:
`<out_root>/frames/<scene>/` with the decoder's `decoded-%03d.png` names —
rename_map converts them to the scene's frame-number convention.
"""

import os
import sys

from arseg_tpu_torch.tools.video import load_native

# scene -> source video filename (reference camvid_decode.sh:9-12)
CAMVID_VIDEOS = {
    "0001TP": "01TP_extract.avi",
    "0006R0": "0006R0.MXF",
    "0016E5": "0016E5.MXF",
    "Seq05VD": "05VD.MXF",
}


def decode_camvid_videos(video_dir, out_root, videos=CAMVID_VIDEOS, progress=print):
    native = load_native()  # raises NativeUnavailable with make's or the loader's reason
    for scene, fname in videos.items():
        src = os.path.join(video_dir, fname)
        if not os.path.exists(src):
            progress(f"skip {scene}: {src} not found")
            continue
        dst = os.path.join(out_root, "frames", scene)
        os.makedirs(dst, exist_ok=True)
        n = native.decode(src, dst)
        # decoded-NNN.png (1-based) -> <scene>_<frame:06d>.png (0-based)
        for i in range(1, n + 1):
            os.rename(
                os.path.join(dst, f"decoded-{i:03d}.png"),
                os.path.join(dst, f"{scene}_{i - 1:06d}.png"),
            )
        progress(f"{scene}: {n} frames")


if __name__ == "__main__":
    decode_camvid_videos(sys.argv[1], sys.argv[2])
