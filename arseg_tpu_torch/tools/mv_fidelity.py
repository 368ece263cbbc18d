"""MV-carrier fidelity measurement.

A copy of ``arseg_tpu/tools/mv_fidelity.py`` over the port's own binding
of the native library (``tools/video.py``), whose ``NativeUnavailable``
says why the library could not be built or loaded.

The reference gets its motion vectors for free from the HEVC stream it
decodes (libde265-MV fork, reference `.gitmodules:1-3`, consumed at
`pre-process/generate_compressed_dataset_camvid.py:16-17,242`). This rebuild
extracts MVs from an H.264 re-encode of the same frames
(native/arsegvid.cpp) — a different codec's motion search over a different
rate allocation. This tool quantifies what that substitution costs:

  * photometric: PSNR of the merged-MV-warped decoded keyframe against the
    decoded frame at each distance d, vs the no-compensation baseline
    (warping with the true scene motion must beat "assume nothing moved";
    the margin is the useful-signal measure the CReFF fusion feeds on);
  * geometric (synthetic mode): median/mean endpoint error of the merged
    MVs against the known ground-truth displacement field.

Usage:
  python -m arseg_tpu_torch.tools.mv_fidelity --synthetic --gop 12 --size 192 256
  python -m arseg_tpu_torch.tools.mv_fidelity --frames 'seq/*.png' --gop 12

Prints one JSON row per distance plus a summary row.
"""

import argparse
import glob
import json
import os
import tempfile

import numpy as np

from arseg_tpu_torch.tools.video import load_native


def _smooth_noise(rng, h, w, octaves=3):
    img = np.zeros((h, w, 3), np.float32)
    for o in range(octaves):
        s = 2 ** (octaves - o)
        small = rng.rand(h // s + 2, w // s + 2, 3).astype(np.float32)
        big = np.kron(small, np.ones((s, s, 1), np.float32))[:h, :w]
        img += big / (o + 1)
    img -= img.min()
    return (img / img.max() * 255).astype(np.uint8)


def synth_frames(out_dir, n=12, h=192, w=256, seed=0, n_sprites=3):
    """Multi-object synthetic GOP: panning textured background + sprites
    moving with distinct (sub-pixel) velocities. Returns (paths, gt) with
    gt[d] = float32 [h, w, 2] true displacement field frame d -> frame 0
    (x, y), the quantity the merged MV maps approximate (sign convention of
    the reference's merged maps: current position + MV = keyframe position).
    """
    from PIL import Image

    rng = np.random.RandomState(seed)
    pad = 4 * n
    bg = _smooth_noise(rng, h + 2 * pad, w + 2 * pad)
    gx, gy = 2.0, 1.0  # background pan, px/frame
    sprites = []
    for _ in range(n_sprites):
        sh, sw = rng.randint(h // 6, h // 3), rng.randint(w // 6, w // 3)
        tex = _smooth_noise(rng, sh, sw)
        x0, y0 = rng.randint(0, w - sw), rng.randint(0, h - sh)
        vx, vy = rng.uniform(-3, 3), rng.uniform(-2, 2)
        sprites.append(dict(tex=tex, x0=x0, y0=y0, vx=vx, vy=vy))

    os.makedirs(out_dir, exist_ok=True)
    paths, gts = [], []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for f in range(n):
        ox, oy = int(round(pad + gx * f)), int(round(pad + gy * f))
        frame = bg[oy : oy + h, ox : ox + w].copy()
        # ground truth: displacement current -> keyframe (ancestor - current,
        # the merged-map convention). The crop window pans right by gx/frame,
        # so content seen at x in frame f sat at x + gx*f in frame 0.
        gt = np.empty((h, w, 2), np.float32)
        gt[..., 0] = round(pad + gx * f) - pad
        gt[..., 1] = round(pad + gy * f) - pad
        for s in sprites:
            sx = int(round(s["x0"] + s["vx"] * f))
            sy = int(round(s["y0"] + s["vy"] * f))
            sh, sw = s["tex"].shape[:2]
            x1, y1 = max(sx, 0), max(sy, 0)
            x2, y2 = min(sx + sw, w), min(sy + sh, h)
            if x2 <= x1 or y2 <= y1:
                continue
            frame[y1:y2, x1:x2] = s["tex"][y1 - sy : y2 - sy, x1 - sx : x2 - sx]
            # sprite pixels map back to the sprite's frame-0 position
            gt[y1:y2, x1:x2, 0] = (s["x0"] - sx)
            gt[y1:y2, x1:x2, 1] = (s["y0"] - sy)
        p = os.path.join(out_dir, f"{f:03d}.png")
        Image.fromarray(frame).save(p)
        paths.append(p)
        gts.append(gt)
    return paths, np.stack(gts)


def _warp_np(img, flow):
    """Backward bilinear warp: sample img at (x + flow_x, y + flow_y)."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = np.clip(xx + flow[..., 0], 0, w - 1)
    sy = np.clip(yy + flow[..., 1], 0, h - 1)
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    im = img.astype(np.float32)
    return (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def measure(paths, gop=12, bitrate_kbps=3000, fps=30, gt=None, workdir=None,
            mv_source="carrier"):
    """Run the native GOP pipeline on `paths` (one GOP) and score the merged
    MV maps. mv_source: 'carrier' (H.264 re-encode) or 'hevc' (the HEVC
    encode's own analysis MVs). Returns a list of per-distance dicts."""
    from PIL import Image

    nv = load_native()  # raises NativeUnavailable with make's or the loader's reason
    tmp_ctx = tempfile.TemporaryDirectory() if workdir is None else None
    wd = workdir or tmp_ctx.name
    n = len(paths)
    nv.gop_pipeline(paths, wd, fps=fps, bitrate_kbps=bitrate_kbps, gop=gop,
                    merge_upto=n - 1, mv_source=mv_source)

    dec = [
        np.asarray(Image.open(os.path.join(wd, f"decoded-{f + 1:03d}.png")))
        for f in range(n)
    ]
    h, w = dec[0].shape[:2]
    key = dec[0]
    rows = []
    for d in range(1, n):
        mv = np.fromfile(
            os.path.join(wd, f"merged_test_{d:03d}.bin"), dtype=np.int16
        ).reshape(h, w, 2).astype(np.float32) / 4.0
        warped = _warp_np(key, mv)
        row = dict(
            distance=d,
            psnr_warp=round(_psnr(warped, dec[d]), 2),
            psnr_nowarp=round(_psnr(key, dec[d]), 2),
            mv_mag_p50=round(float(np.median(np.abs(mv))), 2),
            mv_mag_p99=round(float(np.percentile(np.abs(mv), 99)), 2),
        )
        if gt is not None:
            epe = np.sqrt(np.sum((mv - gt[d]) ** 2, axis=-1))
            row["epe_p50"] = round(float(np.median(epe)), 2)
            row["epe_mean"] = round(float(np.mean(epe)), 2)
        rows.append(row)
    if tmp_ctx is not None:
        tmp_ctx.cleanup()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", default=None, help="glob of source frame PNGs (one GOP)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--size", type=int, nargs=2, default=(192, 256))
    p.add_argument("--gop", type=int, default=12)
    p.add_argument("--bitrate", type=int, default=3000, help="kbps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mv_source", choices=("carrier", "hevc"),
                   default="carrier")
    args = p.parse_args(argv)

    gt = None
    if args.synthetic:
        tmp = tempfile.TemporaryDirectory()
        paths, gt = synth_frames(
            tmp.name, n=args.gop, h=args.size[0], w=args.size[1], seed=args.seed
        )
    elif args.frames:
        paths = sorted(glob.glob(args.frames))[: args.gop]
        if len(paths) < 2:
            raise SystemExit(f"need >= 2 frames, got {len(paths)}")
    else:
        raise SystemExit("pass --frames or --synthetic")

    rows = measure(paths, gop=args.gop, bitrate_kbps=args.bitrate, gt=gt,
                   mv_source=args.mv_source)
    for r in rows:
        print(json.dumps(r))
    gain = [r["psnr_warp"] - r["psnr_nowarp"] for r in rows]
    summary = dict(
        mean_psnr_gain_db=round(float(np.mean(gain)), 2),
        min_psnr_gain_db=round(float(np.min(gain)), 2),
    )
    if gt is not None:
        summary["epe_p50_worst"] = max(r["epe_p50"] for r in rows)
    print(json.dumps({"summary": summary}))
    return rows


if __name__ == "__main__":
    main()
