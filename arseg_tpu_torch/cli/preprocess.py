"""Compressed-dataset generation CLI (L0 pipeline) — the port's copy of
``arseg_tpu/cli/preprocess.py``, with its flags and defaults, over the
port's ``tools``. Run it as ``python -m arseg_tpu_torch.cli.preprocess``.
It needs the native library (``native/``, built on first use with the
FFmpeg development stack) for every subcommand but ``labels``.

Equivalent of running the reference's pre-process scripts
(`generate_compressed_dataset_camvid.py`, `..._cityscapes.py`,
`camvid-pre-process.py`, `camvid_decode.sh`) — backed by the native
arsegvid codec runtime instead of x265/dec265/ffmpeg CLIs.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="AR-Seg dataset preprocessing.")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("camvid", help="generate compressed CamVid sequence data")
    g.add_argument("--camvid_root", required=True)
    g.add_argument("--sequence_root", required=True)
    g.add_argument("--gop", type=int, default=12)
    g.add_argument("--bitrate", type=int, default=3000)
    g.add_argument("--fps", type=int, default=30)
    g.add_argument("--splits", default="train,val,test")
    g.add_argument("--mv_source", choices=("hevc", "carrier"), default="hevc",
                   help="hevc = MVs from the HEVC encode's own analysis dump "
                        "(default; the reference-faithful source), carrier = "
                        "legacy H.264 re-encode MVs")

    c = sub.add_parser("cityscapes", help="generate compressed Cityscapes data")
    c.add_argument("--cityscapes_root", required=True)
    c.add_argument("--gop", type=int, default=12)
    c.add_argument("--bitrate", type=int, default=5000)
    c.add_argument("--fps", type=int, default=30)
    c.add_argument("--splits", default="train,val")
    c.add_argument("--mv_source", choices=("hevc", "carrier"), default="hevc")

    l = sub.add_parser("labels", help="CamVid RGB label PNGs -> index maps")
    l.add_argument("label_dir")
    l.add_argument("--out", default=None)

    d = sub.add_parser("decode", help="extract CamVid source videos to frames")
    d.add_argument("video_dir")
    d.add_argument("out_root")

    args = p.parse_args(argv)
    if args.cmd == "camvid":
        from arseg_tpu_torch.tools.preprocess import generate_compressed_camvid

        generate_compressed_camvid(
            args.camvid_root, args.sequence_root, ref_gap=args.gop,
            bitrate=args.bitrate, fps=args.fps, splits=tuple(args.splits.split(",")),
            mv_source=args.mv_source,
        )
    elif args.cmd == "cityscapes":
        from arseg_tpu_torch.tools.preprocess import generate_compressed_cityscapes

        generate_compressed_cityscapes(
            args.cityscapes_root, ref_gap=args.gop, bitrate=args.bitrate,
            fps=args.fps, splits=tuple(args.splits.split(",")),
            mv_source=args.mv_source,
        )
    elif args.cmd == "labels":
        from arseg_tpu_torch.tools.labels import convert_label_dir

        print(convert_label_dir(args.label_dir, args.out))
    elif args.cmd == "decode":
        from arseg_tpu_torch.tools.camvid_decode import decode_camvid_videos

        decode_camvid_videos(args.video_dir, args.out_root)


if __name__ == "__main__":
    main()
