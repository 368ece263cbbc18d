"""Evaluation command — port of ``arseg_tpu/cli/evaluation.py`` (the
reference's flag surface, ``evaluation.py:221-234``):

    python -m arseg_tpu_torch.cli.evaluation --dataset camvid --backbone psp18 \\
        --mode 1 0 1 --GOP 12 --test_scale 0.5 \\
        --data_root ./data --ckpt_root ./checkpoints --result_dir ./evaluation-result

``--num_devices N`` spreads the frames over N ranks (``data_group``, the
histograms summed); it runs under torchrun, one process per device, and a
rank outside the group does nothing. ``--device`` (default ``cuda``) names
the device.
"""

import argparse

import torch
import torch.distributed as dist

from arseg_tpu_torch.cli._launch import launched
from arseg_tpu_torch.eval.protocol import run_protocol
from arseg_tpu_torch.parallel import data_group


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation.")
    parser.add_argument("--mode", type=int, nargs="+", default=[1, 1, 1],
                        help="Eval or not with HR / LR / AR")
    parser.add_argument("--result_dir", type=str, default="./evaluation-result")
    parser.add_argument("--ckpt_root", type=str, default="./checkpoints")
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--dataset", type=str, default="camvid")
    parser.add_argument("--backbone", type=str, default="psp18")
    parser.add_argument("--GOP", type=int, default=12, help="GOP size")
    parser.add_argument("--test_scale", type=float, default=0.5)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--flow_shape", type=int, nargs=2, default=None,
                        help="MV map H W (defaults to the dataset's full resolution: camvid "
                             "720 960, cityscapes 1024 2048)")
    parser.add_argument("--num_devices", type=int, default=1,
                        help=">1 spreads eval frames over that many ranks (summed confusion "
                             "histogram); run under torchrun with one process per device")
    parser.add_argument("--dtype", type=str, default=None, choices=["bfloat16", "float32"],
                        help="serving dtype for the forward passes (default: the checkpoint's, "
                             "float32)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with launched(args.num_devices, args.device, "evaluation"):
        mesh = None
        if args.num_devices > 1 or dist.is_initialized():
            mesh = data_group(args.num_devices, device=args.device)
            if mesh is None:  # a rank outside the group
                return
        run_protocol(
            dataset=args.dataset,
            backbone=args.backbone,
            mode=tuple(args.mode),
            gop=args.GOP,
            test_scale=args.test_scale,
            data_root=args.data_root,
            ckpt_root=args.ckpt_root,
            result_dir=args.result_dir,
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            flow_shape=tuple(args.flow_shape) + (2,) if args.flow_shape else None,
            mesh=mesh,
            dtype=getattr(torch, args.dtype) if args.dtype else None,
            device=args.device,
        )


if __name__ == "__main__":
    main()
