"""Phase-1 training command — port of ``arseg_tpu/cli/train.py`` (the flag
surface of reference ``train.py:61-75``, plus --teacher_snapshot):

    python -m arseg_tpu_torch.cli.train --data-path D --models-path M ...

``--resume`` takes a checkpoint this trainer wrote (a ``.pth`` with the
optimizer state); ``--snapshot`` and ``--teacher_snapshot`` also take a
reference ``.pth`` or a JAX ``.npz``. ``--device`` (default ``cuda``)
names the device; several cards run under torchrun (``cli/_launch.py``).
"""

import argparse

from arseg_tpu_torch.cli._launch import launched
from arseg_tpu_torch.train.trainer import train_phase1


def main(argv=None):
    p = argparse.ArgumentParser(description="Phase-1 (HR / plain LR) training.")
    p.add_argument("--data-path", required=True)
    p.add_argument("--models-path", required=True)
    p.add_argument("--backend", default="resnet34")
    p.add_argument("--snapshot", default=None)
    p.add_argument("--resume", default=None, metavar="CKPT.pth",
                   help="true resume from a trainer checkpoint: weights + optimizer state + "
                        "epoch/best-mIoU cursors (vs --snapshot: weights-only warm start, "
                        "fresh optimizer)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--start-lr", type=float, default=0.001)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--feat_loss", default=None)
    p.add_argument("--dataset", default="camvid")
    p.add_argument("--model_type", default="pspnet")
    p.add_argument("--teacher_snapshot", default=None)
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks of the data-parallel group (all when omitted); above 1, run "
                        "under torchrun with one process per device")
    p.add_argument("--seed", type=int, default=233)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches (train/step.py)")
    p.add_argument("--bn_mode", default="sync", choices=["sync", "master"],
                   help="BN stats: global-batch (sync) or DataParallel-faithful replica-0 (master)")
    p.add_argument("--train_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed-precision compute (float32 master weights, optimizer "
                        "state, BN stats and losses)")
    p.add_argument("--cropsize", type=int, nargs=2, default=None, metavar=("W", "H"),
                   help="override the per-dataset crop policy (reference hard-codes it)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    with launched(args.num_devices, args.device, "train"):
        train_phase1(
            data_path=args.data_path,
            models_path=args.models_path,
            backend=args.backend,
            snapshot=args.snapshot,
            resume=args.resume,
            batch_size=args.batch_size,
            alpha=args.alpha,
            epochs=args.epochs,
            start_lr=args.start_lr,
            scale=args.scale,
            feat_loss=args.feat_loss,
            dataset=args.dataset,
            model_type=args.model_type,
            teacher_snapshot=args.teacher_snapshot,
            num_devices=args.num_devices,
            seed=args.seed,
            bn_mode=args.bn_mode,
            train_dtype=args.train_dtype,
            accum_steps=args.accum_steps,
            cropsize=tuple(args.cropsize) if args.cropsize else None,
            device=args.device,
        )


if __name__ == "__main__":
    main()
