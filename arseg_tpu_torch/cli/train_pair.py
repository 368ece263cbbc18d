"""Phase-2 (FST + CReFF) training command — port of
``arseg_tpu/cli/train_pair.py`` (the flag surface of reference
``train_pair.py:65-90``, plus --teacher_snapshot):

    python -m arseg_tpu_torch.cli.train_pair --data-path D --sequence-path S \\
        --models-path M --teacher_snapshot HR.pth ...

As in the JAX command, ``--milestones``, ``--crop_x`` and ``--crop_y`` are
parsed and not used (the reference's flags; the crop comes from the
dataset policy). ``--device`` (default ``cuda``) names the device; several
cards run under torchrun (``cli/_launch.py``).
"""

import argparse

from arseg_tpu_torch.cli._launch import launched
from arseg_tpu_torch.train.trainer import train_phase2


def main(argv=None):
    p = argparse.ArgumentParser(description="Phase-2 (LR + CReFF + FST) training.")
    p.add_argument("--data-path", required=True)
    p.add_argument("--sequence-path", required=True)
    p.add_argument("--models-path", required=True)
    p.add_argument("--backend", default="resnet34")
    p.add_argument("--snapshot", default=None)
    p.add_argument("--resume", default=None, metavar="CKPT.pth",
                   help="true resume from a trainer checkpoint: weights + optimizer state + "
                        "epoch/best-mIoU cursors (vs --snapshot: weights-only warm start, "
                        "fresh optimizer)")
    p.add_argument("--crop_x", type=int, default=256)
    p.add_argument("--crop_y", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--start-lr", type=float, default=0.001)
    p.add_argument("--milestones", default="10,20,30")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--feat_loss", default=None)
    p.add_argument("--atten_type", default="local")
    p.add_argument("--atten_k", type=int, default=7)
    p.add_argument("--stage1_epoch", type=int, default=50)
    p.add_argument("--ref_gap", type=int, default=2)
    p.add_argument("--bitrate", type=int, default=3)
    p.add_argument("--with_motion", type=int, default=0)
    p.add_argument("--model_type", default="pspnet")
    p.add_argument("--dataset", default="camvid")
    p.add_argument("--fuse_version", type=int, default=1)
    p.add_argument("--teacher_snapshot", required=True)
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks of the data-parallel group (all when omitted); above 1, run "
                        "under torchrun with one process per device")
    p.add_argument("--seed", type=int, default=689)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches (train/step.py)")
    p.add_argument("--flow_shape", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="MV-bin spatial shape when it differs from the dataset default "
                        "(720x960 CamVid / 1024x2048 Cityscapes)")
    p.add_argument("--bn_mode", default="sync", choices=["sync", "master"],
                   help="BN stats: global-batch (sync) or DataParallel-faithful replica-0 (master)")
    p.add_argument("--train_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed-precision compute (float32 master weights, optimizer "
                        "state, BN stats and losses)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    with launched(args.num_devices, args.device, "train_pair"):
        train_phase2(
            data_path=args.data_path,
            sequence_path=args.sequence_path,
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
            atten_type=args.atten_type,
            atten_k=args.atten_k,
            stage1_epoch=args.stage1_epoch,
            ref_gap=args.ref_gap,
            bitrate=args.bitrate,
            with_motion=bool(args.with_motion),
            model_type=args.model_type,
            dataset=args.dataset,
            fuse_version=args.fuse_version,
            teacher_snapshot=args.teacher_snapshot,
            num_devices=args.num_devices,
            seed=args.seed,
            bn_mode=args.bn_mode,
            train_dtype=args.train_dtype,
            accum_steps=args.accum_steps,
            flow_shape=(tuple(args.flow_shape) + (2,)) if args.flow_shape else None,
            device=args.device,
        )


if __name__ == "__main__":
    main()
