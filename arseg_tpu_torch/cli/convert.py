"""Checkpoint conversion command — port of ``arseg_tpu/cli/convert.py``:

    python -m arseg_tpu_torch.cli.convert SRC DST [--backend B] [--dataset ...]

* default: SRC is a reference ``.pth`` (a bare state dict or
  ``{"state_dict": ...}``, with or without DataParallel's ``module.``) or a
  JAX ``.npz`` (with ``--backend``, which picks its key names); DST is the
  port's ``.pth`` (``utils/checkpoint.save_checkpoint``'s layout), with
  ``--backend``, ``--dataset``, ``--scale``, ``--epoch``, ``--miou`` and the
  source path in its ``"metadata"``, as the JAX command writes its
  ``.json``.
* ``--to_torch``: SRC is a checkpoint of the port; DST the bare state dict
  in the reference's layout, its keys prefixed with ``module.`` under
  ``--data_parallel``. The DenseNet and SqueezeNet families are refused, as
  the JAX exporter refuses them.

It runs on the host and needs no card.
"""

import argparse

import torch

from arseg_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from arseg_tpu_torch.utils.convert import family

NOT_EXPORTED = ("psp-densenet", "psp-squeezenet")


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert reference .pth checkpoints.")
    p.add_argument("src", help=".pth state_dict or JAX .npz (a port checkpoint with --to_torch)")
    p.add_argument("dst", help="output .pth checkpoint of the port (reference .pth with "
                               "--to_torch)")
    p.add_argument("--to_torch", action="store_true",
                   help="reverse direction: a port checkpoint -> reference .pth")
    p.add_argument("--data_parallel", action="store_true",
                   help="with --to_torch: prefix keys with 'module.' (nn.DataParallel layout)")
    p.add_argument("--backend", default=None,
                   help="key-alias family: camvid-psp18 | cityscapes-psp18 | camvid-bise18 | "
                        "cityscapes-bise18 | psp-densenet | psp-squeezenet")
    p.add_argument("--dataset", default=None)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--miou", type=float, default=None)
    args = p.parse_args(argv)

    if args.to_torch:
        if args.backend is not None and family(args.backend) in NOT_EXPORTED:
            raise NotImplementedError(
                f"export_state_dict does not support backend {args.backend!r} "
                "(ablation backbones; export the four headline configs)")
        sd = load_checkpoint(args.src, args.backend)["state_dict"]
        if args.data_parallel:
            sd = {f"module.{k}": v for k, v in sd.items()}
        torch.save(sd, args.dst)
        print(args.dst)
        return

    sd = load_checkpoint(args.src, args.backend)["state_dict"]
    meta = {k: v for k, v in dict(backend=args.backend, dataset=args.dataset, scale=args.scale,
                                  epoch=args.epoch, miou=args.miou, source=args.src).items()
            if v is not None}
    save_checkpoint(args.dst, sd, metadata=meta)
    print(args.dst)


if __name__ == "__main__":
    main()
