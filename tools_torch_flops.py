"""Operations per GOP of the port's PSPNets, counted on the CPU.

    python3 tools_torch_flops.py

For camvid PSPNet V1 on each backbone the trainers accept (720x960, LR
0.5x) and the cityscapes PSPNetSemseg on ResNet-18 and ResNet-50
(1024x2048), counts the FLOPs of one HR keyframe forward (``forward_key``)
and one LR phase-1 forward with ``torch.utils.flop_counter`` at 1/8 of
the size in each dimension, and scales them by 64 (convolutions' work
grows with the pixels; the pyramid pools' fixed bins are a rounding
error). A GOP is one HR forward and 11 LR ones; the fusion and head after
phase 1, which run the hand-written kernels, are not counted. A count,
not a measurement: it needs no card.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from arseg_tpu_torch.train.trainer import DATASET_POLICY, build_train_model

CASES = [("camvid", b) for b in ("resnet18", "resnet50", "resnet101", "resnet152", "densenet",
                                 "squeezenet")] + [("cityscapes", "resnet18"),
                                                   ("cityscapes", "resnet50")]
FULL_HW = {"camvid": (720, 960), "cityscapes": (1024, 2048)}
SHRINK = 8


def flops(fn, x):
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(x)
    return counter.get_total_flops() * SHRINK ** 2


def main():
    for dataset, backend in CASES:
        model = build_train_model("pspnet", dataset, backend,
                                  DATASET_POLICY[dataset]["n_classes"], fuse=True).eval()
        h, w = (v // SHRINK for v in FULL_HW[dataset])
        hr = flops(model.forward_key, torch.randn(1, 3, h, w))
        lr = flops(lambda x: model.forward_phase1(x, with_aux=False),
                   torch.randn(1, 3, h // 2, w // 2))
        print(f"{dataset} {backend}: HR {hr / 1e9:.0f} GFLOP, LR {lr / 1e9:.0f} GFLOP, "
              f"GOP (HR + 11 LR) {(hr + 11 * lr) / 1e12:.2f} TFLOP", flush=True)


if __name__ == "__main__":
    main()
