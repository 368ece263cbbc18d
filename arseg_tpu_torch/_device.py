"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a default
of ``"cuda"`` with no card present is an error, never a silent CPU run."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises if a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def set_f32_parity_mode():
    """Full-precision float32 convolutions and matmuls on the card: cuDNN
    runs float32 convolutions in TF32 by default (about three decimal
    digits), which breaks parity checks against the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
