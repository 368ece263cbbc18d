"""Model registry — port of ``arseg_tpu/models/registry.py``.

``build_model(backend, fuse)`` returns an ``nn.Module`` with weights drawn
from a seeded ``torch.Generator``, on ``device`` ("cuda" unless the caller
asks for the CPU), in eval mode. The BiSeNet backends are ported; the
PSPNet ones wait (ROADMAP Queue A, PSPNet family).
"""

import torch

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.nn.bisenet import BiSeNetV1

BISENET_CLASSES = {"camvid-bise18": 12, "cityscapes-bise18": 19}
NOT_PORTED = ("camvid-psp18", "cityscapes-psp18")


def build_model(backend: str, fuse: bool = False, *, seed: int = 0, device=None, **kw):
    backend = backend.lower()
    if backend in NOT_PORTED:
        raise NotImplementedError(
            f"{backend} is not ported yet (ROADMAP Queue A, PSPNet family)"
        )
    if backend not in BISENET_CLASSES:
        raise KeyError(f"unknown backend {backend}; options: "
                       f"{sorted(BISENET_CLASSES) + list(NOT_PORTED)}")
    model = BiSeNetV1(
        n_classes=BISENET_CLASSES[backend],
        backend="resnet18",
        aux_mode=kw.get("aux_mode", "train"),
        with_fuse=fuse,
        attention_type=kw.get("attention_type", "local"),
        atten_k=kw.get("atten_k", 7),
        generator=torch.Generator().manual_seed(seed),
    )
    return model.to(resolve_device(device)).eval()


def phase2_argmax_head(model, warped_hw, out_hw):
    """``model.forward_phase2_argmax`` when the model has it and its output
    resolution (warped feature x ``phase2_argmax_upscale``) equals out_hw;
    else None, and callers take forward_phase2 -> resize -> argmax."""
    up = getattr(model, "phase2_argmax_upscale", 1)
    if hasattr(model, "forward_phase2_argmax") and (
        warped_hw[0] * up, warped_hw[1] * up
    ) == tuple(out_hw):
        return model.forward_phase2_argmax
    return None
