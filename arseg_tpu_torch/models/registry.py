"""Model registry — port of ``arseg_tpu/models/registry.py``.

``build_model(backend, fuse)`` returns an ``nn.Module`` with weights drawn
from a seeded ``torch.Generator``, on ``device`` ("cuda" unless the caller
asks for the CPU), in eval mode. cityscapes-psp18 is built with the
fusion in both registries (``fuse`` is ignored), as the reference does.
"""

import torch

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.nn.bisenet import BiSeNetV1
from arseg_tpu_torch.nn.pspnet import PSPNet
from arseg_tpu_torch.nn.pspnet_semseg import PSPNetSemseg

BISENET_CLASSES = {"camvid-bise18": 12, "cityscapes-bise18": 19}


def _camvid_psp18(fuse, gen, **kw):
    return PSPNet(
        n_classes=12,
        sizes=(1, 2, 3, 6),
        psp_size=512,
        deep_features_size=256,
        backend="resnet18",
        fuse_version=(kw.get("fuse_version", 1) if fuse else 0),
        attention_type=kw.get("attention_type", "local"),
        atten_k=kw.get("atten_k", 7),
        generator=gen,
    )


def _cityscapes_psp18(fuse, gen, **kw):
    return PSPNetSemseg(
        layers=18,
        bins=(1, 2, 3, 6),
        classes=19,
        feat_dim=512,
        with_fuse=True,
        attention_type=kw.get("attention_type", "local"),
        atten_k=kw.get("atten_k", 7),
        generator=gen,
    )


def _bisenet(backend):
    def build(fuse, gen, **kw):
        return BiSeNetV1(
            n_classes=BISENET_CLASSES[backend],
            backend="resnet18",
            aux_mode=kw.get("aux_mode", "train"),
            with_fuse=fuse,
            attention_type=kw.get("attention_type", "local"),
            atten_k=kw.get("atten_k", 7),
            generator=gen,
        )

    return build


MODELS = {"camvid-psp18": _camvid_psp18, "cityscapes-psp18": _cityscapes_psp18,
          **{b: _bisenet(b) for b in BISENET_CLASSES}}


def build_model(backend: str, fuse: bool = False, *, seed: int = 0, device=None, **kw):
    backend = backend.lower()
    if backend not in MODELS:
        raise KeyError(f"unknown backend {backend}; options: {sorted(MODELS)}")
    model = MODELS[backend](fuse, torch.Generator().manual_seed(seed), **kw)
    return model.to(resolve_device(device)).eval()


def phase2_argmax_head(model, warped_hw, out_hw):
    """``model.forward_phase2_argmax`` when the model has it and its output
    resolution (warped feature x ``phase2_argmax_upscale``: 8 for BiSeNet's
    1/8-resolution fusion, 1 for PSPNet's full-resolution one) equals
    out_hw; else None, and callers take forward_phase2 -> resize -> argmax."""
    up = getattr(model, "phase2_argmax_upscale", 1)
    if hasattr(model, "forward_phase2_argmax") and (
        warped_hw[0] * up, warped_hw[1] * up
    ) == tuple(out_hw):
        return model.forward_phase2_argmax
    return None
