"""The program's models and the reference's, both loaded with one seeded
state dict through ``load_state_dict``.

A configuration names the program's registry entry (``port_backend``) and
the reference's class (``reference``: module and class under
``reference/``, with ``reference_kwargs``)."""

import importlib

import torch

from harness import seeded


def port_model(cfg, fuse, device):
    from arseg_tpu_torch.models.registry import MODELS

    # built on the device with a generator there, so that the registry's
    # own initialisation (which the seeded weights replace) costs little
    with torch.device(device):
        model = MODELS[cfg["port_backend"]](fuse, torch.Generator(device=device))
    return model.eval()


def reference_model(cfg, fuse, device):
    mod, cls = cfg["reference"].rsplit(".", 1)
    with torch.device(device):
        model = getattr(importlib.import_module(mod), cls)(
            cfg["n_classes"], with_fuse=fuse, **cfg.get("reference_kwargs", {}))
    return model


def weights(cfg, seed, stream, fuse, device):
    """The float32 state dict of stream ``stream`` (e.g. "hr", "ar")."""
    return seeded.state_dict(reference_model(cfg, fuse, device), seed, stream, device)


def loaded(model, sd):
    model.load_state_dict(sd, strict=True)
    return model
