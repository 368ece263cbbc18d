"""Checkpoints of the port's trainers, and the loader of every checkpoint
the port reads.

``save_checkpoint`` writes a ``.pth`` holding ``{"state_dict": <the
reference's keys>, "optimizer": <the optimizer's state_dict>, "metadata":
{...}}``, all tensors on the CPU. The reference's tools and the JAX
package's ``utils/torch_convert.load_torch_checkpoint`` read it
(``torch.load(weights_only=True)`` of the ``"state_dict"`` entry). The
trainers name it as the reference does, ``PSPNet_{backend}_{scale}_
{epoch}_.pth``, so that the eval protocol's scale-token lookup finds it.

``load_checkpoint`` reads such a ``.pth``, a reference ``.pth`` (a bare
state dict or ``{"state_dict": ...}``, keys with or without DataParallel's
``module.`` prefix) or the JAX package's ``.npz`` (``params.*`` keys, a
``.json`` of metadata beside it), which goes through the port's
``state_dict_from_jax`` and so needs the backend. The JAX optimizer state
does not carry over.
"""

import json
import os

import numpy as np
import torch

from arseg_tpu_torch.utils.convert import state_dict_from_jax


def save_checkpoint(path, model, optimizer=None, metadata=None):
    """``model``: an ``nn.Module`` or its state dict."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    ck = {"state_dict": {k: v.detach().cpu() for k, v in state.items()},
          "metadata": dict(metadata or {})}
    if optimizer is not None:
        ck["optimizer"] = _to_cpu(optimizer.state_dict())
    torch.save(ck, path)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _npz_tree(path):
    data = np.load(path)
    tree = {}
    for key in data.files:
        if not key.startswith("params."):
            continue
        node = tree
        parts = key[len("params."):].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree


def load_checkpoint(path, backend=None):
    """{"state_dict": {key: tensor}, "optimizer": state or None,
    "metadata": dict} from a ``.pth`` or a JAX ``.npz`` (module docstring);
    backend names the model of an ``.npz`` (``"camvid-bise18"`` ...)."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        if backend is None:
            raise ValueError(f"{path}: a JAX checkpoint needs its backend to convert")
        meta_path = os.path.splitext(path)[0] + ".json"
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return {"state_dict": state_dict_from_jax(_npz_tree(path), backend), "optimizer": None,
                "metadata": meta}
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ck, dict) and "state_dict" in ck:
        sd, opt, meta = ck["state_dict"], ck.get("optimizer"), ck.get("metadata") or {}
    else:
        sd, opt, meta = ck, None, {}
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return {"state_dict": sd, "optimizer": opt, "metadata": meta}


def load_weights(model, path, backend=None, allow_missing=()):
    """Load a checkpoint's weights into ``model`` strictly, except that keys
    under the ``allow_missing`` prefixes may be absent (the fusion of a
    teacher built with it from an HR checkpoint without it). Returns the
    checkpoint as ``load_checkpoint`` gives it."""
    ck = load_checkpoint(path, backend)
    missing, unexpected = model.load_state_dict(ck["state_dict"], strict=False)
    missing = [k for k in missing if not k.startswith(tuple(allow_missing))]
    if missing or unexpected:
        raise KeyError(f"{path} does not fit the model: missing {missing[:8]}, "
                       f"unexpected {unexpected[:8]}")
    return ck
