"""JAX parameter tree -> the port's state dict.

``state_dict_from_jax`` turns an ``arseg_tpu`` parameter tree (nested dicts
of numpy arrays) into tensors under the reference checkpoint's keys, which
are the port modules' keys: conv kernels HWIO -> OIHW, linear weights
[in, out] -> [out, in], the modules the reference registers under two names
emitted under both, and a zero ``num_batches_tracked`` beside every BN
``running_mean``. The result loads with ``load_state_dict(strict=True)``.
"""

import numpy as np
import torch

# reference modules registered under two attribute paths (bisenet.py
# feat_conv_out / final_conv, pspnet_semseg.py final_conv = cls[4]), and the
# semseg backbone, whose tree path differs from its state-dict name: tree
# path -> every state-dict name
SHARED_NAMES = {
    "camvid-bise18": {
        "conv_out.conv": ("feat_conv_out", "conv_out.conv"),
        "conv_out.conv_out": ("final_conv", "conv_out.conv_out"),
    },
}
SHARED_NAMES["cityscapes-bise18"] = SHARED_NAMES["camvid-bise18"]
# PSPNet registers every module once; PReLU slopes stay [1]
SHARED_NAMES["camvid-psp18"] = {}
SHARED_NAMES["cityscapes-psp18"] = {
    "backbone.conv1": ("layer0.0",),
    "backbone.bn1": ("layer0.1",),
    **{f"backbone.layer{i}": (f"layer{i}",) for i in range(1, 5)},
    "cls.4": ("final_conv", "cls.4"),
}


def _leaf(name, arr):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "weight" and arr.ndim == 2:
        return arr.transpose(1, 0)  # [in, out] -> [out, in]
    return arr


def state_dict_from_jax(params_np, backend: str):
    """params_np: nested dict of array-likes -> {key: torch.Tensor}."""
    if backend not in SHARED_NAMES:
        raise NotImplementedError(
            f"state_dict_from_jax supports {sorted(SHARED_NAMES)}, not {backend!r}"
        )
    shared = SHARED_NAMES[backend]
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    walk(params_np, "")
    out = {}
    for key, arr in flat.items():
        names = [key]
        for prefix in sorted(shared, key=len, reverse=True):
            if key == prefix or key.startswith(prefix + "."):
                names = [t + key[len(prefix):] for t in shared[prefix]]
                break
        for name in names:
            out[name] = torch.from_numpy(np.array(_leaf(name, arr), order="C"))
            if name.endswith(".running_mean"):
                stem = name[: -len("running_mean")]
                out[stem + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
