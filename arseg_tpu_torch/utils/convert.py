"""JAX parameter tree -> the port's state dict.

``state_dict_from_jax`` turns an ``arseg_tpu`` parameter tree (nested dicts
of numpy arrays) into tensors under the reference checkpoint's keys, which
are the port modules' keys: conv kernels HWIO -> OIHW, linear weights
[in, out] -> [out, in], the modules the reference registers under two names
emitted under both, the names the JAX tree flattens restored, and a zero
``num_batches_tracked`` beside every BN ``running_mean``. The result loads
with ``load_state_dict(strict=True)``.

The names depend on the model family, not on the depth: ``family`` maps a
backend name (``"camvid-bise18"``, ``"cityscapes-psp50"``,
``"camvid-pspdensenet"``, ``"psp-squeezenet"`` ...) to one.
"""

import re

import numpy as np
import torch

# family -> {tree path prefix: every state-dict name of it}: the reference
# modules registered under two attribute paths (bisenet.py feat_conv_out /
# final_conv, pspnet_semseg.py final_conv = cls[4], extractors.py's dense
# blocks and transitions in ``blocks``), and the paths the JAX tree names
# otherwise (the semseg backbone, DenseNet's stem, SqueezeNet's
# Sequential indices)
SHARED_NAMES = {
    "bisenet": {
        "conv_out.conv": ("feat_conv_out", "conv_out.conv"),
        "conv_out.conv_out": ("final_conv", "conv_out.conv_out"),
    },
    # PSPNet registers every module once; PReLU slopes stay [1]
    "camvid-psp": {},
    "cityscapes-psp": {
        "backbone.conv1": ("layer0.0",),
        "backbone.bn1": ("layer0.1",),
        **{f"backbone.layer{i}": (f"layer{i}",) for i in range(1, 5)},
        "cls.4": ("final_conv", "cls.4"),
    },
    "psp-densenet": {
        "feats.conv0": ("feats.start_features.conv0",),
        "feats.norm0": ("feats.start_features.norm0",),
        **{f"feats.denseblock{b + 1}": (f"feats.denseblock{b + 1}", f"feats.blocks.{2 * b}")
           for b in range(4)},
        **{f"feats.transition{b + 1}": (f"feats.transition{b + 1}", f"feats.blocks.{2 * b + 1}")
           for b in range(3)},
    },
    "psp-squeezenet": {
        "feats.feat_1.conv": ("feats.feat_1.0",),
        **{f"feats.feat_{g}.fire{i}": (f"feats.feat_{g}.{i - (g == 4)}",)
           for g, n in ((2, 2), (3, 2), (4, 4)) for i in range(1, n + 1)},
    },
}
# regex rewrites of each name after the prefixes: the dense layers' 'norm.1'
# / 'conv.2' modules, which the JAX tree names 'norm1' / 'conv2'
SUBSTITUTIONS = {"psp-densenet": [(re.compile(r"(denselayer\d+)\.(norm|conv)(\d)\."),
                                   r"\1.\2.\3.")]}


def family(backend: str) -> str:
    """The key-name family of a backend name: "bisenet" for
    ``{dataset}-bise*``, "psp-densenet" / "psp-squeezenet" for those
    backbones (``psp-densenet`` or a trainer's ``camvid-pspdensenet``), and
    "camvid-psp" / "cityscapes-psp" for the ResNet PSPNets of every depth."""
    if backend in SHARED_NAMES:
        return backend
    dataset, _, model = backend.partition("-")
    if dataset in ("camvid", "cityscapes"):
        if model.startswith("bise"):
            return "bisenet"
        if model in ("pspdensenet", "pspsqueezenet"):
            return f"psp-{model[3:]}"
        if re.fullmatch(r"psp\d+", model):
            return f"{dataset}-psp"
    raise NotImplementedError(f"state_dict_from_jax: no key-name family for {backend!r}")


def _leaf(name, arr):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "weight" and arr.ndim == 2:
        return arr.transpose(1, 0)  # [in, out] -> [out, in]
    return arr


def state_dict_from_jax(params_np, backend: str):
    """params_np: nested dict of array-likes -> {key: torch.Tensor}."""
    fam = family(backend)
    shared, subs = SHARED_NAMES[fam], SUBSTITUTIONS.get(fam, ())
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
            for pattern, repl in subs:
                name = pattern.sub(repl, name)
            out[name] = torch.from_numpy(np.array(_leaf(name, arr), order="C"))
            if name.endswith(".running_mean"):
                stem = name[: -len("running_mean")]
                out[stem + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
