"""The PSPNet backbones the trainers accept beyond the headline configs'
ResNet-18 (``PSP_SIZES``): the camvid PSPNet on the bottleneck
ResNet-50/101/152, DenseNet-121 and SqueezeNet 1.1, and the cityscapes
(semseg) PSPNet on ResNet-50/101/152, held against the JAX package on the
CPU at 32x32, float32, TF32 off.

Each model is built by both packages' ``build_train_model``; seeded JAX
parameters (``torch_parity.random_params``) go through the port's
``state_dict_from_jax`` under the trainers' backend name and load with
``strict=True``; the eval-mode forward's outputs agree within 1e-5 of
max(1, max |JAX output|) (float32 sums in another order; in a random net
each residual block doubles the variance, so ResNet-152's outputs reach
~1e6, hence a bound relative to the largest). The JAX importer, given the
port's state dict and the family name it takes for the reference's
checkpoints, gives back exactly the JAX tree: so the port's module names
are the ones the JAX package reads as the reference's.

The JAX trainers name the converter's family ``{dataset}-psp{depth}``,
which the JAX importer knows only for the headline configs:
``test_jax_trainers_misname_a_reference_teacher`` shows what that does to
a reference ``.pth`` teacher of these backbones (ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arseg_tpu.train.trainer import _load_params as j_load_params
from arseg_tpu.train.trainer import build_train_model as j_build_train_model
from arseg_tpu.utils.torch_convert import ALIASES, convert_state_dict

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.train.trainer import DATASET_POLICY, backend_key, build_train_model
from arseg_tpu_torch.utils.convert import family, state_dict_from_jax

from torch_parity import few_threads, flatten, random_params  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

HW = (32, 32)
TOL = 1e-5  # of max(1, max |JAX output|)
CASES = [
    # dataset, backend, the JAX importer's family of the reference's names
    ("camvid", "resnet50", "camvid-psp18"),
    ("camvid", "resnet101", "camvid-psp18"),
    ("camvid", "resnet152", "camvid-psp18"),
    ("camvid", "densenet", "psp-densenet"),
    ("camvid", "squeezenet", "psp-squeezenet"),
    ("cityscapes", "resnet50", "cityscapes-psp18"),
    ("cityscapes", "resnet101", "cityscapes-psp18"),
    ("cityscapes", "resnet152", "cityscapes-psp18"),
]


def _models(dataset, backend, seed):
    n_classes = DATASET_POLICY[dataset]["n_classes"]
    jm = j_build_train_model("pspnet", dataset, backend, n_classes, fuse=False)
    tm = build_train_model("pspnet", dataset, backend, n_classes, fuse=False, seed=seed)
    return jm, tm


@pytest.mark.parametrize("dataset,backend,jax_family", CASES,
                         ids=[f"{d}-{b}" for d, b, _ in CASES])
def test_backbone_matches_jax(dataset, backend, jax_family):
    seed = CASES.index((dataset, backend, jax_family))
    jm, tm = _models(dataset, backend, seed)
    params = random_params(jm, seed)
    tm.load_state_dict(state_dict_from_jax(params, backend_key("pspnet", dataset, backend)),
                       strict=True)
    tm.eval()
    x = np.random.RandomState(seed).randn(1, *HW, 3).astype(np.float32)
    x_jax = jnp.asarray(x)
    # a forward at 32x32 needs no optimised code: compile the least
    want = jax.jit(jm.apply).lower(params, x_jax).compile(
        compiler_options={"xla_backend_optimization_level": 0})(params, x_jax)
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    # the JAX semseg model without the fusion returns (logits, aux); the
    # port's returns its cls feature beside them
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy().transpose(0, 2, 3, 1) if g.ndim == 4 else g.numpy()
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= TOL * max(1.0, float(np.abs(w).max())), (err, float(np.abs(w).max()))

    back = flatten(convert_state_dict(tm.state_dict(), jax_family))
    tree = flatten(params)
    assert sorted(back) == sorted(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)


@pytest.mark.parametrize("backend,want", [
    ("camvid-bise18", "bisenet"), ("cityscapes-bise34", "bisenet"),
    ("camvid-psp18", "camvid-psp"), ("camvid-psp152", "camvid-psp"),
    ("cityscapes-psp50", "cityscapes-psp"), ("camvid-pspdensenet", "psp-densenet"),
    ("psp-squeezenet", "psp-squeezenet"),
])
def test_family_keys_by_dataset_and_model_not_depth(backend, want):
    assert family(backend) == want


def test_family_refuses_unknown_names():
    for backend in ("kitti-psp18", "camvid-pspvgg", "camvid-unet"):
        with pytest.raises(NotImplementedError, match=backend):
            family(backend)


@pytest.mark.parametrize("dataset,backend", [("cityscapes", "resnet50"), ("camvid", "densenet")])
def test_jax_trainers_misname_a_reference_teacher(dataset, backend, tmp_path):
    """The JAX trainers load a ``.pth`` teacher through
    ``load_torch_checkpoint(path, f"{dataset}-psp{depth}")``
    (``arseg_tpu/train/trainer.py:432-433``); for these backbones ALIASES
    has no such entry, so the reference's names are kept as they are
    (``layer0.0`` for ``backbone.conv1``, DenseNet's ``start_features`` and
    ``blocks.<i>``), and the tree does not fit the JAX model. The port's
    modules take the reference's names, so its load is strict and
    complete."""
    key = f"{dataset}-psp{backend.replace('resnet', '')}"
    assert key not in ALIASES
    jm, tm = _models(dataset, backend, seed=0)
    path = tmp_path / "teacher.pth"
    torch.save(tm.state_dict(), path)
    got = set(flatten(j_load_params(str(path), key)))
    want = set(flatten(jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    assert got != want and not want <= got
    assert tm.load_state_dict(torch.load(path), strict=True).missing_keys == []
