"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py)."""

import socket

import numpy as np
import pytest
import torch

# torch threads of a port test module (``few_threads``): with one a core,
# the tier-1 command's xdist workers oversubscribe the CPU many times over
TEST_THREADS = 2


def randomize_bn_tree(tree, rng):
    """A JAX parameter tree with numpy leaves, every BN's affine parameters
    and running statistics drawn from ``rng`` (so the parity tests exercise
    BN with non-trivial statistics)."""
    if isinstance(tree, dict):
        if "running_mean" in tree:
            c = tree["running_mean"].shape[0]
            return {
                "weight": (1.0 + 0.2 * rng.uniform(-1, 1, c)).astype(np.float32),
                "bias": (0.1 * rng.randn(c)).astype(np.float32),
                "running_mean": (0.1 * rng.randn(c)).astype(np.float32),
                "running_var": (0.5 + rng.rand(c)).astype(np.float32),
            }
        return {k: randomize_bn_tree(v, rng) for k, v in tree.items()}
    return np.asarray(tree)


def rel_l2(a, b):
    """||a - b|| / ||b|| of two arrays (0 when both are 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb else float(np.linalg.norm(a))


def random_params(model, seed):
    """A JAX model's parameter tree with numpy leaves from the model's own
    init, every draw taken from a numpy generator seeded with ``seed`` (the
    JAX package's init module is given numpy in place of ``jax.random``,
    which compiles each draw of a new shape), and every BN as in
    ``randomize_bn_tree``."""
    import types
    from unittest import mock

    import jax
    from arseg_tpu.nn import init as Init

    rng = np.random.default_rng(seed)

    def normal(key, shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def uniform(key, shape, minval=0.0, maxval=1.0):
        return rng.uniform(minval, maxval, shape).astype(np.float32)

    fake = types.SimpleNamespace(random=types.SimpleNamespace(
        normal=normal, uniform=uniform, split=lambda key: (key, key)))
    with mock.patch.object(Init, "jax", fake):
        tree = model.init(None)
    return randomize_bn_tree(jax.tree_util.tree_map(np.asarray, tree), np.random.RandomState(seed))


def flatten(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def free_port():
    """A free TCP port on 127.0.0.1, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def few_threads():
    """torch on TEST_THREADS threads for the module, restored after; a
    module takes it with ``pytestmark = pytest.mark.usefixtures(
    "few_threads")`` and the name imported from here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(threads)
