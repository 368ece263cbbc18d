"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py)."""

import numpy as np


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
