"""cityscapes-psp18's phase-2 stage-2 objective (CE + 0.4 aux CE + the
feature MSE, merge mode through K2's and K1's plain versions), the port's
against the JAX package's on the CPU, float32, dropout neutralised, BN in
train mode at batch 8: its PPM normalises the 1x1 bin, one value per image
(``train_parity.py``). Also camvid-psp18 V2's merge mode against the JAX
``apply``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arseg_tpu.nn.functional as JFn

from arseg_tpu_torch import set_f32_parity_mode

from train_parity import check_stage2, models_pair, no_dropout  # noqa: F401 (a fixture)

from torch_parity import few_threads  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()


def test_cityscapes_psp18_phase2_stage2_matches_jax(no_dropout):  # noqa: F811
    check_stage2(no_dropout, "cityscapes-psp18", 8, 19)


def test_psp18_v2_merge_mode_matches_jax():
    """forward(x, mode="merge", ref_p=...) of camvid-psp18 V2 against the
    JAX apply(mode="merge") in eval mode: every output."""
    backend, kw = "camvid-psp18", {"fuse_version": 2}
    m = models_pair(backend, **kw)
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    student = m["student"].eval()
    with torch.no_grad():
        mid = student.forward_phase1(torch.from_numpy(x).permute(0, 3, 1, 2), with_aux=False)
        ref = torch.randn(1, mid.shape[1], 2 * mid.shape[2], 2 * mid.shape[3],
                          generator=torch.Generator().manual_seed(0))
        got = student(torch.from_numpy(x).permute(0, 3, 1, 2), mode="merge", ref_p=ref)
    want = m["js"].apply(m["sp"], jnp.asarray(x), JFn.Ctx(train=False), mode="merge",
                         ref_p=jnp.asarray(ref.permute(0, 2, 3, 1).numpy()))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.numpy() if a.dim() == 2 else a.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))
