"""K1B, the backward of K1 (``ops/creff_backward_kernel.py``): its plain
version (the analytic gradients in float32 torch ops) against autograd over
the composed module (``local_attention.module_composed``) on the CPU, and
the kernel against the plain version on a card. This file imports no JAX,
so its card tests also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k1_backward.py -m cuda
"""

import pytest
import torch

from arseg_tpu_torch.ops import _build, creff_backward_kernel, creff_kernel
from arseg_tpu_torch.ops import local_attention as tla

from torch_parity import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

# Relative L2 error of each gradient (d lr_up, d hr, and each conv's 9 taps
# and bias together) against autograd over the composed module in float32.
# float32: the same function with sums in another order (observed at most
# 6.2e-7 on these cases). bfloat16 inputs: Q, K, V and P are rounded to
# bf16 (2^-9 relative each) and d lr_up, d hr once more, against a
# reference that rounds nothing (observed 6.3e-3 to 8.1e-3, worst gradient
# of each case).
CPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _case(seed, n, h, w, c, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    lr_up, hr, g = (torch.randn(n, h, w, c, generator=gen) for _ in range(3))
    wb = [x for _ in range(3) for x in (torch.randn(c, 1, 3, 3, generator=gen) / 3.0,
                                        torch.randn(c, generator=gen) * 0.1)]
    return [x.to(device) for x in (lr_up, hr, g, *wb)]


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _groups(d_lr, d_hr, wgrads):
    """The gradients compared: d lr_up, d hr (or None), and each conv's
    weight and bias flattened together."""
    convs = [torch.cat([wgrads[2 * i].flatten(), wgrads[2 * i + 1]]) for i in range(3)]
    return {"d lr_up": d_lr, "d hr": d_hr, "conv q": convs[0], "conv k": convs[1],
            "conv v": convs[2]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need_hr", [True, False])
@pytest.mark.parametrize("shape", [(2, 11, 13, 16), (1, 5, 6, 16)])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_plain_backward_matches_autograd_over_composed(k, shape, need_hr, dtype):
    """The module's backward on the CPU (K1B's plain version) against
    torch.autograd.grad over module_composed in float32, on the same values
    (bf16 inputs rounded once, then taken up to float32 for the reference).
    11x13 and 5x6 are no multiple of 16 and put pixels at every edge (at
    5x6 every window of 5 and 7 crosses one); without need_hr the hr input
    takes no gradient, as the teacher's warped feature in FST stage 2."""
    lr_up, hr, g, *wb = (x.to(dtype) for x in _case(k, *shape))
    ref_in = [x.detach().float().clone().requires_grad_(True) for x in (lr_up, hr, *wb)]
    want = torch.autograd.grad(tla.module_composed(*ref_in, k, k), ref_in, g.float())

    ins = [x.detach().clone().requires_grad_(True) for x in (lr_up, hr, *wb)]
    ins[1].requires_grad_(need_hr)
    out = tla.creff_local_module(*ins, k, k)
    out.backward(g)
    assert ins[0].grad.dtype == dtype and all(x.grad.dtype == dtype for x in ins[2:])
    assert (ins[1].grad is not None) == need_hr
    got = _groups(ins[0].grad, ins[1].grad, [x.grad for x in ins[2:]])
    ref = _groups(want[0], want[1], want[2:])
    for name, gv in got.items():
        if gv is None:
            continue
        err = _rel(gv, ref[name])
        assert err <= CPU_TOL[dtype], f"{name}: relative L2 {err:.3e} > {CPU_TOL[dtype]}"


def test_plain_backward_leaves_hr_out_without_launch():
    """need_ref=False gives no d hr and the same other gradients; the CPU
    path counts no launch."""
    lr_up, hr, g, *wb = _case(1, 1, 9, 10, 16)
    taps, bias = creff_kernel.pack_qkv(*wb)
    _build.LAUNCHES.clear()
    full = creff_backward_kernel.creff_qkv_fused_backward(lr_up, hr, g, taps, bias, 7, 7)
    part = creff_backward_kernel.creff_qkv_fused_backward(lr_up, hr, g, taps, bias, 7, 7,
                                                          need_ref=False)
    assert part[1] is None and full[1] is not None
    assert torch.equal(full[0], part[0]) and torch.equal(full[2], part[2])
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------- card only


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")


# Kernel against plain version: each gradient's largest |difference| over
# its largest |plain value| (per group as above). float32: both in float32,
# sums in another order (window sums of 49 x C terms, weight sums over every
# pixel). bfloat16: Q, K and V are the same bits on both sides, the logits'
# float32 sums differ in order, so P's rounding to bf16 can differ by one
# bf16 unit (2^-8 relative) at a few window positions, and d lr_up, d hr
# are rounded once to bf16 after sums in another order: within 2^-6 of the
# largest value, as K1's own forward check.
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def _card_check(n, h, w, c, k, dtype, need_ref, seed=0):
    lr_up, hr, g, *wb = (x.to(dtype) if i < 3 else x
                         for i, x in enumerate(_case(seed, n, h, w, c, "cuda")))
    taps, bias = creff_kernel.pack_qkv(*wb)
    got = creff_backward_kernel.creff_qkv_fused_backward(lr_up, hr, g, taps, bias, k, k,
                                                         need_ref)
    want = creff_backward_kernel.creff_qkv_fused_backward_plain(lr_up, hr, g, taps, bias, k, k,
                                                                need_ref)
    assert (got[1] is None) == (not need_ref)
    names = ("d lr_up", "d hr", "conv q", "conv k", "conv v")
    pairs = [(got[0], want[0]), (got[1], want[1])] + [(got[2][i], want[2][i]) for i in range(3)]
    for name, (a, b) in zip(names, pairs):
        if b is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= CARD_TOL[dtype], f"{name} {dtype}: max|d| / max|plain| {err:.3e}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,k,dtype,need_ref", [
    (16, 90, 120, 256, 7, torch.bfloat16, False),  # the FST stage-2 step (hr under no_grad)
    (11, 90, 120, 512, 7, torch.bfloat16, True),  # psp18 V2
    *[(2, 13, 37, 32, k, dt, ref) for k in (3, 5, 7) for dt in (torch.float32, torch.bfloat16)
      for ref in (True, False)],
    (1, 1, 5, 16, 7, torch.bfloat16, True),  # one row
    (1, 21, 1, 48, 5, torch.float32, True),  # one column
])
def test_k1b_matches_plain_on_card(n, h, w, c, k, dtype, need_ref):
    """K1B against its plain version: the training step's shape, psp18 V2's
    C = 512, and ragged shapes off the 4 x 32 tiles and 64-column segments
    in float32 and bf16 for windows 3, 5 and 7."""
    needs_card()
    _card_check(n, h, w, c, k, dtype, need_ref)


@pytest.mark.cuda
def test_k1b_two_launches_bit_equal():
    """No float atomics: two launches on the same inputs give the same bits."""
    needs_card()
    lr_up, hr, g, *wb = (x.to(torch.bfloat16) if i < 3 else x
                         for i, x in enumerate(_case(5, 4, 45, 70, 64, "cuda")))
    taps, bias = creff_kernel.pack_qkv(*wb)
    a = creff_backward_kernel.creff_qkv_fused_backward(lr_up, hr, g, taps, bias, 7, 7)
    b = creff_backward_kernel.creff_qkv_fused_backward(lr_up, hr, g, taps, bias, 7, 7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_k1b_one_launch_per_backward():
    """The module's forward and backward on the card launch K1 and K1B once
    each, in the stage-2 form (hr takes no gradient)."""
    needs_card()
    lr_up, hr, g, *wb = (x.to(torch.bfloat16) for x in _case(6, 2, 30, 40, 32, "cuda"))
    lr_up.requires_grad_(True)
    wb = [x.requires_grad_(True) for x in wb]
    _build.LAUNCHES.clear()
    tla.creff_local_module(lr_up, hr, *wb, 7, 7).backward(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["creff_qkv_fused"] == 1
    assert _build.LAUNCHES["creff_qkv_fused_backward"] == 1
    assert hr.grad is None and lr_up.grad is not None
