"""Parity of the port's BiSeNetV1 (arseg_tpu_torch.nn.bisenet) with the JAX
model on the CPU, float32, TF32 off. JAX parameters (BN statistics
randomised with numpy) go through the port's ``state_dict_from_jax`` and
load strict; outputs are compared NCHW against NHWC transposed."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.utils.torch_convert import export_state_dict

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.models import build_model, phase2_argmax_head
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from torch_parity import randomize_bn_tree  # noqa: E402

set_f32_parity_mode()

H, W = 64, 96
# float32; convolutions sum in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(backend, fuse, aux_mode="train", seed=0):
    jm = j_build_model(backend, fuse=fuse, aux_mode=aux_mode)
    params = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                               np.random.RandomState(seed))
    tm = build_model(backend, fuse=fuse, aux_mode=aux_mode, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, backend), strict=True)
    return jm, params, tm


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def fuse_pair():
    return _pair("camvid-bise18", True, seed=1)


@pytest.mark.parametrize("aux_mode", ["train", "eval"])
def test_bisenet_apply_matches_jax(aux_mode):
    jm, params, tm = _pair("camvid-bise18", False, aux_mode)
    x = np.random.RandomState(2).randn(1, H, W, 3).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == len(want) == (4 if aux_mode == "train" else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)
    if aux_mode == "train":
        key_logits, feat = tm.forward_key(_nchw(x))
        np.testing.assert_array_equal(key_logits.detach().numpy(), got[0].numpy())
        np.testing.assert_array_equal(feat.detach().numpy(), got[-1].numpy())


def test_bisenet_fuse_phase1_and_heads_match_jax(fuse_pair):
    jm, params, tm = fuse_pair
    rng = np.random.RandomState(3)
    x = rng.randn(2, H // 2, W // 2, 3).astype(np.float32)
    want = jm.forward_phase1(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.forward_phase1(_nchw(x))
        mid = tm.forward_phase1(_nchw(x), with_aux=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)
    np.testing.assert_array_equal(mid.numpy(), got[-1].numpy())

    ref = rng.randn(2, H // 8, W // 8, 256).astype(np.float32)
    mid_j = want[-1]
    out_j, fused_j = jm.forward_phase2(params, mid_j, jnp.asarray(ref))
    with torch.no_grad():
        out_t, fused_t = tm.forward_phase2(_nchw(mid_j), _nchw(ref))
        pred_t, fused_t2 = tm.forward_phase2_argmax(_nchw(mid_j), _nchw(ref), return_fused=True)
    np.testing.assert_allclose(_nhwc(fused_t), np.asarray(fused_j), **TOL)
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), **TOL)
    np.testing.assert_array_equal(fused_t2.numpy(), fused_t.numpy())
    pred_j = np.asarray(jm.forward_phase2_argmax(params, mid_j, jnp.asarray(ref)))
    assert pred_t.dtype == torch.int32 and pred_t.shape == pred_j.shape
    assert np.mean(pred_t.numpy() == pred_j) >= 0.999
    assert phase2_argmax_head(tm, (H // 8, W // 8), (H, W)) == tm.forward_phase2_argmax
    assert phase2_argmax_head(tm, (H // 8, W // 8), (H, W + 1)) is None


@pytest.mark.parametrize("backend", ["camvid-bise18", "cityscapes-bise18"])
def test_state_dict_from_jax_equals_export_state_dict(backend):
    """The port's converter gives exactly the keys and tensors of the JAX
    package's exporter, and they load strict into the port's model."""
    jm = j_build_model(backend, fuse=True)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    ours = state_dict_from_jax(params, backend)
    theirs = export_state_dict(params, backend)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    tm = build_model(backend, fuse=True, device="cpu")
    tm.load_state_dict(ours, strict=True)
    assert set(tm.state_dict()) == set(ours)
    assert tm.final_conv.out_channels == {"camvid-bise18": 12, "cityscapes-bise18": 19}[backend]


def test_registry_refuses_unported_backends():
    # every headline backend builds (cityscapes-psp18:
    # tests/test_torch_pspnet_semseg.py); unknown names and the fusion the
    # reference lacks are refused
    with pytest.raises(KeyError):
        build_model("nope", device="cpu")
    with pytest.raises(NotImplementedError, match="MyAttentionV1"):
        build_model("camvid-bise18", fuse=True, attention_type="local1", device="cpu")


def test_registry_init_is_seeded():
    a = build_model("camvid-bise18", fuse=True, seed=3, device="cpu").state_dict()
    b = build_model("camvid-bise18", fuse=True, seed=3, device="cpu").state_dict()
    c = build_model("camvid-bise18", fuse=True, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cp.resnet.conv1.weight"], c["cp.resnet.conv1.weight"])
    assert a["feat_conv_out.conv.weight"].data_ptr() == a["conv_out.conv.conv.weight"].data_ptr()
