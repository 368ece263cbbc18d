"""The port's mIoU_d protocol (arseg_tpu_torch.eval.protocol.run_protocol)
against the JAX package's on a synthetic CamVid GOP tree with random
camvid-bise18 weights: the same result files (names, line counts, values
within 1e-6) from the same checkpoints, JAX .npz ones for HR and AR and a
.pth written by the port for LR, which both packages read."""

import os

import jax
import numpy as np
import pytest
import torch

from arseg_tpu.eval.protocol import run_protocol as j_run_protocol
from arseg_tpu.models import build_model as j_build_model
from arseg_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from arseg_tpu_torch import set_f32_parity_mode
from arseg_tpu_torch.eval.protocol import find_scale_snapshot, run_protocol
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.utils.checkpoint import save_checkpoint
from arseg_tpu_torch.utils.convert import state_dict_from_jax

from synthetic_data import FLOW_SHAPE, make_camvid_tree
from torch_parity import few_threads, randomize_bn_tree  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("few_threads")

set_f32_parity_mode()

GOP, BACKEND = 3, "camvid-bise18"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("protocol")
    make_camvid_tree(str(root / "data"), gop=GOP)
    ck = root / "ckpt" / BACKEND
    weights = {}
    for i, (mode, fuse, scale) in enumerate((("HR", False, "1.0"), ("AR", True, "0.5"),
                                             ("LR", True, "0.5"))):
        os.makedirs(ck / mode)
        jm = j_build_model(BACKEND, fuse=fuse)
        p = randomize_bn_tree(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(i))),
                              np.random.RandomState(i))
        weights[mode] = p
        name = f"PSPNet_resnet18_{scale}_1_"
        if mode == "LR":  # a checkpoint the port wrote
            m = build_model(BACKEND, fuse=True, device="cpu")
            m.load_state_dict(state_dict_from_jax(p, BACKEND), strict=True)
            save_checkpoint(str(ck / mode / f"{name}.pth"), m, metadata={"scale": 0.5})
        else:
            j_save_checkpoint(str(ck / mode / f"{name}.npz"), p, {"scale": float(scale)})
    return root


def test_protocol_matches_jax(tree):
    kw = dict(dataset="camvid", backbone="bise18", mode=(1, 1, 1), gop=GOP, test_scale=0.5,
              data_root=str(tree / "data"), ckpt_root=str(tree / "ckpt"), batch_size=2,
              num_workers=2, verbose=False, flow_shape=FLOW_SHAPE)
    want = j_run_protocol(result_dir=str(tree / "jax"), **kw)
    got = run_protocol(result_dir=str(tree / "port"), device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["AR", "HR", "LR"]
    names = sorted(os.listdir(tree / "jax"))
    assert names == sorted(os.listdir(tree / "port"))
    assert names == [f"camvid-bise18-{m}-resolution-exp-GOP{GOP}-3M-evaluation.txt"
                     for m in ("0.5x", "1.0x", "AR-0.5x")]
    for name in names:
        a = np.loadtxt(tree / "port" / name)
        b = np.loadtxt(tree / "jax" / name)
        assert a.shape == b.shape == (GOP + 1,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
        with open(tree / "port" / name) as f:
            assert len(f.read().splitlines()) == GOP + 1
    # distance 0 of AR is the HR model on the keyframe
    assert got["AR"][0] == got["HR"][0]


def test_protocol_refuses_what_is_not_ported(tree):
    with pytest.raises(TypeError, match="DataGroup"):
        run_protocol(ckpt_root=str(tree / "ckpt"), mesh=object(), device="cpu")
    with pytest.raises(FileNotFoundError):
        find_scale_snapshot(str(tree / "ckpt"), "camvid", "bise18", "AR", 0.25)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_protocol(data_root=str(tree / "data"), ckpt_root=str(tree / "ckpt"))
