"""The mIoU_d evaluation protocol — port of ``arseg_tpu/eval/protocol.py``
(reference ``evaluation.py:218-439``).

For each ref_gap in 1..GOP, build the dataset rooted at
  {data_root}/{ds}-sequence/{bitrate}-GOP{G}/decoded_GOP{G}_dist_{ref_gap-1}
(with the MVmap and frames side directories for AR at ref_gap > 1),
evaluate HR, LR and AR with the port's engines, append the mean as line 13
and write
  {ds}-{bb}[-AR]-{scale}x-resolution-exp-GOP{G}-{bitrate}-evaluation.txt
with ``np.savetxt``'s default format, as the JAX protocol and the released
evaluation results do. Checkpoints: a ``.pth`` loads directly, a JAX
``.npz`` through ``state_dict_from_jax`` (``utils/checkpoint.py``). The
readers are imported inside ``run_protocol``.

``mesh`` (a ``parallel.DataGroup``; every rank runs ``run_protocol``): the
engines spread each batch's frames over the ranks and sum their histograms,
the batch is at least the group's size (the JAX protocol's rule), every
rank returns the same numbers, and rank 0 alone writes the files and logs.
"""

import os
import time

import numpy as np

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.eval.engine import EvalAlterRes, EvalConstRes
from arseg_tpu_torch.models import build_model
from arseg_tpu_torch.parallel.group import check_group, is_main
from arseg_tpu_torch.utils.checkpoint import load_weights

DATASET_INFO = {
    "camvid": dict(bitrate="3M", n_classes=12),
    "cityscapes": dict(bitrate="5M", n_classes=19),
}


def _snapshots(d):
    return sorted(x for x in os.listdir(d) if not x.endswith(".json"))


def find_hr_snapshot(ckpt_root, dataset, backbone):
    d = os.path.join(ckpt_root, f"{dataset}-{backbone}", "HR")
    return os.path.join(d, _snapshots(d)[0])


def find_scale_snapshot(ckpt_root, dataset, backbone, mode_dir, test_scale):
    """The reference's file names carry the scale as the third
    '_'-separated token (``evaluation.py:313``)."""
    d = os.path.join(ckpt_root, f"{dataset}-{backbone}", mode_dir)
    matches = [x for x in _snapshots(d) if x.split("_")[2] == str(test_scale)]
    if not matches:
        raise FileNotFoundError(f"no {mode_dir} checkpoint for scale {test_scale} in {d}")
    return os.path.join(d, matches[0])


def _make_dataset(dataset, data_path, backbone, ref_gap=None, flow_path=None, ref_path=None,
                  flow_shape=None):
    from arseg_tpu_torch.data import CamVid, CamVidWithFlow, CityScapes, CityScapesWithFlow

    model_type = f"{backbone[:-2]}net"
    if ref_gap is None:  # the plain single-frame dataset
        if dataset == "camvid":
            return CamVid(data_path, mode="test")
        return CityScapes(data_path, model_type=model_type, mode="val")
    kw = {"flow_shape": flow_shape} if flow_shape else {}
    if dataset == "camvid":
        return CamVidWithFlow(data_path, mode="test", load_pair=True, ref_gap=ref_gap,
                              flow_path=flow_path, ref_path=ref_path, **kw)
    return CityScapesWithFlow(data_path, model_type=model_type, mode="val", ref_gap=ref_gap,
                              flow_path=flow_path, ref_path=ref_path, **kw)


def _seq_paths(data_root, dataset, bitrate, gop, ref_gap):
    seq = os.path.join(data_root, f"{dataset}-sequence", f"{bitrate}-GOP{gop}")
    return (os.path.join(seq, f"decoded_GOP{gop}_dist_{ref_gap - 1}"),
            os.path.join(seq, f"MVmap_GOP{gop}_dist_{ref_gap - 1}"),
            os.path.join(seq, "frames"))


def _write_result(result_dir, name, mious, mesh=None):
    mious = list(mious)
    mious.append(float(np.mean(mious)))
    if is_main(mesh):
        os.makedirs(result_dir, exist_ok=True)
        np.savetxt(os.path.join(result_dir, name), np.asarray(mious))
    return mious


def _model(backend, fuse, path, device):
    model = build_model(backend, fuse=fuse, device="cpu")
    load_weights(model, path, backend)
    return model.to(device)


def run_protocol(dataset="camvid", backbone="psp18", mode=(1, 1, 1), gop=12, test_scale=0.5,
                 data_root="./data", ckpt_root="./checkpoints", result_dir="./evaluation-result",
                 batch_size=1, num_workers=4, verbose=True, flow_shape=None, mesh=None,
                 dtype=None, device=None):
    """mode: (HR, LR, AR) switches. Returns {"HR"/"LR"/"AR": the 13 numbers
    written}."""
    from arseg_tpu_torch.data import Loader

    mesh = check_group(mesh)
    device = resolve_device(device if device is not None or mesh is None else mesh.device)
    info = DATASET_INFO[dataset]
    bitrate, n_classes = info["bitrate"], info["n_classes"]
    backend = f"{dataset}-{backbone}"
    if mesh is not None:
        batch_size = max(batch_size, mesh.size)
    eval_kw = dict(mesh=mesh, dtype=dtype, device=device)
    verbose = verbose and is_main(mesh)
    results = {}

    hr_model = _model(backend, False, find_hr_snapshot(ckpt_root, dataset, backbone), device)
    t_start = time.perf_counter()

    def log(*a):
        if verbose:
            print(f"[{time.perf_counter() - t_start:7.1f}s]", *a, flush=True)

    def make_loader(ds):
        # the ragged last batch is kept: every sample counts, as in the
        # reference's batch-1 loop
        return Loader(ds, batch_size=batch_size, shuffle=False, num_workers=num_workers,
                      drop_last=False, pin_memory=device.type == "cuda")

    def hr_miou(ref_gap):
        data_path = _seq_paths(data_root, dataset, bitrate, gop, ref_gap)[0]
        ds = _make_dataset(dataset, data_path, backbone)
        return EvalConstRes(scale=1.0, **eval_kw)(hr_model, make_loader(ds), n_classes)

    name = f"GOP{gop}-{bitrate}-evaluation.txt"
    if mode[0]:  # HR
        mious = []
        for ref_gap in range(1, gop + 1):
            miou = hr_miou(ref_gap)
            log(ref_gap, "HR", "1.0x", miou)
            mious.append(miou)
        results["HR"] = _write_result(
            result_dir, f"{dataset}-{backbone}-1.0x-resolution-exp-{name}", mious, mesh)

    if mode[2]:  # AR
        ar_model = _model(backend, True, find_scale_snapshot(ckpt_root, dataset, backbone, "AR",
                                                             test_scale), device)
        mious = []
        for ref_gap in range(1, gop + 1):
            if ref_gap > 1:
                data_path, flow_path, ref_path = _seq_paths(data_root, dataset, bitrate, gop,
                                                            ref_gap)
                ds = _make_dataset(dataset, data_path, backbone, ref_gap, flow_path, ref_path,
                                   flow_shape)
                miou = EvalAlterRes(scale=test_scale, **eval_kw)(hr_model, ar_model,
                                                                  make_loader(ds), n_classes)
            else:  # distance 0 is the HR model on the keyframe
                miou = hr_miou(ref_gap)
            log(ref_gap, "AR", test_scale, miou)
            mious.append(miou)
        results["AR"] = _write_result(
            result_dir, f"{dataset}-{backbone}-AR-{test_scale}x-resolution-exp-{name}", mious,
            mesh)

    if mode[1]:  # LR
        lr_model = _model(backend, True, find_scale_snapshot(ckpt_root, dataset, backbone, "LR",
                                                             test_scale), device)
        mious = []
        for ref_gap in range(1, gop + 1):
            data_path = _seq_paths(data_root, dataset, bitrate, gop, ref_gap)[0]
            ds = _make_dataset(dataset, data_path, backbone)
            miou = EvalConstRes(scale=test_scale, **eval_kw)(lr_model, make_loader(ds), n_classes)
            log(ref_gap, "LR", test_scale, miou)
            mious.append(miou)
        results["LR"] = _write_result(
            result_dir, f"{dataset}-{backbone}-{test_scale}x-resolution-exp-{name}", mious,
            mesh)

    return results
