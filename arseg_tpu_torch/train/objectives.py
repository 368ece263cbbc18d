"""Training objectives — port of ``arseg_tpu/train/objectives.py``: the
phase-1 loss (``train.py:209-298``) and the phase-2 FST + CReFF loss
(``train_pair.py:290-410``).

Both return ``loss_fn(student, teacher, batch) -> (loss,
metrics)``. ``student`` is the model's forward (``train/step.py`` gives
it the step's parameters); ``teacher`` the frozen HR model in eval mode,
which runs under ``torch.no_grad()``, as the reference wraps it in
``torch.no_grad`` with ``teacher.eval()``. Its feature is the last output
of ``forward_key``. A batch holds NHWC ``image`` [N, H, W, 3], ``label``
[N, H, W], and as the objective needs them ``existence`` [N, n_classes],
``ref_image`` and ``flow`` [N, H, W, 2], all on the step's device.

Phase-2 stage 2 resizes the flows to the teacher feature's grid
(magnitude rescale, then nearest, ``train_pair.py:345-348``), warps the
teacher's keyframe feature with ``ops.warp_feature`` (K2 on the card), and
runs the student in merge mode, whose "local" fusion is
``ops.creff_local_module_resize`` (K1 on the card, with K1B as its
backward).

Each stage of a loss runs under a ``record_function`` span, which the
benchmark's per-layer readers read: ``train.teacher`` (the frozen
teacher's forwards, and in stage 2 the flow resize and the K2 warp of the
key feature), ``train.student`` (the resize to the LR scale and the
student's forward) and ``train.loss`` (the segmentation and feature
losses). ``train/step.py`` adds ``train.step``, ``train.backward`` and
``train.update``.
"""

import torch
from torch.profiler import record_function

from arseg_tpu_torch.ops.resize import interpolate_bilinear
from arseg_tpu_torch.ops.warp import scale_and_resize_flow, warp_feature
from arseg_tpu_torch.train import losses as L


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _resize(x, hw):
    """Bilinear, align_corners=True; x itself when already at hw."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return interpolate_bilinear(x, hw, True)


def _teacher_feat(teacher, x):
    with torch.no_grad():
        return teacher.forward_key(x)[-1]


def _seg_losses(model_type, dataset, outputs, batch, out_hw, alpha):
    """The per-model segmentation losses: (loss, the feature output,
    metrics)."""
    y = batch["label"]
    if model_type == "pspnet":
        out, out_cls, out_p = outputs[0], outputs[1], outputs[2]
        out = _resize(out, out_hw)
        if dataset == "camvid":
            seg = L.nll_loss(out, y)
            cls = L.bce_with_logits(out_cls, batch["existence"])
            return seg + alpha * cls, out_p, {"seg_loss": seg, "cls_loss": cls}
        aux = _resize(out_cls, out_hw)
        seg = L.cross_entropy(out, y)
        auxl = L.cross_entropy(aux, y)
        return seg + 0.4 * auxl, out_p, {"seg_loss": seg, "aux_loss": auxl}
    out, out16, out32, out_p = outputs
    l0, l16, l32 = (L.ohem_ce(_resize(o, out_hw), y) for o in (out, out16, out32))
    return l0 + l16 + l32, out_p, {"seg_loss": l0}


def _feat_loss(kind, target, out_p, loss, metrics):
    if kind == "mse":
        fl = L.mse(target, out_p)
    elif kind == "KL":
        fl = L.kl_div_log_target(target, out_p)
    else:
        return loss
    metrics["feat_loss"] = fl
    return loss + fl


def _sizes(cropsize_wh, scale):
    ch, cw = cropsize_wh[1], cropsize_wh[0]
    return (ch, cw), (int(ch * scale), int(cw * scale))


def build_phase1_loss(model_type, dataset, cropsize_wh, scale, alpha=1.0, feat_loss=None):
    """Phase 1: the model on the image downscaled to ``scale``; with
    feat_loss ("mse" or "KL") also the distance of its feature from the
    teacher's, resized to the LR size."""
    out_hw, lr_hw = _sizes(cropsize_wh, scale)

    def loss_fn(student, teacher, batch):
        x_full = _nchw(batch["image"])
        target = None
        if feat_loss:
            with record_function("train.teacher"):
                target = _resize(_teacher_feat(teacher, x_full), lr_hw)
        with record_function("train.student"):
            outputs = student(_resize(x_full, lr_hw))
        with record_function("train.loss"):
            loss, out_p, metrics = _seg_losses(model_type, dataset, outputs, batch, out_hw, alpha)
            loss = _feat_loss(feat_loss, target, out_p, loss, metrics)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def build_phase2_loss(model_type, dataset, cropsize_wh, scale, alpha=1.0, feat_loss="mse",
                      stage2=False, with_motion=True):
    """Phase 2 (FST): the fused student on the image at ``scale``, its
    feature held to the teacher's on the full image. Stage 1 runs the
    student in normal mode; stage 2 in merge mode with the teacher's
    feature of ``ref_image``, warped by ``flow`` when with_motion."""
    out_hw, lr_hw = _sizes(cropsize_wh, scale)

    def loss_fn(student, teacher, batch):
        x_full = _nchw(batch["image"])
        with record_function("train.teacher"):
            highres_p = _teacher_feat(teacher, x_full)
            if stage2:
                ref_p = _teacher_feat(teacher, _nchw(batch["ref_image"]))
                if with_motion:
                    flow = scale_and_resize_flow(batch["flow"], tuple(ref_p.shape[-2:]),
                                                 mode="nearest", split=True)
                    ref_p = _nchw(warp_feature(ref_p.permute(0, 2, 3, 1), flow))
        with record_function("train.student"):
            x = _resize(x_full, lr_hw)
            outputs = student(x, mode="merge", ref_p=ref_p) if stage2 else student(x)
        with record_function("train.loss"):
            loss, out_p, metrics = _seg_losses(model_type, dataset, outputs, batch, out_hw, alpha)
            loss = _feat_loss(feat_loss, highres_p, _resize(out_p, highres_p.shape[-2:]), loss,
                              metrics)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn
