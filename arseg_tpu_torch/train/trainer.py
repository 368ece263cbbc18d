"""The trainers — port of ``arseg_tpu/train/trainer.py``: phase 1 (the
HR or plain LR image model, reference ``train.py:77-307``) and phase 2 (LR
+ CReFF + FST, ``train_pair.py:91-429``), on one device or data parallel.

As in the JAX package, the per-dataset policy (crop size, scales, optimizer
kind) lives in ``DATASET_POLICY``, and checkpoints carry explicit metadata
and the optimizer state for a true resume, under the reference's
``PSPNet_{backend}_{scale}_{epoch}_`` names. Validation runs the port's
``EvalConstRes`` (phase 1, phase-2 stage 1) and ``EvalAlterRes`` (phase-2
stage 2) on copies of the models; the models go back to train mode after.

The readers (``arseg_tpu_torch.data``, which open files with PIL and cv2)
are imported inside ``train_phase1``/``train_phase2``, so that importing
this module imports neither. The training readers draw each sample's
augmentation from a ``SampleRng`` that the loader seeds per sample.

Data parallel: run one process per card (``torchrun --nproc_per_node N``,
``init_process_group`` first); ``num_devices`` (all ranks when None) is
clamped to the largest count that divides ``batch_size``
(``parallel.data_group``), ``batch_size`` is the global batch, and each
rank's loader yields its rows of it. ``bn_mode`` is the step's
(``train/step.py``). Rank 0 alone prints and writes checkpoints; a resume
is read by rank 0 and broadcast, and every rank starts from rank 0's
weights. Validation runs the engines with the group (frames spread over
the ranks, the histogram summed), so every rank takes the same decisions.
A rank outside the clamped group returns (None, []) at once.
"""

import os

import torch

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.eval.engine import EvalAlterRes, EvalConstRes
from arseg_tpu_torch.nn.bisenet import BiSeNetV1
from arseg_tpu_torch.nn.pspnet import PSPNet
from arseg_tpu_torch.nn.pspnet_semseg import PSPNetSemseg
from arseg_tpu_torch.train.objectives import build_phase1_loss, build_phase2_loss
from arseg_tpu_torch.train.optim import (cosine_schedule, make_optimizer, t_max_for,
                                         warmup_cosine_schedule)
from arseg_tpu_torch.parallel.group import broadcast_object, data_group, is_main, replicate
from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
from arseg_tpu_torch.utils.checkpoint import load_checkpoint, load_weights, save_checkpoint

DATASET_POLICY = {
    "camvid": dict(
        cropsize=(960, 720),
        randomscale=(0.5, 0.675, 0.75, 0.875, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5),
        n_classes=12,
        optimizer="adam",
        train_workers=8,
        val_workers=4,
    ),
    "cityscapes": dict(
        cropsize=(512, 1024),
        randomscale=(0.5, 0.75, 0.875, 1.0, 1.25, 1.5, 1.75, 2.0),
        n_classes=19,
        optimizer="sgd",
        train_workers=16,
        val_workers=4,
    ),
}

FINAL_CONV_PATH = {
    ("pspnet", "camvid"): "final_conv",
    ("pspnet", "cityscapes"): "cls.4",
    ("bisenet", "camvid"): "conv_out.conv_out",
    ("bisenet", "cityscapes"): "conv_out.conv_out",
}

PSP_SIZES = {
    "resnet18": (512, 256),
    "resnet34": (512, 256),
    "resnet50": (2048, 1024),
    "resnet101": (2048, 1024),
    "resnet152": (2048, 1024),
    "densenet": (1024, 512),
    "squeezenet": (512, 256),
}

# batch entries the objectives read
BATCH_KEYS = ("image", "label", "existence", "ref_image", "flow")


def compute_dtype_of(train_dtype):
    """"bfloat16" -> torch.bfloat16 mixed precision (``train/step.py``);
    None or "float32" -> float32 throughout."""
    if train_dtype in (None, "float32"):
        return None
    return getattr(torch, train_dtype)


def build_train_model(model_type, dataset, backend, n_classes, fuse, seed=0, **kw):
    """The reference's model registries (``train.py:141-170``,
    ``train_pair.py:176-254``), weights from a generator seeded with
    ``seed``, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    atten = dict(attention_type=kw.get("atten_type", "local"), atten_k=kw.get("atten_k", 7))
    if model_type == "pspnet":
        if dataset == "camvid":
            psp_size, deep = PSP_SIZES[backend]
            return PSPNet(n_classes=n_classes, psp_size=psp_size, deep_features_size=deep,
                          backend=backend, fuse_version=kw.get("fuse_version", 1) if fuse else 0,
                          generator=gen, **atten)
        return PSPNetSemseg(layers=int(backend.replace("resnet", "")), classes=n_classes,
                            feat_dim=PSP_SIZES[backend][0], with_fuse=fuse, generator=gen,
                            **atten)
    return BiSeNetV1(n_classes=n_classes, backend=backend, with_fuse=fuse, generator=gen, **atten)


def backend_key(model_type, dataset, backend):
    """The converter's backend name, e.g. "camvid-bise18",
    "cityscapes-psp50" or "camvid-pspdensenet" (``utils/convert.family``
    gives its key names)."""
    return f"{dataset}-{'psp' if model_type == 'pspnet' else 'bise'}{backend.replace('resnet', '')}"


def graft_final_conv(model, teacher, path):
    """The reference's load_decoder (``train.py:51-59``): copy the teacher's
    final conv into the student."""
    model.get_submodule(path).load_state_dict(teacher.get_submodule(path).state_dict())


def dropout_generator(seed, epoch, device):
    """The dropout masks' generator of a run resumed at ``epoch``: seeded
    from (seed, epoch), as the JAX trainers fold the epoch into their key."""
    return torch.Generator(device=device).manual_seed((seed + 1) * 1_000_003 + epoch)


class TrainLoop:
    """The epoch loop both phases share; with a ``mesh`` (a
    ``parallel.DataGroup``) its batches go to the group's device and rank 0
    alone prints."""

    def __init__(self, device=None, log_every=50, verbose=True, mesh=None):
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.log_every = log_every
        self.verbose = verbose and is_main(mesh)

    def run_epoch(self, step_fn, model, teacher, loader, epoch, generator=None):
        """One pass of ``step_fn`` over ``loader``'s batches, copied to the
        device two batches ahead. The losses stay on the device; the host
        reads one at each log point and their mean at the end. Returns the
        mean loss (nan for an empty loader)."""
        from arseg_tpu_torch.data.loader import device_prefetch

        model.train()
        batches = ({k: v for k, v in b.items() if k in BATCH_KEYS} for b in loader)
        losses = []
        for i, batch in enumerate(device_prefetch(batches, self.device, size=2)):
            metrics = step_fn(model, teacher, batch, generator)
            losses.append(metrics["loss"])
            if self.verbose and i % self.log_every == 0:
                print(f"[{epoch + 1}] it {i}: loss={float(metrics['loss']):.5f}", flush=True)
        if not losses:
            return float("nan")
        return float(torch.stack(losses).double().mean())


def _check_flags(resume, snapshot):
    if resume and snapshot:
        raise ValueError("resume and snapshot are mutually exclusive: resume restores a full "
                         "trainer state, snapshot warm-starts weights with a fresh optimizer")


def _optimizer(model, policy, snapshot, start_lr, t_max, frozen):
    params = trainable_parameters(model, frozen)
    if snapshot:
        return make_optimizer("adam", warmup_cosine_schedule(start_lr, 1e-5, 500, t_max), params)
    return make_optimizer(policy["optimizer"], cosine_schedule(start_lr, t_max), params)


def _resume(path, model, optimizer, verbose, group=None):
    """True resume from a checkpoint these trainers wrote: the weights, the
    optimizer state (with the schedule's update count) and the epoch and
    best-mIoU cursors. As in the JAX package, the trainers save only when
    the validation mIoU improves, so a run resumes from its best epoch, and
    the dropout generator is seeded anew rather than replayed. With a
    group, rank 0 reads the file and broadcasts it. Returns (start_epoch,
    max_miou)."""
    ck = broadcast_object(load_checkpoint(path) if is_main(group) else None, group)
    model.load_state_dict(ck["state_dict"], strict=True)
    if ck["optimizer"] is None:
        raise ValueError(f"resume checkpoint {path!r} has no optimizer state; "
                         "use snapshot to warm-start from weights alone")
    optimizer.load_state_dict(ck["optimizer"])
    meta = ck["metadata"]
    start_epoch, max_miou = int(meta.get("epoch", 0)), float(meta.get("miou", 0.0))
    if verbose and is_main(group):
        print(f"resuming from {path}: epoch {start_epoch}, best mIoU {max_miou:.4f}", flush=True)
    return start_epoch, max_miou


def _save(models_path, backend, scale, epoch, model, optimizer, metadata, group):
    if is_main(group):
        save_checkpoint(os.path.join(models_path, f"PSPNet_{backend}_{scale}_{epoch + 1}_.pth"),
                        model, optimizer, metadata)


def train_phase1(data_path, models_path, backend="resnet34", snapshot=None, batch_size=16,
                 alpha=1.0, epochs=20, start_lr=1e-3, scale=1.0, feat_loss=None,
                 dataset="camvid", model_type="pspnet", teacher_snapshot=None, seed=233,
                 num_devices=None, num_workers=None, verbose=True, eval_every=1, cropsize=None,
                 randomscale=None, bn_mode="sync", accum_steps=1, train_dtype=None,
                 resume=None, nanmean=False, device=None):
    """Phase 1. Returns (model, history): the trained model on the device
    and one dict (epoch, loss, miou) per validation."""
    from arseg_tpu_torch.data import CamVid, CityScapes, Loader
    from arseg_tpu_torch.data.transform import SampleRng

    _check_flags(resume, snapshot)
    group = data_group(num_devices, batch_size, device)
    if group is None:
        return None, []
    device = group.device
    policy = DATASET_POLICY[dataset]
    os.makedirs(models_path, exist_ok=True)
    cropsize = cropsize or policy["cropsize"]
    randomscale = randomscale or policy["randomscale"]
    n_classes = policy["n_classes"]
    compute_dtype = compute_dtype_of(train_dtype)
    key = backend_key(model_type, dataset, backend)

    if dataset == "camvid":
        train_ds = CamVid(data_path, cropsize=cropsize, mode="train", randomscale=randomscale,
                          rng=SampleRng())
        val_ds = CamVid(data_path, mode="val")
    else:
        train_ds = CityScapes(data_path, model_type=model_type, cropsize=cropsize, mode="train",
                              randomscale=randomscale, rng=SampleRng())
        val_ds = CityScapes(data_path, model_type=model_type, mode="val")
    train_loader = Loader(train_ds, batch_size=batch_size, shuffle=True,
                          num_workers=num_workers or policy["train_workers"], drop_last=True,
                          seed=seed, group=group, pin_memory=device.type == "cuda")
    val_loader = Loader(val_ds, batch_size=group.size, shuffle=False,
                        num_workers=policy["val_workers"], drop_last=False,
                        pin_memory=device.type == "cuda")

    model = build_train_model(model_type, dataset, backend, n_classes, fuse=False, seed=seed)
    if snapshot:
        load_weights(model, snapshot, key)
    teacher, frozen = None, ()
    if feat_loss:
        if teacher_snapshot is None:
            raise ValueError("feat_loss requires teacher_snapshot")
        teacher = build_train_model(model_type, dataset, backend, n_classes, fuse=False)
        load_weights(teacher, teacher_snapshot, key)
        fc = FINAL_CONV_PATH[(model_type, dataset)]
        graft_final_conv(model, teacher, fc)
        if not snapshot:
            frozen = (fc,)
        teacher = teacher_copy(teacher, device, compute_dtype)
    model = replicate(model.to(device, memory_format=torch.channels_last), group)

    t_max = t_max_for(epochs, len(train_ds), batch_size)
    optimizer = _optimizer(model, policy, snapshot, start_lr, t_max, frozen)
    start_epoch, max_miou = 0, 0.0
    if resume:
        start_epoch, max_miou = _resume(resume, model, optimizer, verbose, group)

    loss_fn = build_phase1_loss(model_type, dataset, cropsize, scale, alpha, feat_loss)
    step_fn = make_train_step(loss_fn, optimizer, mesh=group, bn_mode=bn_mode,
                              accum_steps=accum_steps, compute_dtype=compute_dtype, device=device)
    loop = TrainLoop(verbose=verbose, mesh=group)
    verbose = verbose and is_main(group)
    evaluator = EvalConstRes(scale=scale, ignore_label=255, nanmean=nanmean, mesh=group,
                             device=device)
    generator = dropout_generator(seed, start_epoch, device)
    history = []
    for epoch in range(start_epoch, epochs):
        mean_loss = loop.run_epoch(step_fn, model, teacher, train_loader, epoch, generator)
        if (epoch + 1) % eval_every:
            continue
        miou = evaluator(model, val_loader, n_classes)
        model.train()
        history.append(dict(epoch=epoch, loss=mean_loss, miou=miou))
        if verbose:
            print(f"epoch {epoch}: val mIoU {miou:.4f}, max {max_miou:.4f}", flush=True)
        if miou > max_miou:
            max_miou = miou
            _save(models_path, backend, scale, epoch, model, optimizer,
                  dict(dataset=dataset, backend=backend, scale=scale, epoch=epoch + 1, miou=miou,
                       phase=1), group)
    return model, history


def train_phase2(data_path, sequence_path, models_path, backend="resnet34", snapshot=None,
                 batch_size=16, alpha=1.0, epochs=20, start_lr=1e-3, scale=1.0, feat_loss="mse",
                 atten_type="local", atten_k=7, stage1_epoch=50, ref_gap=2, bitrate=3,
                 with_motion=True, model_type="pspnet", dataset="camvid", fuse_version=1,
                 teacher_snapshot=None, seed=689, num_devices=None, num_workers=None,
                 verbose=True, eval_every=1, flow_shape=None, cropsize=None, randomscale=None,
                 bn_mode="sync", accum_steps=1, train_dtype=None, resume=None, nanmean=False,
                 device=None):
    """Phase 2: stage 1 (normal mode) for epochs before ``stage1_epoch``,
    stage 2 (merge mode on the warped keyframe feature) from it on.
    Returns (model, history)."""
    from arseg_tpu_torch.data import CamVid, CamVidWithFlow, CityScapes, CityScapesWithFlow, Loader
    from arseg_tpu_torch.data.transform import SampleRng

    _check_flags(resume, snapshot)
    group = data_group(num_devices, batch_size, device)
    if group is None:
        return None, []
    device = group.device
    policy = DATASET_POLICY[dataset]
    os.makedirs(models_path, exist_ok=True)
    cropsize = cropsize or policy["cropsize"]
    randomscale = randomscale or policy["randomscale"]
    n_classes = policy["n_classes"]
    compute_dtype = compute_dtype_of(train_dtype)
    key = backend_key(model_type, dataset, backend)

    mv_dir = os.path.join(sequence_path, f"{bitrate}M-GOP{ref_gap}",
                          f"MVmap_GOP{ref_gap}_dist_{ref_gap - 1}")
    ref_dir = os.path.join(sequence_path, f"{bitrate}M-GOP{ref_gap}", "frames")
    flow_kw = {"flow_shape": flow_shape} if flow_shape else {}
    if dataset == "camvid":
        if with_motion:
            train_ds = CamVidWithFlow(data_path, cropsize=cropsize, mode="train",
                                      randomscale=randomscale, load_pair=True, ref_gap=ref_gap,
                                      flow_path=mv_dir, ref_path=ref_dir, rng=SampleRng(),
                                      **flow_kw)
            val_ds = CamVidWithFlow(data_path, mode="val", load_pair=True, ref_gap=ref_gap,
                                    flow_path=mv_dir, ref_path=ref_dir, **flow_kw)
        else:
            train_ds = CamVid(data_path, cropsize=cropsize, mode="train", randomscale=randomscale,
                              load_pair=True, ref_gap=ref_gap, ref_path=ref_dir, rng=SampleRng())
            val_ds = CamVid(data_path, mode="val", load_pair=True, ref_gap=ref_gap,
                            ref_path=ref_dir)
        val_ds_stage1 = CamVid(data_path, mode="val")
    else:
        if not with_motion:
            raise NotImplementedError("cityscapes phase-2 requires motion vectors")
        train_ds = CityScapesWithFlow(data_path, model_type=model_type, cropsize=cropsize,
                                      mode="train", randomscale=randomscale, ref_gap=ref_gap,
                                      flow_path=mv_dir, rng=SampleRng())
        val_ds = CityScapesWithFlow(data_path, model_type=model_type, mode="val",
                                    ref_gap=ref_gap, flow_path=mv_dir)
        val_ds_stage1 = CityScapes(data_path, model_type=model_type, mode="val")
    train_loader = Loader(train_ds, batch_size=batch_size, shuffle=True,
                          num_workers=num_workers or policy["train_workers"], drop_last=True,
                          seed=seed, group=group, pin_memory=device.type == "cuda")
    val_loader = Loader(val_ds, batch_size=group.size, shuffle=False,
                        num_workers=policy["val_workers"], drop_last=False,
                        pin_memory=device.type == "cuda")
    val_loader_stage1 = Loader(val_ds_stage1, batch_size=group.size, shuffle=False,
                               num_workers=4, drop_last=False,
                               pin_memory=device.type == "cuda")

    kw = dict(atten_type=atten_type, atten_k=atten_k, fuse_version=fuse_version)
    model = build_train_model(model_type, dataset, backend, n_classes, fuse=True, seed=seed, **kw)
    # The teacher is built from the same fuse class as the student (the
    # reference builds highres_net from the fuse registry,
    # train_pair.py:178-254): its normal-mode feature is then the one at
    # the student's fusion depth. An HR checkpoint has no fusion weights;
    # normal mode never runs them.
    if teacher_snapshot is None:
        raise ValueError("phase 2 requires teacher_snapshot (the HR model)")
    teacher = build_train_model(model_type, dataset, backend, n_classes, fuse=True, **kw)
    load_weights(teacher, teacher_snapshot, key, allow_missing=("fuse_attention",))
    if snapshot:
        load_weights(model, snapshot, key)
    frozen = ()
    fc = FINAL_CONV_PATH[(model_type, dataset)]
    if feat_loss:
        graft_final_conv(model, teacher, fc)
        if not snapshot:
            frozen = (fc,)
    model = replicate(model.to(device, memory_format=torch.channels_last), group)
    teacher_dev = teacher_copy(teacher, device, compute_dtype)

    t_max = t_max_for(epochs, len(train_ds), batch_size)
    optimizer = _optimizer(model, policy, snapshot, start_lr, t_max, frozen)
    start_epoch, max_miou = 0, 0.0
    if resume:
        start_epoch, max_miou = _resume(resume, model, optimizer, verbose, group)

    def step_for(stage2):
        loss_fn = build_phase2_loss(model_type, dataset, cropsize, scale, alpha, feat_loss,
                                    stage2, with_motion)
        return make_train_step(loss_fn, optimizer, mesh=group, bn_mode=bn_mode,
                               accum_steps=accum_steps, compute_dtype=compute_dtype,
                               device=device)

    step_stage1, step_stage2 = step_for(False), step_for(True)
    loop = TrainLoop(verbose=verbose, mesh=group)
    verbose = verbose and is_main(group)
    eval_kw = dict(scale=scale, ignore_label=255, nanmean=nanmean, mesh=group, device=device)
    eval_stage2, eval_stage1 = EvalAlterRes(**eval_kw), EvalConstRes(**eval_kw)
    generator = dropout_generator(seed, start_epoch, device)
    history = []
    for epoch in range(start_epoch, epochs):
        stage2 = epoch >= stage1_epoch
        mean_loss = loop.run_epoch(step_stage2 if stage2 else step_stage1, model, teacher_dev,
                                   train_loader, epoch, generator)
        if (epoch + 1) % eval_every:
            continue
        if stage2:
            miou = eval_stage2(teacher, model, val_loader, n_classes)
        else:
            miou = eval_stage1(model, val_loader_stage1, n_classes)
        model.train()
        history.append(dict(epoch=epoch, loss=mean_loss, miou=miou, stage=2 if stage2 else 1))
        if verbose:
            print(f"epoch {epoch}: val mIoU {miou:.4f}, max {max_miou:.4f}", flush=True)
        if miou > max_miou:
            max_miou = miou
            _save(models_path, backend, scale, epoch, model, optimizer,
                  dict(dataset=dataset, backend=backend, scale=scale, epoch=epoch + 1, miou=miou,
                       phase=2, stage=2 if stage2 else 1, ref_gap=ref_gap), group)
    return model, history
