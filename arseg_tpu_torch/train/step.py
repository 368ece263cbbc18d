"""The training step — port of the single-device path of
``arseg_tpu/train/step.py``.

``make_train_step(loss_fn, optimizer, ...)`` returns
``step(model, teacher, batch, generator=None) -> metrics``: one optimizer
update of ``model`` (in place) from ``loss_fn(student, teacher, batch) ->
(loss, metrics)``, where ``student`` calls the model's forward with the
step's parameters. The metrics are detached 0-d tensors left on the device,
so a step never waits for the card.

Frozen subtrees (FST's final conv, ``train_pair.py:259-263``) are frozen
by module: ``trainable_parameters`` sets ``requires_grad_(False)`` on them
and returns the rest, which the optimizer takes. A module the reference
registers under two names (BiSeNet's ``conv_out.conv_out`` is also
``final_conv``) is one object, so freezing one name freezes both, and
``parameters()`` yields it once. BN running statistics are buffers, never
parameters.

``compute_dtype=torch.bfloat16`` is the JAX package's mixed precision:
the forward and backward run on bf16 copies of the float32 master
parameters (``torch.func.functional_call``; the cast's backward brings the
gradients back to float32), the images are cast to bf16, and the flows,
the BN batch statistics, the running statistics, the optimizer state and
the loss math stay float32. BN's weight and bias stay float32 too, so its
running-statistics update stays float32: the JAX package rounds them to
bf16 for the normalisation (``nn/functional.py:450-452``), a difference
within the bf16 tolerance. ``torch.autocast`` would cast another set of
ops, so it is not used.

``accum_steps > 1`` splits the batch into that many micro-batches and sums
their gradients before one update, then scales by 1/k, as the JAX
``lax.scan`` does. BN then normalises each micro-batch with its own
statistics, and the running statistics take one momentum update with the
mean of the micro-batches' (mean, unbiased variance), as the JAX
``apply_bn_updates`` does: the micro-batches run with BN momentum 1.0, so
each leaves its own statistics in the running buffers, which are read and
restored; torch's own k sequential updates would give another result.

Data parallel (``mesh``: a ``parallel.DataGroup`` of n ranks, one process
per card; the JAX keyword's name is kept): each rank steps its own copy of
the model on its rows of the batch (``parallel.shard_batch``, or a
``Loader`` given the group), and the copies stay equal.

- ``bn_mode="sync"`` (the JAX default): the forward and backward run inside
  ``parallel.synced``, so BN normalises with the whole batch's statistics
  and moves the running statistics with them, dropout draws the whole
  batch's masks, and the loss is this rank's share of the whole batch's
  loss (OHEM included: ``train/losses.py``); the gradients' sum over the
  ranks (one coalesced all-reduce) is then the gradient of the whole
  batch's loss, as under the JAX package's jitted step over a sharded
  batch. The metrics are summed the same way.
- ``bn_mode="master"`` (``nn.DataParallel``'s semantics): each rank
  normalises with its own rows' statistics and takes the mean loss of its
  rows; the gradients and metrics are averaged over the ranks, and every
  rank's BN running statistics are set to rank 0's after its update
  (``broadcast``), as the JAX step keeps replica 0's update alone
  (``arseg_tpu/train/step.py:118-131``).

A group of one rank exchanges nothing: the step is the one-device step.
``accum_steps > 1`` with more than one rank, or with ``bn_mode="master"``,
raises, as in the JAX package.

A step runs under a ``train.step`` span (``record_function``, a no-op
unless a profiler records), its ``loss.backward()`` under
``train.backward`` and the optimizer's step under ``train.update``; the
objectives mark their own stages inside (``train/objectives.py``).
"""

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call
from torch.profiler import record_function

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.gop.pipeline import place_model
from arseg_tpu_torch.nn.functional import BN_MOMENTUM, set_dropout_generator
from arseg_tpu_torch.parallel.group import check_group, coalesced, synced

IMAGE_KEYS = ("image", "ref_image")


def trainable_parameters(model, frozen_prefixes=()):
    """Freeze the modules named by ``frozen_prefixes`` (``requires_grad_
    (False)``) and return the parameters left to train, each once."""
    for prefix in frozen_prefixes:
        model.get_submodule(prefix).requires_grad_(False)
    return [p for p in model.parameters() if p.requires_grad]


def teacher_copy(teacher, device=None, compute_dtype=None):
    """The frozen teacher as the step takes it: a copy on ``device`` in
    eval mode, in ``compute_dtype`` unless None (the engines' ``place_model``)."""
    return place_model(teacher, resolve_device(device), compute_dtype).requires_grad_(False)


def _batch_norms(model):
    return [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]


def _student(model, compute_dtype):
    """The model's forward with float parameters cast to compute_dtype
    (BN's kept float32), or the model itself when compute_dtype is None."""
    if compute_dtype is None:
        return model
    keep = {id(p) for m in _batch_norms(model) for p in m.parameters(recurse=False)}
    params = {n: p if id(p) in keep or not p.is_floating_point() else p.to(compute_dtype)
              for n, p in model.named_parameters()}

    def call(*args, **kwargs):
        # tie_weights=False: a module registered under two names is one
        # object, so the tensor set under one name serves both, and the
        # originals are put back after the call
        return functional_call(model, params, args, kwargs, tie_weights=False)

    return call


def make_train_step(loss_fn, optimizer, mesh=None, bn_mode="sync", accum_steps=1,
                    compute_dtype=None, device=None):
    """optimizer: a ``ScheduledOptimizer`` over ``model``'s trainable
    parameters; mesh: a ``parallel.DataGroup`` or None; device: the
    group's device when None and a group is given. See the module
    docstring."""
    if bn_mode not in ("sync", "master"):
        raise ValueError(f"bn_mode must be 'sync' or 'master', got {bn_mode!r}")
    mesh = check_group(mesh)
    if bn_mode == "master" and mesh is None:
        raise ValueError("bn_mode='master' needs a mesh (per-replica stats)")
    multi_device = mesh is not None and mesh.size > 1
    if accum_steps > 1 and (multi_device or bn_mode != "sync"):
        raise ValueError("accum_steps>1 is the single-device path "
                         "(shard over the mesh instead)")
    device = resolve_device(device if device is not None or mesh is None else mesh.device)
    pg = mesh.process_group if multi_device else None

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=device)
            out[k] = v.to(compute_dtype) if compute_dtype is not None and k in IMAGE_KEYS else v
        return out

    def forward_backward(model, teacher, batch):
        loss, metrics = loss_fn(_student(model, compute_dtype), teacher, batch)
        with record_function("train.backward"):
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def accumulate(model, teacher, batch):
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} not divisible by accum_steps {accum_steps}")
        chunks = {k: v.chunk(accum_steps) for k, v in batch.items()}
        bns = _batch_norms(model)
        old = [(m.running_mean.clone(), m.running_var.clone(), m.num_batches_tracked.clone())
               for m in bns]
        sums = [(torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var)) for m in bns]
        total = None
        try:
            for m in bns:
                m.momentum = 1.0  # the buffers take each micro-batch's own statistics
            for i in range(accum_steps):
                metrics = forward_backward(model, teacher, {k: c[i] for k, c in chunks.items()})
                total = metrics if total is None else {k: total[k] + metrics[k] for k in total}
                for (mean, var), m in zip(sums, bns):
                    mean += m.running_mean
                    var += m.running_var
        finally:
            for m in bns:
                m.momentum = BN_MOMENTUM
        inv = 1.0 / accum_steps
        with torch.no_grad():
            for (mean, var), m, (old_mean, old_var, tracked) in zip(sums, bns, old):
                # a BN this forward did not run keeps its statistics, as in
                # the JAX package; decided on the device, without a sync
                ran = m.num_batches_tracked.ne(tracked)
                m.running_mean.copy_(torch.where(
                    ran, old_mean * (1 - BN_MOMENTUM) + mean * inv * BN_MOMENTUM, old_mean))
                m.running_var.copy_(torch.where(
                    ran, old_var * (1 - BN_MOMENTUM) + var * inv * BN_MOMENTUM, old_var))
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            torch._foreach_mul_(grads, inv)
        return {k: v * inv for k, v in total.items()}

    def reduce_step(metrics):
        """The gradients (in place) and the metrics summed over the ranks
        (sync) or averaged (master): one all-reduce per dtype."""
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        names = sorted(metrics)
        values = [metrics[k].float().reshape(1) for k in names]

        def reduce(flat):
            dist.all_reduce(flat, group=pg)
            if bn_mode == "master":
                flat.div_(mesh.size)

        coalesced(grads + values, reduce)
        return {k: v.reshape(()) for k, v in zip(names, values)}

    def keep_rank0_statistics(model):
        stats = [b for m in _batch_norms(model) for b in (m.running_mean, m.running_var)]
        coalesced(stats, lambda flat: dist.broadcast(flat, src=0, group=pg))

    def step(model, teacher, batch, generator=None):
        """One update of ``model`` (this rank's rows of the batch under a
        mesh); ``teacher`` as ``teacher_copy`` gives it; ``generator`` the
        dropout masks' source. Returns the metrics."""
        with record_function("train.step"):
            model.train()
            set_dropout_generator(model, generator)
            batch = to_device(batch)
            optimizer.zero_grad()
            if accum_steps > 1:
                metrics = accumulate(model, teacher, batch)
            elif not multi_device:
                metrics = forward_backward(model, teacher, batch)
            elif bn_mode == "sync":
                with synced(mesh):
                    metrics = forward_backward(model, teacher, batch)
                metrics = reduce_step(metrics)
            else:
                metrics = reduce_step(forward_backward(model, teacher, batch))
                keep_rank0_statistics(model)
            with record_function("train.update"):
                optimizer.step()
            return metrics

    return step
