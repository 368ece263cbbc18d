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

Data parallelism (``mesh``, ``bn_mode="master"``) is not ported.
"""

import torch
import torch.nn as nn
from torch.func import functional_call

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.gop.pipeline import place_model
from arseg_tpu_torch.nn.functional import BN_MOMENTUM, set_dropout_generator

DATA_PARALLEL = ("data-parallel training (a mesh, bn_mode='master') is not ported: "
                 "ROADMAP.md Queue A 3, data parallel")
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
    parameters. See the module docstring."""
    if bn_mode not in ("sync", "master"):
        raise ValueError(f"bn_mode must be 'sync' or 'master', got {bn_mode!r}")
    if mesh is not None or bn_mode != "sync":
        raise NotImplementedError(DATA_PARALLEL)
    device = resolve_device(device)

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=device)
            out[k] = v.to(compute_dtype) if compute_dtype is not None and k in IMAGE_KEYS else v
        return out

    def forward_backward(model, teacher, batch):
        loss, metrics = loss_fn(_student(model, compute_dtype), teacher, batch)
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

    def step(model, teacher, batch, generator=None):
        """One update of ``model``; ``teacher`` as ``teacher_copy`` gives it;
        ``generator`` the dropout masks' source. Returns the metrics."""
        model.train()
        set_dropout_generator(model, generator)
        batch = to_device(batch)
        optimizer.zero_grad()
        if accum_steps == 1:
            metrics = forward_backward(model, teacher, batch)
        else:
            metrics = accumulate(model, teacher, batch)
        optimizer.step()
        return metrics

    return step
