"""Data parallelism over ``torch.distributed`` — the counterpart of
``arseg_tpu/parallel/mesh.py``.

The JAX package runs one program over a 1-D "data" mesh of n devices; the
port runs one process per card, and the mesh becomes a process group of n
ranks. A ``DataGroup`` carries what the port's data-parallel entry points
need: the process group, this process's rank in it, its size, and the
device this rank computes on. Launch the processes with ``torchrun`` (or
``torch.multiprocessing``) and ``init_process_group`` before
``data_group``: ``nccl`` between cards, ``gloo`` on the CPU.

Only two collectives are used, ``broadcast`` and ``all_reduce``: ``gloo``
runs both on CUDA tensors too, so two ranks can share one card (NCCL
refuses that), which is how one card holds the sharding logic. A gather is
an ``all_reduce`` into a zero-filled buffer, as the JAX master mode builds
its keep-replica-0 update (``arseg_tpu/train/step.py:125-130``).

``synced(group)`` is the step's switch for the global-batch semantics of
``bn_mode="sync"``: inside it the port's BatchNorm takes its train-mode
statistics over the group's whole batch, ``Dropout2d`` draws the whole
batch's masks and keeps its rank's rows, and the losses reduce over the
whole batch (``nn/functional.py``, ``train/losses.py``). It is scoped by a
``with`` block and never outlives the step.
"""

import contextlib
import contextvars
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from arseg_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """``process_group``: the ranks' group (None when ``size`` is 1, where
    nothing is exchanged); ``rank`` in it; ``size``; this rank's device."""

    process_group: object
    rank: int
    size: int
    device: torch.device


def _rank_device(device):
    """This rank's device: ``device`` resolved, a CUDA device without an
    index (``"cuda"``, or None) taken as ``cuda:{local rank}``:
    ``LOCAL_RANK`` as torchrun sets it, else the global rank modulo the
    cards present when there are several ranks, else the current device."""
    device = resolve_device(device)  # raises for "cuda" with no card
    if device.type != "cuda" or device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count()
    elif dist.is_initialized() and dist.get_world_size() > 1:
        index = dist.get_rank() % torch.cuda.device_count()
    else:
        index = torch.cuda.current_device()
    return torch.device("cuda", index)


def data_group(n_devices=None, batch_size=None, device=None):
    """The group of the first n ranks of the initialised process group (one
    process alone when none is): n is ``n_devices`` (all ranks when None),
    clamped, as ``data_mesh`` clamps, to the largest size that divides
    ``batch_size``. Every rank must call it. A rank outside the group gets
    None and takes no part. ``device``: this rank's device; ``cuda:{local
    rank}`` when None or ``"cuda"`` (``_rank_device``), made the current
    CUDA device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks")
    if batch_size is not None:
        while n > 1 and batch_size % n:
            n -= 1
    device = _rank_device(device)
    if device.type == "cuda":  # NCCL's own buffers go to the current device
        torch.cuda.set_device(device)
    if n == world and n > 1:
        pg = dist.group.WORLD
    elif n > 1:
        pg = dist.new_group(list(range(n)))  # a collective call: every rank makes it
    else:
        pg = None
    if rank >= n:
        return None
    return DataGroup(pg, rank, n, device)


def check_group(mesh):
    """``mesh`` itself if it is a ``DataGroup`` or None; else TypeError."""
    if mesh is not None and not isinstance(mesh, DataGroup):
        raise TypeError(f"mesh must be a parallel.DataGroup (data_group()), got {type(mesh)}")
    return mesh


def is_main(group):
    """Whether this process writes files and logs: rank 0, or no group."""
    return group is None or group.rank == 0


def shard_batch(batch, group):
    """A dict of arrays or tensors -> this rank's contiguous rows
    [r*b/n, (r+1)*b/n) of each; the batch unchanged when size is 1."""
    if group is None or group.size == 1:
        return batch
    b = len(next(iter(batch.values())))
    if b % group.size:
        raise ValueError(f"batch of {b} rows does not divide over {group.size} ranks")
    k = b // group.size
    return {key: v[group.rank * k:(group.rank + 1) * k] for key, v in batch.items()}


def replicate(module_or_state, group):
    """Every tensor of a module (parameters and buffers) or of a dict of
    tensors set to rank 0's, in place (``broadcast``); returns it."""
    if group is None or group.size == 1:
        return module_or_state
    if isinstance(module_or_state, torch.nn.Module):
        tensors = [*module_or_state.parameters(), *module_or_state.buffers()]
    else:
        tensors = list(module_or_state.values())
    coalesced(tensors, lambda flat: dist.broadcast(flat, src=0, group=group.process_group))
    return module_or_state


def coalesced(tensors, collective):
    """Run ``collective`` (in place on a flat tensor) once per dtype over
    the tensors' values laid end to end, and copy the results back: one
    collective for many small tensors, whatever their memory format."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            collective(flat)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()


def broadcast_object(obj, group):
    """Rank 0's picklable ``obj`` on every rank (a ``broadcast`` of its
    bytes)."""
    if group is None or group.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group.process_group, device=group.device)
    return box[0]


def psum_hist(hist, group):
    """The confusion histogram summed over the ranks (an int64
    ``all_reduce``, in place); the histogram itself when size is 1."""
    if group is None or group.size == 1:
        return hist
    dist.all_reduce(hist, group=group.process_group)
    return hist


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks, differentiable: the backward sums
    the ranks' gradients the same way, so each rank's input gets the
    gradient of the sum of every rank's loss."""
    if group is None or group.size == 1:
        return x
    return _AllReduceSum.apply(x, group.process_group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.pg)
        return out, None


def gather_rows(x, group):
    """Every rank's ``x`` (equal shapes), stacked along dim 0 in rank
    order: each rank's rows in a zero-filled buffer, then one
    ``all_reduce``. Differentiable; ``x`` itself when size is 1."""
    if group is None or group.size == 1:
        return x
    k = x.shape[0]
    before = x.new_zeros((group.rank * k, *x.shape[1:]))
    after = x.new_zeros(((group.size - group.rank - 1) * k, *x.shape[1:]))
    return all_reduce_sum(torch.cat([before, x, after]), group)


def pad_rows(batch, n, pad_values=None):
    """Each array or tensor of a dict padded along dim 0 to a multiple of
    n, with zeros or ``pad_values[key]`` (the JAX engines' ``_pad_rows``)."""
    b = len(next(iter(batch.values())))
    pad = (-b) % n
    if pad == 0:
        return batch
    pad_values = pad_values or {}
    out = {}
    for key, v in batch.items():
        fill = pad_values.get(key, 0)
        if torch.is_tensor(v):
            out[key] = torch.cat([v, v.new_full((pad, *v.shape[1:]), fill)])
        else:
            v = np.asarray(v)
            out[key] = np.concatenate([v, np.full((pad, *v.shape[1:]), fill, v.dtype)])
    return out


_SYNC = contextvars.ContextVar("arseg_tpu_torch_sync_group", default=None)


@contextlib.contextmanager
def synced(group):
    """Global-batch semantics (module docstring) inside the block; a no-op
    for None or a group of one."""
    token = _SYNC.set(group if group is not None and group.size > 1 else None)
    try:
        yield
    finally:
        _SYNC.reset(token)


def sync_group():
    """The group of the enclosing ``synced`` block, or None."""
    return _SYNC.get()
