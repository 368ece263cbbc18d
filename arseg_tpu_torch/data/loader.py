"""Host-side batching and prefetching loader (the DataLoader's place) — a
copy of ``arseg_tpu/data/loader.py``'s ``Loader``, and ``device_prefetch``,
the device stage of the training loop.

The loader overlaps PIL/cv2 decode with device compute through a thread
pool and a bounded prefetch queue, and yields batches of numpy arrays in a
fixed order for a seed. Threads (not processes) suffice because decode is
PIL/cv2/numpy-bound and releases the GIL. With ``pin_memory=True`` (a CUDA
device only) the workers stack each batch straight into pinned host
tensors.

``device_prefetch`` is the port's one way of staging host batches on the
card ahead of compute (training, the eval engines, ``gop/feeder.py``):
each batch's copies are issued with ``non_blocking=True`` from pinned
memory on a side CUDA stream, ``size`` batches ahead; the consumer's
stream waits on the copies' event before it reads them, so the copy of
batch k+1 runs beside the compute of batch k. It is issued from the
consumer's thread because the current stream is per thread. The staged
tensors are allocated on the side stream and read on the consumer's, so
each is ``record_stream``'d onto it: without that the caching allocator
could hand a block out again while the compute still reads it. Each
batch's staging (pinned copies, the device allocation and the enqueued
copies) runs under a ``loader.stage`` span (``record_function``).

Data parallel (``group``, a ``parallel.DataGroup`` of n ranks): every
rank draws the same order from the same seed, and rank r yields rows
[r*b/n, (r+1)*b/n) of each batch of b, so that the ranks' batches together
are the one-process batch. A dataset whose ``rng`` is a
``transform.SampleRng`` has it seeded before each sample from a number the
loader draws once an epoch (after the shuffle, the same on every rank) and
the sample's place in the epoch, so a sample is augmented alike whichever
rank or thread reads it.
"""

import collections
import queue
import random
import threading

import numpy as np
import torch
from torch.profiler import record_function

from arseg_tpu_torch.data.transform import SampleRng


def pinned(shape, dtype):
    """An uninitialised pinned host tensor of numpy ``dtype`` and its numpy
    view, to fill. It comes from PyTorch's caching host allocator, which
    hands a block out again only after the copies recorded on it have run,
    so a producer may allocate one per batch."""
    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)
    return t, t.numpy()


def _stack(samples, pin=False):
    out = {}
    for k in samples[0]:
        parts = [np.asarray(s[k]) for s in samples]
        if pin:
            out[k], view = pinned((len(parts), *parts[0].shape), parts[0].dtype)
            np.stack(parts, out=view)
        else:
            out[k] = np.stack(parts)
    return out


class Loader:
    def __init__(
        self,
        dataset,
        batch_size=1,
        shuffle=False,
        num_workers=4,
        drop_last=False,
        seed=None,
        prefetch=4,
        group=None,
        pin_memory=False,
    ):
        if group is not None and group.size > 1:
            if batch_size % group.size or not drop_last or seed is None:
                raise ValueError("a data-parallel loader needs a batch size that divides over "
                                 "the ranks, drop_last=True and a seed (every rank draws the "
                                 "same order)")
        self.group = group
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = random.Random(seed)
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        """This rank's (place in the epoch, sample index) pairs of each
        batch."""
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        lo, hi = 0, self.batch_size
        if self.group is not None and self.group.size > 1:
            k = self.batch_size // self.group.size
            lo, hi = self.group.rank * k, (self.group.rank + 1) * k
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield [(i + j, chunk[j]) for j in range(lo, min(hi, len(chunk)))]

    def __iter__(self):
        batches = list(self._batches())
        sample_rng = getattr(self.dataset, "rng", None)
        if not isinstance(sample_rng, SampleRng):
            sample_rng = None
        epoch_seed = self.rng.getrandbits(64) if sample_rng is not None else 0

        def read(place, i):
            if sample_rng is not None:
                sample_rng.seed((epoch_seed << 32) + place)
            return self.dataset[i]

        out_q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        # Each batch is fetched by one worker (keeps sample order inside a
        # batch deterministic); batches are emitted strictly in order.
        results = {}
        results_lock = threading.Condition()
        next_emit = [0]

        def worker(worker_id):
            for bi in range(worker_id, len(batches), self.num_workers):
                with results_lock:
                    # bound the decode look-ahead so a slow consumer holds
                    # O(prefetch + workers) batches in host memory, not the
                    # whole epoch (same backpressure as gop/feeder.py)
                    while (
                        bi - next_emit[0] > self.prefetch + self.num_workers
                        and not stop.is_set()
                    ):
                        results_lock.wait()
                if stop.is_set():
                    return
                try:
                    batch = _stack([read(place, i) for place, i in batches[bi]],
                                   self.pin_memory)
                except Exception as e:  # surface in consumer
                    batch = e
                with results_lock:
                    results[bi] = batch
                    results_lock.notify_all()

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        def emitter():
            for bi in range(len(batches)):
                with results_lock:
                    while bi not in results:
                        results_lock.wait()
                    item = results.pop(bi)
                    next_emit[0] = bi
                    results_lock.notify_all()
                out_q.put(item)
            out_q.put(None)

        threading.Thread(target=emitter, daemon=True).start()

        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            with results_lock:
                results_lock.notify_all()  # release workers in the bound-wait


def _is_array(v):
    return isinstance(v, np.ndarray) or torch.is_tensor(v)


def _map(fn, batch):
    """fn over the values of a dict or a tuple."""
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return tuple(fn(v) for v in batch)


def _host(v):
    """A host array as a pinned tensor (copied into one unless it is one)."""
    if torch.is_tensor(v) and v.is_pinned():
        return v
    v = np.asarray(v)
    t, view = pinned(v.shape, v.dtype)
    view[...] = v
    return t


def _stage(batch, device, stream):
    """Start the copies of a batch's arrays to ``device`` on ``stream``:
    (the batch on the device, the copies' event). A list of arrays is
    stacked on the device along a new first axis, each row copied into its
    place; other values pass unchanged."""

    def one(v):
        if isinstance(v, list):
            rows = [_host(x) for x in v]
            dst = torch.empty((len(rows), *rows[0].shape), dtype=rows[0].dtype, device=device)
            for b, src in enumerate(rows):
                dst[b].copy_(src, non_blocking=True)
            return dst
        return _host(v).to(device, non_blocking=True) if _is_array(v) else v

    with record_function("loader.stage"), torch.cuda.stream(stream):
        out = _map(one, batch)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _on_cpu(v):
    if isinstance(v, list):
        return torch.stack([torch.as_tensor(x) for x in v])
    return torch.as_tensor(v) if _is_array(v) else v


def device_prefetch(iterator, device, size=2):
    """Batches (dicts or tuples of host arrays) from ``iterator`` as the same
    containers of tensors on ``device``, each staged ``size`` batches before
    the consumer takes it (module docstring). A list of arrays becomes one
    tensor stacked along a new first axis; other values pass unchanged.

    On a CUDA device the copies come from pinned memory: a pinned tensor
    (``Loader(pin_memory=True)``, ``pinned``) is copied as it is, any other
    array is first copied into a pinned tensor on the caller's thread. On
    the CPU the arrays are wrapped without a copy."""
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield _map(_on_cpu, batch)
        return
    side = torch.cuda.Stream(device=device)
    buf = collections.deque()
    for batch in it:
        buf.append(_stage(batch, device, side))
        if len(buf) == size:
            break
    while buf:
        out, event = buf.popleft()
        for batch in it:
            buf.append(_stage(batch, device, side))
            break
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for v in (out.values() if isinstance(out, dict) else out):
            if torch.is_tensor(v):
                v.record_stream(compute)
        yield out
