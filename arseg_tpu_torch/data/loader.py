"""Host-side batching and prefetching loader (the DataLoader's place) — a
copy of ``arseg_tpu/data/loader.py``'s ``Loader``, and ``device_prefetch``,
the device stage of the training loop.

The loader overlaps PIL/cv2 decode with device compute through a thread
pool and a bounded prefetch queue, and yields batches of numpy arrays in a
fixed order for a seed. Threads (not processes) suffice because decode is
PIL/cv2/numpy-bound and releases the GIL. ``device_prefetch`` copies each
batch to the device from pinned host memory with ``non_blocking=True``,
two batches ahead of the consumer, so the copies overlap the steps before
them.

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

from arseg_tpu_torch.data.transform import SampleRng


def _stack(samples):
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples])
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
                    batch = _stack([read(place, i) for place, i in batches[bi]])
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


def device_prefetch(iterator, device, size=2):
    """Batches (dicts of arrays) from ``iterator`` as dicts of tensors on
    ``device``, each copy started ``size`` batches before the consumer
    takes it. On a CUDA device each array is copied into pinned memory and
    from there with ``non_blocking=True`` (PyTorch's pinned-memory pool
    keeps the host buffer until its copy has run); on the CPU the arrays are
    wrapped without a copy."""
    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) == size:
            break
    while buf:
        out = buf.popleft()
        for batch in it:
            buf.append(put(batch))
            break
        yield out
