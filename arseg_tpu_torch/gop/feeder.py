"""Serving-side GOP feeder: host decode and the copies to and from the card
overlap the card's compute — port of ``arseg_tpu/gop/feeder.py``
(``GOPFeeder``, ``AsyncWriter``) with staging of the port's own.

Four stages:

  worker threads   PNG decode + merged-MV ``.bin`` read + flow-plane split,
                   each GOP written straight into pinned host tensors (on a
                   CUDA device with stage=True; numpy arrays otherwise); a
                   sequential source (``VideoGOPSource.iter_gops``) writes
                   its GOPs into buffers from the same allocator
  consumer thread  ``data/loader.device_prefetch``, the port's one staging
                   helper: the H2D copies, ``non_blocking`` on a side CUDA
                   stream, ``depth`` GOPs ahead of the one being served,
                   the consumer's stream waiting on their event and the
                   tensors ``record_stream``'d onto it; a ``gop_batch``
                   stack is put together on the card, each GOP's pinned
                   tensors copied into its rows
  main thread      the GOP step on the compute stream (the consumer's
                   current stream)
  writer thread    ``AsyncWriter``: the maps are cast to uint8 on the card
                   and copied into pinned host memory on a second side
                   stream; the thread waits on that copy's event, then
                   encodes the PNGs

Threads suffice for host overlap: PIL/cv2/zlib decode, ``np.fromfile`` and
CUDA event waits release the GIL (same argument as ``data/loader.py``).
"""

import functools
import os
import queue
import threading

import numpy as np
import torch

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.data.loader import device_prefetch, pinned


def _empty(shape, dtype, pin=False):
    """(owner, numpy view to fill): a pinned torch tensor or a numpy array."""
    if pin:
        return pinned(shape, dtype)
    a = np.empty(shape, dtype)
    return a, a


def _assemble(dataset, start, g, pin=False):
    """Host-side GOP assembly: one keyframe [1, H, W, 3] + g-1 frames + the
    flow planes fx, fy [g-1, Hf, Wf], the layout ``ARPipeline`` consumes;
    written into pinned torch tensors with pin=True, else numpy arrays."""
    samples = [dataset[start + k] for k in range(g)]
    img, flow = samples[0]["image"], samples[1]["flow"]
    kf, kf_np = _empty((1, *img.shape), img.dtype, pin)
    fr, fr_np = _empty((g - 1, *img.shape), img.dtype, pin)
    fx, fx_np = _empty((g - 1, *flow.shape[:-1]), np.float32, pin)
    fy, fy_np = _empty((g - 1, *flow.shape[:-1]), np.float32, pin)
    kf_np[0] = img
    for k, s in enumerate(samples[1:]):
        fr_np[k] = s["image"]
        fx_np[k] = s["flow"][..., 0]
        fy_np[k] = s["flow"][..., 1]
    return kf, fr, fx, fy


class GOPFeeder:
    """Iterate a sequence dataset GOP-at-a-time with background host
    assembly and staging on the card.

    Yields (gop_index, keyframe, frames, (fx, fy)): CUDA tensors, their
    copies already ordered before the consumer's stream (stage=True on a
    CUDA device), or host numpy arrays (stage=False, or the CPU). Order is
    strict; worker exceptions re-raise in the consumer. Host look-ahead is
    bounded by ``depth + num_workers`` GOPs, staged GOPs by ``depth``
    items.

    gop_batch=B stacks B consecutive GOPs into the multi-GOP throughput
    layout (keyframes [B,H,W,3], frames [B,G-1,H,W,3] —
    ``ARPipeline.multi_gop_step``). The tail (n_gops % B) is emitted as
    single GOPs.

    A dataset with ``iter_gops()`` (``VideoGOPSource``) is read
    sequentially on one producer thread instead of by random access."""

    def __init__(self, dataset, ref_gap, num_workers=2, depth=2, stage=True,
                 gop_batch=1, device=None):
        self.dataset = dataset
        self.g = int(ref_gap)
        self.num_workers = max(1, num_workers)
        self.depth = max(1, depth)
        self.gop_batch = max(1, int(gop_batch))
        self.device = resolve_device(device) if stage else None
        self.stage = stage and self.device.type == "cuda"

    def __len__(self):
        return len(self.dataset) // self.g

    def _host_iter(self):
        # sequential sources (VideoGOPSource: direct compressed-stream
        # decode) produce whole GOP items in order; one producer thread
        # gives the same host/device overlap as the random-access workers
        if hasattr(self.dataset, "iter_gops"):
            yield from self._seq_host_iter()
            return
        n_gops = len(self)
        results = {}
        lock = threading.Condition()
        stop = threading.Event()
        emitted = [0]

        def worker(wid):
            for gi in range(wid, n_gops, self.num_workers):
                if stop.is_set():
                    return
                with lock:
                    # bound assembly look-ahead (in single-GOP units) so host
                    # memory stays O(depth + workers) GOPs
                    while gi - emitted[0] > self.depth + self.num_workers and not stop.is_set():
                        lock.wait()
                if stop.is_set():
                    return
                try:
                    item = _assemble(self.dataset, gi * self.g, self.g, self.stage)
                except Exception as e:  # surface in consumer
                    item = e
                with lock:
                    results[gi] = item
                    lock.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for gi in range(n_gops):
                with lock:
                    while gi not in results:
                        lock.wait()
                    item = results.pop(gi)
                    emitted[0] = gi
                    lock.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield gi, item
        finally:
            stop.set()
            with lock:
                lock.notify_all()

    def _seq_host_iter(self):
        """Drive a sequential source's iter_gops() on one producer thread,
        `depth + num_workers` GOP items of look-ahead (matching the
        random-access path's host memory bound). Abandoning the iteration
        early (e.g. zip over streams of unequal length) stops the producer
        and closes the source generator, releasing its decode threads. The
        source writes each GOP into buffers from ``_empty`` (pinned when
        staging)."""
        q = queue.Queue(maxsize=self.depth + self.num_workers)
        done = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                it = self.dataset.iter_gops(alloc=functools.partial(_empty, pin=self.stage))
                try:
                    for item in it:
                        if not put(item):
                            return
                finally:
                    # closing the generator runs its finally (stops
                    # VideoGOPSource's decode threads)
                    if hasattr(it, "close"):
                        it.close()
                put(done)
            except Exception as e:  # surface in consumer
                put(e)

        threading.Thread(target=producer, daemon=True).start()
        gi = 0
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield gi, item
                gi += 1
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def _grouped(self):
        """(first GOP index, list of host items): gop_batch consecutive
        GOPs, then the ragged tail (including all of an unknown-length
        sequential source's leftovers) one GOP a list."""
        pending = []
        for gi, item in self._host_iter():
            pending.append((gi, item))
            if len(pending) == self.gop_batch:
                yield pending[0][0], [it for _, it in pending]
                pending = []
        for gi, item in pending:
            yield gi, [item]

    def __iter__(self):
        groups = self._grouped()
        if not self.stage:
            for gi, items in groups:
                if len(items) == 1:
                    kf, fr, fx, fy = items[0]
                else:
                    kf = np.stack([it[0][0] for it in items])
                    fr, fx, fy = (np.stack([it[f] for it in items]) for f in (1, 2, 3))
                yield gi, kf, fr, (fx, fy)
            return
        # a stack goes to device_prefetch as lists of rows (the keyframes'
        # [1, H, W, 3] as [H, W, 3]), which it copies into [B, ...] tensors
        host = ((gi, *items[0]) if len(items) == 1 else
                (gi, [it[0][0] for it in items], *([it[f] for it in items] for f in (1, 2, 3)))
                for gi, items in groups)
        for gi, kf, fr, fx, fy in device_prefetch(host, self.device, size=self.depth):
            yield gi, kf, fr, (fx, fy)


class _D2H:
    """Maps copied into pinned host memory; ``event`` marks the copy's end."""

    def __init__(self, host, event):
        self.host = host
        self.event = event


class AsyncWriter:
    """Background D2H + PNG writer: `put(preds, names)` enqueues class maps
    [n, H, W] (a CUDA or CPU tensor, or numpy); a writer thread encodes
    them as PNGs named `names`. For a CUDA tensor, ``put`` casts the maps
    to uint8 on the card and starts their copy into pinned memory on a
    side stream after the work queued so far; the thread waits on the
    copy's event, so the caller never waits for the card here. Bounded
    queue (depth) so at most `depth` GOPs of outputs are in flight."""

    def __init__(self, out_dir, colorize=False, depth=2):
        self.out_dir = out_dir
        self.colorize = colorize
        self._q = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._stream = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from PIL import Image

        from arseg_tpu_torch.tools.labels import index_to_rgb

        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # drain mode: keep consuming so put()/close() never block
            try:
                preds, names = item
                if isinstance(preds, _D2H):
                    preds.event.synchronize()
                    preds = preds.host.numpy()
                preds = np.asarray(preds).astype(np.uint8)
                for k, name in enumerate(names):
                    out = preds[k]
                    if self.colorize:
                        out = index_to_rgb(out)
                    Image.fromarray(out).save(os.path.join(self.out_dir, name + ".png"))
            except Exception as e:
                # record and DRAIN rather than exit: with the bounded queue a
                # producer blocked in put() would otherwise deadlock — the
                # error surfaces on the next put() or at close()
                self._err = e

    def _to_host(self, preds):
        compute = torch.cuda.current_stream(preds.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=preds.device)
        maps = preds.to(torch.uint8)
        host = torch.empty(maps.shape, dtype=torch.uint8, pin_memory=True)
        self._stream.wait_stream(compute)
        with torch.cuda.stream(self._stream):
            host.copy_(maps, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        maps.record_stream(self._stream)
        return _D2H(host, event)

    def put(self, preds, names):
        if self._err is not None:
            raise self._err
        if torch.is_tensor(preds) and preds.is_cuda:
            preds = self._to_host(preds)
        self._q.put((preds, list(names)))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
