"""Offline labelling of an archive, B GOPs a step: the program's
``GOPFeeder`` (worker threads assembling GOPs into pinned memory, staging on
a side stream) over an in-memory sequence, ``ARPipeline.multi_gop_step``,
and each step's class maps copied back into pinned host memory as uint8.

Traffic parameters: ``gop_batch``, ``io_workers`` and ``depth`` (the
command's ``--io_workers``, and its staging depth for ``--gop_batch`` > 1);
``pool_steps`` (the pool's steps of distinct GOPs, cycled through);
``warmup_steps``; the sample that the check reads (``check_first_steps``,
``check_steps``, ``check_gops``, ``check_frames``, plus the last step);
``trace_from_step`` and ``trace_steps``.

The sequence has the item layout of the program's ``CamVidWithFlowTest``
(``image``, ``ref_image``, ``flow`` [H, W, 2] in pixels, constant over
each 8x8 block), with uint8 images, which the pipeline normalises on the
card."""

import numpy as np
import torch

from harness import checks, models, seeded
from harness.runctx import Outcome, free, memory_peak, no_tf32
from harness.trace import Capture, span


class PoolSequence:
    """A sequence of ``length`` frames whose GOP i is the pool's GOP
    i % pool_gops."""

    def __init__(self, frames, flows, gop, length):
        self.frames, self.flows, self.g, self.length = frames, flows, gop, length
        self.pool_gops = frames.shape[0] // gop

    def __len__(self):
        return self.length

    def locate(self, index):
        """(pool GOP, position in the GOP) of frame ``index``."""
        return (index // self.g) % self.pool_gops, index % self.g

    def __getitem__(self, index):
        j, p = self.locate(index)
        item = {"image": self.frames[j * self.g + p], "ref_image": self.frames[j * self.g],
                "label": np.int32(0), "existence": np.float32(0)}
        if p:
            item["flow"] = self.flows[j * (self.g - 1) + p - 1]
        return item


class MapsToHost:
    """Each step's maps cast to uint8 on the card and copied into pinned
    host memory on a side stream; ``slots`` steps in flight. ``done(step,
    host)`` is called once a step's maps are on the host."""

    def __init__(self, device, slots, done):
        self.device, self.done = device, done
        self.pending = []
        self.slots = slots
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, step, maps):
        if self.stream is None:
            self.done(step, maps.to(torch.uint8).numpy())
            return
        while len(self.pending) >= self.slots:
            self._finish(self.pending.pop(0))
        u8 = maps.to(torch.uint8)
        host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(u8, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        u8.record_stream(self.stream)
        self.pending.append((step, host, ev))

    def _finish(self, item):
        step, host, ev = item
        ev.synchronize()
        self.done(step, host.numpy())

    def drain(self):
        while self.pending:
            self._finish(self.pending.pop(0))


def pool(ctx):
    """The sequence over ``pool_steps`` steps of distinct GOPs, from the seed."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    g, n = cfg["gop"], tr["pool_steps"] * tr["gop_batch"]
    hw = tuple(cfg["frame_hw"])
    frames = seeded.frames(ctx.seed, "frames", n * g, hw, dev).cpu().numpy()
    flows = seeded.block_flows(ctx.seed, "flows", n * (g - 1), hw, dev).cpu().numpy()
    return PoolSequence(frames, flows, g, length=10 ** 9 // g * g)


def plan(ctx, b, g):
    """Which steps, GOPs and GOP positions the check reads (from the seed):
    ``check_steps`` of the window's first ``check_first_steps`` and the
    last; in each, every GOP at the keyframe and the last position (the
    longest warp), and ``check_gops`` of them at ``check_frames`` - 2 other
    positions too."""
    tr, rng = ctx.traffic, ctx.rng("check")
    steps = sorted(rng.sample(range(tr["check_first_steps"]), tr["check_steps"]))

    def pick():
        mid = rng.sample(range(1, g - 1), max(0, min(tr["check_frames"] - 2, g - 2)))
        more = set(rng.sample(range(b), tr["check_gops"]))
        return {gi: sorted({0, g - 1, *(mid if gi in more else ())}) for gi in range(b)}

    return {s: pick() for s in steps}, pick()


def run(ctx):
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.gop.feeder import GOPFeeder

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    g, b = cfg["gop"], tr["gop_batch"]
    norm = (cfg["normalize"]["mean"], cfg["normalize"]["std"])
    sd_hr = models.weights(cfg, ctx.seed, "hr", False, dev)
    sd_ar = models.weights(cfg, ctx.seed, "ar", True, dev)
    ctx.mark("weights")
    hr = models.loaded(models.port_model(cfg, False, dev), sd_hr)
    ar = models.loaded(models.port_model(cfg, True, dev), sd_ar)
    ctx.mark("port_models")
    pipe = ARPipeline(hr, ar, scale=cfg["lr_scale"], dtype=getattr(torch, cfg["dtype"]),
                      normalize=norm, device=dev)
    del hr, ar
    ctx.mark("models")
    seq = pool(ctx)
    ctx.mark("pool")
    feeder = GOPFeeder(seq, g, num_workers=tr["io_workers"], depth=tr["depth"], stage=True,
                       gop_batch=b, device=dev)
    checked, last_plan = plan(ctx, b, g)
    kept = []  # (gop index, position, served map)
    state = {"last": None}

    def done(step, host):
        want = checked.get(step) if step is not None else None
        if step is not None:
            state["last"] = (step, host)
        for gi, positions in (want or {}).items():
            for p in positions:
                kept.append((step_gop[step] + gi, p, host[gi, p].copy()))

    step_gop = {}
    d2h = MapsToHost(dev, tr.get("d2h_slots", 2), done)
    it = iter(feeder)
    feed_s = []

    def one(step):
        t = ctx.now()
        with span("bench.feed"):
            gi, kf, fr, fl = next(it)
        feed_s.append(ctx.now() - t)
        if step is not None:
            step_gop[step] = gi
        with span("bench.step"):
            preds = pipe.multi_gop_step(kf, fr, fl)
        with span("bench.d2h"):
            d2h.put(step, preds)

    for i in range(tr["warmup_steps"]):
        one(None)
        d2h.drain()
        ctx.sync()
        ctx.mark(f"warm{i}")
    feed_s.clear()
    cap = Capture(dev) if ctx.trace else None
    if cap is not None:
        cap.warm()
    setup_s = ctx.now() - ctx.t_start
    t0 = ctx.now()
    steps = traced = 0
    while ctx.now() - t0 < ctx.seconds:
        if cap is not None and steps == tr["trace_from_step"]:
            cap.start()
        one(steps)
        steps += 1
        traced += cap is not None and cap.active
        if cap is not None and steps == tr["trace_from_step"] + tr["trace_steps"]:
            cap.stop()
    d2h.drain()
    ctx.sync()
    window = ctx.now() - t0
    if cap is not None:
        cap.stop()
    del it, feeder
    frames_done = steps * b * g
    peak = memory_peak(dev)
    last_step, last_host = state["last"]
    for gi, positions in last_plan.items():
        for p in positions:
            if last_step not in checked or gi not in checked[last_step]:
                kept.append((step_gop[last_step] + gi, p, last_host[gi, p].copy()))
    del pipe, state, last_host
    free(dev)
    readings = reference_readings(ctx, seq, kept, sd_hr, sd_ar)
    return Outcome(
        e2e={"frames_per_s": frames_done / window, "setup_s": setup_s},
        attempted=frames_done, failed=0, memory_peak_bytes=peak, readings=readings,
        info={"steps": steps, "window_s": window, "frames": frames_done,
              "checked_frames": len(kept)},
        host={"feed_wait_s": feed_s, "steps": steps, "traced_steps": traced,
              "window_s": window, "gops_per_step": b,
              "frames_per_s": frames_done / window},
        trace=cap.trace if cap is not None else None)


def reference_readings(ctx, seq, kept, sd_hr, sd_ar, control=False, lowp=None):
    """The check's numbers over the kept maps (``control``: the fp8
    reference's own maps take the program's place)."""
    from reference.model import lowp_mode
    from reference.serve import gop_logits

    cfg, dev = ctx.cfg, ctx.device
    no_tf32()
    hr = models.loaded(models.reference_model(cfg, False, dev), sd_hr).eval()
    ar = models.loaded(models.reference_model(cfg, True, dev), sd_ar).eval()
    stats = checks.GapStats()
    by_gop = {}
    for gi, p, served in kept:
        by_gop.setdefault(gi, []).append((p, served))
    g = cfg["gop"]
    for gi, items in sorted(by_gop.items()):
        j = gi % seq.pool_gops
        key = torch.as_tensor(seq.frames[j * g][None], device=dev)
        fr = {p: torch.as_tensor(seq.frames[j * g + p][None], device=dev) for p, _ in items if p}
        fl = {p: tuple(torch.as_tensor(seq.flows[j * (g - 1) + p - 1][None, ..., k], device=dev)
                       for k in (0, 1)) for p, _ in items if p}
        positions = [p for p, _ in items]
        ref = dict(gop_logits(hr, ar, key, fr, fl, positions, cfg))
        if control:
            with lowp_mode(lowp or torch.float8_e4m3fn):
                low = dict(gop_logits(hr, ar, key, fr, fl, positions, cfg))
        for p, served in items:
            s = low[p].argmax(0) if control else torch.as_tensor(served)
            stats.add(ref[p], s)
    return stats.readings()


def control_readings(ctx, lowp=None):
    """The check's numbers with the reference in a lower precision (float8
    unless ``lowp``) in the program's place,
    over the GOPs and positions that a run of this seed samples."""
    b, g = ctx.traffic["gop_batch"], ctx.cfg["gop"]
    checked, last_plan = plan(ctx, b, g)
    checked[ctx.traffic["check_first_steps"]] = last_plan
    kept = [(step * b + gi, p, None) for step, gops in checked.items()
            for gi, positions in gops.items() for p in positions]
    cfg, dev = ctx.cfg, ctx.device
    return reference_readings(ctx, pool(ctx), kept, models.weights(cfg, ctx.seed, "hr", False, dev),
                              models.weights(cfg, ctx.seed, "ar", True, dev), control=True,
                              lowp=lowp)
