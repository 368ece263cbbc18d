"""What the loop's thread did while the card idled, from one traced run of
a cell: a diagnostic beside ``run.py``, which the benchmark's own runs
never run.

    python3 h100_bench/idle_host.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

It runs the cell as ``run.py --trace 1`` does and keeps the profiler's raw
events. Each device-idle gap of the traced window is cut by the loop
thread's innermost open span, as ``Trace.breakdown`` charges it. Inside
each piece, the loop thread's outermost operations (events that are not
spans) are summed by name; what none of them covers is "no op": Python
between calls, or a wait for the interpreter lock. The same is read
inside each of the spans in ``INSIDE``, idle or not. All in ms a traced
step: a line a span on standard output, and the whole as JSON to
``--out``.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
# the spans read inside, idle or not: the benchmark's and the program's
INSIDE = ("bench.feed", "feeder.wait", "loader.stage", "bench.step", "bench.d2h", "gop.hr_key",
          "train.step")


def traced_run(workload, seed, seconds, device, overrides=None):
    """One traced run of the cell: (its per-layer metrics, its ``Trace``,
    the profiler's raw events, its traced steps)."""
    import torch

    import run
    from harness import manifest, trace
    from harness.runctx import Ctx

    man = manifest.manifest()
    cell = manifest.workload(workload, man)
    cfg = {**manifest.config(cell["config"]), **(overrides or {}).get("config", {})}
    tr = {**manifest.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    ctx = Ctx(workload=cell, cfg=cfg, traffic=tr, limits=manifest.limits(workload), seed=seed,
              seconds=seconds, trace=True, device=torch.device(device),
              t_start=time.perf_counter())
    raw = []
    init = trace.Trace.__init__

    def keep(self, events):
        raw[:] = list(events)
        init(self, raw)

    trace.Trace.__init__ = keep
    try:
        out = manifest.driver(tr["driver"]).run(ctx)
        metrics = {k: v["value"] for k, v in run.per_layer(man, cell, ctx, out).items()}
    finally:
        trace.Trace.__init__ = init
    return metrics, out.trace, raw, out.host["traced_steps"]


def report(t, raw, steps):
    """{"idle_in": {span: reading}, "inside": {span: reading}}; a reading
    is the ms a step of the pieces, of no op in them, and the loop's
    outermost operations in them by name, largest first."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in raw
                 if e.device_type() == cpu and not e.is_user_annotation()
                 and e.start_thread_id() == t.loop_tid
                 and e.start_ns() < t.t1 and e.start_ns() + e.duration_ns() > t.t0)

    def reading(pieces):
        by, total = collections.Counter(), 0
        for lo, hi in pieces:
            total += hi - lo
            end = -1
            for s, e, name in ops:
                if e <= lo or s >= hi or s < end:  # outside, or inside one counted
                    continue
                by[name[:80]] += min(e, hi) - max(s, lo)
                end = e
        ms = 1e-6 / steps
        return {"ms_per_step": total * ms, "no_op_ms_per_step": (total - sum(by.values())) * ms,
                "ops": [[k, v * ms] for k, v in by.most_common()]}

    gaps, prev = [], t.t0
    for s, e in t.busy_intervals() + [[t.t1, t.t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = collections.defaultdict(list)
    for g0, g1 in gaps:
        for s, e, name in t._host_segments():
            if min(e, g1) > max(s, g0):
                idle[name].append((max(s, g0), min(e, g1)))
    inside = {n: [(s, e) for s, e, tid, _ in t.spans.get(n, ())
                  if tid == t.loop_tid and t.t0 <= s < t.t1] for n in INSIDE}
    return {"idle_in": {n: reading(v) for n, v in idle.items()},
            "inside": {n: reading(v) for n, v in inside.items() if v}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", help="the whole report as JSON")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(BENCH.parent))
    import run

    run.cache_env()
    metrics, t, raw, steps = traced_run(args.workload, args.seed, args.seconds, "cuda")
    res = {"cell": args.workload, "seed": args.seed, "card": run.power_limit(),
           "traced_steps": steps, "metrics": metrics,
           "window_ms_per_step": (t.t1 - t.t0) * 1e-6 / steps,
           "busy_ms_per_step": t.busy_s * 1e3 / steps, **report(t, raw, steps)}
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: res[k] for k in ("cell", "seed", "card", "traced_steps", "metrics",
                                          "window_ms_per_step", "busy_ms_per_step")}))
    for kind in ("idle_in", "inside"):
        for name, r in res[kind].items():
            print(f"{kind} {name}: {r['ms_per_step']:.3f} ms/step, no op "
                  f"{r['no_op_ms_per_step']:.3f}; " + "; ".join(
                      f"{k} {v:.3f}" for k, v in r["ops"][:6]), flush=True)


if __name__ == "__main__":
    main()
