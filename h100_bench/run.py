"""Run one benchmark cell once on the card and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` profiles a steady stretch of the window and reports
its per-layer metrics, ``busy_s``, ``window_s`` and a ``breakdown``. Every
run checks what its timed path produced against the plain float32
reference (``reference/``) and prints each compared number beside its
limit, last on standard error and last in the result line. The last line
of standard output is the result. No card, fewer cards than the cell asks
for, or JAX or the JAX package loaded: a message on standard error, no
result, and a non-zero exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "arseg_tpu")


def cache_env():
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg):
    print(f"run.py: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def execute(workload, seed, seconds, trace, device, overrides=None, t_start=None):
    """Run one cell: (result dict, checks). ``overrides`` ({"config":
    {...}, "traffic": {...}}) changes sizes for the tests on the CPU."""
    import torch

    from harness import checks, manifest
    from harness.runctx import Ctx

    man = manifest.manifest(ROOT)
    cell = manifest.workload(workload, man)
    cfg = {**manifest.config(cell["config"]), **(overrides or {}).get("config", {})}
    tr = {**manifest.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    ctx = Ctx(workload=cell, cfg=cfg, traffic=tr, limits=manifest.limits(workload), seed=seed,
              seconds=seconds, trace=bool(trace), device=torch.device(device),
              t_start=T_START if t_start is None else t_start)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.mark("cuda_ready")
    out = manifest.driver(tr["driver"]).run(ctx)
    correct, compared = checks.judge(out.readings, ctx.limits)
    correct = correct and out.failed == 0
    if trace:
        metrics = per_layer(man, cell, ctx, out)
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_of(workload, man, "end_to_end")}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    info = {"info": out.info, "readings": out.readings, "end_to_end": out.e2e,
            "setup_marks_s": ctx.marks}
    if trace and out.trace is not None:
        t = out.trace
        info["trace_device_ms"] = {n: 1e3 * t.span_device_s(n) for n in t.spans
                                   if n.startswith(("gop.", "bench.", "Optimizer"))}
        info["trace_device_ms"]["all"] = 1e3 * sum(e - s for s, e, _, _ in t.ops_in) * 1e-9
    result["checks"] = compared
    return result, info


def per_layer(man, cell, ctx, out):
    from harness import manifest

    run = PerLayerRun(ctx, out)
    metrics = {}
    for m in manifest.metrics_of(cell["name"], man, "per_layer"):
        v = manifest.reader(m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


class PerLayerRun:
    """What a per-layer reader reads: ``trace`` (``harness.trace.Trace``),
    ``host`` (the driver's host-clock data), ``cfg``, ``traffic``, ``e2e``."""

    def __init__(self, ctx, out):
        self.cfg, self.traffic, self.trace = ctx.cfg, ctx.traffic, out.trace
        self.host, self.e2e = out.host, out.e2e


def main(argv=None):
    args = parse(argv)
    cache_env()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness import manifest

    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{args.workload} needs {cell['chips']} cards, {torch.cuda.device_count()} present")
    smi = power_limit()
    result, info = execute(args.workload, args.seed, args.seconds, args.trace, "cuda")
    bad = forbidden_modules()
    if bad:
        fail(f"modules of {bad} are loaded: the benchmark runs the PyTorch port alone")
    print(json.dumps({"cell": args.workload, "seed": args.seed, "card": smi, **info}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def power_limit():
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


if __name__ == "__main__":
    main()
