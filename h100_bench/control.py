"""Readings that set a cell's limits, on the card at the cell's own size:
the control (the reference in float8, the precision below the
configuration's bfloat16, in the program's place), a witness (the
reference in the configuration's own bfloat16, emulated) and, for a
training cell, the planted fault "half of the batch left out" and a second
witness (the program itself in float32, TF32 off).

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 [--witness]

Prints one JSON line per seed and reading. The benchmark's own runs never
run it; the sound runs' readings come from ``run.py``'s own lines.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def context(workload, seed, device, seconds=None, overrides=None):
    import torch

    from harness import manifest
    from harness.runctx import Ctx

    cell = manifest.workload(workload)
    cfg = {**manifest.config(cell["config"]), **(overrides or {}).get("config", {})}
    tr = {**manifest.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    man = manifest.manifest()
    return Ctx(workload=cell, cfg=cfg, traffic=tr, limits=manifest.limits(workload), seed=seed,
               seconds=seconds if seconds is not None else float(man["run_seconds"]),
               trace=False, device=torch.device(device), t_start=time.perf_counter())


def readings(workload, seed, device, witness=False, overrides=None, seconds=None):
    """{reading name: the check's numbers} for one seed."""
    import torch

    from harness import checks, manifest
    from harness.runctx import free, no_tf32

    ctx = context(workload, seed, device, seconds, overrides)
    kind = ctx.traffic["driver"]
    drv = manifest.driver(kind)
    if kind != "train":
        return {"control_fp8": drv.control_readings(ctx),
                "reference_bfloat16": drv.control_readings(ctx, torch.bfloat16)}
    sd_t, sd_s = drv.weights(ctx)
    pool = drv.batches(ctx)[:ctx.traffic["check_steps"]]
    ref = drv.reference_steps(ctx, sd_t, sd_s, pool)
    out = {}
    for name, kw in (("control_fp8", {"lowp": torch.float8_e4m3fn}),
                     ("reference_bfloat16", {"lowp": torch.bfloat16}),
                     ("fault_half_batch", {"half_batch": True})):
        out[name] = checks.train_readings(drv.reference_steps(ctx, sd_t, sd_s, pool, **kw), ref)[0]
        free(ctx.device)
    if witness:
        import run

        no_tf32()
        over = {"config": {**(overrides or {}).get("config", {}), "dtype": "float32"},
                "traffic": (overrides or {}).get("traffic", {})}
        _, info = run.execute(workload, seed, 1.0, 0, device, over)
        out["program_float32"] = info["readings"]
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(BENCH.parent))
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, "cuda", args.witness)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
