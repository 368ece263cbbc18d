"""Where the time of one camvid-bise18 AR GOP goes on the card (PyTorch/CUDA
port): the configuration of chip_smoke.py's pipeline phase (720x960, GOP 12,
LR 0.5x, bf16, full width, seeded random weights, uint8 frames).

    python3 tools_torch_profile_gop.py

Prints the wall time per GOP (host clock around synchronised work, no
profiler), the device's kernel time per GOP and its idle share against that
wall time, the kernel time and host time of each pipeline stage (the
``gop.*`` record_function spans of arseg_tpu_torch/gop/pipeline.py) and the
kernels by device time, from torch.profiler over a steady window after two
warm-up GOPs. The host clock varies from clip to clip (the host's cores are
shared), so the wall time is the median of several clips. K2 is launched
through its binding, outside any PyTorch op, so its time shows on its kernel
line and not under the ``gop.warp`` span. Writes the chrome trace to
chiprun_out/torch_gop_trace.json.
"""

import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

WALL_REPEATS = 5


def main():
    gops = cs.CLIP_GOPS
    if not torch.cuda.is_available():
        raise SystemExit("tools_torch_profile_gop: no CUDA device")
    from arseg_tpu_torch.gop import ARPipeline

    cs.device_phase()
    cs.build_phase()
    pipe = ARPipeline(*cs.make_models(), scale=cs.SCALE, dtype=torch.bfloat16,
                      normalize=(cs.CAMVID_MEAN, cs.CAMVID_STD), device="cuda")
    kfs, frs, fxs, fys = (x.cuda() for x in cs.make_clip(gops))
    for _ in range(2):
        pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
    torch.cuda.synchronize()

    walls = []
    for _ in range(WALL_REPEATS):
        t0 = time.perf_counter()
        pipe.scan_step(kfs, frs, fxs, fys)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / gops)
    wall = float(np.median(walls))
    print(f"wall {wall:.3f} ms/GOP median of {WALL_REPEATS} clips (no profiler), "
          f"{cs.GOP * 1e3 / wall:.1f} frames/s; all: {[round(x, 3) for x in walls]}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.scan_step(kfs, frs, fxs, fys)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3 / gops
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # kernels only: the gop.* spans also appear as device-side annotations
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == cuda and not e.key.startswith("gop.")) / 1e3 / gops
    print(f"profiled wall {wall_prof:.3f} ms/GOP; device kernels {busy:.3f} ms/GOP; "
          f"idle share against the unprofiled median wall {1 - busy / wall:.3f}", flush=True)
    for e in events:
        if e.device_type == cuda and ("creff_qkv_fused_kernel" in e.key
                                      or "warp_bilinear_kernel" in e.key):
            print(f"  kernel {e.key[:60]}: {e.self_device_time_total / 1e3 / gops:.3f} "
                  f"ms/GOP, {e.count // gops} launch(es)/GOP", flush=True)
    print("stage: device kernel ms/GOP, host ms/GOP (profiled):", flush=True)
    for e in sorted((e for e in events if e.device_type == cpu and e.key.startswith("gop.")),
                    key=lambda e: -e.device_time_total):
        print(f"  {e.key:18s} {e.device_time_total / 1e3 / gops:8.3f} "
              f"{e.cpu_time_total / 1e3 / gops:8.3f}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=25), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/torch_gop_trace.json")


if __name__ == "__main__":
    main()
