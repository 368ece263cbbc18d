"""Where the time of one AR GOP goes on the card (PyTorch/CUDA port), in
chip_smoke.py's pipeline configuration (GOP 12, LR 0.5x, bf16, full width,
seeded random weights, uint8 frames; 720x960 for the camvid configs,
1024x2048 for the cityscapes ones):

    python3 tools_torch_profile_gop.py                                   # camvid-bise18
    python3 tools_torch_profile_gop.py --fused_upsample_head on          # its K5 head
    python3 tools_torch_profile_gop.py --attention_type localNoGroup     # a K4 fusion
    python3 tools_torch_profile_gop.py --backend camvid-psp18 --fuse_version 1
    python3 tools_torch_profile_gop.py --backend cityscapes-bise18       # or cityscapes-psp18
    python3 tools_torch_profile_gop.py --multi_gop 8                     # 8 GOPs a gop_step

Prints the wall time per GOP (host clock around synchronised work, no
profiler), the device's kernel time per GOP and its idle share against that
wall time, the kernel time and host time of each pipeline stage (the
``gop.*`` record_function spans of arseg_tpu_torch/gop/pipeline.py) and the
kernels by device time, from torch.profiler over a steady window after two
warm-up clips. A clip is 3 GOPs through scan_step, or with --multi_gop B, B
GOPs in one gop_step (the multi-GOP throughput mode); times are per GOP
either way. The host clock varies from clip to clip (the host's cores are
shared), so the wall time is the median of several clips. The port's
kernels are launched through their binding, outside any PyTorch op. K2,
K3 and K5 are launched straight from their span, and their time shows on
their kernel lines only, not under the ``gop.*`` span; K1 and K4 are
launched inside a ``torch.autograd.Function``, whose op the profiler
credits them to, so their time shows on their kernel lines and under
``gop.fuse_head`` as well. Writes the chrome trace to
chiprun_out/torch_gop_trace_<backend>[_<attention_type>][_k5head][_multi<B>].json.
"""

import argparse
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

WALL_REPEATS = 5
# K1, K3 and K5 are the kernel template module_kernel with the epilogues
# StoreFusedMma (K1), ArgmaxHeadMma (K3) and UpsampleArgmaxHeadMma (K5) in
# bf16 (creff_module_mma.cuh), StoreFused, ArgmaxHead and UpsampleArgmaxHead
# in float32 (creff_module.cuh); K4 is attention_mma_kernel in bf16 and
# attention_kernel in float32, K2 warp_bilinear_kernel
PORT_KERNELS = ("module_kernel", "attention_mma_kernel", "attention_kernel",
                "warp_bilinear_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="camvid-bise18",
                    choices=["camvid-bise18", "camvid-psp18", "cityscapes-bise18",
                             "cityscapes-psp18"])
    ap.add_argument("--fuse_version", type=int, default=1, choices=[1, 2],
                    help="camvid-psp18 only: 1 fuses at full resolution (K3 head), 2 at the "
                         "backbone feature")
    ap.add_argument("--attention_type", default="local",
                    help="the CReFF fusion variant (nn/attention.get_fusion); not camvid-psp18")
    ap.add_argument("--fused_upsample_head", choices=["on", "off"], default=None,
                    help="the BiSeNets only: set nn/bisenet.USE_FUSED_UPSAMPLE_HEAD (K5 head "
                         "for the local fusion); default: the module's setting")
    ap.add_argument("--multi_gop", type=int, default=0, metavar="B",
                    help="run B GOPs in one gop_step (5-D frames) instead of scan_step")
    args = ap.parse_args()
    gops = args.multi_gop or cs.CLIP_GOPS
    if not torch.cuda.is_available():
        raise SystemExit("tools_torch_profile_gop: no CUDA device")
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.nn import bisenet

    if args.fused_upsample_head is not None:
        bisenet.USE_FUSED_UPSAMPLE_HEAD = args.fused_upsample_head == "on"
    cs.device_phase()
    cs.build_phase()
    bise = args.backend.endswith("bise18")
    city = args.backend.startswith("cityscapes")
    tag = (f"{args.attention_type}, USE_FUSED_UPSAMPLE_HEAD={bisenet.USE_FUSED_UPSAMPLE_HEAD}"
           if bise else args.attention_type if city else f"V{args.fuse_version}")
    hw = cs.CITY_HW if city else (cs.H, cs.W)
    mode = f"{gops} GOPs in one gop_step" if args.multi_gop else f"scan_step over {gops} GOPs"
    print(f"{args.backend} {tag}, {hw[0]}x{hw[1]}, {mode}", flush=True)
    models = cs.make_models(args.backend, args.fuse_version, args.attention_type)
    norm = cs.CITY_NORM[args.backend] if city else (cs.CAMVID_MEAN, cs.CAMVID_STD)
    pipe = ARPipeline(*models, scale=cs.SCALE, dtype=torch.bfloat16, normalize=norm,
                      device="cuda")
    kfs, frs, fxs, fys = (x.cuda() for x in cs.make_clip(gops, hw=hw))
    if args.multi_gop:
        clip = lambda: pipe.gop_step(kfs, frs, (fxs, fys))
    else:
        clip = lambda: pipe.scan_step(kfs, frs, fxs, fys)
    for _ in range(2):
        clip()
    torch.cuda.synchronize()

    walls = []
    for _ in range(WALL_REPEATS):
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / gops)
    wall = float(np.median(walls))
    print(f"wall {wall:.3f} ms/GOP median of {WALL_REPEATS} clips (no profiler), "
          f"{cs.GOP * 1e3 / wall:.1f} frames/s; all: {[round(x, 3) for x in walls]}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clip()
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
        if e.device_type == cuda and any(k in e.key for k in PORT_KERNELS):
            print(f"  kernel {e.key[:110]}: {e.self_device_time_total / 1e3 / gops:.3f} "
                  f"ms/GOP, {e.count} launch(es) in the clip", flush=True)
    print("stage: device kernel ms/GOP, host ms/GOP (profiled):", flush=True)
    for e in sorted((e for e in events if e.device_type == cpu and e.key.startswith("gop.")),
                    key=lambda e: -e.device_time_total):
        print(f"  {e.key:18s} {e.device_time_total / 1e3 / gops:8.3f} "
              f"{e.cpu_time_total / 1e3 / gops:8.3f}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=25), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = args.backend
    if bise and args.attention_type != "local":
        name += f"_{args.attention_type}"
    if bise and bisenet.USE_FUSED_UPSAMPLE_HEAD:
        name += "_k5head"
    if args.multi_gop:
        name += f"_multi{gops}"
    prof.export_chrome_trace(f"chiprun_out/torch_gop_trace_{name}.json")


if __name__ == "__main__":
    main()
