"""On-card smoke test of the PyTorch/CUDA port (arseg_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit.
  2. build: builds the kernels of arseg_tpu_torch/csrc, prints the seconds.
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, in float32 and bfloat16, with the tolerance stated;
     kernel, plain and library times (CUDA events, median of 20 runs after
     warm-up).
  4. pipeline: camvid-bise18 AR serving at 720x960, GOP 12, LR 0.5x, bf16,
     full width, random seeded weights: scan_step over 3 GOPs of uint8
     frames, with the launch counts of every kernel read around that run;
     then one GOP on the CPU (plain versions, float32) against the card in
     float32.
  5. a JSON line of the kernels, and the last line {"ok": true, ...}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

GOP, H, W, SCALE, CLIP_GOPS = 12, 720, 960, 0.5, 3
FEAT_HW = (H // 8, W // 8)
C = 256
CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no tensor cores for f32
# max |kernel - plain| allowed, relative to max(1, max |plain|): float32 sums
# run in another order; bfloat16 outputs are rounded once, so two units in
# the last place of the largest output
TOL = {
    "creff_qkv_fused": {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6},
    "warp_bilinear": {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7},
}
# one GOP, the card in float32 against the CPU in float32: class maps flip
# only at near ties; the fused feature differs by the order of the sums
# through two BiSeNet forwards (observed ~3e-6 at max |fused| ~1.7)
AGREEMENT = 0.999
FUSED_TOL = 1e-3  # relative to max(1, max |fused|)
TIMED_RUNS = 20


def phase(name):
    print(f"== {name}", flush=True)


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi


def build_phase():
    from arseg_tpu_torch.ops import _build

    phase("build")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"built kernels ({_build.BUILD_INFO['route']} route) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def check(name, dtype, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = TOL[name][dtype] * scale
    ok = err <= tol and bool(torch.isfinite(got.float()).all())
    print(f"{name} {str(dtype):14s} max|d|={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version in {dtype}")
    return err


def kernel_phase():
    from arseg_tpu_torch.gop.pipeline import _resize_flow_planes
    from arseg_tpu_torch.ops import creff_kernel, warp_kernel

    phase("kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = GOP - 1
    stats = {}
    for dt in (torch.float32, torch.bfloat16):
        # K1 at [11, 90, 120, 256]
        lr_up = torch.randn(n, *FEAT_HW, C, device="cuda", generator=gen).to(dt)
        ref = torch.randn(n, *FEAT_HW, C, device="cuda", generator=gen).to(dt)
        convs = [t for _ in range(3) for t in (
            torch.randn(C, 1, 3, 3, device="cuda", generator=gen) / 3.0,
            torch.randn(C, device="cuda", generator=gen) * 0.1)]
        taps, bias = creff_kernel.pack_qkv(*convs)
        k1 = lambda: creff_kernel.creff_qkv_fused(lr_up, ref, taps, bias, 7, 7)
        p1 = lambda: creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, 7, 7)
        err1 = check("creff_qkv_fused", dt, k1(), p1())
        bytes1 = 3 * lr_up.numel() * lr_up.element_size() + (taps.numel() + bias.numel()) * 4
        # per element: three 3x3 depthwise convs (54), 49-tap logits (98) and
        # weighting (98), the residual (1)
        flops1 = lr_up.numel() * 251
        stats[("creff_qkv_fused", dt)] = dict(
            max_abs_err=err1, ms=median_ms(k1), plain_ms=median_ms(p1), library_ms=None,
            bytes=bytes1, flops=flops1)

        # K2: one keyframe feature warped to 11 frames; flows drawn at 720x960
        src = torch.randn(1, *FEAT_HW, C, device="cuda", generator=gen).to(dt)
        fxf = torch.rand(n, H, W, device="cuda", generator=gen) * 32 - 16
        fyf = torch.rand(n, H, W, device="cuda", generator=gen) * 32 - 16
        fx, fy = _resize_flow_planes((fxf, fyf), FEAT_HW)
        k2 = lambda: warp_kernel.warp_bilinear(src, fx, fy)
        p2 = lambda: warp_kernel.warp_bilinear_plain(src, fx, fy)
        err2 = check("warp_bilinear", dt, k2(), p2())
        far = check("warp_bilinear", dt, warp_kernel.warp_bilinear(src, fx * 40, fy * 40),
                    warp_kernel.warp_bilinear_plain(src, fx * 40, fy * 40))
        print(f"warp_bilinear far out-of-image flows (x40) checked, max|d|={far:.3e}", flush=True)
        # library yardstick: F.grid_sample on the same sampling grid (NCHW)
        xs = torch.arange(FEAT_HW[1], device="cuda", dtype=torch.float32)
        ys = torch.arange(FEAT_HW[0], device="cuda", dtype=torch.float32)[:, None]
        grid = torch.stack([2.0 * (xs + fx) / (FEAT_HW[1] - 1) - 1.0,
                            2.0 * (ys + fy) / (FEAT_HW[0] - 1) - 1.0], dim=-1).to(dt)
        src_nchw = src.permute(0, 3, 1, 2).expand(n, -1, -1, -1)
        lib2 = lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=False)
        gs = (lib2().permute(0, 2, 3, 1).float() - k2().float()).abs().max().item()
        print(f"warp_bilinear vs F.grid_sample {dt}: max|d|={gs:.3e} (information)", flush=True)
        bytes2 = (src.numel() * src.element_size() + 2 * fx.numel() * 4
                  + n * FEAT_HW[0] * FEAT_HW[1] * C * src.element_size())
        stats[("warp_bilinear", dt)] = dict(
            max_abs_err=err2, ms=median_ms(k2), plain_ms=median_ms(p2),
            library_ms=median_ms(lib2), bytes=bytes2,
            flops=n * FEAT_HW[0] * FEAT_HW[1] * C * 7)
    for (name, dt), s in stats.items():
        t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = s["flops"] / PEAK_FLOPS[dt] * 1e3
        s["bound_ms"] = max(t_bytes, t_ops)
        s["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name} {str(dt):14s} ms={s['ms']:.4f} plain_ms={s['plain_ms']:.4f} "
              f"library_ms={s['library_ms']} bound_ms={s['bound_ms']:.4f} ({s['bound_by']})",
              flush=True)
    return stats


def make_models():
    """camvid-bise18 HR (no fuse) and LR (fuse) at full width on the CPU,
    weights from seeded generators, BN statistics randomised."""
    from arseg_tpu_torch.models import build_model
    from arseg_tpu_torch.nn.init import randomize_bn_

    models = []
    for seed, fuse in ((0, False), (1, True)):
        m = build_model("camvid-bise18", fuse=fuse, seed=seed, device="cpu")
        randomize_bn_(m, torch.Generator().manual_seed(100 + seed))
        models.append(m)
    return models


def make_clip(gops):
    """uint8 keyframes [K,H,W,3] and frames [K,G-1,H,W,3], and flow planes
    [K,G-1,H,W] drawn uniform(-16, 16) as bench.py draws them."""
    rng = np.random.RandomState(0)
    kfs = torch.from_numpy(rng.randint(0, 256, (gops, H, W, 3), dtype=np.uint8))
    frs = torch.from_numpy(rng.randint(0, 256, (gops, GOP - 1, H, W, 3), dtype=np.uint8))
    fxs = torch.from_numpy(rng.uniform(-16, 16, (gops, GOP - 1, H, W)).astype(np.float32))
    fys = torch.from_numpy(rng.uniform(-16, 16, (gops, GOP - 1, H, W)).astype(np.float32))
    return kfs, frs, fxs, fys


def pipeline_phase():
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    phase("pipeline: camvid-bise18 AR 0.5x, GOP 12, 720x960")
    models = make_models()
    kfs, frs, fxs, fys = make_clip(CLIP_GOPS)
    norm = (CAMVID_MEAN, CAMVID_STD)

    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    dev = [x.cuda() for x in (kfs, frs, fxs, fys)]
    pipe.gop_step(dev[0][:1], dev[1][0], (dev[2][0], dev[3][0]))  # warm-up
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    preds = pipe.scan_step(*dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"scan_step: {CLIP_GOPS} GOPs in {dt * 1e3:.2f} ms: {dt * 1e3 / CLIP_GOPS:.2f} ms/GOP, "
          f"{CLIP_GOPS * GOP / dt:.1f} frames/s; launches {launches}", flush=True)
    if tuple(preds.shape) != (CLIP_GOPS, GOP, H, W) or preds.dtype != torch.int32:
        raise SystemExit(f"chip_smoke: bad output {tuple(preds.shape)} {preds.dtype}")
    if int(preds.min()) < 0 or int(preds.max()) >= 12:
        raise SystemExit("chip_smoke: class index out of range")
    for name in ("creff_qkv_fused", "warp_bilinear"):
        if launches.get(name, 0) != CLIP_GOPS:
            raise SystemExit(f"chip_smoke: {name} launched {launches.get(name, 0)} times on the "
                             f"main path, expected {CLIP_GOPS} (one per GOP)")

    # one GOP: the card in float32 against the CPU (plain versions) in float32
    args = (kfs[:1], frs[0], (fxs[0], fys[0]))
    card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda")
    p_card, f_card = card.gop_step(*args, return_fused=True)
    t0 = time.perf_counter()
    cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu")
    p_cpu, f_cpu = cpu.gop_step(*args, return_fused=True)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    dfused = (f_card.cpu() - f_cpu).abs().max().item()
    fscale = f_cpu.abs().max().item()
    agree_b16 = (preds[0].cpu() == p_cpu).float().mean().item()
    print(f"card f32 vs CPU f32 (one GOP, CPU {time.perf_counter() - t0:.1f} s): class-map "
          f"agreement {agree:.6f} (>= {AGREEMENT}), fused max|d| {dfused:.3e} "
          f"(max|fused| {fscale:.3e}); card bf16 vs CPU f32 agreement {agree_b16:.6f}",
          flush=True)
    if not agree >= AGREEMENT or not dfused <= FUSED_TOL * max(1.0, fscale):
        raise SystemExit("chip_smoke: the card's float32 GOP disagrees with the CPU reference")
    return launches


def main():
    smi = device_phase()
    from arseg_tpu_torch import set_f32_parity_mode

    set_f32_parity_mode()  # float32 convolutions in full float32, not TF32
    build_phase()
    stats = kernel_phase()
    launches = pipeline_phase()
    sources = {
        "creff_qkv_fused": ("arseg_tpu_torch/csrc/creff_qkv_fused.cu",
                            "arseg_tpu/ops/pallas_creff.py:368"),
        "warp_bilinear": ("arseg_tpu_torch/csrc/warp_bilinear.cu",
                          "arseg_tpu/ops/pallas_warp.py:115"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        s = stats[(name, torch.bfloat16)]  # the main path runs in bfloat16
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
