"""On-card smoke test of the PyTorch/CUDA port (arseg_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit.
  2. build: builds the kernels of arseg_tpu_torch/csrc, prints the seconds.
  3. kernels: each kernel against its plain PyTorch version at the shapes
     each driven path gives it, in float32 and bfloat16, with the tolerance
     stated: K1 and K2 at camvid-bise18's and camvid-psp18 V2's, K2 and K3
     at camvid-psp18 V1's, K4 at the localNoGroup and local5 shapes, K5 at
     camvid-bise18's fused head, K1 and K2 at cityscapes-bise18's and
     cityscapes-psp18's (1024x2048 frames, fused at 128x256), K1 and K2 at
     the multi-GOP step's (8 GOPs: K1 over 88 frames, K2 from 8 sources to
     88 frames), streaming's (one frame) and EvalAlterRes's (a batch of 2
     frames, K2 with one source per frame), and K1 at V1's C=64 shape for
     information
     (no path runs it there); kernel, plain and library times (CUDA events,
     median of 20 kernel runs, of 5 plain runs at the 720x960 shapes, each
     run over back-to-back calls filling about 1 ms); K2 must equal its
     plain version exactly, and is timed on block-constant 4x8 flows as
     well, for information. Then K2 on the flow cases of
     tests/test_pallas_warp*.py and at the edges of its tiling (sizes off
     its 32-pixel sets and 32- to 128-pixel blocks, a single row or column,
     n = 1, 11 frames from one source, one source per frame, flows of
     +-60) at C of 8, 64, 136, 256 and 512 (one, two or four warps a set),
     and a source past half the L2 in both block orders, exactly; K2 with
     S sources (3 for 33 frames at C 8, 64 and 136, and S = n) exactly,
     and the wrapper and the C launcher refusing 3 sources for 32 frames.
     Then K1, K3, K4 and K5 in bfloat16 (the tensor-core kernels) at edge
     shapes (sizes no multiple of the tile or of K5's 14-pixel interior, a
     single row or column, n = 1, C of 16, 64 and 512, windows 3, 5 and 7,
     12 and 19 classes), and K3 and K5 with a tie of two classes and with
     every logit below zero, printed with its seconds.
  4. camvid-bise18 AR 0.5x, GOP 12, 720x960, bf16, full width, random
     seeded weights: scan_step over 3 GOPs of uint8 frames, with the launch
     counts of every kernel read around that run; then one GOP on the CPU
     (plain versions, float32) against the card in float32.
  5. camvid-psp18 V1 AR, the same traffic: scan_step over 3 GOPs with its
     launch counts (K3 and K2 once per GOP, K1 never); a short GOP
     (keyframe + 2 frames) on the CPU in float32 against the card in
     float32; camvid-psp18 V2: one GOP on the card with its launch counts
     (K1 and K2 once), and a short GOP on the CPU against the card, both in
     float32.
  6. camvid-bise18 with other CReFF fusions, the same traffic: the
     localNoGroup fusion (K4) by scan_step over 3 GOPs with its launch
     counts, one GOP of local5 (K4 on four sub-grids), and one localNoGroup
     GOP on the CPU against the card in float32; then the fused upsample
     head (K5, the USE_FUSED_UPSAMPLE_HEAD setting that is not the default)
     by scan_step over 3 GOPs with its launch counts, and one GOP on the
     CPU against the card in float32.
  7. cityscapes-bise18 and cityscapes-psp18 AR 0.5x, GOP 12, 1024x2048,
     bf16: scan_step over 3 GOPs with its launch counts (K1 and K2 once per
     GOP; bise18 the planes head, psp18 forward_phase2 -> resize ->
     argmax), then a short GOP (keyframe + 2 frames) at 512x1024 on the CPU
     in float32 against the card in float32.
  8. multi-GOP: camvid-bise18, 8 GOPs in one gop_step call (720x960), its
     launch counts (K1 and K2 once), its maps against scan_step over the
     same GOPs in bf16 and in float32, and the ms per frame of both.
  9. streaming: camvid-bise18, one GOP as key_step + 11 frame_step calls
     against gop_step (float32), and the median ms per frame_step in bf16
     with its launch counts.
 10. eval: EvalConstRes (0.5x) and EvalAlterRes for camvid-bise18 at
     720x960, 4 batches of 2 frames, bf16: each histogram counts every
     scored pixel exactly; EvalAlterRes's launch counts; then both engines
     at 256x320 in float32 on the card against the CPU: class maps agree
     >= 0.999, mIoU within 1e-3, no histogram cell apart by more than 0.1%
     of the scored pixels.
 11. a JSON line of the kernels, and the last line {"ok": true, ...}.
Every phase prints its seconds.
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
C = 256       # camvid-bise18 fusion channels, at FEAT_HW
C_PSP = 64    # camvid-psp18 V1 fusion channels, at (H, W)
C_PSP_V2 = 512  # camvid-psp18 V2 fusion channels (the backbone feature), at FEAT_HW
N_CLASSES = 12
CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)
# cityscapes-bise18 and -psp18: 1024x2048 frames, both fuse at 1/8; the
# short GOP against the CPU runs at half that size
CITY_HW, CITY_SHORT_HW, N_CLASSES_CITY = (1024, 2048), (512, 1024), 19
CITY_FEAT_HW = (CITY_HW[0] // 8, CITY_HW[1] // 8)
C_CITY_PSP = 512  # cityscapes-psp18 fusion channels (the cls feature), at CITY_FEAT_HW
# the reference's Cityscapes normalisation of each model family
CITY_NORM = {"cityscapes-bise18": ((0.3257, 0.3690, 0.3223), (0.2112, 0.2148, 0.2115)),
             "cityscapes-psp18": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}
MULTI_GOPS = 8  # the multi-GOP batch of bench.py's throughput row
# multi-GOP maps against scan_step over the same GOPs: cuDNN picks other
# algorithms at another batch, so sums run in another order
MULTI_AGREEMENT = {torch.bfloat16: 0.999, torch.float32: 0.9999}
STREAM_AGREEMENT = 0.9999  # streaming against gop_step, float32
STREAM_REPEATS = 3  # GOPs served a frame a call for the frame_step timing
EVAL_BATCHES, EVAL_BATCH, EVAL_SMALL_HW, IGNORE = 4, 2, (256, 320), 255
# eval on the card (float32) against the CPU: the class maps' agreement
# (AGREEMENT), mIoU, and each histogram cell as a share of the scored pixels
MIOU_TOL, HIST_CELL_TOL = 1e-3, 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no tensor cores for f32
# max |kernel - plain| allowed, relative to max(1, max |plain|): float32 sums
# run in another order; bfloat16 outputs are rounded once, so two units in
# the last place of the largest output
TOL = {
    "creff_qkv_fused": {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6},
    "warp_bilinear": {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7},
    "creff_attention": {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6},
}
# kernels that repeat their plain version's arithmetic step by step: besides
# the tolerance, max |kernel - plain| must be 0
EXACT = ("warp_bilinear",)
# K3 and K5 write class maps: the share of pixels equal to the plain
# version's, and where they differ the plain version's logits (for K5 the
# upsampled ones) of its class and of the kernel's must be a near tie,
# within this share of max |logit| (float32: sums in another order;
# bfloat16: Q, K, V, p and the fused feature, or K5's logits and column
# interpolation, rounded after such sums)
K3_AGREEMENT = {torch.float32: 0.9999, torch.bfloat16: 0.999}
K3_TIE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# one GOP, the card in float32 against the CPU in float32: class maps flip
# only at near ties; the fused feature differs by the order of the sums
# through two BiSeNet forwards (observed ~3e-6 at max |fused| ~1.7)
AGREEMENT = 0.999
FUSED_TOL = 1e-3  # relative to max(1, max |fused|)
TIMED_RUNS = 20
BATCH_MS = 1.0  # a timing spans back-to-back calls of about this length
PLAIN_RUNS_PSP = 5
WARP_BLOCK = (4, 8)  # one motion vector per 4x8 block (the HEVC motion-field shape)
WARP_EDGE_C = (8, 64, 136, 256, 512)


def phase(name):
    print(f"== {name}", flush=True)


def _events_ms(fn, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median of `runs` timings of one call of fn, in ms, on CUDA events. Each
    timing spans as many back-to-back calls as fill about BATCH_MS, so that
    the host's time to reach the first launch does not count much for a
    short kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = max(1, min(100, int(BATCH_MS / _events_ms(fn, 1))))
    return float(np.median([_events_ms(fn, calls) for _ in range(runs)]))


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
    how = "compiled with nvcc" if _build.BUILD_INFO["compiled"] else "loaded, already built"
    print(f"kernels {how} in {time.perf_counter() - t0:.1f} s", flush=True)


def check(name, dtype, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = TOL[name][dtype] * scale
    ok = err <= tol and bool(torch.isfinite(got.float()).all()) and (name not in EXACT or err == 0)
    exact = " (exact)" if name in EXACT else ""
    print(f"{name} {str(dtype):14s} max|d|={err:.3e} tol={tol:.3e}{exact} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version in {dtype}")
    return err


def _bound(s, dt):
    t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = s["flops"] / PEAK_FLOPS[dt] * 1e3
    s["bound_ms"] = max(t_bytes, t_ops)
    s["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def _qkv_params(gen, c):
    from arseg_tpu_torch.ops import creff_kernel

    convs = [t for _ in range(3) for t in (
        torch.randn(c, 1, 3, 3, device="cuda", generator=gen) / 3.0,
        torch.randn(c, device="cuda", generator=gen) * 0.1)]
    return creff_kernel.pack_qkv(*convs)


def k1_case(gen, dt, n, hw, c, plain_runs):
    """K1 at [n, *hw, c] against its plain version."""
    from arseg_tpu_torch.ops import creff_kernel

    lr_up = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    k1 = lambda: creff_kernel.creff_qkv_fused(lr_up, ref, taps, bias, 7, 7)
    p1 = lambda: creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, 7, 7)
    err = check("creff_qkv_fused", dt, k1(), p1())
    # per element: three 3x3 depthwise convs (54), 49-tap logits (98) and
    # weighting (98), the residual (1)
    return dict(max_abs_err=err, ms=median_ms(k1), plain_ms=median_ms(p1, runs=plain_runs),
                library_ms=None,
                bytes=3 * lr_up.numel() * lr_up.element_size() + (taps.numel() + bias.numel()) * 4,
                flops=lr_up.numel() * 251)


def k2_case(gen, dt, n, hw, c, plain_runs, flow_hw=(H, W), sources=1):
    """K2: `sources` keyframe features [S, *hw, c] warped to n frames, frame
    i reading source i // (n / S) (the dims printed are the output's,
    [n, *hw, c]); flows drawn uniform(-16, 16) at flow_hw and resized to
    hw."""
    from arseg_tpu_torch.gop.pipeline import _resize_flow_planes
    from arseg_tpu_torch.ops import warp_kernel

    src = torch.randn(sources, *hw, c, device="cuda", generator=gen).to(dt)
    fxf = torch.rand(n, *flow_hw, device="cuda", generator=gen) * 32 - 16
    fyf = torch.rand(n, *flow_hw, device="cuda", generator=gen) * 32 - 16
    fx, fy = _resize_flow_planes((fxf, fyf), hw)
    k2 = lambda: warp_kernel.warp_bilinear(src, fx, fy)
    p2 = lambda: warp_kernel.warp_bilinear_plain(src, fx, fy)
    err = check("warp_bilinear", dt, k2(), p2())
    far = check("warp_bilinear", dt, warp_kernel.warp_bilinear(src, fx * 40, fy * 40),
                warp_kernel.warp_bilinear_plain(src, fx * 40, fy * 40))
    print(f"warp_bilinear far out-of-image flows (x40) checked, max|d|={far:.3e}", flush=True)
    # library yardstick: F.grid_sample on the same sampling grid (NCHW), the
    # sources repeated into one image per frame before the timing
    # (grid_sample takes no source index; on the H100 it ran 3-3.6x faster
    # on such a copy than on a stride-0 view of one source, in
    # tools_torch_k2_ab.py)
    xs = torch.arange(hw[1], device="cuda", dtype=torch.float32)
    ys = torch.arange(hw[0], device="cuda", dtype=torch.float32)[:, None]
    grid = torch.stack([2.0 * (xs + fx) / (hw[1] - 1) - 1.0,
                        2.0 * (ys + fy) / (hw[0] - 1) - 1.0], dim=-1).to(dt)
    src_nchw = src.permute(0, 3, 1, 2).repeat_interleave(n // sources, dim=0)
    lib2 = lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)
    gs = (lib2().permute(0, 2, 3, 1).float() - k2().float()).abs().max().item()
    print(f"warp_bilinear vs F.grid_sample {dt}: max|d|={gs:.3e} (information)", flush=True)
    # block-constant flows (one motion vector per 4x8 block at 720x960, the
    # HEVC motion-field shape), resized as the pipeline resizes them
    bfx, bfy = (torch.from_numpy(f).cuda()
                for f in _block_flow(np.random.RandomState(0), n, *flow_hw, -16, 16))
    bfx, bfy = _resize_flow_planes((bfx, bfy), hw)
    kb = lambda: warp_kernel.warp_bilinear(src, bfx, bfy)
    check("warp_bilinear", dt, kb(), warp_kernel.warp_bilinear_plain(src, bfx, bfy))
    ms = median_ms(k2)
    print(f"warp_bilinear {dt} ms: per-pixel random flows {ms:.4f}, block-constant 4x8 flows "
          f"{median_ms(kb):.4f} (information)", flush=True)
    out_numel = n * hw[0] * hw[1] * c
    return dict(max_abs_err=err, ms=ms, plain_ms=median_ms(p2, runs=plain_runs),
                library_ms=median_ms(lib2),
                bytes=src.numel() * src.element_size() + 2 * fx.numel() * 4
                + out_numel * src.element_size(),
                flops=out_numel * 7)


def check_maps(name, dt, got, logits, shape):
    """A kernel's class map `got` against the argmax of the plain version's
    float32 `logits` [..., K]: shape, range, agreement, and near ties
    wherever they differ. Returns (agreement, pixels that differ, largest
    plain-logit gap between the two classes there)."""
    n_classes = logits.shape[-1]
    want = logits.argmax(dim=-1).to(torch.int32)
    in_range = int(got.min()) >= 0 and int(got.max()) < n_classes
    differ = got != want
    agree = 1.0 - differ.float().mean().item()
    # where the maps differ: the plain logit of the plain version's class
    # less that of the kernel's class
    picked = got.clamp(0, n_classes - 1)[..., None].long()
    gaps = (logits.gather(-1, want[..., None].long()) - logits.gather(-1, picked))[differ]
    gap = gaps.max().item() if gaps.numel() else 0.0
    tie_tol = K3_TIE[dt] * logits.abs().max().item()
    ok = (tuple(got.shape) == tuple(shape) and in_range and agree >= K3_AGREEMENT[dt]
          and gap <= tie_tol)
    print(f"{name} {str(dt):14s} agreement={agree:.6f} (>= {K3_AGREEMENT[dt]}), "
          f"{int(differ.sum())} pixels differ, largest plain-logit gap between the two classes "
          f"there {gap:.3e} (near tie <= {tie_tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version in {dt}")
    return agree, int(differ.sum()), gap


def _head_params(gen, c, n_classes, dt):
    from arseg_tpu_torch.ops import creff_head_kernel

    weight = torch.randn(n_classes, c, 1, 1, device="cuda", generator=gen) / c ** 0.5
    return creff_head_kernel.pack_head(
        weight, torch.randn(n_classes, device="cuda", generator=gen) * 0.1, dt)


def k3_case(gen, dt, n, hw, c, n_classes):
    """K3 at [n, *hw, c] against its plain version: class-map agreement and
    near ties at every disagreement."""
    from arseg_tpu_torch.ops import creff_head_kernel, creff_kernel

    lr_up = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    fc_w, fc_b = _head_params(gen, c, n_classes, dt)
    args = (lr_up, ref, taps, bias, fc_w, fc_b, 7, 7)
    k3 = lambda: creff_head_kernel.creff_phase2_argmax(*args)
    p3 = lambda: creff_head_kernel.creff_phase2_argmax_plain(*args)
    # the plain version's logits, to find near ties where the maps differ
    logits = creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, 7, 7).float() @ fc_w + fc_b
    agree, differ, gap = check_maps("creff_phase2_argmax", dt, k3(), logits, (n, *hw))
    del logits
    elem_bytes = lr_up.element_size()
    # a class map has no error magnitude: max_abs_err is that logit gap
    return dict(max_abs_err=gap, agreement=agree, pixels_differ=differ,
                ms=median_ms(k3), plain_ms=median_ms(p3, runs=PLAIN_RUNS_PSP), library_ms=None,
                bytes=2 * lr_up.numel() * elem_bytes + n * hw[0] * hw[1] * 4
                + (taps.numel() + bias.numel() + fc_w.numel() + fc_b.numel()) * 4,
                # the module's 251 per element, and the 1x1 conv's multiply-adds
                flops=lr_up.numel() * (251 + 2 * n_classes))


def k4_case(gen, dt, n, hw, c, plain_runs):
    """K4 at q, k, v [n, *hw, c] against its plain version."""
    from arseg_tpu_torch.ops import creff_attention_kernel

    q, k, v = (torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt) for _ in range(3))
    k4 = lambda: creff_attention_kernel.creff_attention(q, k, v, 7, 7)
    p4 = lambda: creff_attention_kernel.creff_attention_plain(q, k, v, 7, 7)
    err = check("creff_attention", dt, k4(), p4())
    # per element: 49-tap logits (98) and weighting (98)
    return dict(max_abs_err=err, ms=median_ms(k4), plain_ms=median_ms(p4, runs=plain_runs),
                library_ms=None, bytes=4 * q.numel() * q.element_size(), flops=q.numel() * 196)


def k5_case(gen, dt, n, hw, c, n_classes):
    """K5 at [n, *hw, c] -> [n, 8h, 8w] against its plain version: class-map
    agreement and near ties of the plain upsampled logits at every
    disagreement, as K3."""
    from arseg_tpu_torch.ops import creff_upsample_head_kernel as k5

    lr_up = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    weight = torch.randn(n_classes, c, 1, 1, device="cuda", generator=gen) / c ** 0.5
    fc_w, fc_b = k5.pack_upsample_head(
        weight, torch.randn(n_classes, device="cuda", generator=gen) * 0.1, dt)
    args = (lr_up, ref, taps, bias, fc_w, fc_b, 7, 7)
    run5 = lambda: k5.creff_phase2_upsample_argmax(*args)
    plain5 = lambda: k5.creff_phase2_upsample_argmax_plain(*args)
    logits = k5.upsampled_logits_plain(*args)
    out_shape = (n, 8 * hw[0], 8 * hw[1])
    agree, differ, gap = check_maps("creff_phase2_upsample_argmax", dt, run5(), logits, out_shape)
    del logits
    elem_bytes = lr_up.element_size()
    out_px = n * out_shape[1] * out_shape[2]
    return dict(max_abs_err=gap, agreement=agree, pixels_differ=differ,
                ms=median_ms(run5), plain_ms=median_ms(plain5), library_ms=None,
                bytes=2 * lr_up.numel() * elem_bytes + out_px * 4
                + (taps.numel() + bias.numel() + fc_w.numel() + fc_b.numel()) * 4,
                # the module's 251 per element and the 1x1 conv's multiply-adds;
                # per class the column pass (3 per fused row and output column)
                # and the row pass with the bias (4 per output)
                flops=lr_up.numel() * (251 + 2 * n_classes)
                + n_classes * (3 * n * hw[0] * 8 * hw[1] + 4 * out_px))


def _block_flow(rng, n, h, w, lo, hi, jitter=0.0):
    br, bc = WARP_BLOCK
    fb = rng.uniform(lo, hi, (2, n, h // br, w // bc)).astype(np.float32)
    f = np.repeat(np.repeat(fb, br, axis=2), bc, axis=3)
    if jitter:
        f = f + rng.uniform(-jitter, jitter, f.shape).astype(np.float32)
    return f[0], f[1]


def _scene_flow(rng, n, h, w, mag, objects=3):
    """A pan plus a few rigidly moving rectangles, snapped to quarter-pel."""
    fx = np.empty((n, h, w), np.float32)
    fy = np.empty((n, h, w), np.float32)
    for b in range(n):
        fx[b] = rng.uniform(-mag, mag)
        fy[b] = rng.uniform(-mag, mag)
        for _ in range(objects):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            yh, xw = rng.randint(4, h // 2), rng.randint(4, w // 2)
            fx[b, y0 : y0 + yh, x0 : x0 + xw] = rng.uniform(-mag, mag)
            fy[b, y0 : y0 + yh, x0 : x0 + xw] = rng.uniform(-mag, mag)
    return (np.round(fx * 4) / 4).astype(np.float32), (np.round(fy * 4) / 4).astype(np.float32)


def warp_edge_cases(c, seed=0):
    """name -> (src [1 or n, h, w, c], fx [n, h, w], fy) float32 numpy
    arrays: the flow cases of tests/test_pallas_warp.py and
    tests/test_pallas_warp2.py (block-coherent flows with and without
    subpixel jitter, corners far out of the image, discontinuities inside
    motion blocks (window overflow), per-pixel random flows (past the
    correction budget), scene flows, small reach, and reach beyond one
    128-wide tile), then the edges of K2's tiling (sets of 32 pixels,
    blocks of 32 to 128): 11 frames from one source at a size off both tiles, one source
    per frame, a single row, a single column, and flows of +-60. All are
    small enough for K2's frames-outermost block order (warp_edge_phase
    adds sources too large for it)."""
    rng = np.random.RandomState(seed)
    h, w = 32, 64

    def src(hh=h, ww=w):
        return rng.randn(1, hh, ww, c).astype(np.float32)

    cases = {
        "coherent": (src(), *_block_flow(rng, 2, h, w, -6, 6)),
        "coherent_jitter": (src(), *_block_flow(rng, 2, h, w, -6, 6, jitter=0.45)),
        "out_of_image": (src(), *_block_flow(rng, 1, h, w, -40, 40)),
    }
    fx, fy = _block_flow(rng, 1, h, w, -6, 6)
    fx = fx.copy()
    fx[:, 10:20, 13:40] += np.where(
        (np.arange(27)[None, :] + np.arange(10)[:, None]) % 2 == 0, 12.0, -9.0
    ).astype(np.float32)
    cases["discontinuity"] = (src(), fx, fy)
    cases["over_budget"] = (src(), *(rng.uniform(-16, 16, (1, h, w)).astype(np.float32)
                                     for _ in range(2)))
    cases["scene"] = (src(40, 48), *_scene_flow(rng, 2, 40, 48, 9.0))
    cases["small_reach"] = (src(32, 40), *_scene_flow(rng, 1, 32, 40, 3.0))
    cases["cross_tile"] = (src(48, 200), np.full((1, 48, 200), 140.25, np.float32),
                           np.full((1, 48, 200), -20.5, np.float32))
    cases["random_8"] = (src(24, 32), *(rng.uniform(-8, 8, (2, 24, 32)).astype(np.float32)
                                        for _ in range(2)))

    def flow(n, hh, ww, mag):
        return tuple(rng.uniform(-mag, mag, (n, hh, ww)).astype(np.float32) for _ in range(2))

    cases["gop_11"] = (src(13, 37), *flow(11, 13, 37, 16))
    cases["per_frame"] = (rng.randn(3, 29, 43, c).astype(np.float32), *flow(3, 29, 43, 16))
    cases["row"] = (src(1, 45), *flow(2, 1, 45, 8))
    cases["column"] = (src(45, 1), *flow(2, 45, 1, 8))
    cases["reach_60"] = (src(29, 43), *flow(2, 29, 43, 60))
    return cases


def _warp_exact(name, src, fx, fy):
    """K2 against its plain version on one case, in f32 and bf16: max|d|
    must be 0 (and within the tolerance). src, fx, fy are on the card."""
    from arseg_tpu_torch.ops import warp_kernel

    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        s = src.to(dt)
        got = warp_kernel.warp_bilinear(s, fx, fy)
        want = warp_kernel.warp_bilinear_plain(s, fx, fy)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL["warp_bilinear"][dt] * max(1.0, want.float().abs().max().item())
        if not (err <= tol and err == 0):
            raise SystemExit(f"chip_smoke: warp_bilinear case {name} {dt}: "
                             f"max|d| {err:.3e}, must be 0 (and <= {tol:.3e})")
        worst = max(worst, err)
    return worst


def warp_edge_phase():
    phase("K2 on the flow cases of tests/test_pallas_warp*.py and at the edges of its tiling")
    worst = 0.0
    for c in WARP_EDGE_C:
        for name, (src, fx, fy) in warp_edge_cases(c).items():
            worst = max(worst, _warp_exact(f"{name} C={c}", *(torch.from_numpy(a).cuda()
                                                              for a in (src, fx, fy))))
    print(f"warp_bilinear: {len(warp_edge_cases(8))} cases x C in {WARP_EDGE_C} x (f32, bf16) "
          f"ok, largest max|d| {worst:.3e} (exact)", flush=True)
    # a source larger than half the L2 at a size off the 128-pixel tile: one
    # source for 3 frames takes the frames-innermost block order, one source
    # per frame the frames-outermost one
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, c = 3, 723, 965, 64
    fx, fy = ((torch.rand((n, h, w), generator=gen, device="cuda") - 0.5) * 32 for _ in range(2))
    for ns in (1, n):
        src = torch.randn((ns, h, w, c), generator=gen, device="cuda")
        worst = max(worst, _warp_exact(f"[{ns},{h},{w},{c}] -> {n}", src, fx, fy))
    print(f"warp_bilinear: [1 and {n},{h},{w},{c}] -> {n} (f32, bf16) ok, largest max|d| "
          f"{worst:.3e} (exact)", flush=True)
    warp_sources_phase()


def warp_sources_phase():
    """K2 with S sources for n frames (frame i reads source i // (n / S)):
    3 sources for 33 frames at C 8, 64 and 136, and S = n, exactly; then
    the wrapper and the C launcher refuse an n that S does not divide."""
    from arseg_tpu_torch.ops import _build, warp_kernel

    rng = np.random.RandomState(2)
    worst = 0.0
    for c in (8, 64, 136):
        for s, n, h, w in ((3, 33, 13, 37), (4, 4, 29, 43)):
            src = torch.from_numpy(rng.randn(s, h, w, c).astype(np.float32)).cuda()
            fx, fy = (torch.from_numpy(rng.uniform(-16, 16, (n, h, w)).astype(np.float32)).cuda()
                      for _ in range(2))
            worst = max(worst, _warp_exact(f"{s} sources -> {n} C={c}", src, fx, fy))
    print(f"warp_bilinear: 3 sources -> 33 frames and S = n = 4, C in (8, 64, 136) (f32, bf16) "
          f"ok, largest max|d| {worst:.3e} (exact)", flush=True)
    src = torch.zeros(3, 13, 37, 8, device="cuda")
    fx = torch.zeros(32, 13, 37, device="cuda")
    out = torch.empty(32, 13, 37, 8, device="cuda")
    try:
        warp_kernel.warp_bilinear(src, fx, fx)
    except ValueError:
        pass
    else:
        raise SystemExit("chip_smoke: warp_bilinear took 3 sources for 32 frames")
    rc = _build.kernels().lib.arseg_warp_bilinear(
        out.data_ptr(), src.data_ptr(), fx.data_ptr(), fx.data_ptr(), 32, 3, 13, 37, 8, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    if rc == 0:
        raise SystemExit("chip_smoke: the K2 launcher took 3 sources for 32 frames")
    print(f"warp_bilinear: 3 sources for 32 frames refused by the wrapper (ValueError) and by "
          f"the launcher (CUDA error {rc})", flush=True)


# (n, h, w, c, window): sizes that are no multiple of the 16 x 16 tile, a
# single row, n = 1, C of 16, 64 and 512, and each window
MODULE_EDGE_SHAPES = [
    (1, 13, 37, 16, 3), (2, 13, 37, 64, 5), (1, 1, 5, 64, 7), (1, 1, 5, 16, 5),
    (1, 45, 60, 512, 7), (3, 45, 60, 16, 7), (2, 13, 37, 512, 3),
]
# K4 and K5 besides: sizes that are no multiple of K5's 14-pixel interior
# (one past a multiple, and one short of one), and a single column, where
# the upsample's clamp folds i1 onto i0 along that axis as h = 1 does
HEAD_EDGE_SHAPES = [(1, 15, 29, 64, 7), (2, 29, 43, 16, 5), (1, 27, 13, 32, 7), (1, 7, 1, 16, 3)]


def _tie_and_negative(name, run, logits_of, gen, dt):
    """`run(fc_w, fc_b)` -> a class map at [2, 13, 37] C = 64; classes 2
    and 9 tied in every pixel (the lower index must win everywhere), then
    every logit below zero, held against `logits_of(fc_w, fc_b)`."""
    fc_w, fc_b = _head_params(gen, 64, 12, dt)
    # classes 2 and 9 lie in different n8 tiles and on different lanes
    fc_w[:, 9] = fc_w[:, 2]
    fc_b[2] = fc_b[9] = 50.0
    got = run(fc_w, fc_b)
    print(f"{name} tie of classes 2 and 9: {int((got == 2).sum())} of {got.numel()} pixels take "
          f"class 2", flush=True)
    if not bool((got == 2).all()):
        raise SystemExit(f"chip_smoke: {name} does not take the lowest index of a tie")
    fc_b = torch.full_like(fc_b, -100.0)
    check_maps(f"{name} logits all below 0", dt, run(fc_w, fc_b), logits_of(fc_w, fc_b),
               tuple(got.shape))


def module_edge_phase():
    """K1, K3, K4 and K5 in bfloat16 (the tensor-core body and products)
    against their plain versions, with the main rows' tolerances, at
    MODULE_EDGE_SHAPES and HEAD_EDGE_SHAPES (K3 and K5 with 12 and 19
    classes; K1 and K3 at the first list only); then K3 and K5 with two
    classes tied in every pixel (the lower index must win everywhere) and
    with every logit below zero (K3: the zero columns that pad the classes
    must never win)."""
    from arseg_tpu_torch.ops import creff_attention_kernel, creff_head_kernel, creff_kernel
    from arseg_tpu_torch.ops import creff_upsample_head_kernel as k5

    t0 = time.perf_counter()
    phase("K1, K3, K4 and K5, bf16 tensor-core kernels, at edge shapes")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    for n, h, w, c, k in MODULE_EDGE_SHAPES + HEAD_EDGE_SHAPES:
        print(f"-- [{n},{h},{w},{c}] window {k}", flush=True)
        lr_up = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        ref = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        v = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        taps, bias = _qkv_params(gen, c)
        check("creff_attention", dt, creff_attention_kernel.creff_attention(lr_up, ref, v, k, k),
              creff_attention_kernel.creff_attention_plain(lr_up, ref, v, k, k))
        module = (n, h, w, c, k) in MODULE_EDGE_SHAPES
        if module:
            fused = creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, k, k)
            check("creff_qkv_fused", dt,
                  creff_kernel.creff_qkv_fused(lr_up, ref, taps, bias, k, k), fused)
        for n_classes in (12, 19):
            fc_w, fc_b = _head_params(gen, c, n_classes, dt)
            if module:
                got = creff_head_kernel.creff_phase2_argmax(lr_up, ref, taps, bias, fc_w, fc_b,
                                                            k, k)
                check_maps(f"creff_phase2_argmax {n_classes} classes", dt, got,
                           fused.float() @ fc_w + fc_b, (n, h, w))
            args = (lr_up, ref, taps, bias, fc_w, fc_b, k, k)
            check_maps(f"creff_phase2_upsample_argmax {n_classes} classes", dt,
                       k5.creff_phase2_upsample_argmax(*args), k5.upsampled_logits_plain(*args),
                       (n, 8 * h, 8 * w))
    lr_up = torch.randn(2, 13, 37, 64, device="cuda", generator=gen).to(dt)
    ref = torch.randn(2, 13, 37, 64, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, 64)
    fused = creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, 7, 7)
    _tie_and_negative(
        "creff_phase2_argmax",
        lambda fc_w, fc_b: creff_head_kernel.creff_phase2_argmax(lr_up, ref, taps, bias, fc_w,
                                                                 fc_b, 7, 7),
        lambda fc_w, fc_b: fused.float() @ fc_w + fc_b, gen, dt)
    _tie_and_negative(
        "creff_phase2_upsample_argmax",
        lambda fc_w, fc_b: k5.creff_phase2_upsample_argmax(lr_up, ref, taps, bias, fc_w, fc_b, 7,
                                                           7),
        lambda fc_w, fc_b: k5.upsampled_logits_plain(lr_up, ref, taps, bias, fc_w, fc_b, 7, 7),
        gen, dt)
    print(f"-- kernel edge shapes: {time.perf_counter() - t0:.1f} s", flush=True)


def kernel_phase():
    phase("kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = GOP - 1
    stats = {}
    big = (n, (H, W), C_PSP, PLAIN_RUNS_PSP)
    v2 = (n, FEAT_HW, C_PSP_V2, TIMED_RUNS)
    # (kernel, shape key, case, its arguments); the key names the path
    cases = [
        ("creff_qkv_fused", "bise18", k1_case, (n, FEAT_HW, C, TIMED_RUNS)),
        ("warp_bilinear", "bise18", k2_case, (n, FEAT_HW, C, TIMED_RUNS)),
        ("creff_phase2_argmax", "psp18 V1", k3_case, (n, (H, W), C_PSP, N_CLASSES)),
        ("warp_bilinear", "psp18 V1", k2_case, big),
        ("creff_qkv_fused", "psp18 V2", k1_case, v2),
        ("warp_bilinear", "psp18 V2", k2_case, v2),
        ("creff_attention", "bise18 localNoGroup", k4_case, (n, FEAT_HW, C, TIMED_RUNS)),
        ("creff_attention", "bise18 local5 sub-grid", k4_case,
         (n, (FEAT_HW[0] // 2, FEAT_HW[1] // 2), C, TIMED_RUNS)),
        ("creff_phase2_upsample_argmax", "bise18 fused head", k5_case, (n, FEAT_HW, C, N_CLASSES)),
        ("creff_qkv_fused", "cityscapes-bise18", k1_case, (n, CITY_FEAT_HW, C, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "cityscapes-bise18", k2_case,
         (n, CITY_FEAT_HW, C, PLAIN_RUNS_PSP, CITY_HW)),
        ("creff_qkv_fused", "cityscapes-psp18", k1_case,
         (n, CITY_FEAT_HW, C_CITY_PSP, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "cityscapes-psp18", k2_case,
         (n, CITY_FEAT_HW, C_CITY_PSP, PLAIN_RUNS_PSP, CITY_HW)),
        # B GOPs in one step: K1 over all B*(G-1) frames, K2 from B sources
        ("creff_qkv_fused", "bise18 multi-GOP", k1_case,
         (MULTI_GOPS * n, FEAT_HW, C, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "bise18 multi-GOP", k2_case,
         (MULTI_GOPS * n, FEAT_HW, C, PLAIN_RUNS_PSP, (H, W), MULTI_GOPS)),
        # streaming: a frame a frame_step; EvalAlterRes: a batch of frames,
        # each warped from its own keyframe's feature
        ("creff_qkv_fused", "bise18 streaming", k1_case, (1, FEAT_HW, C, TIMED_RUNS)),
        ("warp_bilinear", "bise18 streaming", k2_case, (1, FEAT_HW, C, TIMED_RUNS)),
        ("creff_qkv_fused", "EvalAlterRes", k1_case, (EVAL_BATCH, FEAT_HW, C, TIMED_RUNS)),
        ("warp_bilinear", "EvalAlterRes", k2_case,
         (EVAL_BATCH, FEAT_HW, C, TIMED_RUNS, (H, W), EVAL_BATCH)),
        # information: no driven path runs K1 at V1's shape (V1 runs K3 there)
        ("creff_qkv_fused", "psp18 V1 (information)", k1_case, big),
    ]
    for dt in (torch.float32, torch.bfloat16):
        for name, shape, case, args in cases:
            dims = [args[0], *args[1], args[2]]
            print(f"-- {name} at the {shape} shape {dims}, {dt}", flush=True)
            stats[(name, shape, dt)] = dict(case(gen, dt, *args), dims=dims)
        torch.cuda.empty_cache()
    for (name, shape, dt), s in stats.items():
        _bound(s, dt)
        lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f}"
        print(f"{name} {shape} {s['dims']} {str(dt):14s} ms={s['ms']:.4f} "
              f"plain_ms={s['plain_ms']:.4f} library_ms={lib} bound_ms={s['bound_ms']:.4f} "
              f"({s['bound_by']}) max_abs_err={s['max_abs_err']:.3e}", flush=True)
    warp_edge_phase()
    module_edge_phase()
    return stats


def make_models(backend="camvid-bise18", fuse_version=1, attention_type="local"):
    """HR and LR models at full width on the CPU, weights from seeded
    generators, BN statistics randomised. The BiSeNets: HR plain, LR fused
    with `attention_type`; camvid-psp18 V1: HR plain (V0), LR V1; V2: both
    V2; cityscapes-psp18: both with the fusion, as the registry builds it."""
    from arseg_tpu_torch.models import build_model
    from arseg_tpu_torch.nn.init import randomize_bn_

    kw = (dict(fuse_version=fuse_version) if backend == "camvid-psp18"
          else dict(attention_type=attention_type))
    hr_fuse = backend == "camvid-psp18" and fuse_version == 2
    models = []
    for seed, fuse in ((0, hr_fuse), (1, True)):
        m = build_model(backend, fuse=fuse, seed=seed, device="cpu", **kw)
        randomize_bn_(m, torch.Generator().manual_seed(100 + seed))
        models.append(m)
    return models


def make_clip(gops, frames=GOP - 1, hw=(H, W)):
    """uint8 keyframes [K,h,w,3] and frames [K,frames,h,w,3], and flow planes
    [K,frames,h,w] drawn uniform(-16, 16) as bench.py draws them."""
    rng = np.random.RandomState(0)
    kfs = torch.from_numpy(rng.randint(0, 256, (gops, *hw, 3), dtype=np.uint8))
    frs = torch.from_numpy(rng.randint(0, 256, (gops, frames, *hw, 3), dtype=np.uint8))
    fxs = torch.from_numpy(rng.uniform(-16, 16, (gops, frames, *hw)).astype(np.float32))
    fys = torch.from_numpy(rng.uniform(-16, 16, (gops, frames, *hw)).astype(np.float32))
    return kfs, frs, fxs, fys


def check_maps_range(preds, shape, n_classes, name):
    if tuple(preds.shape) != tuple(shape) or preds.dtype != torch.int32:
        raise SystemExit(f"chip_smoke: {name}: bad output {tuple(preds.shape)} {preds.dtype}")
    if int(preds.min()) < 0 or int(preds.max()) >= n_classes:
        raise SystemExit(f"chip_smoke: {name}: class index out of range")


def run_clip(pipe, clip, name, n_classes=N_CLASSES):
    """Warm-up GOP, then scan_step over the clip with every launch count set
    to 0 just before and read just after. Returns (maps, launches)."""
    from arseg_tpu_torch.ops import _build

    dev = [x.cuda() for x in clip]
    pipe.gop_step(dev[0][:1], dev[1][0], (dev[2][0], dev[3][0]))  # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    preds = pipe.scan_step(*dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    gops = dev[0].shape[0]
    print(f"{name} scan_step: {gops} GOPs in {dt * 1e3:.2f} ms: {dt * 1e3 / gops:.2f} ms/GOP, "
          f"{gops * GOP / dt:.1f} frames/s; launches {launches}", flush=True)
    check_maps_range(preds, (gops, GOP, *dev[0].shape[1:3]), n_classes, name)
    return preds, launches


def expect_launches(launches, expected, name):
    for kernel, count in expected.items():
        if launches.get(kernel, 0) != count:
            raise SystemExit(f"chip_smoke: {kernel} launched {launches.get(kernel, 0)} times on "
                             f"the {name} path, expected {count}")


def pipeline_phase():
    from arseg_tpu_torch.gop import ARPipeline

    phase("pipeline: camvid-bise18 AR 0.5x, GOP 12, 720x960")
    models = make_models()
    kfs, frs, fxs, fys = make_clip(CLIP_GOPS)
    norm = (CAMVID_MEAN, CAMVID_STD)

    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    preds, launches = run_clip(pipe, (kfs, frs, fxs, fys), "camvid-bise18")
    expect_launches(launches, {"warp_bilinear": CLIP_GOPS, "creff_phase2_argmax": 0,
                               "creff_attention": 0, **head_launches(None)}, "camvid-bise18")
    card_vs_cpu(models, (kfs, frs, fxs, fys), preds[0], "camvid-bise18")
    return launches


def head_launches(fused_head):
    """Expected launches of K1 and K5 over a clip of camvid-bise18 "local"
    with the fused upsample head on or off (None: the module default)."""
    from arseg_tpu_torch.nn import bisenet

    if fused_head is None:
        fused_head = bisenet.USE_FUSED_UPSAMPLE_HEAD
    return {"creff_qkv_fused": 0 if fused_head else CLIP_GOPS,
            "creff_phase2_upsample_argmax": CLIP_GOPS if fused_head else 0}


def card_vs_cpu(models, clip, preds_b16, name, norm=(CAMVID_MEAN, CAMVID_STD)):
    """One GOP on the card in float32 against the CPU (plain versions) in
    float32: class-map agreement, and the fused features within FUSED_TOL;
    the card's bfloat16 maps of that GOP, `preds_b16`, beside them for
    information where given."""
    from arseg_tpu_torch.gop import ARPipeline

    kfs, frs, fxs, fys = clip
    args = (kfs[:1], frs[0], (fxs[0], fys[0]))
    card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda")
    cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu")
    p_card, f_card = card.gop_step(*args, return_fused=True)
    t0 = time.perf_counter()
    p_cpu, f_cpu = cpu.gop_step(*args, return_fused=True)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    dfused = (f_card.cpu() - f_cpu).abs().max().item()
    fscale = f_cpu.abs().max().item()
    b16 = ("" if preds_b16 is None else
           f"; card bf16 vs CPU f32 agreement {(preds_b16.cpu() == p_cpu).float().mean().item():.6f}")
    print(f"{name} card f32 vs CPU f32 (one GOP of {frs.shape[1] + 1} frames at "
          f"{tuple(kfs.shape[1:3])}, CPU {time.perf_counter() - t0:.1f} s): class-map agreement "
          f"{agree:.6f} (>= {AGREEMENT}), fused max|d| {dfused:.3e} (max|fused| {fscale:.3e}){b16}",
          flush=True)
    if not agree >= AGREEMENT or not dfused <= FUSED_TOL * max(1.0, fscale):
        raise SystemExit(f"chip_smoke: the card's float32 {name} GOP disagrees with the CPU")


def variants_phase():
    """camvid-bise18 with the localNoGroup and local5 fusions (K4), then
    with the fused upsample head (K5)."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.nn import bisenet
    from arseg_tpu_torch.ops import _build

    norm = (CAMVID_MEAN, CAMVID_STD)
    clip = make_clip(CLIP_GOPS)
    paths = {}

    phase("pipeline: camvid-bise18 AR, localNoGroup fusion (K4), GOP 12, 720x960, bf16")
    models = make_models(attention_type="localNoGroup")
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    preds, paths["camvid-bise18 localNoGroup"] = run_clip(pipe, clip, "camvid-bise18 localNoGroup")
    expect_launches(paths["camvid-bise18 localNoGroup"],
                    {"creff_attention": CLIP_GOPS, "warp_bilinear": CLIP_GOPS,
                     "creff_qkv_fused": 0, "creff_phase2_upsample_argmax": 0},
                    "camvid-bise18 localNoGroup")
    del pipe
    card_vs_cpu(models, clip, preds[0], "camvid-bise18 localNoGroup")

    phase("pipeline: camvid-bise18 AR, local5 fusion (K4 on four sub-grids), one GOP, bf16")
    pipe = ARPipeline(*make_models(attention_type="local5"), scale=SCALE, dtype=torch.bfloat16,
                      normalize=norm, device="cuda")
    kfs, frs, fxs, fys = (x.cuda() for x in clip)
    pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))  # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
    torch.cuda.synchronize()
    paths["camvid-bise18 local5"] = dict(_build.LAUNCHES)
    print(f"camvid-bise18 local5 GOP: {tuple(out.shape)} {out.dtype}, classes "
          f"{int(out.min())}..{int(out.max())}; launches {paths['camvid-bise18 local5']}",
          flush=True)
    if tuple(out.shape) != (GOP, H, W) or int(out.min()) < 0 or int(out.max()) >= N_CLASSES:
        raise SystemExit("chip_smoke: bad local5 output")
    expect_launches(paths["camvid-bise18 local5"],
                    {"creff_attention": 4, "warp_bilinear": 1, "creff_qkv_fused": 0},
                    "camvid-bise18 local5")
    del pipe, out, kfs, frs, fxs, fys
    torch.cuda.empty_cache()

    head = not bisenet.USE_FUSED_UPSAMPLE_HEAD
    phase(f"pipeline: camvid-bise18 AR, USE_FUSED_UPSAMPLE_HEAD={head} (not the default), "
          f"GOP 12, 720x960, bf16")
    bisenet.USE_FUSED_UPSAMPLE_HEAD = head
    models = make_models()
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    name = f"camvid-bise18 USE_FUSED_UPSAMPLE_HEAD={head}"
    preds, paths[name] = run_clip(pipe, clip, name)
    expect_launches(paths[name],
                    {"warp_bilinear": CLIP_GOPS, "creff_attention": 0, **head_launches(head)},
                    name)
    del pipe
    # with the fused head on, return_fused adds the fused feature through K1
    card_vs_cpu(models, clip, preds[0], name)
    bisenet.USE_FUSED_UPSAMPLE_HEAD = not head
    torch.cuda.empty_cache()
    return paths


def psp18_phase():
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    phase("pipeline: camvid-psp18 V1 AR 0.5x, GOP 12, 720x960, bf16")
    norm = (CAMVID_MEAN, CAMVID_STD)
    models = make_models("camvid-psp18", 1)
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    preds, launches = run_clip(pipe, make_clip(CLIP_GOPS), "camvid-psp18 V1")
    expect_launches(launches, {"creff_phase2_argmax": CLIP_GOPS, "warp_bilinear": CLIP_GOPS,
                               "creff_qkv_fused": 0}, "camvid-psp18 V1")
    del pipe, preds
    torch.cuda.empty_cache()

    # a short GOP (keyframe + 2 frames): the card in float32 against the CPU
    kfs, frs, fxs, fys = make_clip(1, frames=2)
    args = (kfs, frs[0], (fxs[0], fys[0]))
    p_card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda").gop_step(*args)
    t0 = time.perf_counter()
    p_cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu").gop_step(*args)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    print(f"camvid-psp18 V1 card f32 vs CPU f32 (keyframe + 2 frames, CPU "
          f"{time.perf_counter() - t0:.1f} s): class-map agreement {agree:.6f} (>= {AGREEMENT})",
          flush=True)
    if not agree >= AGREEMENT:
        raise SystemExit("chip_smoke: the card's float32 psp18 GOP disagrees with the CPU")
    torch.cuda.empty_cache()

    phase("pipeline: camvid-psp18 V2, one GOP on the card, bf16")
    models = make_models("camvid-psp18", 2)
    v2 = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(1))
    _build.LAUNCHES.clear()
    out = v2.gop_step(kfs, frs[0], (fxs[0], fys[0]))
    torch.cuda.synchronize()
    v2_launches = dict(_build.LAUNCHES)
    print(f"camvid-psp18 V2 GOP: {tuple(out.shape)} {out.dtype}, classes "
          f"{int(out.min())}..{int(out.max())}; launches {v2_launches}", flush=True)
    if tuple(out.shape) != (GOP, H, W) or out.dtype != torch.int32:
        raise SystemExit(f"chip_smoke: bad V2 output {tuple(out.shape)} {out.dtype}")
    if int(out.min()) < 0 or int(out.max()) >= N_CLASSES:
        raise SystemExit("chip_smoke: V2 class index out of range")
    expect_launches(v2_launches, {"creff_qkv_fused": 1, "warp_bilinear": 1,
                                  "creff_phase2_argmax": 0}, "camvid-psp18 V2")
    del v2, out
    torch.cuda.empty_cache()

    # a short GOP (keyframe + 2 frames): the card in float32 against the CPU
    kfs, frs, fxs, fys = make_clip(1, frames=2)
    args = (kfs, frs[0], (fxs[0], fys[0]))
    p_card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda").gop_step(*args)
    t0 = time.perf_counter()
    p_cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu").gop_step(*args)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    print(f"camvid-psp18 V2 card f32 vs CPU f32 (keyframe + 2 frames, CPU "
          f"{time.perf_counter() - t0:.1f} s): class-map agreement {agree:.6f} (>= {AGREEMENT})",
          flush=True)
    if not agree >= AGREEMENT:
        raise SystemExit("chip_smoke: the card's float32 psp18 V2 GOP disagrees with the CPU")
    return {"camvid-psp18 V1": launches, "camvid-psp18 V2": v2_launches}


def cityscapes_phase(backend):
    """`backend` AR 0.5x at 1024x2048 (GOP 12, bf16): scan_step over 3 GOPs
    with its launch counts (K1 and K2 once per GOP), then a short GOP
    (keyframe + 2 frames) at 512x1024 on the card in float32 against the
    CPU."""
    from arseg_tpu_torch.gop import ARPipeline

    phase(f"pipeline: {backend} AR 0.5x, GOP 12, 1024x2048, bf16")
    norm = CITY_NORM[backend]
    models = make_models(backend)
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    _, launches = run_clip(pipe, make_clip(CLIP_GOPS, hw=CITY_HW), backend, N_CLASSES_CITY)
    k1_k5 = (head_launches(None) if backend == "cityscapes-bise18"
             else {"creff_qkv_fused": CLIP_GOPS, "creff_phase2_upsample_argmax": 0})
    expect_launches(launches, {"warp_bilinear": CLIP_GOPS, "creff_phase2_argmax": 0,
                               "creff_attention": 0, **k1_k5}, backend)
    del pipe
    torch.cuda.empty_cache()
    card_vs_cpu(models, make_clip(1, frames=2, hw=CITY_SHORT_HW), None, backend, norm)
    torch.cuda.empty_cache()
    return {backend: launches}


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def multi_gop_phase():
    """camvid-bise18, B = 8 GOPs in one gop_step call (5-D frames): launch
    counts (K1 and K2 once for the step), maps against scan_step over the
    same GOPs in bfloat16 and in float32, and the ms per frame of both."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    b = MULTI_GOPS
    phase(f"pipeline: camvid-bise18 multi-GOP, B = {b} GOPs in one gop_step, GOP 12, 720x960")
    norm = (CAMVID_MEAN, CAMVID_STD)
    models = make_models()
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(b))
    launches = None
    for dt in (torch.bfloat16, torch.float32):
        pipe = ARPipeline(*models, scale=SCALE, dtype=dt, normalize=norm, device="cuda")
        pipe.gop_step(kfs, frs, (fxs, fys))  # warm-up
        pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
        torch.cuda.synchronize()
        if launches is None:
            _build.LAUNCHES.clear()
            multi, _ = _sync_ms(lambda: pipe.gop_step(kfs, frs, (fxs, fys)))
            launches = dict(_build.LAUNCHES)
            expect_launches(launches, {"creff_qkv_fused": 1, "warp_bilinear": 1,
                                       "creff_phase2_argmax": 0, "creff_attention": 0,
                                       "creff_phase2_upsample_argmax": 0},
                            "camvid-bise18 multi-GOP")
        t_multi, t_scan = [], []
        for _ in range(3):
            multi, ms = _sync_ms(lambda: pipe.gop_step(kfs, frs, (fxs, fys)))
            t_multi.append(ms)
            scan, ms = _sync_ms(lambda: pipe.scan_step(kfs, frs, fxs, fys))
            t_scan.append(ms)
        check_maps_range(multi, (b, GOP, H, W), N_CLASSES, "camvid-bise18 multi-GOP")
        agree = (multi == scan).float().mean().item()
        frames = b * GOP
        print(f"camvid-bise18 multi-GOP {dt}: {float(np.median(t_multi)) / frames:.4f} ms/frame "
              f"(one gop_step of {b} GOPs, median of 3; all {[round(x, 3) for x in t_multi]} ms) "
              f"against scan_step {float(np.median(t_scan)) / frames:.4f} ms/frame (all "
              f"{[round(x, 3) for x in t_scan]} ms); maps agree {agree:.6f} "
              f"(>= {MULTI_AGREEMENT[dt]}); launches {launches}", flush=True)
        if not agree >= MULTI_AGREEMENT[dt]:
            raise SystemExit(f"chip_smoke: multi-GOP maps disagree with scan_step in {dt}")
        del pipe, multi, scan
        torch.cuda.empty_cache()
    return {"camvid-bise18 multi-GOP": launches}


def streaming_phase(smi):
    """camvid-bise18 served a frame a call: one GOP as key_step + 11
    frame_step calls against gop_step on the same GOP (float32), then the
    median ms per frame_step in bfloat16 over 3 GOPs, with its launch
    counts (K1 and K2 once per frame_step)."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    phase("pipeline: camvid-bise18 streaming, key_step + 11 frame_step calls a GOP, 720x960")
    norm = (CAMVID_MEAN, CAMVID_STD)
    models = make_models()
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(1))

    def serve(pipe, times=None):
        key_step, frame_step = pipe.streaming_step()
        kmap, ref = key_step(kfs[:1])
        maps = [kmap]
        for i in range(GOP - 1):
            args = (ref, frs[0, i : i + 1], (fxs[0, i : i + 1], fys[0, i : i + 1]))
            out, ms = _sync_ms(lambda: frame_step(*args))
            maps.append(out)
            if times is not None:
                times.append(ms)
        return torch.cat(maps)

    pipe = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda")
    maps = serve(pipe)
    gop = pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
    check_maps_range(maps, (GOP, H, W), N_CLASSES, "camvid-bise18 streaming")
    agree = (maps == gop).float().mean().item()
    print(f"camvid-bise18 streaming float32: maps against gop_step agree {agree:.6f} "
          f"(>= {STREAM_AGREEMENT})", flush=True)
    if not agree >= STREAM_AGREEMENT:
        raise SystemExit("chip_smoke: streaming maps disagree with gop_step")
    del pipe
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    serve(pipe)  # warm-up
    times = []
    _build.LAUNCHES.clear()
    for _ in range(STREAM_REPEATS):
        serve(pipe, times)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    per_frame = STREAM_REPEATS * (GOP - 1)
    expect_launches(launches, {"creff_qkv_fused": per_frame, "warp_bilinear": per_frame,
                               "creff_phase2_argmax": 0, "creff_attention": 0,
                               "creff_phase2_upsample_argmax": 0}, "camvid-bise18 streaming")
    print(f"camvid-bise18 streaming bf16: frame_step median {float(np.median(times)):.3f} ms "
          f"(host clock around synchronised calls, {len(times)} calls, range "
          f"{min(times):.3f}-{max(times):.3f}) on {smi}; launches {launches}", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return {"camvid-bise18 streaming": launches}


def make_eval_batches(batches, per_batch, hw, seed=0):
    """Seeded normalised images and keyframes, labels with about 5% of
    pixels at the ignore label, flows uniform(-16, 16) [..., 2]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        label = rng.randint(0, N_CLASSES, (per_batch, *hw))
        label[rng.rand(per_batch, *hw) < 0.05] = IGNORE
        out.append(dict(image=rng.randn(per_batch, *hw, 3).astype(np.float32),
                        label=label.astype(np.int32),
                        ref_image=rng.randn(per_batch, *hw, 3).astype(np.float32),
                        flow=rng.uniform(-16, 16, (per_batch, *hw, 2)).astype(np.float32)))
    return out


def eval_phase():
    """EvalConstRes (0.5x) and EvalAlterRes for camvid-bise18 at 720x960, 4
    batches of 2 frames, bf16: each histogram counts every scored pixel
    exactly, with the launch counts of the AR engine (K1 and K2 once per
    batch, K2 with one source per frame); then both engines at 256x320, 2
    batches, in float32 on the card against the CPU: the class maps, the
    histograms and the mIoU."""
    from arseg_tpu_torch.eval import (EvalAlterRes, EvalConstRes, confusion_update,
                                      miou_from_hist)
    from arseg_tpu_torch.ops import _build

    phase("eval: EvalConstRes (0.5x) and EvalAlterRes, camvid-bise18, 720x960, 4 batches of 2, "
          "bf16")
    hr, lr = make_models()
    loader = make_eval_batches(EVAL_BATCHES, EVAL_BATCH, (H, W))
    scored = sum(int((b["label"] != IGNORE).sum()) for b in loader)
    launches = None
    for name, engine, models in (("EvalConstRes", EvalConstRes, (hr,)),
                                 ("EvalAlterRes", EvalAlterRes, (hr, lr))):
        eng = engine(scale=SCALE, dtype=torch.bfloat16, device="cuda")
        eng.histogram(*models, loader[:1], N_CLASSES)  # warm-up
        _build.LAUNCHES.clear()
        hist, ms = _sync_ms(lambda: eng.histogram(*models, loader, N_CLASSES))
        if name == "EvalAlterRes":
            launches = dict(_build.LAUNCHES)
            expect_launches(launches, {"creff_qkv_fused": EVAL_BATCHES,
                                       "warp_bilinear": EVAL_BATCHES}, "EvalAlterRes")
        total = int(hist.sum())
        print(f"{name} bf16: {EVAL_BATCHES} batches in {ms:.1f} ms, histogram sum {total} "
              f"(scored pixels {scored}), mIoU {float(miou_from_hist(hist.cpu())):.6f} "
              f"(random weights)", flush=True)
        if total != scored or hist.dtype != torch.int64:
            raise SystemExit(f"chip_smoke: {name}'s histogram does not count every scored pixel")
    print(f"EvalAlterRes launches {launches}", flush=True)

    small = make_eval_batches(2, EVAL_BATCH, EVAL_SMALL_HW, seed=1)
    scored = sum(int((b["label"] != IGNORE).sum()) for b in small)
    for name, engine, models in (("EvalConstRes", EvalConstRes, (hr,)),
                                 ("EvalAlterRes", EvalAlterRes, (hr, lr))):
        maps, hists = [], []
        for device in ("cuda", "cpu"):
            pairs = list(engine(scale=SCALE, device=device).predictions(*models, small))
            hist = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int64)
            for label, pred in pairs:
                hist = confusion_update(hist, label.cpu(), pred.cpu(), N_CLASSES, IGNORE)
            maps.append(torch.cat([pred.cpu().flatten() for _, pred in pairs]))
            hists.append(hist)
        agree = (maps[0] == maps[1]).float().mean().item()
        card, cpu = hists
        dmiou = abs(float(miou_from_hist(card)) - float(miou_from_hist(cpu)))
        dcell = int((card - cpu).abs().max())
        print(f"{name} card f32 vs CPU f32 at {EVAL_SMALL_HW}, 2 batches: class maps agree "
              f"{agree:.6f} (>= {AGREEMENT}), mIoU |d| {dmiou:.3e} (<= {MIOU_TOL}), largest "
              f"histogram cell |d| {dcell} (<= {HIST_CELL_TOL} x {scored} scored pixels)",
              flush=True)
        if not (agree >= AGREEMENT and dmiou <= MIOU_TOL and dcell <= HIST_CELL_TOL * scored):
            raise SystemExit(f"chip_smoke: {name} on the card disagrees with the CPU")
    torch.cuda.empty_cache()
    return {"EvalAlterRes camvid-bise18": launches}


def timed(fn, name):
    t0 = time.perf_counter()
    out = fn()
    print(f"-- phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    smi = timed(device_phase, "device")
    from arseg_tpu_torch import set_f32_parity_mode

    set_f32_parity_mode()  # float32 convolutions in full float32, not TF32
    timed(build_phase, "build")
    stats = timed(kernel_phase, "kernels")
    paths = {"camvid-bise18": timed(pipeline_phase, "camvid-bise18 pipeline"),
             **timed(psp18_phase, "camvid-psp18 pipelines"),
             **timed(variants_phase, "camvid-bise18 fusion variants and fused head"),
             **timed(lambda: cityscapes_phase("cityscapes-bise18"), "cityscapes-bise18 pipeline"),
             **timed(lambda: cityscapes_phase("cityscapes-psp18"), "cityscapes-psp18 pipeline"),
             **timed(multi_gop_phase, "camvid-bise18 multi-GOP"),
             **timed(lambda: streaming_phase(smi), "camvid-bise18 streaming"),
             **timed(eval_phase, "eval engines")}
    kernels = []
    # each kernel in bfloat16 at the shape of the first path that runs it;
    # its other shapes beside it
    sources = {
        "creff_qkv_fused": ("arseg_tpu_torch/csrc/creff_qkv_fused.cu",
                            "arseg_tpu/ops/pallas_creff.py:368", "bise18"),
        "warp_bilinear": ("arseg_tpu_torch/csrc/warp_bilinear.cu",
                          "arseg_tpu/ops/pallas_warp.py:115", "bise18"),
        "creff_phase2_argmax": ("arseg_tpu_torch/csrc/creff_phase2_argmax.cu",
                                "arseg_tpu/ops/pallas_creff.py:485", "psp18 V1"),
        "creff_attention": ("arseg_tpu_torch/csrc/creff_attention.cu",
                            "arseg_tpu/ops/pallas_creff.py:151", "bise18 localNoGroup"),
        "creff_phase2_upsample_argmax": ("arseg_tpu_torch/csrc/creff_phase2_upsample_argmax.cu",
                                         "arseg_tpu/ops/pallas_creff.py:648",
                                         "bise18 fused head"),
    }
    keys = ("dims", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    for name, (source, replaces, shape) in sources.items():
        s = stats[(name, shape, torch.bfloat16)]
        by_path = {p: launches.get(name, 0) for p, launches in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "shape": shape, "dims": s["dims"], "launches_by_path": by_path,
            "other_shapes": {k[1]: {x: o[x] for x in keys} for k, o in stats.items()
                             if k[0] == name and k[1] != shape and k[2] == torch.bfloat16},
        }
        if "agreement" in s:
            entry["agreement"] = s["agreement"]
            entry["pixels_differ"] = s["pixels_differ"]
            entry["max_abs_err_is"] = ("largest plain-logit gap between the plain version's "
                                       "class and the kernel's where the maps differ")
        kernels.append(entry)
    print(f"-- total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
