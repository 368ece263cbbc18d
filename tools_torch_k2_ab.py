"""K2 (the MV warp, csrc/warp_bilinear.cu) of two or more checkouts of this
repo, timed in one process on the same inputs, so that two versions of the
kernel are compared on one card in one call:

    python3 tools_torch_k2_ab.py ROOT_A ROOT_B [...]

Each ROOT's ``arseg_tpu_torch/csrc/warp_bilinear.cu`` is compiled on its
own (this checkout's nvcc flags) into ``build/torch_kernels/k2_ab/<i>/``
and loaded with ctypes. At each shape, in bfloat16 and float32, every
version must equal this checkout's plain version exactly (max|d| = 0); a
version that refuses a shape (an older launcher and S sources) is marked
so. Versions are timed in the order A, B, ..., ..., B, A (CUDA events,
``chip_smoke.median_ms``) and each prints the mean of its two timings.
Shapes: chip_smoke.py's K2 shapes of the camvid paths (one source to 11
frames at [90,120,256], [720,960,64] and [90,120,512]) and of the
multi-GOP and eval paths (8 sources to 88 frames, 2 sources to 2 frames).

The library yardstick is timed beside them, ``F.grid_sample`` (bilinear,
zero padding) on the same grid, in two forms: ``expand``, the source given
as a batch view of stride 0 (one source only); ``copy``, the source
repeated into one image per frame (``repeat_interleave``) before the
timing.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs

# (name, sources, frames, (h, w), channels, flow grid)
SHAPES = (
    ("bise18", 1, 11, (90, 120), 256, (cs.H, cs.W)),
    ("psp18 V1", 1, 11, (cs.H, cs.W), 64, (cs.H, cs.W)),
    ("psp18 V2", 1, 11, (90, 120), 512, (cs.H, cs.W)),
    ("bise18 multi-GOP", 8, 88, (90, 120), 256, (cs.H, cs.W)),
    ("EvalAlterRes", 2, 2, (90, 120), 256, (cs.H, cs.W)),
)


def build(root, out_dir):
    from arseg_tpu_torch.ops import _build

    csrc = Path(root).resolve() / "arseg_tpu_torch" / "csrc"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libk2.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.ARCH_FLAGS, "-Xcompiler", "-fPIC",
           "-shared", "-I", str(csrc), str(csrc / "warp_bilinear.cu"), "-o", str(lib)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed for {csrc}:\n{r.stdout}{r.stderr}")
    k = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    k.arseg_warp_bilinear.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    k.arseg_warp_bilinear.restype = i
    return k


def launcher(k, src, fx, fy):
    """A callable that launches this version's K2, or None if it refuses
    the shape."""
    n, h, w = fx.shape
    out = torch.empty(n, h, w, src.shape[-1], device="cuda", dtype=src.dtype)
    code = 1 if src.dtype == torch.bfloat16 else 0

    def run():
        rc = k.arseg_warp_bilinear(out.data_ptr(), src.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                                   n, src.shape[0], h, w, src.shape[-1], 0, code,
                                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return out

    try:
        run()
    except RuntimeError:
        return None
    torch.cuda.synchronize()
    return run


def main():
    roots = sys.argv[1:]
    if len(roots) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    from arseg_tpu_torch.gop.pipeline import _resize_flow_planes
    from arseg_tpu_torch.ops import warp_kernel

    smi = cs.device_phase()
    base = Path(__file__).resolve().parent / "build" / "torch_kernels" / "k2_ab"
    libs = [build(r, base / str(i)) for i, r in enumerate(roots)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for name, s, n, hw, c, flow_hw in SHAPES:
            src = torch.randn(s, *hw, c, device="cuda", generator=gen).to(dt)
            flows = (torch.rand(n, *flow_hw, device="cuda", generator=gen) * 32 - 16
                     for _ in range(2))
            fx, fy = _resize_flow_planes(tuple(flows), hw)
            want = warp_kernel.warp_bilinear_plain(src, fx, fy)
            runs = [launcher(k, src, fx, fy) for k in libs]
            for root, run in zip(roots, runs):
                if run is not None and not torch.equal(run(), want):
                    raise SystemExit(f"tools_torch_k2_ab: {root}'s K2 disagrees with the "
                                     f"plain version at {name} {dt}")
            order = list(range(len(runs))) + list(reversed(range(len(runs))))
            times = {i: [] for i in range(len(runs))}
            for i in order:
                if runs[i] is not None:
                    times[i].append(cs.median_ms(runs[i]))
            xs = torch.arange(hw[1], device="cuda", dtype=torch.float32)
            ys = torch.arange(hw[0], device="cuda", dtype=torch.float32)[:, None]
            grid = torch.stack([2.0 * (xs + fx) / (hw[1] - 1) - 1.0,
                                2.0 * (ys + fy) / (hw[0] - 1) - 1.0], dim=-1).to(dt)
            nchw = src.permute(0, 3, 1, 2)
            lib = {"copy": nchw.repeat_interleave(n // s, dim=0)}
            if s == 1:
                lib["expand"] = nchw.expand(n, -1, -1, -1)
            lib_ms = {form: cs.median_ms(lambda x=x: F.grid_sample(
                x, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
                for form, x in lib.items()}
            dims = f"[{s},{hw[0]},{hw[1]},{c}]->{n}"
            parts = []
            for i, t in times.items():
                each = ", ".join(f"{x:.4f}" for x in t)
                parts.append(f"{roots[i]} " + (f"{float(np.mean(t)):.4f} ms ({each})" if t
                                               else "refused"))
            print(f"K2 {name} {dims} {dt}: " + "; ".join(parts) + "; grid_sample "
                  + ", ".join(f"{f} {ms:.4f} ms" for f, ms in lib_ms.items()), flush=True)
        torch.cuda.empty_cache()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
