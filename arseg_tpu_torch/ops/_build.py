"""Build and bind the port's CUDA kernels (``arseg_tpu_torch/csrc``).

Built on first use into ``build/torch_kernels/`` at the root of the
checkout, for ``sm_90a``: one ``nvcc`` per ``.cu`` file, all started
together, linked into a shared library with a plain C interface
(``csrc/kernels.h``) and loaded with ctypes. No source includes the
PyTorch headers, so a build takes seconds. The library's name carries a
hash of the sources and flags; a process that finds it built already loads
it. Processes that build at once (the ranks of a data-parallel run) are
safe: each compiles in a directory of its own and publishes the library
with an atomic rename, so they only repeat each other's work. Build in the
parent before spawning the ranks (as ``chip_smoke.py`` does) to compile
once. The launchers return ``cudaGetLastError()`` and the callables below
raise on a non-zero code.

The callables: ``creff_qkv_fused(out, lr_up, ref, taps, bias, kh, kw)``,
``creff_qkv_fused_backward(d_lr, d_ref, d_taps, workspace, lr_up, ref, g,
taps, bias, kh, kw)`` (``d_ref`` may be None) with
``creff_qkv_fused_backward_workspace(lr_up, kh)`` (its workspace's bytes),
``creff_phase2_argmax(out, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw)``,
``creff_attention(out, q, k, v, kh, kw)``,
``creff_phase2_upsample_argmax(out, lr_up, ref, taps, bias, fc_w, fc_b,
kh, kw)``, ``warp_bilinear(out, src, fx, fy, align_corners)`` and
``resize_bilinear_backward(dx, g, th, wh, tw, ww, bh, rmax, tile, layout)``.
Launch counts for the wrappers in ``creff_kernel.py``,
``creff_backward_kernel.py``, ``creff_head_kernel.py``,
``creff_attention_kernel.py``, ``creff_upsample_head_kernel.py``,
``warp_kernel.py`` and ``resize_kernel.py`` live in ``LAUNCHES``.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("creff_qkv_fused.cu", "creff_qkv_fused_backward.cu", "creff_phase2_argmax.cu",
                  "creff_attention.cu", "creff_phase2_upsample_argmax.cu", "warp_bilinear.cu",
                  "resize_bilinear_backward.cu")
HEADERS = ("kernels.h", "creff_module.cuh", "creff_module_mma.cuh")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17"]

# kernel name -> launches made by its wrapper (reset with LAUNCHES.clear())
LAUNCHES = collections.Counter()

_lock = threading.Lock()
_kernels = None
# whether this process compiled the library, and the seconds it took
BUILD_INFO = {}


def kernels():
    """The bound kernels, built on first call."""
    global _kernels
    with _lock:
        if _kernels is None:
            t0 = time.perf_counter()
            lib, compiled = _library()
            _kernels = _bind(lib)
            BUILD_INFO["compiled"] = compiled
            BUILD_INFO["seconds"] = time.perf_counter() - t0
        return _kernels


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    nvcc = str(cand) if cand.exists() else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ARCH_FLAGS).encode())
    for name in KERNEL_SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _library():
    """Path of the built library, compiling it first if it is missing."""
    lib_path = BUILD_DIR / f"libarseg_torch_kernels_{_source_hash()}.so"
    if lib_path.exists():
        return ctypes.CDLL(str(lib_path)), False
    nvcc = _nvcc()
    out = BUILD_DIR / f"obj_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in KERNEL_SOURCES:
        obj = out / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *ARCH_FLAGS, "-Xcompiler", "-fPIC", "-I", str(CSRC),
               "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    objs, errors = [], []
    for obj, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {obj.name}:\n{log}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out / lib_path.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)  # atomic: another process sees the whole file or none
    shutil.rmtree(out, ignore_errors=True)
    return ctypes.CDLL(str(lib_path)), True


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arseg_creff_qkv_fused.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.arseg_creff_qkv_fused.restype = i
    lib.arseg_creff_qkv_fused_backward_workspace.argtypes = [i, i, i, i, i, i]
    lib.arseg_creff_qkv_fused_backward_workspace.restype = ctypes.c_size_t
    lib.arseg_creff_qkv_fused_backward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                                   p]
    lib.arseg_creff_qkv_fused_backward.restype = i
    lib.arseg_creff_phase2_argmax.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.arseg_creff_phase2_argmax.restype = i
    lib.arseg_creff_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.arseg_creff_attention.restype = i
    lib.arseg_creff_phase2_upsample_argmax.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                                       i, p]
    lib.arseg_creff_phase2_upsample_argmax.restype = i
    lib.arseg_warp_bilinear.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.arseg_warp_bilinear.restype = i
    lib.arseg_resize_bilinear_backward.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i, i, i, i,
                                                   i, i, i, p]
    lib.arseg_resize_bilinear_backward.restype = i

    def code(t):
        return 1 if t.dtype == torch.bfloat16 else 0

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def creff_qkv_fused(out, lr_up, ref, taps, bias, kh, kw):
        n, h, w, c = lr_up.shape
        check(lib.arseg_creff_qkv_fused(out.data_ptr(), lr_up.data_ptr(), ref.data_ptr(),
                                        taps.data_ptr(), bias.data_ptr(), n, h, w, c, kh,
                                        kw, code(lr_up), stream(out)), "creff_qkv_fused")

    def creff_qkv_fused_backward_workspace(lr_up, k):
        n, h, w, c = lr_up.shape
        return lib.arseg_creff_qkv_fused_backward_workspace(n, h, w, c, k, code(lr_up))

    def creff_qkv_fused_backward(d_lr, d_ref, d_taps, workspace, lr_up, ref, g, taps, bias, kh,
                                 kw):
        n, h, w, c = lr_up.shape
        check(lib.arseg_creff_qkv_fused_backward(
            d_lr.data_ptr(), None if d_ref is None else d_ref.data_ptr(), d_taps.data_ptr(),
            workspace.data_ptr(), lr_up.data_ptr(), ref.data_ptr(), g.data_ptr(),
            taps.data_ptr(), bias.data_ptr(), n, h, w, c, kh, kw, code(lr_up), stream(d_lr)),
            "creff_qkv_fused_backward")

    def creff_phase2_argmax(out, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
        n, h, w, c = lr_up.shape
        check(lib.arseg_creff_phase2_argmax(out.data_ptr(), lr_up.data_ptr(), ref.data_ptr(),
                                            taps.data_ptr(), bias.data_ptr(), fc_w.data_ptr(),
                                            fc_b.data_ptr(), n, h, w, c, fc_w.shape[1], kh, kw,
                                            code(lr_up), stream(out)), "creff_phase2_argmax")

    def creff_attention(out, q, k, v, kh, kw):
        n, h, w, c = q.shape
        check(lib.arseg_creff_attention(out.data_ptr(), q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), n, h, w, c, kh, kw, code(q), stream(out)),
              "creff_attention")

    def creff_phase2_upsample_argmax(out, lr_up, ref, taps, bias, fc_w, fc_b, kh, kw):
        n, h, w, c = lr_up.shape
        check(lib.arseg_creff_phase2_upsample_argmax(
            out.data_ptr(), lr_up.data_ptr(), ref.data_ptr(), taps.data_ptr(), bias.data_ptr(),
            fc_w.data_ptr(), fc_b.data_ptr(), n, h, w, c, fc_w.shape[1], kh, kw, code(lr_up),
            stream(out)), "creff_phase2_upsample_argmax")

    def warp_bilinear(out, src, fx, fy, align_corners):
        n, h, w, c = out.shape
        check(lib.arseg_warp_bilinear(out.data_ptr(), src.data_ptr(), fx.data_ptr(),
                                      fy.data_ptr(), n, src.shape[0], h, w, c,
                                      int(align_corners), code(out), stream(out)),
              "warp_bilinear")

    def resize_bilinear_backward(dx, g, th, wh, tw, ww, bh, rmax, tile, layout):
        n, c, hin, win = dx.shape
        check(lib.arseg_resize_bilinear_backward(
            dx.data_ptr(), g.data_ptr(), th.data_ptr(), wh.data_ptr(), wh.shape[1], tw.data_ptr(),
            ww.data_ptr(), ww.shape[1], n, c, hin, win, g.shape[2], g.shape[3], bh, rmax, tile,
            layout, code(g), stream(dx)), "resize_bilinear_backward")

    return types.SimpleNamespace(creff_qkv_fused=creff_qkv_fused,
                                 creff_qkv_fused_backward=creff_qkv_fused_backward,
                                 creff_qkv_fused_backward_workspace=(
                                     creff_qkv_fused_backward_workspace),
                                 creff_phase2_argmax=creff_phase2_argmax,
                                 creff_attention=creff_attention,
                                 creff_phase2_upsample_argmax=creff_phase2_upsample_argmax,
                                 warp_bilinear=warp_bilinear,
                                 resize_bilinear_backward=resize_bilinear_backward, lib=lib)
