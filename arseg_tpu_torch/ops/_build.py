"""Build and bind the port's CUDA kernels (``arseg_tpu_torch/csrc``).

Built on first use into ``build/torch_kernels/`` at the root of the
checkout, for ``sm_90a``. Two routes give the same callables:

* ``"load"``: ``torch.utils.cpp_extension.load`` over all sources in one
  call (ninja compiles them in parallel); only ``binding.cpp`` includes the
  PyTorch headers, and it checks each launch with
  ``C10_CUDA_KERNEL_LAUNCH_CHECK()``.
* ``"nvcc"``: where ninja is missing, one ``nvcc`` per ``.cu`` file, all
  started together, linked into a shared library with a plain C interface
  and loaded with ctypes. The launchers return ``cudaGetLastError()`` and
  the wrapper raises on a non-zero code.

Both routes expose ``creff_qkv_fused(out, lr_up, ref, taps, bias, kh, kw)``
and ``warp_bilinear(out, src, fx, fy, align_corners)``. Launch counts for
the wrappers in ``creff_kernel.py`` and ``warp_kernel.py`` live in
``LAUNCHES``.
"""

import collections
import ctypes
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("creff_qkv_fused.cu", "warp_bilinear.cu")
BINDING = "binding.cpp"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17"]

# kernel name -> launches made by its wrapper (reset with LAUNCHES.clear())
LAUNCHES = collections.Counter()

_lock = threading.Lock()
_kernels = None
# the route taken and the build seconds of this process
BUILD_INFO = {}


def default_route():
    from torch.utils.cpp_extension import is_ninja_available

    return "load" if is_ninja_available() else "nvcc"


def kernels():
    """The bound kernels, built on first call."""
    global _kernels
    with _lock:
        if _kernels is None:
            route = default_route()
            t0 = time.perf_counter()
            _kernels = _build_load() if route == "load" else _build_nvcc()
            BUILD_INFO["route"] = route
            BUILD_INFO["seconds"] = time.perf_counter() - t0
        return _kernels


def _build_load():
    from torch.utils.cpp_extension import load

    out = BUILD_DIR / "load"
    out.mkdir(parents=True, exist_ok=True)
    ext = load(
        name="arseg_torch_kernels",
        sources=[str(CSRC / BINDING)] + [str(CSRC / s) for s in KERNEL_SOURCES],
        build_directory=str(out),
        extra_cflags=["-O3", "-std=c++17"],
        extra_cuda_cflags=NVCC_FLAGS + ARCH_FLAGS,
        extra_include_paths=[str(CSRC)],
        verbose=False,
    )
    return types.SimpleNamespace(
        creff_qkv_fused=ext.creff_qkv_fused, warp_bilinear=ext.warp_bilinear
    )


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    nvcc = str(cand) if cand.exists() else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def _build_nvcc():
    nvcc = _nvcc()
    out = BUILD_DIR / "nvcc"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in KERNEL_SOURCES:
        obj = out / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *ARCH_FLAGS, "-Xcompiler", "-fPIC", "-I", str(CSRC),
               "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    objs = []
    for obj, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{log}")
        objs.append(str(obj))
    lib_path = out / "libarseg_torch_kernels.so"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(lib_path)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arseg_creff_qkv_fused.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.arseg_creff_qkv_fused.restype = i
    lib.arseg_warp_bilinear.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.arseg_warp_bilinear.restype = i

    def code(t):
        return 1 if t.dtype == torch.bfloat16 else 0

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def creff_qkv_fused(out, lr_up, ref, taps, bias, kh, kw):
        n, h, w, c = lr_up.shape
        stream = torch.cuda.current_stream(out.device).cuda_stream
        check(lib.arseg_creff_qkv_fused(out.data_ptr(), lr_up.data_ptr(), ref.data_ptr(),
                                        taps.data_ptr(), bias.data_ptr(), n, h, w, c, kh,
                                        kw, code(out), stream), "creff_qkv_fused")

    def warp_bilinear(out, src, fx, fy, align_corners):
        n, h, w, c = out.shape
        stream = torch.cuda.current_stream(out.device).cuda_stream
        check(lib.arseg_warp_bilinear(out.data_ptr(), src.data_ptr(), fx.data_ptr(),
                                      fy.data_ptr(), n, src.shape[0], h, w, c,
                                      int(align_corners), code(out), stream), "warp_bilinear")

    return types.SimpleNamespace(creff_qkv_fused=creff_qkv_fused, warp_bilinear=warp_bilinear,
                                 lib=lib)
