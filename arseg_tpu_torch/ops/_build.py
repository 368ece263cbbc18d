"""Build, load and launch the port's CUDA kernels (``arseg_tpu_torch/csrc``).

Built on first use into ``build/torch_kernels/`` at the root of the
checkout, for ``sm_90a``: one ``nvcc`` per ``.cu`` file, all started
together, linked into a shared library with a plain C interface
(``csrc/kernels.h``, the one declaration of every launcher's arguments)
and loaded with ctypes. No source includes the PyTorch headers, so a build
takes seconds. The library's name carries a hash of the sources and flags;
a process that finds it built already loads it. Processes that build at
once (the ranks of a data-parallel run) are safe: each compiles in a
directory of its own and publishes the library with an atomic rename, so
they only repeat each other's work. Build in the parent before spawning
the ranks (as ``chip_smoke.py`` does) to compile once.

Every wrapper launches through ``launch(name, *args)``, with the arguments
of ``arseg_<name>`` in ``kernels.h``'s order but the stream, which
``launch`` appends; it raises on a non-zero ``cudaGetLastError()`` and
counts the launch in ``LAUNCHES[name]``. A new kernel takes its ``.cu``
file, an entry in ``KERNEL_SOURCES``, its declaration in ``kernels.h`` and
a wrapper that calls ``launch``.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
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

# kernel name (the C launcher's without "arseg_") -> launches (reset with
# LAUNCHES.clear())
LAUNCHES = collections.Counter()
# torch dtype -> the launchers' `dtype` code (kernels.h)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
# whether this process compiled the library, and the seconds it took
BUILD_INFO = {}


def library():
    """The loaded library (a ``ctypes.CDLL``), built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            _lib, BUILD_INFO["compiled"] = _library()
            BUILD_INFO["seconds"] = time.perf_counter() - t0
        return _lib


def _c_arg(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if a is None:
        return None
    if isinstance(a, torch.dtype):
        return ctypes.c_int(DTYPE_CODES[a])
    return ctypes.c_int(int(a))


def launch(name, *args):
    """Call ``arseg_<name>`` with ``args`` in ``kernels.h``'s order: a tensor
    as its data pointer, None as a null pointer, a torch dtype as its code,
    an int or bool as a C int; then the current stream of the first tensor's
    device. Raises on a non-zero return, else counts the launch."""
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = getattr(library(), f"arseg_{name}")(*map(_c_arg, args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


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
    """The loaded library, compiled first if it is missing, and whether it was."""
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
