"""Registers, shared memory and spills of every kernel instantiation of the
PyTorch/CUDA port, as ptxas reports them. Needs the CUDA toolkit (nvcc):

    python3 tools_torch_ptxas.py [source.cu ...]   # default: every kernel source

Compiles each source of arseg_tpu_torch/csrc with the port's own flags plus
``-Xptxas -v`` (objects into build/torch_kernels/ptxas/, removed after) and
prints, per kernel function, ptxas's "Used ... registers" line with the
spill lines before it. Names are demangled with cu++filt where the toolkit
has it.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

from arseg_tpu_torch.ops import _build


def demangle(names, nvcc):
    tool = Path(nvcc).parent / "cu++filt"
    if not names or not tool.exists():
        return names
    out = subprocess.run([str(tool)], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def report(src, nvcc, out_dir):
    cmd = [nvcc, *_build.NVCC_FLAGS, *_build.ARCH_FLAGS, "-Xptxas", "-v", "-Xcompiler", "-fPIC",
           "-I", str(_build.CSRC), "-c", str(_build.CSRC / src), "-o", str(out_dir / "k.o")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    log = r.stdout + r.stderr
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{log}")
    # ptxas prints, per function: "Compiling entry function '<name>'", then
    # "... bytes stack frame, ... spill stores, ... spill loads", then
    # "Used N registers, ... smem, ..."
    blocks, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = [m.group(1), []]
            blocks.append(cur)
        elif cur is not None and ("spill" in line or "Used" in line):
            cur[1].append(line.split("ptxas info    :")[-1].strip())
    names = demangle([b[0] for b in blocks], nvcc)
    for name, (_, lines) in zip(names, blocks):
        print(f"{src}: {name}")
        for line in lines:
            print(f"    {line}")


def main():
    nvcc = _build._nvcc()
    out_dir = _build.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        for src in sys.argv[1:] or _build.KERNEL_SOURCES:
            report(src, nvcc, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
