"""K1 (the fused CReFF module, ``csrc/creff_qkv_fused.cu``): its least
time from shapes (``harness.arith.k1_cost``, bf16, at the step's
[B*(G-1), h/8, w/8, C]) over its median launch in the trace, in percent."""

import statistics

from harness import arith


def read(run):
    times = run.trace.kernels("module_kernel", "StoreFused") if run.trace else []
    if not times:
        return None
    cfg = run.cfg
    n = run.host["gops_per_step"] * (cfg["gop"] - 1)
    fh, fw = arith.feature_hw(cfg)
    return 100 * arith.bound_s(*arith.k1_cost(n, fh, fw, cfg["middle_dim"])) / statistics.median(times)
