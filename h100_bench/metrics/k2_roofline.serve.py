"""K2 (the MV warp, ``csrc/warp_bilinear.cu``): its least time from shapes
(``harness.arith.k2_cost``, bf16, B keyframe features warped to B*(G-1)
frames) over its median launch in the trace, in percent."""

import statistics

from harness import arith


def read(run):
    times = run.trace.kernels("warp_bilinear_kernel") if run.trace else []
    if not times:
        return None
    cfg, b = run.cfg, run.host["gops_per_step"]
    fh, fw = arith.feature_hw(cfg)
    cost = arith.k2_cost(b * (cfg["gop"] - 1), b, fh, fw, cfg["middle_dim"])
    return 100 * arith.bound_s(*cost) / statistics.median(times)
