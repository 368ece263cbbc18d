"""K3 (the fused CReFF module, ``final_conv`` and argmax,
``csrc/creff_phase2_argmax.cu``): its least time from shapes
(``harness.arith_psp.k3_cost``, bf16, at the frames of one launch: the
traced steps' B*(G-1) frames over K3's launches in the window) over its
median launch in the trace, in percent."""

import statistics

from harness import arith, arith_psp


def read(run):
    times = run.trace.kernels("module_kernel", "ArgmaxHead") if run.trace else []
    if not times or not run.host.get("traced_steps"):
        return None
    cfg = run.cfg
    frames = run.host["traced_steps"] * run.host["gops_per_step"] * (cfg["gop"] - 1)
    h, w = cfg["frame_hw"]
    cost = arith_psp.k3_cost(frames / len(times), h, w, cfg["middle_dim"], cfg["n_classes"])
    return 100 * arith.bound_s(*cost) / statistics.median(times)
