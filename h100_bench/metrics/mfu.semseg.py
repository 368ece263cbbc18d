"""The served steps' counted FLOPs (``harness.arith_semseg.serve_flops_per_gop``)
over the traced window, as a share of the H100's bf16 dense peak. The
window opens and closes on a synchronise, so the steps issued inside it
ran in it."""

from harness import arith, arith_semseg


def read(run):
    t = run.trace
    if not t or t.window_s <= 0 or not run.host.get("traced_steps"):
        return None
    gops = run.host["traced_steps"] * run.host["gops_per_step"]
    flops = gops * arith_semseg.serve_flops_per_gop(run.cfg)
    return 100 * flops / t.window_s / arith.PEAK["bfloat16_flops"]
