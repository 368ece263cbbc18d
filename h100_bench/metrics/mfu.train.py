"""The training steps' counted FLOPs (``harness.arith.train_flops_per_step``)
over the traced window, as a share of the H100's bf16 dense peak. The
window opens and closes on a synchronise between steps, so the steps
issued inside it ran in it."""

from harness import arith


def read(run):
    t = run.trace
    if not t or t.window_s <= 0 or not run.host.get("traced_steps"):
        return None
    flops = run.host["traced_steps"] * arith.train_flops_per_step(run.cfg, run.traffic["batch"])
    return 100 * flops / t.window_s / arith.PEAK["bfloat16_flops"]
