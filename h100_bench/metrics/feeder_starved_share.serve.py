"""The share of the GOPs taken in the traced window that the loop had to
wait for: ``feeder.wait`` spans (one a starved take) over traced steps x
GOPs a step, percent."""

from harness import spans


def read(run):
    t = run.trace
    if not spans.feed_traced(t) or not run.host.get("traced_steps"):
        return None
    gops = run.host["traced_steps"] * run.host["gops_per_step"]
    return 100 * len(spans.opened(t, "feeder.wait")) / gops
