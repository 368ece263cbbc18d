"""Host time the serving loop's thread spent in the program's
``feeder.wait`` spans (``gop/feeder.py``: waiting for a GOP that no worker
had assembled yet), per traced step."""

from harness import spans


def read(run):
    t = run.trace
    if not spans.feed_traced(t) or not run.host.get("traced_steps"):
        return None
    return 1e3 * spans.host_s(t, "feeder.wait") / run.host["traced_steps"]
