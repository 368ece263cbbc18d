"""Device-idle time that the trace's breakdown charges to the program's
``feeder.wait`` and ``loader.stage`` spans (the loop's innermost open span
over each gap in which nothing ran on the card), per traced step."""

from harness import spans


def read(run):
    t = run.trace
    if not spans.feed_traced(t) or not run.host.get("traced_steps") or t.busy_s <= 0:
        return None
    return 1e3 * spans.idle_s(t, spans.FEED) / run.host["traced_steps"]
