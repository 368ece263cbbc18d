"""Readings of the program's own spans in a traced window (``Trace`` of
``harness/trace.py``), for the per-layer readers: "in the window" means
the spans that opened between the trace's ``t0`` and ``t1``.

A program without a span gives no reading of it: the readers return
``None`` then, as they do where nothing ran on the card."""

import bisect

# the program's spans on the serving loop's thread around taking a batch
# (``gop/feeder.py``, ``data/loader.py``); a CUDA run stages every step
FEED = ("feeder.wait", "loader.stage")


def opened(trace, name):
    """(start, end) ns of the spans called ``name`` opened in the window."""
    return sorted((s, e) for s, e, _, _ in trace.spans.get(name, ()) if trace.t0 <= s < trace.t1)


def host_s(trace, name):
    """Host seconds of the spans called ``name`` opened in the window."""
    return sum(e - s for s, e in opened(trace, name)) * 1e-9


def feed_traced(trace):
    """Whether the program marks its feed with spans (a program that does
    not leaves every feed reading out)."""
    return trace is not None and any(trace.spans.get(n) for n in FEED)


def idle_s(trace, names):
    """Device-idle seconds that ``Trace.breakdown`` charges to the spans
    called ``names``: every gap, not the largest ten."""
    return sum(v for n, v in trace.breakdown(top=None)["idle_gaps"] if n in names)


def device_ms_per_step(run, name):
    """Device ms a traced step of the operations launched under the spans
    called ``name`` on their own thread (``Trace.span_device_s``)."""
    t = run.trace
    n = t.span_count(name) if t else 0
    busy = t.span_device_s(name) if n else 0.0
    return 1e3 * busy / run.host["traced_steps"] if busy > 0 else None


def launched_within_s(trace, name):
    """Device seconds of the operations launched from any thread while a
    span called ``name`` opened in the window was open. Autograd launches
    a backward from its own thread, which ``Trace.span_device_s`` (by
    thread) would miss."""
    merged = []
    for s, e in opened(trace, name):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    total = 0
    for s, e, _, c in trace.ops:
        at = trace.launch.get(c)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at[0]) - 1
        if i >= 0 and at[0] <= merged[i][1]:
            total += e - s
    return total * 1e-9
