"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` events kept
in memory (nothing is written to disk) and reduced to what the per-layer
readers and the result's ``device`` and ``breakdown`` need.

- Device operations: kernels, copies and sets that ran on the card. Busy
  time is the union of their intervals inside the traced window, over all
  streams, so that overlapping work counts once.
- A host span (a ``record_function`` of the benchmark or of the program, or
  an autograd node) owns the device operations launched while it was open
  on the same thread, found through the launch's correlation id.
- Idle gaps (no device operation running) are charged to the innermost
  host span of the benchmark's loop thread open at the gap's start.
"""

import bisect
import collections
import contextlib
import heapq

import torch

WINDOW = "bench.trace_window"


class Capture:
    """Start and stop the profiler around a stretch of the window, the
    stretch under a ``bench.trace_window`` span, synchronised at both ends."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self._span = None
        self._trace = None
        self.done = False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop a profiler once in set-up: the first start loads
        the device tracer, seconds that would otherwise fall in the window."""
        prof = self._profile()
        prof.start()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()

    def start(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof = self._profile()
        self.prof.start()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self):
        """Stop at once; the events are read after the window (``trace``)."""
        if self.prof is None or self.done:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    @property
    def active(self):
        return self.prof is not None and not self.done

    @property
    def trace(self):
        if self._trace is None and self.done:
            self._trace = Trace(self.prof.profiler.kineto_results.events())
            self.prof = None
        return self._trace


@contextlib.contextmanager
def span(name):
    """A host span of the benchmark's own (a no-op unless profiling)."""
    with torch.profiler.record_function(name):
        yield


def _is_device(e):
    return e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation()


def _is_host(e):
    return e.device_type() == torch.autograd.DeviceType.CPU


class Trace:
    def __init__(self, events):
        dev, cpu = [], []
        for e in events:
            if _is_device(e):
                dev.append(e)
            elif _is_host(e):
                cpu.append(e)
        win = [e for e in cpu if e.name() == WINDOW]
        if not win:
            raise RuntimeError("the traced window's span is missing from the trace")
        self.t0 = win[0].start_ns()
        self.t1 = win[0].start_ns() + win[0].duration_ns()
        self.loop_tid = win[0].start_thread_id()
        corr = {e.correlation_id(): e for e in dev}
        # the host call that launched each device operation
        self.launch = {}
        self.spans = collections.defaultdict(list)
        for e in cpu:
            c = e.correlation_id()
            if c and c in corr and e.name().startswith("cu"):
                self.launch[c] = (e.start_ns(), e.start_thread_id())
            elif e.name() != WINDOW:
                self.spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                             e.start_thread_id(), e.is_user_annotation()))
        self.ops = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                            e.correlation_id()) for e in dev if e.duration_ns() > 0))
        self.ops_in = [o for o in self.ops if o[1] > self.t0 and o[0] < self.t1]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self):
        out = []
        for s, e, _, _ in self.ops_in:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels(self, *parts):
        """Durations (s) of the window's device operations whose name holds
        every one of ``parts``."""
        return [(e - s) * 1e-9 for s, e, n, _ in self.ops_in if all(p in n for p in parts)]

    def _named(self, name):
        """The spans called ``name``, or whose name holds it after a "*"."""
        if name.startswith("*"):
            return [sp for n, v in self.spans.items() if name[1:] in n for sp in v]
        return self.spans.get(name, [])

    def span_count(self, name):
        return sum(1 for s, e, _, _ in self._named(name) if self.t0 <= s < self.t1)

    def span_device_s(self, name):
        """Device seconds of the operations launched inside the window's
        spans called ``name`` (a span counts if it opened in the window)."""
        by_tid = collections.defaultdict(list)
        for s, e, tid, _ in sorted(self._named(name)):
            if not self.t0 <= s < self.t1:
                continue
            iv = by_tid[tid]
            if iv and s <= iv[-1][1]:
                iv[-1][1] = max(iv[-1][1], e)
            else:
                iv.append([s, e])
        starts = {tid: [s for s, _ in iv] for tid, iv in by_tid.items()}
        total = 0
        for s, e, _, c in self.ops:
            at = self.launch.get(c)
            if at is None or at[1] not in by_tid:
                continue
            i = bisect.bisect_right(starts[at[1]], at[0]) - 1
            if i >= 0 and at[0] <= by_tid[at[1]][i][1]:
                total += e - s
        return total * 1e-9

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        charged to the loop thread's innermost open span over their length."""
        by_op = collections.Counter()
        for s, e, n, _ in self.ops_in:
            by_op[n[:160]] += (min(e, self.t1) - max(s, self.t0)) * 1e-9
        gaps = collections.Counter()
        segs = self._host_segments()
        j = 0
        prev = self.t0
        for s, e in self.busy_intervals() + [[self.t1, self.t1]]:
            if s > prev:
                # charge the gap [prev, s] to the host segments it overlaps
                while j < len(segs) and segs[j][1] <= prev:
                    j += 1
                k, at = j, prev
                while at < s:
                    if k < len(segs) and segs[k][0] <= at:
                        end = min(segs[k][1], s)
                        gaps[segs[k][2]] += (end - at) * 1e-9
                        at = end
                        k += 1
                    else:
                        end = min(segs[k][0], s) if k < len(segs) else s
                        gaps["outside any span"] += (end - at) * 1e-9
                        at = end
            prev = max(prev, e)
        return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}

    def _host_segments(self):
        """The loop thread's window cut into (start, end, innermost open
        span) pieces, spans nesting as calls do."""
        host = sorted((s, -e, n) for n, v in self.spans.items() for s, e, tid, ann in v
                      if ann and tid == self.loop_tid and -(-e) > self.t0 and s < self.t1)
        segs, stack, at = [], [], self.t0

        def emit(until):
            nonlocal at
            while stack and stack[-1][0] <= until:
                end, name = stack.pop()
                if end > at:
                    segs.append((at, end, name))
                    at = end
            if stack and until > at:
                segs.append((at, until, stack[-1][1]))
            at = max(at, until)

        for s, neg_e, n in host:
            emit(s)
            stack.append((-neg_e, n))
        emit(self.t1)
        return [(max(a, self.t0), min(b, self.t1), n) for a, b, n in segs if b > a]
