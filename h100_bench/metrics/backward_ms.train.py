"""Device time of the operations launched from any thread while the
program's ``train.backward`` span (``loss.backward()``) was open, per
training step in the traced window. Autograd launches the backward from
its own device thread, so the attribution is by time, not by thread."""

from harness import spans


def read(run):
    t = run.trace
    busy = spans.launched_within_s(t, "train.backward") if t else 0.0
    return 1e3 * busy / run.host["traced_steps"] if busy > 0 else None
