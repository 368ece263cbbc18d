"""Device time of the kernels launched under the autograd node of K1's
composed backward (``_CreffLocalModuleBackward``, ``ops/local_attention.py``),
per training step in the traced window."""


def read(run):
    t = run.trace
    busy = t.span_device_s("*_CreffLocalModuleBackward") if t else 0.0
    return 1e3 * busy / run.host["traced_steps"] if busy > 0 else None
