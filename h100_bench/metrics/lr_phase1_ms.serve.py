"""Device time of the kernels launched under the program's
``gop.lr_phase1`` span (resize to the LR scale and phase 1 of the LR
model), per GOP."""


def read(run):
    t = run.trace
    n = t.span_count("gop.lr_phase1") if t else 0
    busy = t.span_device_s("gop.lr_phase1") if n else 0.0
    return 1e3 * busy / (n * run.host["gops_per_step"]) if busy > 0 else None
