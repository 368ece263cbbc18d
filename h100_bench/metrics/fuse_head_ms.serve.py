"""Device time of the kernels launched under the program's
``gop.fuse_head`` span (the CReFF fusion, K1, and the planes head: 1x1
conv, x8 bilinear, argmax), per GOP."""


def read(run):
    t = run.trace
    n = t.span_count("gop.fuse_head") if t else 0
    busy = t.span_device_s("gop.fuse_head") if n else 0.0
    return 1e3 * busy / (n * run.host["gops_per_step"]) if busy > 0 else None
