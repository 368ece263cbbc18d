"""Device time of the kernels launched under the program's
``gop.head_chunk`` span, per GOP: the resize-and-argmax head of the LR
frames, a launch of ``csrc/resize_bilinear_argmax.cu`` a step in the
pipeline's fallback head and in BiSeNet's planes head (a program without
that kernel opens the span around each chunk of its fallback head's
``F.interpolate`` and ``argmax``, and none in BiSeNet's head). None where
no such span ran."""


def read(run):
    t = run.trace
    n = t.span_count("gop.head_chunk") if t else 0
    busy = t.span_device_s("gop.head_chunk") if n else 0.0
    gops = run.host.get("traced_steps", 0) * run.host.get("gops_per_step", 0)
    return 1e3 * busy / gops if busy > 0 and gops else None
