"""Device time of the kernels launched under the program's ``psp.decoder``
span (``nn/pspnet.py``: the PSP module and the three x2 upsamples, for the
keyframe inside ``gop.hr_key`` and the LR frames inside ``gop.lr_phase1``),
per GOP."""


def read(run):
    t = run.trace
    n = t.span_count("psp.decoder") if t else 0
    busy = t.span_device_s("psp.decoder") if n else 0.0
    gops = run.host.get("traced_steps", 0) * run.host.get("gops_per_step", 0)
    return 1e3 * busy / gops if busy > 0 and gops else None
