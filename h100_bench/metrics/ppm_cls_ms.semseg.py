"""Device time of the kernels launched under the program's
``semseg.ppm_cls`` span (``nn/pspnet_semseg.py``: the PPM and ``cls[:4]``,
whose 3x3 conv 1024 -> 512 is the largest conv of the model, for the
keyframe inside ``gop.hr_key`` and the LR frames inside ``gop.lr_phase1``),
per GOP."""


def read(run):
    t = run.trace
    n = t.span_count("semseg.ppm_cls") if t else 0
    busy = t.span_device_s("semseg.ppm_cls") if n else 0.0
    gops = run.host.get("traced_steps", 0) * run.host.get("gops_per_step", 0)
    return 1e3 * busy / gops if busy > 0 and gops else None
