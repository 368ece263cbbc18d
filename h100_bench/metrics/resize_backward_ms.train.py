"""Device time of the kernels launched under the autograd nodes of bilinear
resize's backward, per training step in the traced window: PyTorch's own
(``UpsampleBilinear2DBackward0``, the atomic scatter) where the program
leaves the backward to it, and the port's gather form
(``BilinearResizeBackward``, ``ops/resize_kernel.py``) where it has one."""


def read(run):
    t = run.trace
    if not t:
        return None
    busy = sum(t.span_device_s(n) for n in ("*UpsampleBilinear2DBackward",
                                            "*BilinearResizeBackward"))
    return 1e3 * busy / run.host["traced_steps"] if busy > 0 else None
