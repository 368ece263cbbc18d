"""Device time of the operations launched under the program's
``train.update`` span (the optimizer's step: Adam on the float32 masters),
per training step in the traced window."""

from harness import spans


def read(run):
    return spans.device_ms_per_step(run, "train.update")
