"""Device time of the operations launched under the program's ``train.loss``
span (the OHEM segmentation losses and the feature loss), per training
step in the traced window."""

from harness import spans


def read(run):
    return spans.device_ms_per_step(run, "train.loss")
