"""Device time of the operations launched under the program's
``train.student`` span (the resize to the LR scale and the student's
forward, K1 included), per training step in the traced window."""

from harness import spans


def read(run):
    return spans.device_ms_per_step(run, "train.student")
