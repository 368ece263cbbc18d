"""Device time of the operations launched under the program's
``train.teacher`` span (the frozen teacher's forwards on the frame and the
keyframe, the flow resize and K2's warp of the key feature), per training
step in the traced window."""

from harness import spans


def read(run):
    return spans.device_ms_per_step(run, "train.teacher")
