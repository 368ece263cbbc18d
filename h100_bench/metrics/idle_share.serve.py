"""The share of the traced window in which no operation ran on the card
(1 - the union of device operations' intervals / the window), percent."""


def read(run):
    t = run.trace
    return 100 * (1 - t.busy_s / t.window_s) if t and t.busy_s > 0 else None
