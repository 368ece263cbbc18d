"""Host time the serving loop waited in ``next(feeder)`` for the next
staged batch of GOPs, per step, over the traced run's window."""


def read(run):
    waits = run.host.get("feed_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
