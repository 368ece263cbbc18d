"""Host time of the program's ``loader.stage`` spans (``data/loader.py``
``_stage``: pinned copies, the device allocation and the enqueued H2D
copies of a staged batch), per traced step."""

from harness import spans


def read(run):
    t = run.trace
    if t is None or not spans.opened(t, "loader.stage") or not run.host.get("traced_steps"):
        return None
    return 1e3 * spans.host_s(t, "loader.stage") / run.host["traced_steps"]
