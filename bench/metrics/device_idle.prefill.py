"""device_idle.prefill: the share of the traced steps' untraced time in
which no operation ran on the card (:func:`harness.trace.idle_share`: the
union of device activity in the profiled stretch over the window's mean
wall time of steps of the same shapes, so the profiler's own cost on the
host is left out)."""
from harness.trace import idle_share


def read(run):
    if run.cell.driver != "prefill_closed":
        return None
    return idle_share(run.trace, run.window)
