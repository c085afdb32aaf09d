"""device_idle.train: the share of the traced training steps' untraced
time in which no operation ran on the card
(:func:`harness.trace.idle_share`: the union of device activity in the
profiled stretch over the window's mean wall time of a step, so the
profiler's own cost on the host is left out)."""
from harness.trace import idle_share


def read(run):
    if run.cell.driver != "train_steps":
        return None
    return idle_share(run.trace, run.window)
