"""device_idle_layer_types.prefill: ``device_idle.prefill``'s share for a
stack whose layers differ in their mixer: the share of the traced steps'
untraced time in which no operation ran on the card
(:func:`harness.trace.idle_share`).  None but in a run of the
``prefill_layer_types`` traffic kind."""
from harness.trace import idle_share


def read(run):
    if run.cell.driver != "prefill_layer_types":
        return None
    return idle_share(run.trace, run.window)
