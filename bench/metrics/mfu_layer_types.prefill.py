"""mfu_layer_types.prefill: the whole prefill step's share of the card's
bf16 peak in a stack whose layers differ in their mixer.

The model FLOPs of every step of the window (``counts.layer_types.
prefill_flops`` on the configuration's ``arch_config``: two a weight a
token, the routed experts held here at their expected share, causal
attention over the attention layers, the last position's unembedding) over
the window's wall time and 989 TFLOP/s.  Read from the untraced window;
None but in a run of the ``prefill_layer_types`` traffic kind."""
from counts import PEAKS
from counts.layer_types import prefill_flops


def read(run):
    if run.cell.driver != "prefill_layer_types" or run.window is None:
        return None
    c = run.config["arch_config"]
    w = run.window
    flops = sum(prefill_flops(c, B, L) for B, L in w.steps)
    return 100.0 * flops / w.seconds / PEAKS["bf16"]
