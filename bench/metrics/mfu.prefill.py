"""mfu.prefill: the whole prefill step's share of the card's bf16 peak.

The model FLOPs of every step of the window (``counts.prefill_flops``: two
a weight a token, causal attention, the last position's unembedding) over
the window's wall time and 989 TFLOP/s.  Read from the untraced window."""
from counts import PEAKS, prefill_flops


def read(run):
    if run.cell.driver != "prefill_closed":
        return None
    w = run.window
    flops = sum(prefill_flops(run.config, B, L) for B, L in w.steps)
    return 100.0 * flops / w.seconds / PEAKS["bf16"]
