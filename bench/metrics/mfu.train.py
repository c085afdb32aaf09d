"""mfu.train: the whole training step's share of the card's bf16 peak.

The model FLOPs of every step of the window (``counts.train_flops``: three
times the forward's, recomputation not counted) over the window's wall time
and 989 TFLOP/s.  Read from the untraced window."""
from counts import PEAKS, train_flops


def read(run):
    if run.cell.driver != "train_steps":
        return None
    w = run.window
    flops = sum(train_flops(run.config, B, L) for B, L in w.steps)
    return 100.0 * flops / w.seconds / PEAKS["bf16"]
