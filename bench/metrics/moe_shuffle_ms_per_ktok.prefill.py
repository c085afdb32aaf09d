"""moe_shuffle_ms_per_ktok.prefill: device milliseconds of the MoE
layers' routing, dispatch and combine (``nn.moe.route``, ``dispatch`` and
``combine``, the program's own ``repro_torch.moe.route``,
``repro_torch.moe.dispatch`` and ``repro_torch.moe.combine`` spans), the
work around the expert products, per 1,000 prompt tokens of the profiled
stretch.

A span's time is its device wall, from the CUDA event the program records
at its entry to the one at its exit (idle inside it included), read from
the program's recorder (``repro_torch.obs.snapshot()``), which records
while the profiler's active cycle runs.  None without a trace, or where
the program has no recorder or recorded no such span."""

SPANS = ("repro_torch.moe.route", "repro_torch.moe.dispatch",
         "repro_torch.moe.combine")


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    device_s = obs.snapshot().device_s(*SPANS)
    tokens = sum(B * L for B, L in t.steps)
    if not device_s or not tokens:
        return None
    return 1e3 * device_s / (tokens / 1e3)
