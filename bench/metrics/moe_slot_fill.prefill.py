"""moe_slot_fill.prefill: the share (%) of the MoE capacity buffer's rows
(``nn.moe.dispatch``'s ``[D, E, C, d]``) that hold a token: the program's
``moe.kept`` counter (assignments that found a slot) over its
``moe.slots`` (D E C a routing chunk), summed over the profiled stretch.
The rest are zeros that the expert products compute all the same.

Read from the program's recorder (``repro_torch.obs.snapshot()``), which
counts while the profiler's active cycle runs.  None without a trace, or
where the program has no recorder or counted no slot."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    counters = obs.snapshot().counters
    if not counters.get("moe.slots") or "moe.kept" not in counters:
        return None
    return 100.0 * counters["moe.kept"] / counters["moe.slots"]
