"""moe_ms_per_ktok.prefill: device milliseconds of the MoE layers
(``nn.moe.moe_ffn``, the ``bench.moe`` span) per 1,000 prompt tokens of
the profiled stretch."""

SPAN = "bench.moe"


def read(run):
    t = run.trace
    if t is None or not t.calls.get(SPAN) or t.device_s(SPAN) <= 0:
        return None
    tokens = sum(B * L for B, L in t.steps)
    return 1e3 * t.device_s(SPAN) / (tokens / 1e3)
