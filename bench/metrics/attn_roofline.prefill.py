"""attn_roofline.prefill: the attention core's share of its roofline.

The least time of every call of ``kernels.ops.mha_flash`` in the profiled
stretch (the larger of its causal FLOPs at 989 TFLOP/s and q, k, v, o once
at 3.35 TB/s, ``counts.attention_fwd``) over the device time the profiler
attributes to the ``bench.attn_core`` span."""
from counts import attention_fwd, least_seconds

SPAN = "bench.attn_core"


def read(run):
    t = run.trace
    if t is None or not t.calls.get(SPAN) or t.device_s(SPAN) <= 0:
        return None
    least = sum(least_seconds(*attention_fwd(*shape), "bf16")
                for shape in t.calls[SPAN])
    return 100.0 * least / t.device_s(SPAN)
