"""attn_bwd_roofline.train: attention's backward share of its roofline.

The least time of every call of K4's backward in the profiled steps (the
larger of four products, twice the forward's FLOPs, at 989 TFLOP/s and q,
k, v, o, dO read with dq, dk, dv written once at 3.35 TB/s,
``counts.attention_bwd``) over the device time the profiler attributes to
the ``bench.attn_bwd`` span."""
from counts import attention_bwd, least_seconds

SPAN = "bench.attn_bwd"


def read(run):
    t = run.trace
    if t is None or not t.calls.get(SPAN) or t.device_s(SPAN) <= 0:
        return None
    least = sum(least_seconds(*attention_bwd(*shape), "bf16")
                for shape in t.calls[SPAN])
    return 100.0 * least / t.device_s(SPAN)
