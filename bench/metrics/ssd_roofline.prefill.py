"""ssd_roofline.prefill: the SSD intra-chunk step's share of its roofline.

The least time of every call of ``kernels.ops.ssd_intra_chunk`` in the
profiled stretch (the larger of its products, each counted once, at the
TF32 rate of 495 TFLOP/s and its float32 bytes at 3.35 TB/s,
``counts.ssd_intra``) over the device time the profiler attributes to the
``bench.ssd_intra`` span."""
from counts import least_seconds, ssd_intra

SPAN = "bench.ssd_intra"


def read(run):
    t = run.trace
    if t is None or not t.calls.get(SPAN) or t.device_s(SPAN) <= 0:
        return None
    least = sum(least_seconds(*ssd_intra(*shape), "tf32")
                for shape in t.calls[SPAN])
    return 100.0 * least / t.device_s(SPAN)
