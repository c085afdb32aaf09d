"""A profiled stretch of steps, reduced to what the per-layer metrics read.

``torch.profiler`` (CPU and CUDA activity) runs over a few steps after the
window, with the spans of :mod:`harness.spans` put in, after as many under
its warm-up.  The trace stays in
memory; only this summary leaves it:

- ``window_s``: the stretch's length on the host (the ``bench.stretch``
  span, which ends in a synchronize), the profiler's own cost on the host
  included;
- ``busy_s``: the union of the intervals in which any device activity
  (kernel, copy, set) ran, clipped to the stretch: overlapping kernels
  count once;
- ``span_device_s``: for each ``bench.*`` span, the device time the
  profiler attributes to its host side (its kernels and its child ops'
  kernels), summed over its calls, and ``calls`` their shapes; the
  profiler's device-side copy of a span, which lasts from its first
  kernel to its last, is not counted again;
- ``device_ops``: the device operations that took the most time, by name;
- ``idle_gaps``: the device's idle time inside the stretch, each gap named
  by the innermost ``bench.*`` span open on the host at its middle, summed
  by name.
"""
from __future__ import annotations

import dataclasses
import heapq

import torch

from . import spans


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    span_device_s: dict
    calls: dict
    device_ops: list
    idle_gaps: list
    steps: list

    def device_s(self, span: str) -> float:
        return self.span_device_s.get(span, 0.0)


def _device_kind(e) -> bool:
    """Device activity: a kernel, copy or set (the profiler's device-side
    copy of a span, a user annotation, is no activity)."""
    return e.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(e, "is_user_annotation", False)


def _host_kind(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CPU


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def gaps_within(merged, lo: float, hi: float):
    """The holes of ``merged`` inside [lo, hi]."""
    t = lo
    for a, b in merged:
        if a > t:
            yield t, min(a, hi)
        t = max(t, b)
        if t >= hi:
            return
    if t < hi:
        yield t, hi


def name_gaps(gaps, host_spans) -> dict[str, float]:
    """Each gap's length summed under the innermost span (the latest
    start) open on the host at its middle, ``bench.stretch`` where none
    is: one sweep over gaps and spans, both in time order."""
    out: dict[str, float] = {}
    open_: list = []            # heap of (-start, end, name)
    i = 0
    for a, b in sorted(gaps):
        t = (a + b) / 2
        while i < len(host_spans) and host_spans[i][0] <= t:
            s0, s1, name = host_spans[i]
            heapq.heappush(open_, (-s0, s1, name))
            i += 1
        while open_ and open_[0][1] < t:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else "bench.stretch"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def summarize(events, calls: dict, steps: list) -> Trace:
    """:class:`Trace` of a profile's ``events()`` (times in us)."""
    stretch = [e for e in events if e.name == "bench.stretch"
               and _host_kind(e)]
    if not stretch:
        raise RuntimeError("the profile holds no bench.stretch span")
    lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
    dev, by_name, span_dev, host_spans = [], {}, {}, []
    for e in events:
        if _device_kind(e):
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                dev.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start)
        elif _host_kind(e) and e.name.startswith("bench.") \
                and e.name != "bench.stretch":
            span_dev[e.name] = span_dev.get(e.name, 0.0) + e.device_time_total
            host_spans.append((e.time_range.start, e.time_range.end, e.name))
    merged = union(dev)
    busy = sum(b - a for a, b in merged)
    host_spans.sort()
    idle = name_gaps(gaps_within(merged, lo, hi), host_spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                 span_device_s={k: v / 1e6 for k, v in span_dev.items()},
                 calls=calls, device_ops=[[k, v / 1e6] for k, v in top],
                 idle_gaps=[[k, v / 1e6] for k, v in gaps], steps=steps)


def idle_share(found: Trace | None, window) -> float | None:
    """The share (%) of the traced steps' time in which the card ran
    nothing: 1 - ``busy_s`` over what the same steps take untraced, each
    step's shape at the window's mean wall time of steps of that shape.
    None where there is no trace, no device activity, or a traced shape
    that the window did not run."""
    if found is None or found.busy_s <= 0:
        return None
    by_shape: dict = {}
    for shape, s in zip(window.steps, window.step_s):
        by_shape.setdefault(tuple(shape), []).append(s)
    if any(tuple(shape) not in by_shape for shape in found.steps):
        return None
    untraced = sum(sum(v) / len(v) for v in
                   (by_shape[tuple(shape)] for shape in found.steps))
    return 100.0 * (1.0 - found.busy_s / untraced)


def profile_stretch(run_steps, sync) -> Trace:
    """Profile ``run_steps()`` (which runs the stretch's steps and returns
    their shapes) with the layer spans in, then ``sync()``.  The steps run
    twice: first under the profiler's warm-up, whose events are dropped,
    so that its start-up does not fall into the stretch."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    calls = spans.Calls()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with spans.installed(calls):
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            run_steps()
            sync()
            prof.step()
            calls.on = True
            with record_function("bench.stretch"):
                steps = run_steps()
                sync()
            calls.on = False
            prof.step()
    return summarize(prof.events(), calls.shapes, steps)
