"""The port's own spans and counters.

A span marks one layer's work where it happens (``with obs.span(name):``);
a counter adds up what a layer did (``obs.count(name, value)``).  Both
record only while recording is on:

- while ``torch.profiler`` records in the calling thread (its active
  cycle; not its wait or warm-up cycles), so the program traces itself
  exactly where a profile is taken, and the profiler's own trace
  (``export_chrome_trace``) shows the program's spans beside its kernels;
- inside :func:`recording`, for every thread of the process, with no
  profiler running.

Off, :func:`span` and :func:`count` read one flag and return: no
``record_function``, no CUDA event, no tensor op.  On, a span

- opens ``torch.profiler.record_function(name)``, so it lies in the
  profiler's timeline on the kernels' clock;
- keeps a :class:`Span`: name, id, parent id, step id, thread, host start
  and end (``time.perf_counter_ns``) and the attributes it was given;
- where the process uses CUDA, records a timing ``torch.cuda.Event`` at
  its entry and at its exit, both on the stream current at its entry
  (events come from a pool), from which :func:`snapshot` gives its
  device start and end.

Each thread has its own stack of open spans (ranks of
``launch.mesh.run_ranks`` are threads, and autograd runs the backward and
the recompute of checkpointed layers on threads of its own).  A step span
(:func:`step`) opens a new step id, which every span inside it carries; a
span opened on a thread with no open span (autograd's) carries the latest
step opened.  A step span also keeps the hand-written kernels' launches in
it: the change of the ``LAUNCHES`` counts of K1-K5 and of the Mamba2
mixer's prologue and epilogue kernels over the step.

Spans of the port (each name prefixed ``repro_torch.``):

=================  ==========================================================
``prefill_step``   ``launch.steps.make_prefill_step``'s step (a step span;
                   attributes ``B``, ``L``)
``train_step``     ``launch.steps.make_train_step``'s step (a step span)
``layer``          one decoder layer (``nn.blocks.block_forward``; ``type``
                   its mixer: ``mamba``, ``attention`` or ``hybrid``)
``attention``      self-attention (``nn.attention.attention``)
``attn_core``      K4 (``kernels.ops.mha_flash``; ``B S H KH D causal``)
``ssm``            the Mamba2 mixer (``nn.ssm.ssm_mixer``)
``ssd_intra``      K5, the SSD intra-chunk step (``G h q n p``)
``ssd_inter``      the SSD inter-chunk recurrence and its product ``C S_in``
``mlp``            a dense layer's MLP (not the shared experts)
``moe``            the MoE layer (``nn.moe.moe_ffn``)
``moe.route``      its router (``nn.moe.route``)
``moe.dispatch``   the gather into the capacity buffer (``nn.moe.dispatch``)
``moe.experts``    the experts' products (``nn.moe.experts``)
``moe.combine``    the gather back and scatter-add (``nn.moe.combine``)
``moe.shared``     the shared experts
``cache``          building the decode cache after prefill
``unembed``        the logits
``loss``           ``nn.model.lm_loss``
``grads``          the loss and its gradients (``launch.steps.grads_of``)
``optimizer``      ``train.optim.adamw_update``
``attn_bwd``       K4's backward (``B S H KH D causal``)
``ssd_bwd``        K5's backward
=================  ==========================================================

Counters: ``ssm.calls`` (Mamba2 mixer calls) and ``ssm.fused`` (those on
its fused prologue and epilogue kernels, ``nn.ssm.ssm_mixer``);
``moe.assignments`` (token-expert assignments routed, D T K a
routing chunk), ``moe.local`` (those to experts this layer holds, counted
on the device), ``moe.slots`` (rows of the ``[D, E, C, d]`` capacity
buffer, D E C, E the experts held) and ``moe.kept`` (assignments that
found a slot, counted on the device); dropped assignments are ``moe.local -
moe.kept``, and ``moe.slots - moe.kept`` rows of the buffer are zeros.

:func:`snapshot` reads everything recorded so far and clears nothing;
:func:`reset` clears it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled

#: :func:`recording` contexts open in the process.
_held = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_last_step: int | None = None
#: A counter's device values are summed, one sum a device, once it holds
#: this many.
_FOLD = 256


@dataclasses.dataclass
class Span:
    """One recorded span.  ``parent`` and ``step`` are ids of other spans'
    records (None at a thread's outermost span, or outside every step);
    ``thread`` is ``threading.get_ident()``; host times are
    ``time.perf_counter_ns``; ``attrs`` are the keywords it was opened
    with.  ``device`` is the CUDA device index of its
    events (None without CUDA), ``device_start_ns`` and ``device_end_ns``
    its events on the host clock (filled by :func:`snapshot`), and
    ``launches`` a step span's hand-written launches, by kernel."""
    name: str
    id: int
    parent: int | None
    step: int | None
    thread: int
    host_start_ns: int
    host_end_ns: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    device: int | None = None
    device_start_ns: int | None = None
    device_end_ns: int | None = None
    launches: dict | None = None

    @property
    def device_s(self) -> float | None:
        """Its device wall: from the event at its entry to the one at its
        exit, idle inside it included; None without events."""
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e9


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """What was recorded: closed spans in the order they closed,
    counters by name, and the hand-written launches of the recorded steps
    (``launches``, summed over ``steps`` step spans)."""
    spans: tuple
    counters: dict
    launches: dict
    steps: int

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def device_s(self, *names: str) -> float | None:
        """The device walls of every span of ``names``, summed; None where
        there is none, or one has no device times."""
        walls = [s.device_s for s in self.spans if s.name in names]
        if not walls or None in walls:
            return None
        return sum(walls)

    def launches_per_step(self) -> dict:
        return {k: v / self.steps for k, v in self.launches.items()} \
            if self.steps else {}


class _Recorder:
    """Closed spans, their events, counters and the event pool, shared by
    every thread under :data:`_lock`."""

    def __init__(self):
        self.spans: list[Span] = []
        self.events: dict[int, tuple] = {}
        self.host: dict[str, int | float] = {}
        self.device: dict[str, list] = {}
        self.pool: dict[int, list] = {}

    def pair(self, dev: int) -> list:
        """Two timing events of device ``dev``, from the pool where it
        has them."""
        with _lock:
            free = self.pool.setdefault(dev, [])
            got = [free.pop() for _ in range(min(2, len(free)))]
        return got + [torch.cuda.Event(enable_timing=True)
                      for _ in range(2 - len(got))]

    def close(self, rec: Span, events) -> None:
        with _lock:
            self.spans.append(rec)
            if events is not None:
                self.events[rec.id] = events

    def add(self, name: str, value) -> None:
        with _lock:
            if not isinstance(value, torch.Tensor):
                self.host[name] = self.host.get(name, 0) + value
                return
            held = self.device.setdefault(name, [])
            held.append(value)
            if len(held) >= _FOLD:
                self.device[name] = _fold(held)

    def clear(self) -> None:
        with _lock:
            for rec in self.spans:
                events = self.events.get(rec.id)
                if events is not None:
                    self.pool.setdefault(rec.device, []).extend(events)
            self.spans, self.events = [], {}
            self.host, self.device = {}, {}


_REC = _Recorder()


def _fold(tensors: list) -> list:
    """0-d tensors summed on their devices: one sum a device."""
    by_dev: dict = {}
    for t in tensors:
        by_dev.setdefault(t.device, []).append(t)
    return [torch.stack(ts).sum() for ts in by_dev.values()]


def on() -> bool:
    """Whether spans and counters record here and now."""
    return _held > 0 or _profiling()


@contextlib.contextmanager
def recording():
    """Recording on in every thread of the process for the duration,
    with or without a profiler."""
    global _held
    with _lock:
        _held += 1
    try:
        yield
    finally:
        with _lock:
            _held -= 1


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _launch_counts() -> dict:
    """The ``LAUNCHES`` counts of K1-K5 and of the mixer's prologue and
    epilogue, in one dict."""
    from repro_torch.kernels import (comm_stack, flash_attention, spmv_ell,
                                     ssd, ssm_mixer)

    out: dict = {}
    for table in (comm_stack.LAUNCHES, spmv_ell.LAUNCHES,
                  flash_attention.LAUNCHES, ssd.LAUNCHES, ssm_mixer.LAUNCHES):
        out.update(table)
    return out


#: The context :func:`span` returns while recording is off.
_NULL = contextlib.nullcontext()


class _Open:
    """A span that records: see the module's docstring."""
    __slots__ = ("name", "attrs", "new_step", "rec", "rf", "events",
                 "stream", "base")

    def __init__(self, name: str, attrs: dict, new_step: bool):
        self.name, self.attrs, self.new_step = name, attrs, new_step

    def __enter__(self):
        global _last_step
        stack = _stack()
        parent = stack[-1] if stack else None
        sid = next(_ids)
        if self.new_step:
            step = _last_step = sid
        else:
            step = parent.step if parent is not None else _last_step
        rec = self.rec = Span(
            self.name, sid, parent.id if parent is not None else None, step,
            threading.get_ident(), 0, attrs=self.attrs)
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        stack.append(rec)
        self.base = _launch_counts() if self.new_step else None
        self.events = None
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            rec.device = self.stream.device_index
            self.events = _REC.pair(rec.device)
            self.events[0].record(self.stream)
        rec.host_start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.events is not None:
            self.events[1].record(self.stream)
        rec.host_end_ns = time.perf_counter_ns()
        if self.base is not None:
            now = _launch_counts()
            rec.launches = {k: now[k] - v for k, v in self.base.items()
                            if now[k] != v}
        _stack().pop()
        _REC.close(rec, self.events)
        self.rf.__exit__(*exc)
        return None


def span(name: str, **attrs):
    """A context that records span ``name`` with ``attrs`` while recording
    is on (:func:`on`), else a shared no-op context."""
    if not on():
        return _NULL
    return _Open(name, attrs, False)


def step(name: str, **attrs):
    """:func:`span` that opens a new step id (its own id) for every span
    inside it, and keeps the hand-written launches made in it."""
    if not on():
        return _NULL
    return _Open(name, attrs, True)


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while recording is on: a host
    number at once, a 0-d tensor kept on its device until
    :func:`snapshot` reads it."""
    if on():
        _REC.add(name, value)


def _anchors(devices) -> dict:
    """For each CUDA device, after a synchronize: (an event recorded
    now, the host time just after it completed)."""
    out = {}
    for dev in devices:
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            out[dev] = (ev, time.perf_counter_ns())
    return out


def snapshot() -> Snapshot:
    """Everything recorded so far, each span's events turned into device
    times on the host clock; clears nothing."""
    with _lock:
        spans = list(_REC.spans)
        events = dict(_REC.events)
        counters = dict(_REC.host)
        device = {k: list(v) for k, v in _REC.device.items()}
    anchors = _anchors({s.device for s in spans if s.id in events})
    out = []
    for s in spans:
        ev = events.get(s.id)
        if ev is not None:
            anchor, host_ns = anchors[s.device]
            start = host_ns - round(ev[0].elapsed_time(anchor) * 1e6)
            s = dataclasses.replace(
                s, device_start_ns=start,
                device_end_ns=start + round(ev[0].elapsed_time(ev[1]) * 1e6))
        out.append(s)
    for name, held in device.items():
        for t in _fold(held):
            counters[name] = counters.get(name, 0) + t.item()
    steps = [s for s in out if s.launches is not None]
    launches: dict = {}
    for s in steps:
        for k, v in s.launches.items():
            launches[k] = launches.get(k, 0) + v
    return Snapshot(tuple(out), counters, launches, len(steps))


def reset() -> None:
    """Clear the spans, counters and launches recorded (events go back to
    the pool)."""
    _REC.clear()
