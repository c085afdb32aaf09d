"""Deterministic fault injection for the port's device and service sites.

Counterpart of ``repro.comm.faults``.  Every device call on the pricing
path, and every I/O point of the strategy service, passes through a **named
injection site**; an armed site can *raise*, *time out*, *NaN-poison* its
output or *corrupt* it — deterministically (no randomness, an optional
fire count), so a chaos run reproduces exactly.

Sites (:data:`SITES`):

==========================  =================================================
``kernel.segment_reduce``   each call of K1 (``kernels.comm_stack``)
``kernel.queue_walk``       each call of K2 (``kernels.comm_stack``)
``stack.device_store``      arena column shipping (``comm.stack.put_column``)
``serve.cache_read``        strategy-service arena-cache read
``serve.cache_write``       strategy-service arena-cache write
``serve.deadline``          strategy-service per-request deadline check
==========================  =================================================

The reference's three ``autotune.*`` sites are not here: the port has no
numpy/jax autotune (one backend, the device the caller names).

Modes (:data:`MODES`): ``raise`` (an :class:`InjectedFault`), ``timeout``
(an :class:`InjectedTimeout`, also a ``TimeoutError``/``OSError``),
``nan`` (float outputs filled with NaN) and ``corrupt`` (numeric outputs
shifted off their true values, strings and bytes garbled).

Arming a site, two equivalent ways:

* the :func:`inject` context manager (tests)::

      with inject("kernel.segment_reduce", "raise"):
          ...  # every K1 launch raises inside the block

* the ``REPRO_FAULT_INJECT`` env var (chaos runs): a comma-separated list
  of ``site:mode`` or ``site:mode:times`` entries, where ``site`` may be a
  glob (``kernel.*:raise,serve.cache_read:timeout:1``).

Instrumented code calls :func:`fail_point` (raises for armed raise/timeout
specs) and :func:`poison` (transforms outputs for armed nan/corrupt specs);
both are no-ops when nothing matches.  In the port nothing catches at a
device site and nothing falls back: a raise reaches the caller — on the
service path, the service, which records it and answers with an error
result.  A poisoned device output (K1's sums and maxima, K2's steps, an
arena column) is caught, when ``REPRO_STACK_VERIFY`` asks for it, by the
post-kernel check of :mod:`repro_torch.kernels.comm_stack`, which raises
``BackendVerifyError``; with the check off it passes through.  The
service's cache sites poison their bytes, which the cache's checksum
catches.

Port note: a copy of the reference's plan language, matching and poison
(str, bytes, numpy arrays and tuples of them), whose poison also takes
torch tensors with the same semantics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import os

import numpy as np
import torch

__all__ = ["SITES", "MODES", "FaultSpec", "InjectedFault", "InjectedTimeout",
           "inject", "fail_point", "poison", "active_specs", "any_armed",
           "ENV_VAR"]

#: Named injection sites on the port's device path and service.
SITES = (
    "kernel.segment_reduce",
    "kernel.queue_walk",
    "stack.device_store",
    "serve.cache_read",
    "serve.cache_write",
    "serve.deadline",
)

#: Injection modes: raise / timeout fire at :func:`fail_point`, nan /
#: corrupt transform outputs at :func:`poison`.
MODES = ("raise", "timeout", "nan", "corrupt")

#: Env var holding the process-wide fault plan (chaos runs):
#: ``site:mode[:times]`` entries, comma-separated; ``site`` may be a glob.
ENV_VAR = "REPRO_FAULT_INJECT"


class InjectedFault(RuntimeError):
    """A deterministic injected failure (mode ``raise``)."""


class InjectedTimeout(InjectedFault, TimeoutError):
    """An injected timeout (mode ``timeout``).

    Also a ``TimeoutError`` (hence ``OSError``), so the disk-cache paths —
    which guard against real I/O failures — see the same exception family
    a genuine timeout would produce.
    """


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: ``mode`` at every site matching ``site``.

    ``site`` is an exact name or an ``fnmatch`` glob; ``times`` caps how
    often the spec fires (None = every time); ``fired`` counts firings —
    the :func:`inject` context manager yields the spec so tests can assert
    exactly how many times the fault triggered.
    """

    site: str
    mode: str
    times: int | None = None
    fired: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")

    def matches(self, site: str) -> bool:
        """Whether this spec covers ``site`` (exact or glob match)."""
        return self.site == site or fnmatch.fnmatchcase(site, self.site)

    @property
    def armed(self) -> bool:
        """Whether the spec can still fire (``times`` not exhausted)."""
        return self.times is None or self.fired < self.times

    def fire(self) -> None:
        """Count one firing."""
        self.fired += 1


# context-manager-armed specs, innermost last (fires before env specs)
_stack: list[FaultSpec] = []
# parsed env plans, keyed by the raw env string (the env can change
# between calls — monkeypatched tests — so the parse is keyed, not frozen)
_env_cache: dict[str, tuple[FaultSpec, ...]] = {}


def _parse_env(raw: str) -> tuple[FaultSpec, ...]:
    specs = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad {ENV_VAR} entry {entry!r}; expected site:mode or "
                "site:mode:times")
        times = int(parts[2]) if len(parts) == 3 else None
        specs.append(FaultSpec(site=parts[0], mode=parts[1], times=times))
    return tuple(specs)


def _env_specs() -> tuple[FaultSpec, ...]:
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return ()
    if raw not in _env_cache:
        _env_cache.clear()                    # one plan per process at a time
        _env_cache[raw] = _parse_env(raw)
    return _env_cache[raw]


def active_specs() -> tuple[FaultSpec, ...]:
    """Every armed spec, innermost context first, then the env plan."""
    return tuple(s for s in (*reversed(_stack), *_env_specs()) if s.armed)


def any_armed() -> bool:
    """Whether any fault spec is currently armed (context or env)."""
    return bool(active_specs())


def _match(site: str, modes: tuple[str, ...]) -> FaultSpec | None:
    for spec in active_specs():
        if spec.mode in modes and spec.matches(site):
            return spec
    return None


@contextlib.contextmanager
def inject(site: str, mode: str = "raise", times: int | None = None):
    """Arm ``mode`` at every site matching ``site`` for the block.

    ``site`` is an exact name from :data:`SITES` or an ``fnmatch`` glob;
    ``times`` caps how often the spec fires (None = every time).  Yields
    the armed :class:`FaultSpec` (inspect ``spec.fired`` afterwards).
    Nested injections stack; the innermost matching spec fires first.
    """
    spec = FaultSpec(site=site, mode=mode, times=times)
    _stack.append(spec)
    try:
        yield spec
    finally:
        _stack.remove(spec)


def fail_point(site: str) -> None:
    """The raise/timeout trigger, called on entry to an instrumented site.

    Raises :class:`InjectedFault` / :class:`InjectedTimeout` when an armed
    ``raise`` / ``timeout`` spec matches ``site``; otherwise a no-op.
    """
    spec = _match(site, ("raise", "timeout"))
    if spec is None:
        return
    spec.fire()
    if spec.mode == "timeout":
        raise InjectedTimeout(f"injected timeout at {site}")
    raise InjectedFault(f"injected failure at {site}")


def _poison_value(value, mode: str):
    if isinstance(value, tuple):
        return tuple(_poison_value(v, mode) for v in value)
    if isinstance(value, (str, bytes)):
        junk = "\x00corrupt\x00" if isinstance(value, str) else b"\x00corrupt\x00"
        return junk + value
    if isinstance(value, torch.Tensor):
        return _poison_tensor(value, mode)
    arr = np.asarray(value)
    if mode == "nan":
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, np.nan)
        # integer outputs cannot hold NaN; shifting them instead would hide
        # the damage from a finite check, which only inspects float leaves
        return value
    # corrupt: shift every element detectably off its true value — a
    # relative bump for floats (an absolute +1 would vanish against large
    # magnitudes in an allclose check) and +1 for integers
    if np.issubdtype(arr.dtype, np.floating):
        return arr * 1.01 + 1.0
    return arr + np.ones_like(arr)


def _poison_tensor(t: torch.Tensor, mode: str) -> torch.Tensor:
    # a new tensor on the same device, never a write through ``t``: K1's
    # sums and maxima are two views of one buffer
    if mode == "nan":
        return torch.full_like(t, float("nan")) if t.is_floating_point() \
            else t
    if t.is_floating_point():
        return t * 1.01 + 1.0
    return t + torch.ones_like(t)


def poison(site: str, value):
    """The output-poisoning trigger, called on an instrumented site's result.

    When an armed ``nan`` / ``corrupt`` spec matches ``site``, returns a
    poisoned copy of ``value`` (tuples poison element-wise; float arrays
    and tensors are NaN-filled under ``nan``, which leaves integer outputs
    intact; ``corrupt`` shifts numeric outputs off their true values and
    garbles strings and bytes).  A tensor's poisoned copy is a new tensor
    on its device.  Otherwise returns ``value`` unchanged.
    """
    spec = _match(site, ("nan", "corrupt"))
    if spec is None:
        return value
    spec.fire()
    return _poison_value(value, spec.mode)
