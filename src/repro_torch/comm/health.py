"""Device health accounting: failure events, circuit breakers, warn-once.

Counterpart of ``repro.comm.health``.  The port has one backend, the torch
device a caller names, and no fallback: a failed device call (an injected
fault, a build or launch error, an oversized arena) raises to its caller.
What this module keeps is the per-process ledger the strategy service
(:class:`repro_torch.serve.StrategyService`) and the verdict cache
(:class:`repro_torch.serve.ArenaCache`) report those failures to:

* :class:`BackendHealth` keeps a **bounded** event ring (the newest
  ``max_events`` events; :attr:`BackendHealth.dropped_events` counts what
  the ring dropped and :attr:`BackendHealth.n_events` stays the monotone
  total, so snapshot-and-compare probes keep working across a wrap).
* The same object owns the process's **resettable warn-once registry**
  (:meth:`BackendHealth.warn_once`).
* :class:`CircuitBreaker` is the service path's failure policy: repeated
  failures **open** the breaker, and while it is open the service
  **sheds** the patterns it would have priced on that device — each comes
  back with ``verdict=None`` and a typed :class:`BackendUnavailable`
  (where the reference reroutes them to numpy); after ``reset_after``
  seconds the breaker **half-opens** and lets exactly one probe through,
  whose outcome closes or re-opens it.  Per-device breakers live on the
  ledger (:meth:`BackendHealth.breaker_for`), keyed by the device's
  string (``"cuda:0"``, ``"cpu"``), so :func:`reset_health` clears them
  with everything else.

One process-wide instance is served by :func:`get_health`;
:func:`reset_health` restores it to a clean slate.

Port note: stdlib only, a copy of the reference's breaker state machine
and event ring (same transitions, same counters), with the one name the
reference does not have, :class:`BackendUnavailable`.  The reference's
per-backend failure streaks and quarantine set are not here: the
reference quarantines a backend to route its kernels to numpy, and the
port has no other backend to route to.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time
import warnings

__all__ = ["HealthEvent", "BackendHealth", "CircuitBreaker",
           "BackendUnavailable", "get_health", "reset_health",
           "DEFAULT_MAX_EVENTS", "BREAKER_STATES"]

#: Retained-event cap of the ledger ring (override per process with the
#: ``REPRO_HEALTH_MAX_EVENTS`` env var).  Older events beyond the cap are
#: dropped and counted, never silently lost.
DEFAULT_MAX_EVENTS = 4096

#: The circuit-breaker state machine: ``closed`` (requests flow), ``open``
#: (requests are shed), ``half_open`` (one probe in flight).
BREAKER_STATES = ("closed", "open", "half_open")


class BackendUnavailable(RuntimeError):
    """A device's circuit breaker is open: the pattern was shed, not priced.

    Carried in :attr:`repro_torch.serve.ServiceResult.error` beside
    ``verdict=None``; the service never raises it at a caller.  The port
    prices on the device the caller asked for or not at all, so an open
    breaker sheds where the reference reroutes to numpy.
    """


class CircuitBreaker:
    """Per-device circuit breaker for the service request path.

    * ``closed`` — requests flow to the device; ``fail_threshold``
      *consecutive* failures (any success resets the count) **open** it;
    * ``open`` — :meth:`allow` answers False (the service sheds the
      request with :class:`BackendUnavailable`) until ``reset_after``
      seconds have passed, then the breaker **half-opens**;
    * ``half_open`` — exactly one caller gets True (the probe); its
      :meth:`record_success` closes the breaker, its :meth:`record_failure`
      re-opens it for another ``reset_after`` window.

    ``backend`` names the guarded device (labels and warn-once keys);
    ``clock`` is injectable (monotonic seconds) so tests drive transitions
    without sleeping.  Thread-safe; an opening is reported once per
    breaker through the owning ledger's warn-once registry when the
    breaker was created by :meth:`BackendHealth.breaker_for`.
    """

    def __init__(self, backend: str, *, fail_threshold: int = 3,
                 reset_after: float = 30.0, clock=time.monotonic,
                 _health: "BackendHealth | None" = None):
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {fail_threshold}")
        if reset_after < 0:
            raise ValueError(f"reset_after must be >= 0, got {reset_after}")
        self.backend = backend
        self.fail_threshold = int(fail_threshold)
        self.reset_after = float(reset_after)
        self._clock = clock
        self._health = _health
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._n_opens = 0
        self._n_shed = 0

    @property
    def state(self) -> str:
        """Current state (one of :data:`BREAKER_STATES`); an expired
        ``open`` window reads as ``open`` until the next :meth:`allow`
        half-opens it."""
        with self._lock:
            return self._state

    @property
    def n_opens(self) -> int:
        """How many times the breaker has opened since construction."""
        with self._lock:
            return self._n_opens

    @property
    def n_shed(self) -> int:
        """How many :meth:`allow` calls answered False (requests shed)
        since construction."""
        with self._lock:
            return self._n_shed

    def allow(self) -> bool:
        """Whether the next request may try the guarded device.

        ``closed`` → True.  ``open`` → False until ``reset_after`` seconds
        since opening, then the breaker half-opens and this call (only)
        gets True as the probe.  ``half_open`` → False: one probe is
        already in flight.
        """
        with self._lock:
            if self._state == "closed":
                return True
            if (self._state == "open"
                    and self._clock() - self._opened_at >= self.reset_after):
                self._state = "half_open"
                return True
            self._n_shed += 1
            return False

    def record_success(self) -> None:
        """A guarded call succeeded: close the breaker, clear the streak."""
        with self._lock:
            self._state = "closed"
            self._failures = 0

    def record_failure(self) -> None:
        """A guarded call failed: bump the streak; at ``fail_threshold``
        consecutive failures (or any half-open probe failure) the breaker
        opens for ``reset_after`` seconds."""
        with self._lock:
            self._failures += 1
            opening = (self._state == "half_open"
                       or (self._state == "closed"
                           and self._failures >= self.fail_threshold))
            if opening:
                self._state = "open"
                self._opened_at = self._clock()
                self._n_opens += 1
        if opening and self._health is not None:
            self._health.warn_once(
                f"breaker:{self.backend}",
                f"circuit breaker for device {self.backend!r} opened after "
                f"repeated failures; service queries on it are shed with "
                f"BackendUnavailable and a half-open probe re-tries the "
                f"device after {self.reset_after:g}s")

    def reset(self) -> None:
        """Force the breaker back to ``closed`` with a clear streak."""
        with self._lock:
            self._state = "closed"
            self._failures = 0


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One recorded failure: ``backend`` failed at ``site``.

    ``error`` is the triggering exception's ``repr`` (the exception object
    itself is not retained — events outlive their tracebacks); ``seq`` is a
    process-wide monotone sequence number.
    """

    seq: int
    backend: str
    site: str
    error: str

    def __str__(self) -> str:
        return f"[{self.seq}] {self.backend} failed at {self.site}: {self.error}"


class BackendHealth:
    """Per-process failure ledger, circuit breakers and warn-once registry.

    Thread-safe (one lock around all mutation).  ``max_events=None`` reads ``REPRO_HEALTH_MAX_EVENTS`` (default
    :data:`DEFAULT_MAX_EVENTS`); the ledger retains at most that many
    events (newest win), counting what it drops in :attr:`dropped_events`.
    """

    def __init__(self, max_events: int | None = None):
        if max_events is None:
            max_events = int(os.environ.get(
                "REPRO_HEALTH_MAX_EVENTS", DEFAULT_MAX_EVENTS))
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._events: collections.deque[HealthEvent] = collections.deque(
            maxlen=max_events)
        self._total = 0
        self._dropped = 0
        self._warned: set[str] = set()
        self._breakers: dict[str, CircuitBreaker] = {}

    # -- event accounting ----------------------------------------------------
    def record_failure(self, backend: str, site: str,
                       error: BaseException | str) -> HealthEvent:
        """Record one failure of ``backend`` at ``site``.

        ``error`` is the triggering exception (or a plain string), kept as
        its ``repr`` on the event.  Warns once per (backend, site) pair.
        Returns the recorded event.
        """
        err = error if isinstance(error, str) else repr(error)
        with self._lock:
            ev = HealthEvent(seq=next(self._seq), backend=backend, site=site,
                             error=err)
            if len(self._events) == self._events.maxlen:
                self._dropped += 1      # deque drops the oldest on append
            self._events.append(ev)
            self._total += 1
        self.warn_once(
            f"failure:{backend}:{site}",
            f"{backend!r} failed at {site} ({err}); recorded in the health "
            "ledger, further failures at this site are recorded silently")
        return ev

    def breaker_for(self, backend: str, *, fail_threshold: int = 3,
                    reset_after: float = 30.0,
                    clock=time.monotonic) -> CircuitBreaker:
        """The per-``backend`` :class:`CircuitBreaker`, created on first use.

        ``fail_threshold`` / ``reset_after`` / ``clock`` configure a breaker
        being created and are ignored for an existing one (first caller
        wins — one policy per device per process).  Breakers created here
        report openings through :meth:`warn_once` and are cleared by
        :meth:`reset`.
        """
        with self._lock:
            br = self._breakers.get(backend)
            if br is None:
                br = CircuitBreaker(backend, fail_threshold=fail_threshold,
                                    reset_after=reset_after, clock=clock,
                                    _health=self)
                self._breakers[backend] = br
            return br

    # -- inspection ----------------------------------------------------------
    @property
    def events(self) -> tuple[HealthEvent, ...]:
        """The retained events, in sequence order (the newest
        ``max_events``; see :attr:`dropped_events` for what the ring shed)."""
        with self._lock:
            return tuple(self._events)

    @property
    def n_events(self) -> int:
        """Monotone count of every event recorded since the last
        :meth:`reset`, including events the bounded ring has since dropped
        (snapshot it before a call, compare after)."""
        with self._lock:
            return self._total

    @property
    def dropped_events(self) -> int:
        """How many events the bounded ring has dropped since the last
        :meth:`reset` (``n_events - len(events)``)."""
        with self._lock:
            return self._dropped

    def events_for(self, backend: str | None = None,
                   site: str | None = None) -> tuple[HealthEvent, ...]:
        """Events filtered by ``backend`` and/or ``site`` (None = any)."""
        with self._lock:
            return tuple(ev for ev in self._events
                         if (backend is None or ev.backend == backend)
                         and (site is None or ev.site == site))

    # -- warn-once registry --------------------------------------------------
    def warn_once(self, key: str, message: str,
                  category: type[Warning] = RuntimeWarning,
                  stacklevel: int = 3) -> bool:
        """Emit ``message`` as a warning the first time ``key`` is seen;
        returns True when the warning was issued.  :meth:`reset` clears
        the seen-set."""
        with self._lock:
            if key in self._warned:
                return False
            self._warned.add(key)
        warnings.warn(message, category, stacklevel=stacklevel)
        return True

    def warned(self, key: str) -> bool:
        """Whether warn-once ``key`` has fired since the last reset."""
        with self._lock:
            return key in self._warned

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Clear events (and the dropped counter), circuit breakers and
        warn-once state."""
        with self._lock:
            self._events.clear()
            self._total = 0
            self._dropped = 0
            self._warned.clear()
            self._breakers.clear()


_health = BackendHealth()


def get_health() -> BackendHealth:
    """The process-wide :class:`BackendHealth` ledger."""
    return _health


def reset_health() -> None:
    """Reset the process-wide ledger (events, breakers, warn-once)."""
    _health.reset()
