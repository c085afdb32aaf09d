"""Admission control for the strategy service: queue, deadlines, retry.

Counterpart of ``repro.serve.admission`` (a copy: stdlib only).  Three
pieces, shared by :class:`repro_torch.serve.StrategyService`:

* :class:`AdmissionQueue` — a bounded counter of in-flight work units with
  two load-shedding policies: ``'reject'`` sheds the newest batch with a
  typed :class:`Overloaded` (the service turns it into per-pattern error
  results, never an exception), ``'block'`` parks the caller on a condition
  variable until capacity frees or its :class:`Deadline` expires.  A batch
  larger than the whole capacity is admitted when the queue is idle, so an
  oversized request degrades to serial admission instead of wedging forever.

* :class:`Deadline` — a cooperative per-request deadline over a monotonic
  clock: construct once, call :meth:`check` at loop points.  Armed deadlines pass through the ``serve.deadline`` fault
  site, so a chaos run can expire any request deterministically.

* :class:`RetryPolicy` — deterministic jittered exponential backoff for the
  service's sweep on its device.  The jitter stream is seeded, so a test
  replays the exact delay sequence.

Everything here raises only the two typed errors below; the service catches
both and returns them inside :class:`repro_torch.serve.ServiceResult`.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time

__all__ = ["Overloaded", "DeadlineExceeded", "Deadline", "AdmissionQueue",
           "RetryPolicy", "ADMISSION_POLICIES"]

#: The load-shedding policies :class:`AdmissionQueue` accepts.
ADMISSION_POLICIES = ("reject", "block")


class Overloaded(RuntimeError):
    """The admission queue shed this request (policy ``'reject'``).

    Carried in :attr:`repro_torch.serve.ServiceResult.error`; the service never
    raises it at a caller.
    """


class DeadlineExceeded(TimeoutError):
    """A per-request deadline expired (or was expired by an injected fault).

    A ``TimeoutError`` so callers guarding against real timeouts see the
    same exception family; carried in
    :attr:`repro_torch.serve.ServiceResult.error`, never raised at a caller by
    the service.
    """


class Deadline:
    """A cooperative deadline: construct with ``timeout``, :meth:`check` at
    loop points.

    Parameters
    ----------
    timeout : seconds from now until expiry, or None for no deadline (every
        method becomes a no-op — callers hold one ``Deadline`` object
        unconditionally instead of branching).
    clock : the time source (default ``time.monotonic``); injectable so
        tests expire deadlines without sleeping.
    """

    __slots__ = ("timeout", "_clock", "_expires")

    def __init__(self, timeout: float | None = None, clock=time.monotonic):
        if timeout is not None and timeout < 0:
            raise ValueError(f"timeout must be >= 0, got {timeout}")
        self.timeout = None if timeout is None else float(timeout)
        self._clock = clock
        self._expires = None if timeout is None else clock() + float(timeout)

    def remaining(self) -> float | None:
        """Seconds left (>= 0.0), or None when no deadline is armed."""
        if self._expires is None:
            return None
        return max(0.0, self._expires - self._clock())

    @property
    def expired(self) -> bool:
        """Whether the deadline has passed (always False when unarmed)."""
        return self._expires is not None and self._clock() >= self._expires

    def check(self, where: str = "request") -> None:
        """Raise :class:`DeadlineExceeded` if the deadline has passed.

        ``where`` labels the enforcement point in the error text.  Armed
        deadlines fire the ``serve.deadline`` fault site first, so an
        injected fault expires the request exactly like a real timeout
        (converted to :class:`DeadlineExceeded`, never leaked as an
        :class:`repro_torch.comm.faults.InjectedFault`).  Unarmed
        deadlines are a complete no-op — the fault site stays silent too.
        """
        if self._expires is None:
            return
        from repro_torch.comm import faults
        try:
            faults.fail_point("serve.deadline")
        except faults.InjectedFault as e:
            raise DeadlineExceeded(
                f"injected deadline expiry at {where}") from e
        if self._clock() >= self._expires:
            raise DeadlineExceeded(
                f"deadline of {self.timeout}s exceeded at {where}")


class AdmissionQueue:
    """A bounded in-flight work counter with configurable load shedding.

    Parameters
    ----------
    capacity : maximum admitted work units (a unit is one pattern; a
        ``query_many`` batch acquires ``len(batch)`` units).  Must be >= 1.
    policy : ``'reject'`` sheds a batch that would exceed capacity with
        :class:`Overloaded`; ``'block'`` waits for capacity, bounded by the
        caller's :class:`Deadline` (expiry raises
        :class:`DeadlineExceeded`).  See :data:`ADMISSION_POLICIES`.

    A batch larger than ``capacity`` is admitted when the queue is idle
    (nothing else in flight), so oversized batches make progress instead of
    deadlocking.  Thread-safe; counters (:attr:`n_admitted`,
    :attr:`n_shed`, :attr:`pending`) are monotone except ``pending``.
    """

    def __init__(self, capacity: int = 64, policy: str = "reject"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"expected one of {ADMISSION_POLICIES}")
        self.capacity = int(capacity)
        self.policy = policy
        self._cond = threading.Condition()
        self._pending = 0
        self._admitted = 0
        self._shed = 0

    @property
    def pending(self) -> int:
        """Work units currently admitted and not yet released."""
        with self._cond:
            return self._pending

    @property
    def n_admitted(self) -> int:
        """Total work units ever admitted."""
        with self._cond:
            return self._admitted

    @property
    def n_shed(self) -> int:
        """Total work units shed (rejected or deadline-expired waiting)."""
        with self._cond:
            return self._shed

    def acquire(self, units: int = 1, deadline: Deadline | None = None) -> None:
        """Admit ``units`` work units or shed the request.

        Policy ``'reject'`` raises :class:`Overloaded` immediately when the
        queue is non-idle and ``units`` would exceed capacity; ``'block'``
        waits until capacity frees, bounded by ``deadline`` (expiry while
        waiting raises :class:`DeadlineExceeded`).  Callers must pair every
        successful ``acquire`` with :meth:`release` — or use :meth:`admit`.
        """
        if units < 0:
            raise ValueError(f"units must be >= 0, got {units}")
        with self._cond:
            while self._pending and self._pending + units > self.capacity:
                if self.policy == "reject":
                    self._shed += units
                    raise Overloaded(
                        f"admission queue full ({self._pending}/"
                        f"{self.capacity} in flight, batch of {units} shed)")
                remaining = None if deadline is None else deadline.remaining()
                if remaining is not None and remaining <= 0:
                    self._shed += units
                    raise DeadlineExceeded(
                        f"deadline expired waiting for admission "
                        f"({self._pending}/{self.capacity} in flight)")
                self._cond.wait(remaining)
            self._pending += units
            self._admitted += units

    def release(self, units: int = 1) -> None:
        """Return ``units`` previously-acquired work units to the queue."""
        with self._cond:
            self._pending = max(0, self._pending - units)
            self._cond.notify_all()

    @contextlib.contextmanager
    def admit(self, units: int = 1, deadline: Deadline | None = None):
        """Context manager pairing :meth:`acquire` of ``units`` (bounded by
        ``deadline``) with a guaranteed :meth:`release`."""
        self.acquire(units, deadline)
        try:
            yield
        finally:
            self.release(units)


class RetryPolicy:
    """Deterministic jittered exponential backoff.

    Parameters
    ----------
    attempts : total tries including the first (>= 1); 1 means no retry.
    base : first retry's nominal delay in seconds.
    cap : upper bound on any single delay.
    jitter : fractional jitter — each delay is scaled by a factor drawn
        uniformly from ``[1 - jitter, 1 + jitter]``.  0 disables jitter.
    seed : seeds the jitter stream, so a given policy object replays the
        exact same delay sequence (deterministic chaos runs).
    sleep : the sleeper (default ``time.sleep``); injectable for tests.
    """

    def __init__(self, attempts: int = 3, base: float = 0.05,
                 cap: float = 1.0, jitter: float = 0.5, seed: int = 0,
                 sleep=time.sleep):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if not 0 <= jitter <= 1:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        if base < 0 or cap < 0:
            raise ValueError("base and cap must be >= 0")
        self.attempts = int(attempts)
        self.base = float(base)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay(self, attempt: int) -> float:
        """The backoff before retry number ``attempt`` (0-based: the delay
        after the first failure is ``delay(0)``), jittered and capped."""
        nominal = min(self.cap, self.base * (2.0 ** attempt))
        if self.jitter:
            nominal *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return min(self.cap, nominal)

    def run(self, fn, *, deadline: Deadline | None = None,
            on_failure=None):
        """Call ``fn()`` up to :attr:`attempts` times with backoff between.

        ``deadline`` is checked before every attempt and bounds each sleep
        (an expired deadline raises :class:`DeadlineExceeded` instead of
        burning the remaining attempts).  ``on_failure(error, attempt)`` is
        called after each failed attempt — the service hooks the circuit
        breaker and health ledger there.  Re-raises the last error when
        every attempt fails; returns ``fn()``'s value on the first success.
        """
        last: Exception | None = None
        for attempt in range(self.attempts):
            if deadline is not None:
                deadline.check(where=f"retry attempt {attempt}")
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - policy decides, not us
                last = e
                if on_failure is not None:
                    on_failure(e, attempt)
                if attempt + 1 >= self.attempts:
                    break
                pause = self.delay(attempt)
                if deadline is not None:
                    remaining = deadline.remaining()
                    if remaining is not None:
                        pause = min(pause, remaining)
                if pause > 0:
                    self._sleep(pause)
        raise last
