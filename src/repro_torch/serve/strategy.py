"""StrategyService: the never-fail query path for strategy selection, on a
device.

Counterpart of ``repro.serve.strategy``.  The strategy sweep
(:func:`repro_torch.comm.strategies.best_strategy_many`, K1 and K2 on the
card) runs here as a long-lived service: callers hand it traffic shapes
(patterns) and get an answer for every one of them, whatever the state of
the device, the caches or the input.  Contract:
:meth:`StrategyService.query_many` **returns one :class:`ServiceResult`
per pattern and never raises**.  The request path, in order:

1. **validation** — an invalid pattern comes back with ``verdict=None`` and
   the typed :class:`repro_torch.comm.guard.PatternError` in ``error``; the
   rest of the batch still prices.
2. **admission** — a bounded
   :class:`~repro_torch.serve.admission.AdmissionQueue` sheds whole batches
   under overload (:class:`~repro_torch.serve.admission.Overloaded`) or
   blocks until capacity frees, bounded by the per-request
   :class:`~repro_torch.serve.admission.Deadline` (checked at every loop
   point of the service, never mid-kernel).
3. **cache** — pattern fingerprints
   (:func:`repro_torch.comm.delta.pattern_fingerprint`) key priced verdicts
   in a crash-consistent :class:`repro_torch.serve.cache.ArenaCache`; hits
   skip the sweep and launch nothing (``cached=True``, ``plans`` empty on
   restored verdicts).
4. **sweep** — cache misses price in one arena sweep on the service's
   device, under the service's
   :class:`~repro_torch.serve.admission.RetryPolicy` and the device's
   :class:`repro_torch.comm.health.CircuitBreaker`.
5. **worst case** — should the sweep fail while the breaker is still
   closed, each miss is re-priced alone as ``strategies=('standard',)`` on
   the **same device**, marked ``degraded=True`` and not cached; a pattern
   that still fails gets ``verdict=None`` with its error recorded in the
   health ledger.

While the breaker is open, every miss comes back with ``verdict=None`` and
:class:`~repro_torch.comm.health.BackendUnavailable` and nothing launches;
cache hits are still served.  Where the reference reroutes an open
breaker's batch and its worst-case step to ``backend="numpy"``, the port
sheds: nothing is answered from the host when the caller asked for the
card.

Traffic drift prices incrementally: :meth:`StrategyService.reprice` diffs
the new shape against a retained :class:`repro_torch.comm.delta.DeltaStack`
arena on the service's device (:func:`repro_torch.comm.delta.message_delta`),
applies the delta at O(changed) cost, and falls back to a full rebuild when
the drift fraction exceeds the service's threshold or delta verification
trips.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Any

import torch

from repro_torch.comm.health import BackendUnavailable, get_health
from repro_torch.device import resolve_device

from .admission import (AdmissionQueue, Deadline, DeadlineExceeded,
                        Overloaded, RetryPolicy)
from .cache import ArenaCache

__all__ = ["ServiceResult", "StrategyService"]

# "use the service's default timeout" marker for per-call overrides, so an
# explicit timeout=None can still mean "no deadline for this call"
_DEFAULT_TIMEOUT = object()


@dataclasses.dataclass(frozen=True)
class ServiceResult:
    """One pattern's answer from :class:`StrategyService`.

    ``verdict`` is the :class:`repro_torch.comm.strategies.StrategyVerdict`
    (None when the pattern could not be priced — then ``error`` holds the
    reason).  ``degraded`` marks an answer of the worst-case step (the
    standard strategy alone, on the service's device); the service sets it,
    since the port's verdicts carry no such flag.  ``error`` is the
    triggering exception for rejected or failed patterns (a typed
    :class:`repro_torch.comm.guard.PatternError` for invalid input,
    :class:`~repro_torch.serve.admission.Overloaded` for shed batches,
    :class:`~repro_torch.serve.admission.DeadlineExceeded` for expired
    ones, :class:`~repro_torch.comm.health.BackendUnavailable` while the
    device's breaker is open), None for clean answers.  ``cached`` marks
    verdicts served from the arena cache (the same numbers as the sweep
    that stored them; ``plans`` is empty on verdicts restored from disk or
    a snapshot).
    """

    verdict: Any | None
    degraded: bool = False
    error: Exception | None = None
    cached: bool = False

    @property
    def ok(self) -> bool:
        """Whether a verdict was produced (possibly degraded)."""
        return self.verdict is not None

    @property
    def overloaded(self) -> bool:
        """Whether the admission queue shed this request."""
        return isinstance(self.error, Overloaded)


def _verdict_body(v) -> dict:
    """A verdict's cacheable numbers as a JSON-safe dict (plans excluded)."""
    return {"model": {k: float(x) for k, x in v.model.items()},
            "sim": {k: float(x) for k, x in v.sim.items()},
            "model_winner": v.model_winner, "sim_winner": v.sim_winner}


def _verdict_from_body(body):
    from repro_torch.comm.strategies import StrategyVerdict
    return StrategyVerdict(plans={}, model=dict(body["model"]),
                           sim=dict(body["sim"]),
                           model_winner=body["model_winner"],
                           sim_winner=body["sim_winner"])


class StrategyService:
    """A hardened, stateful wrapper around
    :func:`repro_torch.comm.strategies.best_strategy_many`.

    Parameters are the reference's, with ``device`` in place of
    ``backend``:

    machine : the machine preset queries bind to.
    level : model-ladder level queries price at (default ``'contention'``).
    arrival : simulator arrival regime (``'random'`` / ``'posted'``).
    seed : per-candidate arrival seed (default 0).
    device : the torch device every sweep, worst-case step and repricing
        arena runs on; None means CUDA, and construction raises when no
        CUDA device exists (pass ``device="cpu"`` for the plain kernel
        versions on the host).
    strategies : strategy names to sweep (default: every strategy the
        machine supports).
    validate : run the typed validation layer over every query pattern.
    cache : an :class:`~repro_torch.serve.cache.ArenaCache` for priced
        verdicts (share one across services), or None for a fresh
        memory-only cache.  Keys mix the pattern fingerprint with the
        pricing configuration and the device type, so services with other
        levels, seeds, machines or device types never cross-serve.
    admission : an :class:`~repro_torch.serve.admission.AdmissionQueue`, or
        None for a fresh default queue (capacity 64, policy ``'reject'``).
    retry : a :class:`~repro_torch.serve.admission.RetryPolicy` for the
        sweep, or None for a single attempt.
    timeout : default per-request deadline in seconds (None = none);
        ``query_many(timeout=...)`` overrides per call.
    breaker_threshold / breaker_reset : the device's circuit breaker's
        consecutive-failure trip count and open-state hold in seconds; the
        breaker lives in the process-wide health ledger under the device's
        string (``"cuda:0"``, ``"cpu"``), shared by every service on it.
    drift_threshold : :meth:`reprice` falls back to a full rebuild when
        ``(removed + added) / new_messages`` exceeds this fraction.
    verify_reprice : check the delta parity contract on every reprice
        (slow; a trip degrades to a rebuild, never an error).
    arena_capacity : how many repricing arenas (:class:`DeltaStack`, on the
        device) the service retains, LRU (default 16).

    :meth:`query` / :meth:`query_many` / :meth:`reprice` never raise.
    Thread-safe: any number of callers may query concurrently.
    """

    def __init__(self, machine, *, level: str = "contention",
                 arrival: str = "random", seed: int = 0,
                 device=None,
                 strategies: tuple[str, ...] | None = None,
                 validate: bool = True,
                 cache: ArenaCache | None = None,
                 admission: AdmissionQueue | None = None,
                 retry: RetryPolicy | None = None,
                 timeout: float | None = None,
                 breaker_threshold: int = 3,
                 breaker_reset: float = 30.0,
                 drift_threshold: float = 0.25,
                 verify_reprice: bool = False,
                 arena_capacity: int = 16):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.machine = machine
        self.level = level
        self.arrival = arrival
        self.seed = seed
        self.device = device
        self.strategies = strategies
        self.validate = validate
        self.cache = cache if cache is not None else ArenaCache()
        self.admission = admission if admission is not None else AdmissionQueue()
        self.retry = retry
        self.timeout = timeout
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset = float(breaker_reset)
        self.drift_threshold = float(drift_threshold)
        self.verify_reprice = bool(verify_reprice)
        if arena_capacity < 1:
            raise ValueError(
                f"arena_capacity must be >= 1, got {arena_capacity}")
        self.arena_capacity = int(arena_capacity)
        self._arenas: collections.OrderedDict[str, Any] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        mname = getattr(machine, "name", type(machine).__name__)
        strat = ",".join(strategies) if strategies else "auto"
        self._config_token = (f"{mname}|{getattr(machine, 'n_procs', '?')}|"
                              f"{level}|{arrival}|{seed}|{strat}|"
                              f"{device.type}")

    # -- introspection --------------------------------------------------------
    def health(self):
        """The process-wide :class:`repro_torch.comm.health.BackendHealth`
        ledger (failure events, circuit breakers) this service reports to."""
        return get_health()

    def _breaker(self):
        """The circuit breaker of the service's device (created on first
        use with this service's threshold and hold)."""
        return get_health().breaker_for(
            str(self.device), fail_threshold=self.breaker_threshold,
            reset_after=self.breaker_reset)

    def snapshot(self) -> dict:
        """The verdict cache as a versioned, checksummed, JSON-safe dict
        (:meth:`repro_torch.serve.cache.ArenaCache.snapshot`) — feed it to
        a fresh service's :meth:`restore` for a warm restart."""
        return self.cache.snapshot()

    def restore(self, snapshot: dict) -> int:
        """Warm-start the verdict cache from a :meth:`snapshot`; returns
        how many entries landed (0, with a health event, when ``snapshot``
        is damaged or version-skewed — never an error)."""
        return self.cache.restore(snapshot)

    def _key(self, pattern) -> str:
        from repro_torch.comm.delta import pattern_fingerprint
        raw = pattern_fingerprint(pattern) + "|" + self._config_token
        return hashlib.sha256(raw.encode()).hexdigest()

    # -- the query path -------------------------------------------------------
    def query(self, pattern, *,
              timeout: float | None = _DEFAULT_TIMEOUT) -> ServiceResult:
        """Price one pattern (the one-pattern :meth:`query_many`, same
        ``pattern`` / ``timeout`` contract); never raises."""
        return self.query_many([pattern], timeout=timeout)[0]

    def query_many(self, patterns, *,
                   timeout: float | None = _DEFAULT_TIMEOUT
                   ) -> list[ServiceResult]:
        """Price a batch of patterns: one :class:`ServiceResult` each.

        ``timeout`` (seconds; omitted = the service's ``timeout``, an
        explicit None = no deadline for this call) arms a cooperative
        per-request deadline checked at every loop point of the service —
        admission wait, before the sweep, between retry attempts and before
        each worst-case pattern — turning expiry into per-pattern
        :class:`~repro_torch.serve.admission.DeadlineExceeded` results.
        Invalid patterns are rejected individually; cache hits return
        without a launch (``cached=True``); the rest prices in one arena
        sweep on the service's device behind admission, the retry policy
        and the device's circuit breaker.  Never raises.
        """
        from repro_torch.comm.guard import PatternError, validate_phase

        patterns = list(patterns)
        results: list[ServiceResult | None] = [None] * len(patterns)
        deadline = Deadline(self.timeout if timeout is _DEFAULT_TIMEOUT
                            else timeout)
        live: list[int] = []
        for i, pat in enumerate(patterns):
            if self.validate:
                try:
                    validate_phase(pat, where=f"query[{i}]")
                except PatternError as e:
                    results[i] = ServiceResult(verdict=None, error=e)
                    continue
            live.append(i)
        if not live:
            return results

        try:
            self.admission.acquire(len(live), deadline)
        except (Overloaded, DeadlineExceeded) as e:
            for i in live:
                results[i] = ServiceResult(verdict=None, error=e)
            return results
        try:
            misses: list[int] = []
            keys: dict[int, str] = {}
            for i in live:
                keys[i] = self._key(patterns[i])
                body = self.cache.get(keys[i])
                if body is not None:
                    results[i] = ServiceResult(
                        verdict=_verdict_from_body(body), cached=True)
                else:
                    misses.append(i)
            if misses:
                self._price(patterns, misses, keys, results, deadline)
        finally:
            self.admission.release(len(live))
        return results

    def _price(self, patterns, misses, keys, results, deadline) -> None:
        """Sweep the cache-miss patterns through the ladder on the service's
        device, filling ``results`` in place (one result per index in
        ``misses``, whatever happens)."""
        from repro_torch.comm import strategies as _strategies
        from repro_torch.comm.guard import PatternError

        health = get_health()
        label = str(self.device)

        def sweep(idx, strats):
            return _strategies.best_strategy_many(
                [patterns[i] for i in idx], self.machine,
                strategies=strats, level=self.level, arrival=self.arrival,
                seed=self.seed, device=self.device)

        def attempt():
            # a PatternError (an arena column past int32, say) is a fault
            # of the input, not of the device: it is returned, so the retry
            # policy does not repeat it and the breaker does not count it
            try:
                return sweep(misses, self.strategies)
            except PatternError as e:
                return e

        def expire(idx, e):
            for i in idx:
                if results[i] is None:
                    results[i] = ServiceResult(verdict=None, error=e)

        try:
            deadline.check(where="sweep")
        except DeadlineExceeded as e:
            expire(misses, e)
            return

        breaker = self._breaker()
        failure = verdicts = None
        if breaker.allow():
            retry = self.retry if self.retry is not None \
                else RetryPolicy(attempts=1)
            try:
                verdicts = retry.run(
                    attempt, deadline=deadline,
                    on_failure=lambda e, n: breaker.record_failure())
            except DeadlineExceeded as e:
                expire(misses, e)
                return
            except Exception as e:  # noqa: BLE001 - the service answers
                health.record_failure(label, "serve.query_many", e)
                failure = e
            else:
                # an input fault is no failure of the device: it settles a
                # half-open probe as a success, and its batch goes to the
                # worst case below, where the one bad pattern fails alone
                breaker.record_success()
                if isinstance(verdicts, PatternError):
                    health.record_failure(label, "serve.query_many",
                                          verdicts)
                    failure = verdicts
                    verdicts = None
            if verdicts is not None:
                for i, v in zip(misses, verdicts):
                    results[i] = ServiceResult(verdict=v)
                    self.cache.put(keys[i], _verdict_body(v))
                return
        if failure is None or breaker.state != "closed":
            # the breaker is open (or a probe is in flight): shed, launch
            # nothing — the port prices on its device or not at all
            shed = BackendUnavailable(
                f"circuit breaker for {label} is {breaker.state}; the "
                "pattern was shed, not priced")
            shed.__cause__ = failure
            expire(misses, shed)
            return

        # worst case: the standard strategy alone, on the same device, one
        # pattern at a time so a single pathological pattern cannot take
        # the rest of the batch down with it.  Not cached: the one-strategy
        # verdict is not the configured sweep's answer.
        for i in misses:
            try:
                deadline.check(where=f"worst case[{i}]")
                v = sweep([i], ("standard",))[0]
                results[i] = ServiceResult(verdict=v, degraded=True)
            except DeadlineExceeded as e:
                results[i] = ServiceResult(verdict=None, error=e)
            except Exception as e:  # noqa: BLE001
                health.record_failure(label, "serve.query_many", e)
                results[i] = ServiceResult(verdict=None, degraded=True,
                                           error=e)

    # -- drift repricing ------------------------------------------------------
    def _remember_arena(self, fp: str, arena) -> None:
        with self._lock:
            self._arenas[fp] = arena
            self._arenas.move_to_end(fp)
            while len(self._arenas) > self.arena_capacity:
                self._arenas.popitem(last=False)

    def _arena(self, pattern):
        from repro_torch.comm.delta import DeltaStack
        phase = pattern.bind(self.machine) if hasattr(pattern, "bind") \
            else pattern
        return DeltaStack.from_phases([phase], device=self.device)

    def reprice(self, old, new, *,
                timeout: float | None = _DEFAULT_TIMEOUT) -> ServiceResult:
        """Price drifted traffic ``new`` incrementally against ``old``.

        ``old`` is a previously-repriced (or any) pattern; ``new`` is the
        drifted shape; ``timeout`` arms the same per-request deadline as
        :meth:`query_many`.  The service diffs the shapes as message
        multisets (:func:`repro_torch.comm.delta.message_delta`), applies
        the delta to a retained :class:`repro_torch.comm.delta.DeltaStack`
        on its device at O(changed) cost, and prices the mutated phase
        through the full query path (admission, cache, breaker, worst
        case) — so repeated drift against a warm cache launches nothing.
        Hands ``new`` to a plain :meth:`query` when the drift fraction
        exceeds ``drift_threshold``, no arena for ``old`` can be built, or
        delta verification trips (``verify_reprice=True``) — with the
        failure recorded in the health ledger — and while the device's
        breaker is not closed (the query then sheds or probes).  Never
        raises.

        The repriced verdict is for the *canonical mutated order*
        (survivors of ``old`` in place, additions appended): the same
        message multiset as ``new``.
        """
        from repro_torch.comm.delta import message_delta, pattern_fingerprint
        from repro_torch.comm.guard import PatternError, validate_phase

        if self.validate:
            try:
                validate_phase(new, where="reprice(new)")
            except PatternError as e:
                return ServiceResult(verdict=None, error=e)
        if self._breaker().state != "closed":
            return self.query(new, timeout=timeout)

        label = str(self.device)
        old_fp = pattern_fingerprint(old)
        with self._lock:
            arena = self._arenas.get(old_fp)
        if arena is None:
            try:
                arena = self._arena(old)
                self._remember_arena(old_fp, arena)
            except Exception as e:  # noqa: BLE001 - degrade to full rebuild
                get_health().record_failure(label, "serve.reprice", e)
                return self.query(new, timeout=timeout)

        removed, added = message_delta(arena.phases[0], new)
        n_new = int(getattr(new, "n_msgs", len(new.src)))
        frac = (removed.size + added[0].size) / max(1, n_new)
        if frac > self.drift_threshold:
            result = self.query(new, timeout=timeout)
            if result.ok:
                try:
                    self._remember_arena(pattern_fingerprint(new),
                                         self._arena(new))
                except Exception:  # noqa: BLE001 - retention is best-effort
                    pass
            return result

        try:
            mutated = arena.apply(removed, {0: added},
                                  verify=self.verify_reprice)
        except Exception as e:  # noqa: BLE001 - verify trip or bad delta
            get_health().record_failure(label, "serve.reprice", e)
            return self.query(new, timeout=timeout)

        phase = mutated.phases[0]
        result = self.query_many([phase], timeout=timeout)[0]
        if result.ok:
            self._remember_arena(pattern_fingerprint(phase), mutated)
        return result
