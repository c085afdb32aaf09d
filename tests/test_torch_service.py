"""The strategy service of the PyTorch port against the JAX package's.

Counterparts of the service parts of ``tests/test_admission.py``,
``tests/test_serve_cache.py`` and ``tests/test_service_soak.py``:
``repro_torch.serve.StrategyService(device="cpu")`` (the plain K1 and K2)
beside ``repro.serve.StrategyService(backend="numpy")`` on the same seeded
patterns.  Verdicts hold to the reference's: winners equal, ``model`` and
``sim`` within rtol 1e-4 / atol 1e-6; invalid patterns are rejected with
the same ``PatternError`` subclass.

The port's own ladder differs from the reference's in one place, by the
no-fallback rule: an open circuit breaker sheds the misses with
``BackendUnavailable`` and launches nothing, and the worst-case
``('standard',)`` step runs on the service's own device, where the
reference reroutes both to numpy.  Tests marked ``gpu`` repeat the parity
on ``device="cuda"``, arm the kernel fault sites and check that a shed
batch launches no K1/K2; they skip without a card.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.comm.guard as ref_guard  # noqa: E402
import repro.net.machine as ref_machine  # noqa: E402
import repro.serve as ref_serve  # noqa: E402
import repro.sparse as ref_sparse  # noqa: E402
import repro.workloads as ref_workloads  # noqa: E402
from repro_torch.comm import faults, health, strategies  # noqa: E402
from repro_torch.comm.delta import pattern_fingerprint  # noqa: E402
from repro_torch.comm.guard import ArenaOverflowError  # noqa: E402
from repro_torch.comm.health import (BackendUnavailable,  # noqa: E402
                                     get_health)
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.net import machine  # noqa: E402
from repro_torch.serve import (AdmissionQueue, ArenaCache,  # noqa: E402
                               DeadlineExceeded, Overloaded, RetryPolicy,
                               StrategyService)
from repro_torch.sparse import (CommPattern, RowPartition,  # noqa: E402
                                optimize_partition, poisson_3d,
                                spmv_comm_pattern)
from repro_torch.workloads import (DEFAULT_SCENARIOS,  # noqa: E402
                                   default_machines, scenario_patterns)
from test_workloads_golden import GOLDEN  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")
LASSEN = machine.lassen_machine((2, 2, 2))
REF_LASSEN = ref_machine.lassen_machine((2, 2, 2))


@pytest.fixture(autouse=True)
def _fresh_port_health():
    """Reset the port's health ledger and fault-plan cache around every
    test (``tests/conftest.py`` resets only the reference's)."""
    health.reset_health()
    faults._env_cache.clear()
    yield
    health.reset_health()
    faults._env_cache.clear()


def _raw(P, m=6, n=48, seed=7):
    """The soak batch of ``tests/test_service_soak.py``: ``m`` seeded
    patterns of ``n`` messages over ``P`` ranks, as raw arrays."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, P, n), rng.integers(0, P, n),
             rng.integers(64, 4096, n).astype(float)) for _ in range(m)]


def _pair(raw, P):
    return ([CommPattern(s, d, z, n_procs=P) for s, d, z in raw],
            [ref_sparse.CommPattern(src=s, dst=d, size=z, n_procs=P)
             for s, d, z in raw])


def _key(v):
    return (v.model, v.sim, v.model_winner, v.sim_winner)


def _close(port_v, ref_v):
    assert (port_v.model_winner, port_v.sim_winner) == \
        (ref_v.model_winner, ref_v.sim_winner)
    assert port_v.model.keys() == ref_v.model.keys() == port_v.sim.keys()
    for k in ref_v.model:
        np.testing.assert_allclose(port_v.model[k], ref_v.model[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(port_v.sim[k], ref_v.sim[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _held(port_results, ref_results):
    assert len(port_results) == len(ref_results)
    for p, r in zip(port_results, ref_results):
        assert p.ok and r.ok, (p.error, r.error)
        assert not p.degraded and not p.cached
        _close(p.verdict, r.verdict)


def _run_threads(n, fn, join_timeout=300.0):
    """``fn(i)`` on ``n`` barrier-synchronised threads; any escaped
    exception fails the test."""
    errs, out = [], [None] * n
    barrier = threading.Barrier(n)

    def work(i):
        try:
            barrier.wait(timeout=30)
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - the assertion IS "none"
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_timeout)
    assert not errs, f"unhandled exceptions escaped worker threads: {errs}"
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    return out


# ======================================================= parity with repro ==
def test_soak_batch_matches_the_reference():
    port, ref = _pair(_raw(LASSEN.n_procs), LASSEN.n_procs)
    _held(StrategyService(LASSEN, device="cpu").query_many(port),
          ref_serve.StrategyService(REF_LASSEN,
                                    backend="numpy").query_many(ref))


@pytest.mark.parametrize("mname", ["lassen", "frontier", "blue_waters"])
def test_registry_rows_match_the_reference(mname):
    # the 21 rows: the registry's 7 patterns on each of its 3 machines
    names = [(sc.name, ph) for sc in DEFAULT_SCENARIOS
             for ph, _ in scenario_patterns(sc)]
    port = [p for sc in DEFAULT_SCENARIOS for _, p in scenario_patterns(sc)]
    ref = [p for sc in ref_workloads.DEFAULT_SCENARIOS
           for _, p in ref_workloads.scenario_patterns(sc)]
    got = StrategyService(default_machines()[mname],
                          device="cpu").query_many(port)
    _held(got, ref_serve.StrategyService(
        ref_workloads.default_machines()[mname],
        backend="numpy").query_many(ref))
    for (sc, ph), r in zip(names, got):
        assert (r.verdict.model_winner, r.verdict.sim_winner) == \
            GOLDEN[(mname, sc, ph)]


def test_cold_then_warm_after_snapshot_restore(monkeypatch):
    port, ref = _pair(_raw(LASSEN.n_procs, seed=3), LASSEN.n_procs)
    cold_svc = StrategyService(LASSEN, device="cpu")
    cold = cold_svc.query_many(port)
    _held(cold, ref_serve.StrategyService(REF_LASSEN,
                                          backend="numpy").query_many(ref))
    warm_svc = StrategyService(LASSEN, device="cpu")
    assert warm_svc.restore(cold_svc.snapshot()) == len(port)
    calls = []
    real = strategies.best_strategy_many
    monkeypatch.setattr(strategies, "best_strategy_many",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    warm = warm_svc.query_many(port)
    assert not calls                             # nothing priced
    for c, w in zip(cold, warm):
        assert w.ok and w.cached and w.verdict.plans == {}
        assert _key(w.verdict) == _key(c.verdict)   # bit for bit
    hit = cold_svc.query_many(port)
    assert all(h.cached and _key(h.verdict) == _key(c.verdict)
               for h, c in zip(hit, cold))


def test_disk_tier_warm_restart_and_corruption(tmp_path):
    pat = CommPattern(*_raw(LASSEN.n_procs, m=1, seed=5)[0],
                      n_procs=LASSEN.n_procs)
    disk = str(tmp_path / "cache")
    cold = StrategyService(LASSEN, device="cpu",
                           cache=ArenaCache(disk)).query(pat)
    again = StrategyService(LASSEN, device="cpu",
                            cache=ArenaCache(disk)).query(pat)
    assert again.cached and _key(again.verdict) == _key(cold.verdict)
    import glob
    import os
    for f in glob.glob(os.path.join(disk, "*.json")):
        with open(f, "w") as fh:
            fh.write("corrupted mid-run")
    with pytest.warns(RuntimeWarning, match="serve.cache_read"):
        rebuilt = StrategyService(LASSEN, device="cpu",
                                  cache=ArenaCache(disk)).query(pat)
    assert rebuilt.ok and not rebuilt.cached
    assert _key(rebuilt.verdict) == _key(cold.verdict)
    assert get_health().events_for("cache", "serve.cache_read")


def test_cache_keys_include_the_configuration_and_the_device_type():
    pat = CommPattern(*_raw(LASSEN.n_procs, m=1)[0], n_procs=LASSEN.n_procs)
    shared = ArenaCache()
    a = StrategyService(LASSEN, device="cpu", seed=0, cache=shared)
    b = StrategyService(LASSEN, device="cpu", seed=1, cache=shared)
    assert a.query(pat).ok and not b.query(pat).cached
    assert a.query(pat).cached and b.query(pat).cached
    assert a._config_token.endswith("|cpu")
    ref = ref_serve.StrategyService(REF_LASSEN, backend="numpy")
    assert a._config_token.rsplit("|", 1)[0] == \
        ref._config_token.rsplit("|", 1)[0]
    assert str(a.device) == "cpu" and a._breaker().backend == "cpu"


def test_reprice_of_an_optimised_partition():
    res = optimize_partition(poisson_3d(6), LASSEN, n_procs=16, moves=32,
                             rerun_strategies=True, device="cpu")
    assert res.cost <= res.initial_cost and res.verdicts
    initial = spmv_comm_pattern(poisson_3d(6),
                                RowPartition.balanced(poisson_3d(6).n_rows,
                                                      16))
    svc = StrategyService(LASSEN, device="cpu")
    out = svc.reprice(initial, res.pattern)
    assert out.ok and not out.degraded and not out.cached, out.error
    again = svc.reprice(initial, res.pattern)
    assert again.cached and _key(again.verdict) == _key(out.verdict)
    # the reference reprices the same two patterns to the same verdict
    # (this drift, 36 of 84 messages, is past the threshold: a rebuild)
    ref_pats = [ref_sparse.CommPattern(src=p.src, dst=p.dst, size=p.size,
                                       n_procs=p.n_procs)
                for p in (initial, res.pattern)]
    ref = ref_serve.StrategyService(REF_LASSEN,
                                    backend="numpy").reprice(*ref_pats)
    assert ref.ok and not ref.degraded
    _close(out.verdict, ref.verdict)
    assert pattern_fingerprint(res.pattern) in svc._arenas


def test_reprice_chains_and_large_drift_match_the_reference():
    raw = _raw(LASSEN.n_procs, m=1, n=60, seed=0)[0]
    rng = np.random.default_rng(99)

    def drift(r, extra=4):
        s, d, z = r
        P = LASSEN.n_procs
        return (np.concatenate([s[:-extra], rng.integers(0, P, extra)]),
                np.concatenate([d[:-extra], rng.integers(0, P, extra)]),
                np.concatenate([z[:-extra],
                                rng.integers(64, 4096, extra).astype(float)]))

    svc = StrategyService(LASSEN, device="cpu")
    ref_svc = ref_serve.StrategyService(REF_LASSEN, backend="numpy")
    prev = raw
    for _ in range(3):                           # incremental: 8 of 60
        new = drift(prev)
        (p_old, p_new), (r_old, r_new) = _pair([prev, new], LASSEN.n_procs)
        got, want = svc.reprice(p_old, p_new), ref_svc.reprice(r_old, r_new)
        assert got.ok and not got.degraded and not got.cached, got.error
        _close(got.verdict, want.verdict)
        prev = new
    assert len(svc._arenas) == 4                 # the start and 3 mutations
    assert svc.reprice(p_old, p_new).cached
    other = _raw(LASSEN.n_procs, m=1, n=60, seed=123)[0]
    (p_old, p_new), (r_old, r_new) = _pair([raw, other], LASSEN.n_procs)
    big = svc.reprice(p_old, p_new)
    assert big.ok
    _close(big.verdict, ref_svc.reprice(r_old, r_new).verdict)
    assert _key(big.verdict) == _key(
        StrategyService(LASSEN, device="cpu").query(p_new).verdict)
    assert pattern_fingerprint(p_new) in svc._arenas


# =========================================================== validation ==
def _bad_patterns(P):
    good = _raw(P, m=1, n=4)[0]
    s, d, z = (np.array(a) for a in good)
    z_nan, z_neg = z.copy(), z.copy()
    z_nan[1], z_neg[2] = np.nan, -8.0
    s_hi, d_lo = s.copy(), d.copy()
    s_hi[0], d_lo[3] = P, -1
    return {"nan size": (s, d, z_nan), "negative size": (s, d, z_neg),
            "src out of range": (s_hi, d, z), "dst below 0": (s, d_lo, z),
            "good": (s, d, z)}


def test_validation_rejects_per_pattern_as_the_reference():
    cases = _bad_patterns(LASSEN.n_procs)
    port, ref = _pair(list(cases.values()), LASSEN.n_procs)
    got = StrategyService(LASSEN, device="cpu").query_many(port)
    want = ref_serve.StrategyService(REF_LASSEN,
                                     backend="numpy").query_many(ref)
    for name, g, w in zip(cases, got, want):
        if name == "good":
            assert g.ok and w.ok
            _close(g.verdict, w.verdict)
            continue
        assert not g.ok and not w.ok, name
        assert type(g.error).__name__ == type(w.error).__name__, name
        assert isinstance(w.error, ref_guard.PatternError)
        assert str(g.error) == str(w.error)
    svc = StrategyService(LASSEN, device="cpu")
    bad = svc.reprice(port[-1], port[0])
    assert not bad.ok and type(bad.error).__name__ == \
        type(want[0].error).__name__
    assert svc.reprice(port[2], port[-1]).ok     # unusable old: rebuild


# ======================================================== admission ======
def test_overloaded_and_expired_results_are_typed():
    pats, _ = _pair(_raw(LASSEN.n_procs, m=2), LASSEN.n_procs)
    q = AdmissionQueue(capacity=1, policy="reject")
    svc = StrategyService(LASSEN, device="cpu", admission=q)
    q.acquire(1)
    res = svc.query_many(pats)
    assert all(not r.ok and r.overloaded and isinstance(r.error, Overloaded)
               for r in res)
    q.release(1)
    assert svc.query(pats[0]).ok
    hasty = StrategyService(LASSEN, device="cpu", timeout=0.0)
    late = hasty.query(pats[1])
    assert not late.ok and isinstance(late.error, DeadlineExceeded)
    assert hasty.query(pats[1], timeout=None).ok
    with faults.inject("serve.deadline", "raise"):
        r = StrategyService(LASSEN, device="cpu",
                            timeout=1000.0).query(pats[1])
        assert not r.ok and isinstance(r.error, DeadlineExceeded)
        assert StrategyService(LASSEN, device="cpu").query(pats[1]).ok


# ============================================================= breaker ====
def test_breaker_opens_sheds_and_heals_on_the_same_device(monkeypatch):
    real = strategies.best_strategy_many
    calls, broken = [], [True]

    def wedged(patterns, machine=None, **kw):
        calls.append((kw["device"], kw["strategies"]))
        if broken[0]:
            raise RuntimeError("device wedged")
        return real(patterns, machine, **kw)

    pats, _ = _pair(_raw(LASSEN.n_procs, m=5, seed=11), LASSEN.n_procs)
    t = [0.0]
    # first caller wins: the service's breaker runs on this clock
    get_health().breaker_for("cpu", fail_threshold=2, reset_after=10.0,
                             clock=lambda: t[0])
    svc = StrategyService(LASSEN, device="cpu", breaker_threshold=2,
                          breaker_reset=10.0)
    warm = svc.query(pats[4])                    # priced before the fault
    assert warm.ok
    monkeypatch.setattr(strategies, "best_strategy_many", wedged)

    with pytest.warns(RuntimeWarning):
        r0 = svc.query_many(pats[:2])           # sweep fails, then each
    assert [c[1] for c in calls] == [None, ("standard",), ("standard",)]
    assert all(not r.ok and r.degraded and isinstance(r.error, RuntimeError)
               for r in r0)
    assert svc._breaker().state == "closed"
    with pytest.warns(RuntimeWarning, match="BackendUnavailable"):
        r1 = svc.query(pats[2])                 # second failure opens it
    assert svc._breaker().state == "open" and len(calls) == 4
    assert not r1.ok and isinstance(r1.error, BackendUnavailable)
    assert isinstance(r1.error.__cause__, RuntimeError)
    n = len(calls)
    shed = svc.query_many(pats[:4])
    assert len(calls) == n                      # not called on any device
    assert all(isinstance(r.error, BackendUnavailable) and not r.ok
               for r in shed)
    hit = svc.query(pats[4])                    # cache hits still served
    assert hit.cached and _key(hit.verdict) == _key(warm.verdict)
    assert not svc.reprice(pats[0], pats[3]).ok and len(calls) == n

    broken[0] = False
    t[0] = 10.5                                  # the hold has passed
    probe = svc.query(pats[3])                   # the half-open probe
    assert probe.ok and not probe.degraded
    assert svc._breaker().state == "closed"
    want = StrategyService(LASSEN, device="cpu",
                           cache=ArenaCache()).query(pats[3])
    assert _key(probe.verdict) == _key(want.verdict)
    assert {c[0] for c in calls} == {CPU}       # never another device
    assert get_health().events_for("cpu", "serve.query_many")


def test_worst_case_step_is_degraded_on_the_same_device(monkeypatch):
    real = strategies.best_strategy_many
    calls = []

    def sweep_fails(patterns, machine=None, **kw):
        calls.append((kw["device"], kw["strategies"]))
        if kw["strategies"] is None:
            raise RuntimeError("sweep failed")
        return real(patterns, machine, **kw)

    monkeypatch.setattr(strategies, "best_strategy_many", sweep_fails)
    pats, _ = _pair(_raw(LASSEN.n_procs, m=2, seed=4), LASSEN.n_procs)
    svc = StrategyService(LASSEN, device="cpu", breaker_threshold=5)
    with pytest.warns(RuntimeWarning):
        res = svc.query_many(pats)
    assert all(r.ok and r.degraded and set(r.verdict.model) == {"standard"}
               for r in res)
    assert calls == [(CPU, None), (CPU, ("standard",)), (CPU, ("standard",))]
    assert svc.cache.n_entries == 0              # degraded: not cached
    assert not svc.query(pats[0]).cached


@pytest.mark.parametrize("probe", [False, True])
def test_input_faults_in_the_sweep_leave_the_breaker_closed(monkeypatch,
                                                            probe):
    # an oversized pattern that passes validation and overflows an arena
    # column is the client's fault: batch after batch of it must not open
    # the device's breaker, the rest of each batch is priced in the worst
    # case, and a half-open probe that meets it closes the breaker
    real = strategies.best_strategy_many
    pats, _ = _pair(_raw(LASSEN.n_procs, m=3, seed=5), LASSEN.n_procs)
    bad = pats[1]
    calls = []

    def overflows(patterns, machine=None, **kw):
        calls.append((kw["device"], kw["strategies"], len(patterns)))
        if any(p is bad for p in patterns):
            raise ArenaOverflowError("arena column 'offsets' exceeds int32")
        return real(patterns, machine, **kw)

    t = [0.0]
    get_health().breaker_for("cpu", fail_threshold=2, reset_after=1.0,
                             clock=lambda: t[0])
    svc = StrategyService(
        LASSEN, device="cpu", breaker_threshold=2, breaker_reset=1.0,
        retry=RetryPolicy(attempts=3, base=0.0, sleep=lambda s: None))
    if probe:                                    # a half-open probe first
        svc._breaker().record_failure()
        svc._breaker().record_failure()
        t[0] = 2.0
    want = [StrategyService(LASSEN, device="cpu", strategies=("standard",),
                            cache=ArenaCache()).query(p) for p in pats]
    monkeypatch.setattr(strategies, "best_strategy_many", overflows)
    for n in range(4):
        del calls[:]
        if n == 0:                               # the ledger warns once
            with pytest.warns(RuntimeWarning, match="ArenaOverflowError"):
                res = svc.query_many(pats)
        else:
            res = svc.query_many(pats)
        # one sweep (no retry of an input fault), then each pattern alone
        assert calls == [(CPU, None, 3)] + [(CPU, ("standard",), 1)] * 3
        assert svc._breaker().state == "closed"
        assert isinstance(res[1].error, ArenaOverflowError)
        assert not res[1].ok and res[1].degraded
        for r, w in ((res[0], want[0]), (res[2], want[2])):
            assert r.ok and r.degraded and _key(r.verdict) == _key(w.verdict)
    assert svc._breaker().n_opens == (1 if probe else 0)
    assert svc.cache.n_entries == 0              # degraded: not cached


def test_retry_policy_heals_a_transient(monkeypatch):
    real = strategies.best_strategy_many
    n = [0]

    def transient(patterns, machine=None, **kw):
        n[0] += 1
        if n[0] < 2:
            raise RuntimeError("blip")
        return real(patterns, machine, **kw)

    monkeypatch.setattr(strategies, "best_strategy_many", transient)
    svc = StrategyService(
        LASSEN, device="cpu",
        retry=RetryPolicy(attempts=3, base=0.0, sleep=lambda s: None))
    pat = CommPattern(*_raw(LASSEN.n_procs, m=1)[0], n_procs=LASSEN.n_procs)
    res = svc.query(pat)
    assert res.ok and not res.degraded and n[0] == 2
    assert svc._breaker().state == "closed"


# ========================================================= fault sites ====
def test_armed_device_store_site_gives_error_results():
    pats, _ = _pair(_raw(LASSEN.n_procs, m=3, seed=2), LASSEN.n_procs)
    svc = StrategyService(LASSEN, device="cpu")
    with pytest.warns(RuntimeWarning):
        with faults.inject("stack.device_store", "raise") as spec:
            res = svc.query_many(pats)
    assert spec.fired >= 4                       # the sweep, then each alone
    assert len(res) == 3
    assert all(not r.ok and isinstance(r.error, faults.InjectedFault)
               for r in res)
    assert all(r.ok for r in svc.query_many(pats))


def test_threaded_storm_on_serve_sites_is_bit_equal(tmp_path, monkeypatch):
    pats, _ = _pair(_raw(LASSEN.n_procs), LASSEN.n_procs)
    reference = [_key(r.verdict) for r in
                 StrategyService(LASSEN, device="cpu").query_many(pats)]
    monkeypatch.setenv(faults.ENV_VAR, ",".join(
        f"{s}:raise" for s in faults.SITES if s.startswith("serve.")))
    svc = StrategyService(LASSEN, device="cpu",
                          cache=ArenaCache(str(tmp_path / "cache")))

    def work(i):
        return svc.query_many(pats)

    for results in _run_threads(4, work):
        assert len(results) == len(pats)
        for res, want in zip(results, reference):
            assert res.ok, res.error
            assert _key(res.verdict) == want
    h = get_health()
    assert h.n_events == len(h.events) + h.dropped_events
    assert h.events_for("cache", "serve.cache_write")
    assert all(ev.site.startswith("serve.") for ev in h.events)


# ============================================================ on the card ==
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_service_matches_the_reference(cuda):
    port, ref = _pair(_raw(LASSEN.n_procs), LASSEN.n_procs)
    ks.reset_launches()
    svc = StrategyService(LASSEN)
    got = svc.query_many(port)
    assert ks.LAUNCHES["segment_reduce"] and ks.LAUNCHES["queue_walk"]
    assert str(svc.device).startswith("cuda:")
    _held(got, ref_serve.StrategyService(REF_LASSEN,
                                         backend="numpy").query_many(ref))
    before = dict(ks.LAUNCHES)
    warm = svc.query_many(port)
    assert ks.LAUNCHES == before                  # hits launch nothing
    assert all(w.cached and _key(w.verdict) == _key(c.verdict)
               for w, c in zip(warm, got))


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["kernel.segment_reduce",
                                  "kernel.queue_walk"])
def test_cuda_kernel_sites_give_error_results(cuda, site):
    pats, _ = _pair(_raw(LASSEN.n_procs, m=3, seed=8), LASSEN.n_procs)
    svc = StrategyService(LASSEN, breaker_threshold=2)
    with pytest.warns(RuntimeWarning):
        with faults.inject(site, "raise") as spec:
            res = svc.query_many(pats)
            assert spec.fired and len(res) == 3
            assert all(not r.ok and isinstance(r.error, faults.InjectedFault)
                       for r in res)
            svc.query_many(pats)                 # opens the breaker
            before = dict(ks.LAUNCHES)
            shed = svc.query_many(pats)
    assert ks.LAUNCHES == before                 # the shed launched nothing
    assert all(isinstance(r.error, BackendUnavailable) for r in shed)
