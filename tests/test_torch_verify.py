"""Poison at the port's device sites and the ``REPRO_STACK_VERIFY`` check,
against the JAX package's.

Counterparts of the ``REPRO_STACK_VERIFY`` rows and the chaos registry
sweep of ``tests/test_faults.py``, run against the port's three device
sites: K1's wrapper (``kernel.segment_reduce``), K2's
(``kernel.queue_walk``) and an arena column's shipping
(``stack.device_store``), all on CPU tensors here.  Where the reference has
an answer on the same inputs it runs beside the port.  The one difference
is by the port's no-fallback rule: where the reference's ``device_guard``
catches a rejected output and answers from numpy, the port raises
``BackendVerifyError`` to the caller (the strategy service records it as a
device failure); after the fault is disarmed the port answers the clean
result, held to the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import faults as ref_faults  # noqa: E402
from repro.comm import stack as ref_stack  # noqa: E402
from repro.comm.health import get_health as ref_get_health  # noqa: E402
from repro.kernels import comm_stack as cs  # noqa: E402
import repro.net.machine as ref_machine  # noqa: E402
import repro.sparse as ref_sparse  # noqa: E402
from repro.workloads import registry as ref_registry  # noqa: E402
from repro_torch.comm import faults, health  # noqa: E402
from repro_torch.comm.delta import DeltaStack  # noqa: E402
from repro_torch.comm.guard import PatternError  # noqa: E402
from repro_torch.comm.health import (BackendUnavailable,  # noqa: E402
                                     get_health)
from repro_torch.comm.stack import PhaseStack, put_column  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.kernels.comm_stack import BackendVerifyError  # noqa: E402
from repro_torch.net import machine  # noqa: E402
from repro_torch.serve import StrategyService  # noqa: E402
from repro_torch.sparse import CommPattern  # noqa: E402
from repro_torch.workloads import (DEFAULT_SCENARIOS,  # noqa: E402
                                   default_machines, scenario_patterns,
                                   sweep)

RTOL, ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")
#: the check that catches each poison mode
CHECK = {"nan": "finite", "corrupt": "parity"}
#: the exception each chaos mode ends in on the port
RAISED = {"raise": faults.InjectedFault, "timeout": faults.InjectedTimeout,
          "nan": BackendVerifyError, "corrupt": BackendVerifyError}


@pytest.fixture(autouse=True)
def _fresh_port_health():
    """Reset the port's health ledger and fault-plan cache around every
    test (``tests/conftest.py`` resets only the reference's)."""
    health.reset_health()
    faults._env_cache.clear()
    yield
    health.reset_health()
    faults._env_cache.clear()


def _k1_inputs(seed=4, n=1024, n_seg=16):
    rng = np.random.default_rng(seed)
    return rng.random(n), rng.integers(0, n_seg, size=n), n_seg


def _k2_inputs(seed=6, n_regions=12):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n_regions)
    posted = np.concatenate([rng.permutation(c) for c in counts])
    arrival = np.concatenate([rng.permutation(c) for c in counts])
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return posted, arrival, bounds


def _phase_pair(seed=3, n=64):
    m, rm = machine.lassen_machine((2, 2, 2)), \
        ref_machine.lassen_machine((2, 2, 2))
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, m.n_procs, n), rng.integers(0, m.n_procs, n)
    size = rng.integers(64, 1 << 16, n).astype(float)
    return (CommPattern(src, dst, size, n_procs=m.n_procs).bind(m),
            ref_sparse.CommPattern(src=src, dst=dst, size=size,
                                   n_procs=m.n_procs).bind(rm))


def _port_call(site):
    """(the port's call of ``site`` on CPU tensors, its clean answer, the
    reference's call on the same inputs through its jax backend, its
    guarded device path).  At the arena site the call ships one float
    column of a phase and the answer is the phase's stack pricing."""
    if site == "kernel.segment_reduce":
        vals, ids, n_seg = _k1_inputs()

        def k1():
            return ks.segment_reduce(torch.from_numpy(vals.astype(np.float32)),
                                     torch.from_numpy(ids.astype(np.int32)),
                                     n_seg)[0]
        return k1, k1, lambda: cs.segment_sum(vals, ids, n_seg,
                                              backend="jax")
    if site == "kernel.queue_walk":
        args = _k2_inputs()

        def k2():
            return ks.queue_walk(*(torch.from_numpy(a) for a in args))
        return k2, k2, lambda: cs.queue_walk(*args, backend="jax")
    phase, ref_phase = _phase_pair()
    return (lambda: put_column(phase.size, "size", CPU),
            lambda: PhaseStack.build([phase], device="cpu").cost_arrays()[0],
            lambda: ref_stack.PhaseStack.build([ref_phase]).cost_arrays(
                backend="jax")[0])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=ATOL)


# ================================================================ modes ==
@pytest.mark.parametrize("value", ["bogus", "FINITE", "parity,finite"])
def test_unknown_verify_mode_raises_as_the_reference(value, monkeypatch):
    monkeypatch.setenv("REPRO_STACK_VERIFY", value)
    assert ks.VERIFY_MODES == cs.VERIFY_MODES
    with pytest.raises(ValueError) as want:
        cs.verify_mode()
    with pytest.raises(ValueError) as got:
        ks.verify_mode()
    assert str(got.value) == str(want.value)
    assert "REPRO_STACK_VERIFY" in str(got.value)
    # the device sites read the mode on every call: a bad one raises there
    with pytest.raises(ValueError, match="allowed values"):
        _port_call("kernel.segment_reduce")[0]()


# ========================================================= device sites ==
# K2's steps are integers, which nan leaves intact: that pair is
# test_nan_at_queue_walk_passes_the_finite_check
@pytest.mark.parametrize("site,mode", [
    ("kernel.segment_reduce", "nan"), ("kernel.segment_reduce", "corrupt"),
    ("kernel.queue_walk", "corrupt"), ("stack.device_store", "nan"),
    ("stack.device_store", "corrupt")])
def test_verify_catches_poisoned_output_at_each_device_site(site, mode,
                                                            monkeypatch):
    monkeypatch.setenv("REPRO_STACK_VERIFY", CHECK[mode])
    port, answer, ref = _port_call(site)
    with pytest.warns(RuntimeWarning, match="BackendVerifyError"):
        with faults.inject(site, mode) as spec:
            with pytest.raises(BackendVerifyError, match=CHECK[mode]):
                port()
    assert spec.fired == 1
    events = get_health().events_for("cpu", site)
    assert len(events) == 1 and "BackendVerifyError" in events[0].error
    # the reference catches the same damage and answers from numpy
    with pytest.warns(RuntimeWarning):
        with ref_faults.inject(site, mode) as ref_spec:
            want = ref()
    assert ref_spec.fired >= 1
    assert ref_get_health().events_for("jax", site)
    # disarmed, the port answers the clean result
    _close(answer(), want)
    assert len(get_health().events_for("cpu", site)) == 1


def test_nan_at_queue_walk_passes_the_finite_check(monkeypatch):
    monkeypatch.setenv("REPRO_STACK_VERIFY", "finite")
    port, _, ref = _port_call("kernel.queue_walk")
    with faults.inject("kernel.queue_walk", "nan") as spec:
        got = port()
    with ref_faults.inject("kernel.queue_walk", "nan") as ref_spec:
        want = ref()
    assert spec.fired == ref_spec.fired == 1
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert get_health().n_events == 0 == ref_get_health().n_events


@pytest.mark.parametrize("site", ["kernel.segment_reduce",
                                  "stack.device_store"])
def test_poison_without_verify_passes_through(site, monkeypatch):
    # no verify mode: the poisoned output is NOT caught — this is exactly
    # what REPRO_STACK_VERIFY exists to close
    monkeypatch.delenv("REPRO_STACK_VERIFY", raising=False)
    if site == "kernel.segment_reduce":
        port, _, ref = _port_call(site)
        with ref_faults.inject(site, "nan"):
            assert np.isnan(ref()).all()
    else:
        def port():
            return put_column(np.array([64.0, 4096.0]), "size", CPU)
    with faults.inject(site, "nan") as spec:
        got = port()
    assert spec.fired == 1
    assert bool(torch.isnan(got).all())
    assert get_health().n_events == 0 == ref_get_health().n_events


def test_poison_writes_no_view_of_k1s_one_buffer():
    # K1's sums and maxima are views of one buffer: poisoning the pair
    # makes new tensors and leaves the buffer as it was
    buf = torch.arange(7, dtype=torch.float32)
    pair = (buf[:3], buf[3:6])
    with faults.inject("kernel.segment_reduce", "corrupt"):
        sums, maxs = faults.poison("kernel.segment_reduce", pair)
    assert buf.tolist() == list(range(7))
    assert sums.data_ptr() != buf.data_ptr()
    torch.testing.assert_close(maxs, pair[1] * 1.01 + 1.0)
    ints = torch.tensor([3, 4])
    with faults.inject("kernel.queue_walk", "nan"):
        assert faults.poison("kernel.queue_walk", ints) is ints
    with faults.inject("kernel.queue_walk", "corrupt"):
        assert faults.poison("kernel.queue_walk", ints).tolist() == [4, 5]
    assert ints.tolist() == [3, 4]


# ================================================== caches after a trip ==
@pytest.mark.parametrize("site", ["kernel.segment_reduce",
                                  "stack.device_store"])
def test_a_tripped_stack_caches_nothing_and_answers_clean(site, monkeypatch):
    phase, ref_phase = _phase_pair(seed=9)
    want = ref_stack.PhaseStack.build([ref_phase]).cost_arrays()
    stack = PhaseStack.build([phase], device="cpu")
    monkeypatch.setenv("REPRO_STACK_VERIFY", "parity")
    with pytest.warns(RuntimeWarning):
        with faults.inject(site, "corrupt") as spec:
            with pytest.raises(BackendVerifyError):
                stack.cost_arrays()
    assert spec.fired == 1
    assert stack._ladder_cache == {}
    assert site != "stack.device_store" or stack._device_store == {}
    for got, w in zip(stack.cost_arrays(), want):
        _close(got, w)
    # a delta arena's tables are shipped through the same check
    with faults.inject(site, "corrupt"):
        with pytest.raises(BackendVerifyError):
            DeltaStack.from_phases([phase], device="cpu")
    arena = DeltaStack.from_phases([phase], device="cpu")
    for got, w in zip(arena.cost_arrays(), want):
        _close(got, w)


# =============================================================== service ==
def _raw_patterns(m, k=4, n=48, seed=7):
    rng = np.random.default_rng(seed)
    return [CommPattern(rng.integers(0, m.n_procs, n),
                        rng.integers(0, m.n_procs, n),
                        rng.integers(64, 4096, n).astype(float),
                        n_procs=m.n_procs) for _ in range(k)]


def test_a_verify_trip_is_a_device_failure_of_the_service(monkeypatch):
    m = machine.lassen_machine((2, 2, 2))
    pats = _raw_patterns(m)
    clean = StrategyService(m, device="cpu").query_many(pats)
    health.reset_health()        # the breaker is made anew, on this clock
    t = [0.0]
    get_health().breaker_for("cpu", fail_threshold=2, reset_after=1.0,
                             clock=lambda: t[0])
    svc = StrategyService(m, device="cpu", breaker_threshold=2,
                          breaker_reset=1.0)
    monkeypatch.setenv("REPRO_STACK_VERIFY", "parity")
    with pytest.warns(RuntimeWarning):
        with faults.inject("kernel.segment_reduce", "corrupt"):
            first = svc.query_many(pats[:2])
            assert svc._breaker().state == "closed"
            second = svc.query(pats[2])
    # the sweep failed (a device failure, not an input fault), then each
    # pattern alone in the worst case; the second failure opens the breaker
    for r in first:
        assert not r.ok and r.degraded
        assert isinstance(r.error, BackendVerifyError)
        assert not isinstance(r.error, PatternError)
    assert isinstance(second.error, BackendUnavailable)
    assert isinstance(second.error.__cause__, BackendVerifyError)
    assert svc._breaker().state == "open" and svc._breaker().n_opens == 1
    assert svc.cache.n_entries == 0
    assert get_health().events_for("cpu", "serve.query_many")
    assert get_health().events_for("cpu", "kernel.segment_reduce")
    t[0] = 1.5                                   # disarmed, after the hold
    healed = svc.query_many(pats)
    assert svc._breaker().state == "closed"
    for h, c in zip(healed, clean):
        assert h.ok and not h.degraded
        assert (h.verdict.model, h.verdict.sim) == (c.verdict.model,
                                                    c.verdict.sim)


def test_reprice_catches_a_verify_trip_and_keeps_no_mutated_arena(
        monkeypatch):
    m = machine.lassen_machine((2, 2, 2))
    old, = _raw_patterns(m, k=1, seed=12)
    new = CommPattern(old.src.copy(), old.dst.copy(), old.size.copy(),
                      n_procs=m.n_procs)
    new.size[:3] *= 2.0                          # a small drift
    want = StrategyService(m, device="cpu").query(new)
    svc = StrategyService(m, device="cpu", breaker_threshold=5)
    assert svc.query(old).ok
    assert svc.reprice(old, old).ok              # the arena of ``old`` kept
    kept = dict(svc._arenas)
    monkeypatch.setenv("REPRO_STACK_VERIFY", "parity")
    with pytest.warns(RuntimeWarning):
        with faults.inject("kernel.segment_reduce", "corrupt"):
            r = svc.reprice(old, new)
    assert not r.ok and isinstance(r.error, BackendVerifyError)
    assert get_health().events_for("cpu", "serve.reprice")
    assert dict(svc._arenas) == kept             # no arena of the trip
    again = svc.reprice(old, new)
    assert again.ok and not again.degraded
    assert again.verdict.model_winner == want.verdict.model_winner
    for k in want.verdict.model:
        _close(again.verdict.model[k], want.verdict.model[k])
        _close(again.verdict.sim[k], want.verdict.sim[k])


# ============================================== the chaos registry sweep ==
@pytest.fixture(scope="module")
def clean_reference_rows():
    """The reference's registry sweep on its numpy backend, no fault."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_STACK_BACKEND", "numpy")
        mp.delenv("REPRO_STACK_VERIFY", raising=False)
        mp.delenv(ref_faults.ENV_VAR, raising=False)
        rows = ref_registry.sweep(machines=ref_registry.default_machines())
    assert rows and not any(r.degraded for r in rows)
    return {(r.machine, r.scenario, r.phase): r for r in rows}


def _arm(monkeypatch, mode, verify):
    monkeypatch.setenv("REPRO_STACK_VERIFY", verify)
    monkeypatch.setenv(faults.ENV_VAR, f"*:{mode}")
    faults._env_cache.clear()


def _disarm(monkeypatch):
    monkeypatch.delenv("REPRO_STACK_VERIFY", raising=False)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults._env_cache.clear()


_CHAOS = [("raise", ""), ("timeout", ""), ("nan", "finite"),
          ("corrupt", "parity")]


@pytest.mark.parametrize("mode,verify", _CHAOS)
def test_chaos_registry_sweep_raises_and_heals(mode, verify, monkeypatch,
                                               clean_reference_rows):
    machines = default_machines()
    _arm(monkeypatch, mode, verify)
    rows = None
    with pytest.raises(RAISED[mode]):
        rows = sweep(machines=machines, device="cpu")
    assert rows is None
    spec, = faults.active_specs()
    assert spec.fired >= 1
    if mode in CHECK:
        assert "BackendVerifyError" in get_health().events[0].error
    _disarm(monkeypatch)
    rows = sweep(machines=machines, device="cpu")
    assert len(rows) == len(clean_reference_rows)
    for r in rows:
        want = clean_reference_rows[(r.machine, r.scenario, r.phase)]
        assert (r.model_winner, r.sim_winner) == (want.model_winner,
                                                  want.sim_winner)
        _close([r.model, r.sim], [want.model, want.sim])


@pytest.mark.parametrize("mode,verify", _CHAOS)
def test_chaos_registry_through_the_service_sheds_and_heals(
        mode, verify, monkeypatch, clean_reference_rows):
    machines = default_machines()
    names = [(sc.name, ph) for sc in DEFAULT_SCENARIOS
             for ph, _ in scenario_patterns(sc)]
    batch = [p for sc in DEFAULT_SCENARIOS for _, p in scenario_patterns(sc)]
    t = [0.0]
    get_health().breaker_for("cpu", fail_threshold=2, reset_after=5.0,
                             clock=lambda: t[0])
    services = {name: StrategyService(m, device="cpu", breaker_threshold=2,
                                      breaker_reset=5.0)
                for name, m in machines.items()}
    _arm(monkeypatch, mode, verify)
    answered = []
    with pytest.warns(RuntimeWarning):
        for svc in services.values():
            for p in batch:                      # one query a pattern
                answered.append(svc.query(p))
    assert len(answered) == len(machines) * len(batch)
    assert all(r.verdict is None and not r.ok for r in answered)
    # the first pattern fails on the device, the second opens the breaker,
    # every later one is shed
    assert isinstance(answered[0].error, RAISED[mode])
    assert isinstance(answered[1].error, BackendUnavailable)
    assert isinstance(answered[1].error.__cause__, RAISED[mode])
    assert all(isinstance(r.error, BackendUnavailable)
               for r in answered[1:])
    assert services["lassen"]._breaker().state == "open"
    for svc in services.values():                # nothing rejected cached
        assert svc.cache.n_entries == 0 and not svc._arenas
    _disarm(monkeypatch)
    t[0] = 5.5                                   # past the breaker's hold
    for mname, svc in services.items():
        for (sc, ph), r in zip(names, svc.query_many(batch)):
            assert r.ok and not r.degraded and not r.cached, r.error
            want = clean_reference_rows[(mname, sc, ph)]
            v = r.verdict
            assert (v.model_winner, v.sim_winner) == (want.model_winner,
                                                      want.sim_winner)
            _close([v.model[v.model_winner], v.sim[v.sim_winner]],
                   [want.model, want.sim])
    assert services["lassen"]._breaker().state == "closed"


# ============================================================ on the card ==
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("site,mode", [
    ("kernel.segment_reduce", "nan"), ("kernel.segment_reduce", "corrupt"),
    ("kernel.queue_walk", "corrupt"), ("stack.device_store", "nan"),
    ("stack.device_store", "corrupt")])
def test_cuda_sites_poison_and_verify(cuda, site, mode, monkeypatch):
    vals, ids, n_seg = _k1_inputs()
    posted, arrival, bounds = _k2_inputs()
    calls = {
        "kernel.segment_reduce": lambda: ks.segment_reduce(
            torch.from_numpy(vals.astype(np.float32)).to(cuda),
            torch.from_numpy(ids.astype(np.int32)).to(cuda), n_seg),
        "kernel.queue_walk": lambda: ks.queue_walk(
            *(torch.from_numpy(a).to(cuda) for a in (posted, arrival,
                                                      bounds))),
        "stack.device_store": lambda: put_column(vals, "size", cuda)}
    clean = calls[site]()
    ks.reset_launches()
    monkeypatch.setenv("REPRO_STACK_VERIFY", CHECK[mode])
    with pytest.warns(RuntimeWarning, match="BackendVerifyError"):
        with faults.inject(site, mode) as spec:
            with pytest.raises(BackendVerifyError):
                calls[site]()
    assert spec.fired == 1
    assert get_health().events_for(str(cuda) + ":0", site) or \
        get_health().events_for(str(cuda), site)
    if site.startswith("kernel."):               # the kernel did launch
        assert ks.LAUNCHES[site.split(".")[1]] == 1
    monkeypatch.delenv("REPRO_STACK_VERIFY")
    for a, b in zip(ks._leaves(calls[site]()), ks._leaves(clean)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
