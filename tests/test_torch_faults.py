"""Fault injection, the health ledger, admission and the arena cache of the
PyTorch port against the JAX package's.

Counterparts of ``tests/test_faults.py`` (the framework part),
``tests/test_admission.py`` (deadlines, admission, retry, breakers, the
event ring) and ``tests/test_serve_cache.py`` (the cache): every scenario
runs through ``repro_torch`` and, where the reference has the same object,
through ``repro`` on the same inputs, and the two must behave the same —
the same fault firings and exception types, bit-equal poisoned outputs,
equal breaker state sequences under one injected clock, equal retry delays
for one seed, byte-identical cache entries and snapshots.  The port's
``SITES`` are the reference's without ``autotune.*``.

Also here: the kernel build serialises concurrent first calls
(``repro_torch.kernels.build``), checked with ``nvcc`` replaced by a stub.
"""
import glob
import json
import os
import stat
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import faults as ref_faults  # noqa: E402
from repro.comm import health as ref_health  # noqa: E402
from repro.serve import admission as ref_admission  # noqa: E402
from repro.serve import cache as ref_cache  # noqa: E402
from repro_torch.comm import faults, health  # noqa: E402
from repro_torch.comm.health import (BackendHealth,  # noqa: E402
                                     CircuitBreaker, get_health)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serve import (AdmissionQueue, ArenaCache,  # noqa: E402
                               Deadline, DeadlineExceeded, Overloaded,
                               RetryPolicy)
from repro_torch.serve import cache as port_cache  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_port_health():
    """Reset the port's health ledger and fault-plan cache around every
    test (``tests/conftest.py`` resets only the reference's)."""
    health.reset_health()
    faults._env_cache.clear()
    yield
    health.reset_health()
    faults._env_cache.clear()


def _outcome(mod, site):
    """What ``mod.fail_point(site)`` does: None, "raise" or "timeout"."""
    try:
        mod.fail_point(site)
    except mod.InjectedTimeout:
        return "timeout"
    except mod.InjectedFault:
        return "raise"
    return None


# ================================================================ faults ==
def test_sites_are_the_reference_sites_without_autotune():
    assert faults.SITES == tuple(s for s in ref_faults.SITES
                                 if not s.startswith("autotune."))
    assert faults.MODES == ref_faults.MODES
    assert faults.ENV_VAR == ref_faults.ENV_VAR
    assert issubclass(faults.InjectedTimeout, TimeoutError)
    assert issubclass(faults.InjectedTimeout, faults.InjectedFault)


@pytest.mark.parametrize("spec,site", [
    ("kernel.*", "kernel.segment_reduce"),
    ("kernel.*", "stack.device_store"),
    ("serve.cache_*", "serve.cache_write"),
    ("serve.cache_*", "serve.deadline"),
    ("*", "kernel.queue_walk"),
    ("stack.device_store", "stack.device_store"),
    ("*.deadline", "serve.deadline"),
    ("kernel.?ueue_walk", "kernel.queue_walk")])
def test_glob_matching_equals_the_reference(spec, site):
    got = faults.FaultSpec(site=spec, mode="raise").matches(site)
    assert got == ref_faults.FaultSpec(site=spec, mode="raise").matches(site)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="explode"), "unknown fault mode"),
    (dict(mode="raise", times=0), "times must be >= 1")])
def test_spec_validation_equals_the_reference(kw, match):
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match=match):
            mod.FaultSpec(site="kernel.queue_walk", **kw)


@pytest.mark.parametrize("plan", [
    "kernel.*:raise, serve.cache_read:timeout:1",
    "serve.*:timeout:2",
    "*:raise:1",
    "stack.device_store:raise,kernel.queue_walk:timeout",
    "kernel.queue_walk:timeout:1,kernel.*:raise:2",
    " ,serve.deadline:raise:3, "])
def test_env_plan_firings_equal_the_reference(plan, monkeypatch):
    # the same plan, the same calls: the same outcome at every call
    monkeypatch.setenv(faults.ENV_VAR, plan)
    ref_faults._env_cache.clear()
    for _ in range(3):
        for site in faults.SITES:
            assert _outcome(faults, site) == _outcome(ref_faults, site), site
    assert faults.any_armed() == ref_faults.any_armed()
    assert ([(s.site, s.mode, s.times, s.fired)
             for s in faults._env_specs()]
            == [(s.site, s.mode, s.times, s.fired)
                for s in ref_faults._env_specs()])


@pytest.mark.parametrize("plan", ["kernel.segment_reduce",
                                  "a:raise:1:2", "kernel.*:melt"])
def test_bad_env_entries_raise_as_the_reference(plan, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, plan)
    ref_faults._env_cache.clear()
    with pytest.raises(ValueError) as want:
        ref_faults.any_armed()
    with pytest.raises(ValueError) as got:
        faults.any_armed()
    assert str(got.value) == str(want.value)


def test_inject_nesting_times_and_counts_equal_the_reference():
    seen = {}
    for mod in (faults, ref_faults):
        out = []
        with mod.inject("kernel.*", "raise") as outer:
            with mod.inject("kernel.queue_walk", "timeout", times=2) as inner:
                for _ in range(3):
                    out.append(_outcome(mod, "kernel.queue_walk"))
                out.append(_outcome(mod, "stack.device_store"))
            out.append(_outcome(mod, "kernel.segment_reduce"))
        out.append(_outcome(mod, "kernel.segment_reduce"))
        seen[mod.__name__] = (out, outer.fired, inner.fired, inner.armed)
    assert seen["repro_torch.comm.faults"] == seen["repro.comm.faults"]
    assert seen["repro.comm.faults"][0] == ["timeout", "timeout", "raise",
                                            None, "raise", None]


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (str, bytes)):
        assert type(a) is type(b) and a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


_VALUES = {
    "float64": lambda: np.array([1.0, -2.5, 3e10, 0.0]),
    "float32": lambda: np.array([1.0, -2.5, 7.25], dtype=np.float32),
    "int64": lambda: np.array([1, 2, -3, 2 ** 40]),
    "int32": lambda: np.array([[0, 5], [7, -1]], dtype=np.int32),
    "str": lambda: '{"version": 1, "body": {}}',
    "bytes": lambda: b'{"x": 1}',
    "tuple": lambda: (np.array([0.5, 1.5]), np.array([3, 4]), "s"),
}


@pytest.mark.parametrize("mode", ["nan", "corrupt"])
@pytest.mark.parametrize("kind", sorted(_VALUES))
def test_poison_is_bit_equal_to_the_reference(mode, kind):
    with faults.inject("serve.cache_read", mode) as spec:
        got = faults.poison("serve.cache_read", _VALUES[kind]())
    with ref_faults.inject("serve.cache_read", mode) as ref_spec:
        want = ref_faults.poison("serve.cache_read", _VALUES[kind]())
    _same(got, want)
    assert spec.fired == ref_spec.fired == 1
    value = _VALUES[kind]()
    assert faults.poison("serve.cache_read", value) is value   # disarmed


def _device_site_calls():
    """One call of each device site on CPU tensors: K1's and K2's
    wrappers and an arena column's shipping."""
    from repro_torch.comm.stack import put_column
    from repro_torch.kernels import comm_stack as ks
    return {
        "kernel.segment_reduce": lambda: ks.segment_reduce(
            torch.tensor([1.0, 2.5, 4.0]),
            torch.tensor([0, 1, 0], dtype=torch.int32), 2),
        "kernel.queue_walk": lambda: ks.queue_walk(
            torch.tensor([1, 0, 2, 0]), torch.tensor([2, 0, 1, 0]),
            torch.tensor([0, 3, 4])),
        "stack.device_store": lambda: put_column(
            np.array([64.0, 4096.0]), "size", torch.device("cpu")),
    }


@pytest.mark.parametrize("site", ["kernel.segment_reduce", "kernel.*",
                                  "stack.device_store", "*"])
@pytest.mark.parametrize("mode", ["nan", "corrupt"])
def test_poison_specs_at_the_device_sites_fire_and_are_caught(
        site, mode, monkeypatch):
    # a poison spec arms at every device site it covers, fires once a call
    # there, and the matching check (nan: finite, corrupt: parity) rejects
    # the damage; nan leaves K2's integer steps intact, so they pass
    from repro_torch.kernels.comm_stack import BackendVerifyError
    monkeypatch.setenv("REPRO_STACK_VERIFY",
                       {"nan": "finite", "corrupt": "parity"}[mode])
    hit = 0
    with pytest.warns(RuntimeWarning, match="BackendVerifyError"):
        with faults.inject(site, mode) as spec:
            for name, call in _device_site_calls().items():
                if not spec.matches(name):
                    continue
                if mode == "nan" and name == "kernel.queue_walk":
                    assert call().tolist() == [3, 2, 1, 1]
                else:
                    with pytest.raises(BackendVerifyError):
                        call()
                hit += 1
                assert spec.fired == hit, name
    assert hit == {"kernel.segment_reduce": 1, "kernel.*": 2,
                   "stack.device_store": 1, "*": 3}[site]
    # the same spec arms from the env plan beside a service site
    monkeypatch.setenv(faults.ENV_VAR, f"serve.cache_read:raise,{site}:{mode}")
    assert [(s.site, s.mode) for s in faults.active_specs()] == [
        ("serve.cache_read", "raise"), (site, mode)]


# ======================================================== health ledger ==
_SCRIPTS = {
    # F failure, S success, A allow, T+n advance the clock, R reset
    "trip_and_heal": "A F A F A A T+11 A A S A",
    "probe_fails": "F F F A T+6 A F A A T+4 A T+2 A S",
    "success_resets_streak": "F F S F F A F A",
    "threshold_one": "F A T+0.5 A F A T+5 A S F A R A",
    "shed_counting": "F F F A A A T+10 A A A F A",
}


def _run_breaker(mod, script, fail_threshold, reset_after):
    t = [0.0]
    br = mod.CircuitBreaker("cuda:0", fail_threshold=fail_threshold,
                            reset_after=reset_after, clock=lambda: t[0])
    trace = []
    for step in script.split():
        if step == "F":
            br.record_failure()
        elif step == "S":
            br.record_success()
        elif step == "R":
            br.reset()
        elif step == "A":
            trace.append(br.allow())
        else:
            t[0] += float(step[2:])
        trace.append((br.state, br.n_opens, br.n_shed))
    return trace


@pytest.mark.parametrize("threshold,reset_after", [(2, 10.0), (3, 5.0),
                                                   (1, 1.0)])
@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_breaker_state_sequences_equal_the_reference(name, threshold,
                                                     reset_after):
    got = _run_breaker(health, _SCRIPTS[name], threshold, reset_after)
    assert got == _run_breaker(ref_health, _SCRIPTS[name], threshold,
                               reset_after)
    assert health.BREAKER_STATES == ref_health.BREAKER_STATES


def test_breaker_validates_and_registers_per_device():
    with pytest.raises(ValueError, match="fail_threshold"):
        CircuitBreaker("cuda:0", fail_threshold=0)
    with pytest.raises(ValueError, match="reset_after"):
        CircuitBreaker("cuda:0", reset_after=-1.0)
    h = get_health()
    br = h.breaker_for("cuda:0", fail_threshold=2)
    assert h.breaker_for("cuda:0", fail_threshold=9) is br  # first wins
    assert br.fail_threshold == 2
    assert h.breaker_for("cpu") is not br
    with pytest.warns(RuntimeWarning, match="BackendUnavailable"):
        br.record_failure()
        br.record_failure()
    assert br.state == "open" and h.warned("breaker:cuda:0")
    h.reset()
    assert h.breaker_for("cuda:0") is not br     # reset clears the registry
    assert not h.warned("breaker:cuda:0")


@pytest.mark.parametrize("cap,n", [(4, 10), (1, 3), (7, 7), (5, 2)])
def test_event_ring_wraps_as_the_reference(cap, n):
    port, ref = BackendHealth(max_events=cap), \
        ref_health.BackendHealth(max_events=cap)
    for h in (port, ref):
        with pytest.warns(RuntimeWarning):
            for i in range(n):
                h.record_failure("cuda:0" if i % 3 else "cache",
                                 "kernel.segment_reduce", ValueError(str(i)))

    def view(h):
        evs = h.events
        return ([(e.seq - evs[0].seq, e.backend, e.site, e.error)
                 for e in evs], h.n_events, h.dropped_events,
                [(e.backend, e.error) for e in h.events_for("cache")])

    assert view(port) == view(ref)
    assert port.n_events == len(port.events) + port.dropped_events
    port.reset()
    assert (port.n_events, port.dropped_events, port.events) == (0, 0, ())


def test_ring_cap_from_env(monkeypatch):
    assert BackendHealth()._events.maxlen == health.DEFAULT_MAX_EVENTS \
        == ref_health.DEFAULT_MAX_EVENTS
    monkeypatch.setenv("REPRO_HEALTH_MAX_EVENTS", "7")
    h = BackendHealth()
    assert h._events.maxlen == 7
    with pytest.warns(RuntimeWarning):
        for _ in range(9):
            h.record_failure("cuda:0", "kernel.queue_walk", "x")
    assert (h.n_events, h.dropped_events, len(h.events)) == (9, 2, 7)
    with pytest.raises(ValueError, match="max_events"):
        BackendHealth(max_events=0)


def test_warn_once_survives_ring_wrap():
    import warnings
    h = BackendHealth(max_events=2)
    with pytest.warns(RuntimeWarning, match="kernel.segment_reduce"):
        h.record_failure("cuda:0", "kernel.segment_reduce", ValueError("x"))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for _ in range(4):                       # wraps, never re-warns
            h.record_failure("cuda:0", "kernel.segment_reduce",
                             ValueError("y"))
    assert h.n_events == 5 and h.dropped_events == 3
    with pytest.warns(RuntimeWarning, match="once"):
        assert h.warn_once("k", "once") is True
    assert h.warned("k") and h.warn_once("k", "once") is False


def test_health_names_are_the_reference_without_quarantine():
    # the reference quarantines a backend to route it to numpy; the port
    # has one backend, so the quarantine knob is absent, and its one extra
    # name is the shed's error
    assert set(ref_health.__all__) - set(health.__all__) \
        == {"DEFAULT_QUARANTINE_AFTER"}
    assert set(health.__all__) - set(ref_health.__all__) \
        == {"BackendUnavailable"}
    h = BackendHealth()
    for name in ("quarantine_after", "is_quarantined", "record_success",
                 "failure_streak"):
        assert not hasattr(h, name), name


# ======================================= deadline, admission, retry ==
def test_deadline_remaining_and_expiry():
    t = [0.0]
    dl = Deadline(2.0, clock=lambda: t[0])
    assert dl.remaining() == 2.0 and not dl.expired
    dl.check()
    t[0] = 3.0
    assert dl.expired and dl.remaining() == 0.0
    with pytest.raises(DeadlineExceeded, match="sweep"):
        dl.check(where="sweep")
    with pytest.raises(ValueError, match="timeout"):
        Deadline(-1.0)


def test_deadline_site_fires_only_when_armed():
    with faults.inject("serve.deadline", "raise") as spec:
        Deadline(None).check()                   # unarmed: site silent
        assert spec.fired == 0
        with pytest.raises(DeadlineExceeded, match="injected"):
            Deadline(1000.0).check(where="probe")
    assert spec.fired == 1
    assert issubclass(DeadlineExceeded, TimeoutError)
    # the reference's deadline does not see the port's plan, and back
    with ref_faults.inject("serve.deadline", "raise"):
        Deadline(1000.0).check()


def test_admission_policies_as_the_reference():
    for mod in (ref_admission, None):
        Q = AdmissionQueue if mod is None else mod.AdmissionQueue
        Over = Overloaded if mod is None else mod.Overloaded
        q = Q(capacity=2, policy="reject")
        q.acquire(2)
        with pytest.raises(Over, match="shed"):
            q.acquire(1)
        assert q.n_shed == 1 and q.pending == 2
        q.release(2)
        q.acquire(10)                            # idle: oversized admitted
        with pytest.raises(Over):
            q.acquire(1)
        q.release(10)
        assert (q.n_admitted, q.pending, q.n_shed) == (12, 0, 2)
    for kw, match in ((dict(capacity=0), "capacity"),
                      (dict(policy="drop-oldest"), "policy")):
        with pytest.raises(ValueError, match=match):
            AdmissionQueue(**kw)
    with pytest.raises(ValueError, match="units"):
        AdmissionQueue().acquire(-1)


def test_admission_block_policy_waits_and_respects_deadline():
    q = AdmissionQueue(capacity=1, policy="block")
    q.acquire(1)
    got = []

    def waiter():
        with q.admit(1):
            got.append(True)

    th = threading.Thread(target=waiter)
    th.start()
    assert not got
    q.release(1)
    th.join(timeout=5)
    assert got == [True]
    q.acquire(1)
    t = [0.0]
    with pytest.raises(DeadlineExceeded, match="admission"):
        q.acquire(1, Deadline(0.0, clock=lambda: t[0]))
    assert q.n_shed == 1
    q.release(1)


@pytest.mark.parametrize("kw", [
    dict(attempts=5, base=0.1, cap=2.0, jitter=0.5, seed=7),
    dict(attempts=3, base=0.01, cap=0.05, jitter=1.0, seed=0),
    dict(attempts=2, base=0.1, jitter=0.0)])
def test_retry_delays_equal_the_reference(kw):
    port, ref = RetryPolicy(**kw), ref_admission.RetryPolicy(**kw)
    assert [port.delay(i) for i in range(8)] == \
        [ref.delay(i) for i in range(8)]


def test_retry_runs_reraises_and_honours_deadline():
    runs = {}
    for mod in (ref_admission, None):
        RP = RetryPolicy if mod is None else mod.RetryPolicy
        sleeps, seen, n = [], [], [0]

        def flaky():
            n[0] += 1
            if n[0] < 3:
                raise ValueError("boom")
            return "ok"

        rp = RP(attempts=3, base=0.01, seed=1, sleep=sleeps.append)
        assert rp.run(flaky, on_failure=lambda e, a: seen.append(a)) == "ok"
        runs[mod is None] = (sleeps, seen)
    assert runs[True] == runs[False] and runs[True][1] == [0, 1]
    with pytest.raises(ZeroDivisionError):
        RetryPolicy(attempts=2, base=0.0,
                    sleep=lambda s: None).run(lambda: 1 / 0)
    t = [0.0]
    dl = Deadline(1.0, clock=lambda: t[0])

    def fail_and_expire():
        t[0] = 2.0
        raise ValueError("first attempt")

    with pytest.raises(DeadlineExceeded):
        RetryPolicy(attempts=5, base=0.0, sleep=lambda s: None).run(
            fail_and_expire, deadline=dl)
    for kw, match in ((dict(attempts=0), "attempts"),
                      (dict(jitter=2.0), "jitter"), (dict(base=-1), "base")):
        with pytest.raises(ValueError, match=match):
            RetryPolicy(**kw)


# ================================================================ cache ==
_BODIES = [
    {"model": {"standard": 1.5e-05, "two_step": 2.25e-05},
     "sim": {"standard": 1.75e-05}, "model_winner": "standard",
     "sim_winner": "standard"},
    {"x": 1, "y": [1.5, 2.5], "z": None, "w": "text é"},
    {},
    {"nested": {"b": {"a": [0.1, 0.2, 0.30000000000000004]}}},
]


@pytest.mark.parametrize("i", range(len(_BODIES)))
def test_wrap_bytes_equal_the_reference(i):
    body = _BODIES[i]
    assert port_cache._wrap(body) == ref_cache._wrap(body)
    assert port_cache._canonical(body) == ref_cache._canonical(body)
    assert port_cache._unwrap(ref_cache._wrap(body)) == body
    assert port_cache.CACHE_VERSION == ref_cache.CACHE_VERSION


def test_snapshots_and_disk_entries_equal_the_reference(tmp_path):
    port = ArenaCache(str(tmp_path / "port"), max_entries=3)
    ref = ref_cache.ArenaCache(str(tmp_path / "ref"), max_entries=3)
    for c in (port, ref):
        for i, body in enumerate(_BODIES):
            c.put(f"key{i}", body)                 # the first is evicted
        c.get("key2")
    assert port.snapshot() == ref.snapshot()
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    names = {c: sorted(os.path.basename(f) for f in
                       glob.glob(os.path.join(c.path, "*.json")))
             for c in (port, ref)}
    assert names[port] == names[ref] and len(names[port]) == len(_BODIES)
    for name in names[port]:
        with open(os.path.join(port.path, name), "rb") as f, \
                open(os.path.join(ref.path, name), "rb") as g:
            assert f.read() == g.read()
    assert port.stats() == ref.stats()
    # each side restores the other's snapshot and reads its disk
    assert ArenaCache().restore(ref.snapshot()) == 3
    assert ref_cache.ArenaCache().restore(port.snapshot()) == 3
    assert ArenaCache(ref.path).get("key0") == _BODIES[0]


def test_cache_memory_lru():
    c = ArenaCache(max_entries=2)
    assert c.get("a") is None and c.stats()["misses"] == 1
    c.put("a", {"x": 1})
    c.put("b", {"x": 2})
    c.put("c", {"x": 3})
    assert c.get("a") is None and c.get("b") == {"x": 2}
    assert c.n_entries == 2
    c.clear()
    assert c.n_entries == 0
    with pytest.raises(ValueError, match="max_entries"):
        ArenaCache(max_entries=0)


@pytest.mark.parametrize("damage", ["truncate", "garbage", "skew", "tamper"])
def test_damaged_entry_degrades_to_a_miss_with_one_event(tmp_path, damage):
    d = str(tmp_path / "cache")
    ArenaCache(d).put("key", {"x": 1})
    (fname,) = glob.glob(os.path.join(d, "*.json"))
    text = open(fname).read()
    if damage == "truncate":
        text = text[: len(text) // 2]
    elif damage == "garbage":
        text = "\x00not json\x00"
    else:
        obj = json.loads(text)
        if damage == "skew":
            obj["version"] = port_cache.CACHE_VERSION + 1
        else:
            obj["body"] = {"x": 999}
        text = json.dumps(obj)
    with open(fname, "w") as f:
        f.write(text)
    before = get_health().n_events
    c = ArenaCache(d)
    with pytest.warns(RuntimeWarning, match="serve.cache_read"):
        assert c.get("key") is None
    assert c.stats()["rejected"] == 1
    assert get_health().n_events == before + 1
    (ev,) = get_health().events_for("cache", "serve.cache_read")
    # the reference rejects the same bytes with the same error
    ref = ref_cache.ArenaCache(d)
    assert ref.get("key") is None and ref.stats()["rejected"] == 1
    assert ev.error == ref_health.get_health().events_for(
        "cache", "serve.cache_read")[-1].error


def test_cache_fault_sites(tmp_path):
    d = str(tmp_path / "cache")
    c = ArenaCache(d)
    with pytest.warns(RuntimeWarning):
        with faults.inject("serve.cache_write", "raise") as spec:
            c.put("k", {"x": 1})
    assert spec.fired == 1 and c.stats()["write_errors"] == 1
    assert c.get("k") == {"x": 1}                # memory tier still serves
    assert ArenaCache(d).get("k") is None        # disk write was skipped
    c.put("k", {"x": 1})
    with pytest.warns(RuntimeWarning):
        with faults.inject("serve.cache_read", "timeout") as spec:
            assert ArenaCache(d).get("k") is None
    assert spec.fired == 1
    with faults.inject("serve.cache_write", "corrupt"):
        c.put("k2", {"x": 2})                    # poisoned bytes on disk
    fresh = ArenaCache(d)
    assert fresh.get("k2") is None and fresh.stats()["rejected"] == 1
    assert fresh.get("k") == {"x": 1}
    with faults.inject("serve.cache_read", "nan") as spec:
        assert ArenaCache(d).get("k") is None    # text garbled in any mode
    assert spec.fired == 1
    assert ArenaCache(d).get("k") == {"x": 1}
    assert glob.glob(os.path.join(d, "*.tmp")) == []


def test_restore_of_a_damaged_snapshot_restores_nothing():
    c = ArenaCache()
    c.put("a", {"x": 1})
    snap = c.snapshot()
    before = get_health().n_events
    with pytest.warns(RuntimeWarning):
        assert ArenaCache().restore(dict(snap, version=2)) == 0
        assert ArenaCache().restore({"entries": {}}) == 0
        assert ArenaCache().restore("junk") == 0
        # checksum-true, but its entries are not a dict
        assert ArenaCache().restore(
            json.loads(port_cache._wrap({"entries": []}))) == 0
    assert get_health().n_events == before + 4
    assert ArenaCache().restore(json.loads(json.dumps(snap))) == 1


# ========================================================= kernel build ==
_STUB = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(os.path.basename(sys.argv[-1]) + "\\n")
if os.path.exists(out):
    sys.exit("two compiles into " + out)
open(out, "w").close()
time.sleep(0.3)
with open(out, "w") as f:
    f.write("library")
"""


def test_concurrent_first_builds_compile_each_source_once(tmp_path,
                                                          monkeypatch):
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("STUB_LOG", str(log))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    errors, barrier = [], threading.Barrier(2)

    def first_call():
        try:
            barrier.wait(timeout=10)
            build.build_kernels()
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors, errors
    calls = log.read_text().split()
    assert sorted(calls) == sorted(build.SOURCES.values())  # once each
    for name in build.SOURCES:
        assert build.library_path(name).read_text() == "library"
    assert not list((tmp_path / "_build").glob("*.tmp"))
    assert build.build_kernels() == {}           # nothing left to build
