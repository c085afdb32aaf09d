"""The execution layer on the PyTorch port against the JAX package's.

The same seeded numpy patterns go through ``repro.exec`` and through
``repro_torch.exec`` with ``device="cpu"`` (K1's plain version):

* schedules equal field by field (payload, unit arrays, each phase's role
  and messages, each round's ``perm`` / ``pack`` / ``stage`` / ``final``)
  for every host preset x strategy x coloring and a property sweep of
  random patterns;
* the port's virtual-rank executor delivers bit-equal to the reference's
  ``run_reference``, and, in a subprocess with the forced 8-device host
  mesh, to the reference's ``shard_map`` executor;
* the digest (float32 through K1) within rtol 1e-4 of the float64
  ``np.bincount(unit_dst, payload)``: payloads reach 2^31 and float32 sums
  are not associative, so the reference's exact float64 equality is not
  the port's bound;
* model predictions and orderings within 1e-4 of the reference; the
  recorded sweeps within 1e-4 and the fitted tables within rel 1e-4 (the
  port's phase times are float32; the reference holds its own fits at
  1e-6).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.exec as rx  # noqa: E402
from repro.comm import strategies as ref_strategies  # noqa: E402
from repro.comm.health import get_health  # noqa: E402
from repro.comm.phase import CommPhase as RefPhase  # noqa: E402
from repro.net import machine as ref_machine  # noqa: E402
import repro_torch.exec as tx  # noqa: E402
from repro_torch.comm import strategies  # noqa: E402
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.exec import lower  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.net import machine  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
CPU = "cpu"
REF_MACHINES = rx.host_machines()
MACHINES = tx.host_machines()
CASES = [(name, strat) for name, m in REF_MACHINES.items()
         for strat in ref_strategies.strategies_for(m)]
IDS = [f"{m}-{s}" for m, s in CASES]


def _messages(n=40, seed=0, n_procs=8, max_size=6000, min_size=1):
    """``n`` seeded messages, none to itself, as ``tests/test_exec.py``
    and ``benchmarks/bench_exec.py`` draw them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_procs, n)
    dst = (src + rng.integers(1, n_procs, n)) % n_procs
    size = rng.integers(min_size, max_size, n).astype(float)
    return src, dst, size


def _phases(name, *msgs, n_procs=8):
    """The same messages bound on the reference's and the port's preset."""
    msgs = msgs or _messages()
    return (RefPhase.build(REF_MACHINES[name], *msgs, n_procs=n_procs),
            CommPhase.build(MACHINES[name], *msgs, n_procs=n_procs))


def _same_schedule(got, want):
    for f in ("strategy", "n_procs", "unit_bytes", "coloring"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("payload", "unit_src", "unit_dst", "unit_msg"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(got.phases) == len(want.phases)
    for pg, pw in zip(got.phases, want.phases):
        assert pg.role == pw.role
        for f in ("msg_src", "msg_dst", "msg_units"):
            assert np.array_equal(getattr(pg, f), getattr(pw, f)), f
        assert len(pg.rounds) == len(pw.rounds)
        for rg, rw in zip(pg.rounds, pw.rounds):
            assert rg.perm == rw.perm
            for f in ("pack", "stage", "final"):
                a, b = getattr(rg, f), getattr(rw, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.n_units, got.n_rounds, got.n_msgs) == (want.n_units,
                                                       want.n_rounds,
                                                       want.n_msgs)


def _bincount(sched):
    return np.bincount(sched.unit_dst, weights=sched.payload.astype(float),
                       minlength=sched.n_procs)


# -- the planner --------------------------------------------------------------

def test_presets_equal_the_reference():
    assert tx.HOST_PROCS == rx.HOST_PROCS
    assert list(MACHINES) == list(REF_MACHINES)
    for name, m in MACHINES.items():
        ref = REF_MACHINES[name]
        for f in dataclasses.fields(ref):
            if f.name not in ("params", "torus"):
                assert getattr(m, f.name) == getattr(ref, f.name), f.name
        assert m.torus.dims == ref.torus.dims and \
            m.torus.wrap == ref.torus.wrap
        assert m.params.locality_names == ref.params.locality_names
        for f in ("alpha", "Rb", "RN"):
            assert np.array_equal(getattr(m.params, f),
                                  getattr(ref.params, f))
        assert m.n_procs == ref.n_procs == tx.HOST_PROCS
    for path in ("host_staged", "device_direct"):
        assert tx.lassen_8(path).cross_node_locality == \
            rx.lassen_8(path).cross_node_locality
        assert tx.frontier_8(path).cross_node_locality == \
            rx.frontier_8(path).cross_node_locality


def test_units_and_payload_equal_the_reference():
    sizes = [0.0, 1.0, 512.0, 513.0, 5120.0, 1e6]
    for ub in (512.0, 64.0, 1000.0):
        assert np.array_equal(tx.units_for(sizes, ub), rx.units_for(sizes, ub))
    msg = np.repeat(np.arange(50), np.arange(50) % 7 + 1)
    got, want = tx.synth_payload(msg), rx.synth_payload(msg)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert (got != 0).all()
    assert tx.UNIT_BYTES == rx.UNIT_BYTES and tx.COLORINGS == rx.COLORINGS


@pytest.mark.parametrize("name,strat", CASES, ids=IDS)
def test_schedules_equal_the_reference(name, strat):
    ref, ph = _phases(name)
    for coloring in tx.COLORINGS:
        got = tx.build_schedule(ph, strat, coloring=coloring)
        _same_schedule(got, rx.build_schedule(ref, strat, coloring=coloring))
        assert tx.pairs_subset_of_plan(got)


@pytest.mark.parametrize("name,strat", CASES, ids=IDS)
def test_schedules_equal_the_reference_at_other_unit_sizes(name, strat):
    ref, ph = _phases(name, *_messages(n=24, seed=5, max_size=20000))
    for ub in (64.0, 4096.0):
        _same_schedule(tx.build_schedule(ph, strat, unit_bytes=ub),
                       rx.build_schedule(ref, strat, unit_bytes=ub))


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 48))
@settings(max_examples=25, deadline=None)
def test_property_random_schedules_equal_the_reference(seed, n):
    for name in ("blue_waters_8", "lassen_8"):
        ref, ph = _phases(name, *_messages(n=n, seed=seed))
        for strat in strategies.strategies_for(MACHINES[name]):
            got = tx.build_schedule(ph, strat)
            _same_schedule(got, rx.build_schedule(ref, strat))
            want = rx.run_reference(got)
            assert np.array_equal(tx.run_reference(got), want)
            assert torch.equal(tx.build_executor(got, device=CPU)(),
                               torch.from_numpy(want))


@pytest.mark.parametrize("name,strat", CASES, ids=IDS)
def test_plan_schedule_and_payload_accounting_equal_the_reference(name,
                                                                  strat):
    ref, ph = _phases(name)
    got = strategies.rewrite(ph, strat)
    want = ref_strategies.rewrite(ref, strat)
    rows, ref_rows = got.schedule(), want.schedule()
    assert strategies.SCHEDULE_DTYPE == ref_strategies.SCHEDULE_DTYPE
    assert rows.dtype == ref_rows.dtype and np.array_equal(rows, ref_rows)
    assert got.total_msgs == want.total_msgs
    assert got.inter_node_msgs == want.inter_node_msgs
    for role in strategies.ROLES:
        a, b = got.phase_by_role(role), want.phase_by_role(role)
        assert (a is None) == (b is None), role
        if a is not None:
            assert np.array_equal(a.src, b.src) and \
                np.array_equal(a.size, b.size)
    for a, b in zip(got.inter_node_pair_bytes(),
                    want.inter_node_pair_bytes()):
        assert np.array_equal(a, b)
    for fn in ("injected_payload", "delivered_payload"):
        a = getattr(strategies, fn)(got)
        assert np.array_equal(a, getattr(ref_strategies, fn)(want)), fn
    # payload conservation against the original phase
    np.testing.assert_allclose(strategies.injected_payload(got),
                               np.bincount(ph.src, weights=ph.size,
                                           minlength=8), rtol=1e-12)
    np.testing.assert_allclose(strategies.delivered_payload(got),
                               np.bincount(ph.dst, weights=ph.size,
                                           minlength=8), rtol=1e-12)


def test_split_strategies_fan_units_across_injectors():
    ref, ph = _phases("blue_waters_8", [1], [6], [8 * 512.0])
    sched = tx.build_schedule(ph, "three_step")
    _same_schedule(sched, rx.build_schedule(ref, "three_step"))
    inter = [p for p in sched.phases if p.role == "inter"]
    assert len(inter) == 1 and inter[0].n_msgs == 4
    assert torch.equal(tx.execute(sched, device=CPU)[0],
                       torch.from_numpy(tx.reference_delivered(sched)))


def test_copy_phases_are_roundless_for_host_staged():
    ref, ph = _phases("lassen_8")
    sched = tx.build_schedule(ph, "host_staged")
    _same_schedule(sched, rx.build_schedule(ref, "host_staged"))
    roles = [p.role for p in sched.phases]
    assert "d2h" in roles and "h2d" in roles
    assert roles == sorted(roles, key=strategies.ROLES.index)
    for p in sched.phases:
        if p.role in ("d2h", "h2d"):
            assert p.n_rounds == 0 and np.array_equal(p.msg_src, p.msg_dst)


def test_rounds_are_permutations_and_per_message_is_one_a_round():
    ref, ph = _phases("frontier_8", *_messages(n=64, seed=7))
    for strat in strategies.strategies_for(MACHINES["frontier_8"]):
        sched = tx.build_schedule(ph, strat)
        naive = tx.build_schedule(ph, strat, coloring="per_message")
        assert sched.n_rounds <= naive.n_rounds
        for p in sched.phases:
            for rnd in p.rounds:
                senders = [s for s, _ in rnd.perm]
                receivers = [d for _, d in rnd.perm]
                assert len(set(senders)) == len(senders)
                assert len(set(receivers)) == len(receivers)
        for p in naive.phases:
            assert p.n_rounds == (0 if p.role in ("d2h", "h2d")
                                  else p.n_msgs)


def test_unknown_coloring_raises():
    _, ph = _phases("lassen_8")
    with pytest.raises(ValueError, match="coloring"):
        tx.build_schedule(ph, "standard", coloring="rainbow")


# -- the executors ------------------------------------------------------------

@pytest.mark.parametrize("name,strat", CASES, ids=IDS)
def test_cpu_executor_delivers_bit_equal_to_run_reference(name, strat):
    _, ph = _phases(name)
    for coloring in tx.COLORINGS:
        sched = tx.build_schedule(ph, strat, coloring=coloring)
        want = rx.run_reference(sched)
        assert np.array_equal(tx.run_reference(sched), want)
        assert np.array_equal(tx.reference_delivered(sched),
                              rx.reference_delivered(sched))
        got, digest = tx.execute(sched, device=CPU)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert torch.equal(got, torch.from_numpy(want))
        assert digest.dtype == torch.float32 and digest.shape == (8,)
        np.testing.assert_allclose(digest.double().numpy(), _bincount(sched),
                                   rtol=RTOL)


def test_initial_buffers_equal_the_reference():
    _, ph = _phases("lassen_8", [0, 3, 5, 2], [0, 4, 5, 6],
                    [64.0, 1024.0, 0.0, 3000.0])
    for strat in strategies.strategies_for(MACHINES["lassen_8"]):
        sched = tx.build_schedule(ph, strat)
        for a, b in zip(lower.initial_buffers(sched),
                        rx.lower.initial_buffers(sched)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_rank_that_sends_and_receives_in_a_round_sends_what_it_held():
    # a ring over the 8 ranks: in a round every rank both sends and
    # receives; the executor reads every send before any add lands, as the
    # serial walk snapshots its sends
    src = np.arange(8)
    ref, ph = _phases("blue_waters_8", src, (src + 1) % 8,
                      np.full(8, 600.0))
    for strat in ("standard", "three_step"):
        sched = tx.build_schedule(ph, strat)
        assert any(set(s for s, _ in r.perm) & set(d for _, d in r.perm)
                   for p in sched.phases for r in p.rounds)
        assert torch.equal(tx.execute(sched, device=CPU)[0],
                           torch.from_numpy(rx.run_reference(sched)))


def test_flat_indices_pass_int32():
    # 8,192 ranks x 165,931 columns is 1.36e9 slots at full width; a wider
    # schedule's rows past 2^31 / W must not wrap
    W = 300_000
    rows = np.array([3, 8191], dtype=np.int64)
    table = np.zeros((8192, 2), dtype=np.int32)
    table[rows] = [[5, W - 1], [7, 0]]
    idx = lower._flat(rows, table, W)
    assert idx.dtype == np.int64
    assert idx.tolist() == [3 * W + 5, 3 * W + W - 1, 8191 * W + 7,
                            8191 * W]
    assert idx.max() > 2 ** 31


def test_edge_cases_empty_self_single_rank():
    m, ref_m = MACHINES["lassen_8"], REF_MACHINES["lassen_8"]
    cases = [((m, ref_m), ([], [], []), 8),
             ((m, ref_m), ([0, 3, 5], [0, 3, 5], [64.0, 1024.0, 0.0]), 8),
             ((m, ref_m), ([0, 0], [0, 0], [100.0, 200.0]), 1)]
    for (pm, rm), msgs, n_procs in cases:
        ph = CommPhase.build(pm, *msgs, n_procs=n_procs)
        ref = RefPhase.build(rm, *msgs, n_procs=n_procs)
        for strat in strategies.strategies_for(m):
            sched = tx.build_schedule(ph, strat)
            _same_schedule(sched, rx.build_schedule(ref, strat))
            assert sched.n_rounds == 0
            got, digest = tx.execute(sched, device=CPU)
            assert torch.equal(got, torch.from_numpy(
                rx.reference_delivered(sched)))
            np.testing.assert_allclose(digest.double().numpy(),
                                       _bincount(sched), rtol=RTOL)


def test_digest_holds_to_the_float64_bincount_at_large_payloads():
    # payloads near 2^31 summed into one rank: float32 cannot hold the
    # sums exactly, the bound can
    _, ph = _phases("blue_waters_8", np.arange(1, 8).repeat(30),
                    np.zeros(210, dtype=np.int64), np.full(210, 5000.0))
    sched = tx.build_schedule(ph, "two_step")
    delivered = tx.run_reference(sched)
    assert sched.payload.max() > 2 ** 30
    want = rx.delivered_digest(delivered, sched)
    assert get_health().n_events == 0
    assert np.array_equal(want, _bincount(sched))
    for arg in (delivered, torch.from_numpy(delivered)):
        got = tx.delivered_digest(arg, sched, device=CPU)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL)
    with pytest.raises(ValueError, match="shape"):
        tx.delivered_digest(delivered[:, 1:], sched, device=CPU)


def test_digest_sums_through_k1(monkeypatch):
    _, ph = _phases("lassen_8")
    sched = tx.build_schedule(ph, "device_direct")
    calls = []
    real = ks.segment_reduce

    def spy(values, ids, n_seg):
        calls.append((values.dtype, ids.dtype, n_seg, values.numel()))
        return real(values, ids, n_seg)

    monkeypatch.setattr(ks, "segment_reduce", spy)
    tx.execute(sched, device=CPU)
    assert calls == [(torch.float32, torch.int32, 8, sched.n_units)]


# The reference's executor on the forced 8-device host mesh, as its own
# tests run it: the lassen_8 cases of ``tests/test_exec.py``'s script, the
# delivered matrices and the reference's device digests printed as JSON.
MESH_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
from repro.comm.health import get_health
from repro.comm.phase import CommPhase
from repro.comm.strategies import strategies_for
from repro.exec import build_schedule, execute, lassen_8

m = lassen_8()
rng = np.random.default_rng(11)
src = rng.integers(0, 8, 40)
dst = (src + rng.integers(1, 8, 40)) % 8
size = rng.integers(1, 6000, 40).astype(float)
ph = CommPhase.build(m, src, dst, size, n_procs=8)
out = {}
for strat in strategies_for(m):
    got, digest = execute(build_schedule(ph, strat), digest_backend="jax")
    out[strat] = {"delivered": np.asarray(got).tolist(),
                  "digest": np.asarray(digest, dtype=float).tolist()}
print(json.dumps({"cases": out, "health_events": get_health().n_events}))
"""


@pytest.fixture(scope="module")
def mesh_results():
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize(
    "strat", ref_strategies.strategies_for(REF_MACHINES["lassen_8"]))
def test_executor_bit_equal_to_the_reference_on_the_8_device_mesh(
        mesh_results, strat):
    assert mesh_results["health_events"] == 0
    case = mesh_results["cases"][strat]
    src, dst, size = _messages(seed=11)
    ph = CommPhase.build(MACHINES["lassen_8"], src, dst, size, n_procs=8)
    sched = tx.build_schedule(ph, strat)
    got, digest = tx.execute(sched, device=CPU)
    want = np.asarray(case["delivered"], dtype=np.int32)
    assert torch.equal(got, torch.from_numpy(want))
    np.testing.assert_allclose(digest.double().numpy(), case["digest"],
                               rtol=RTOL)


# -- measurement --------------------------------------------------------------

def _bench_phase(name="lassen_8"):
    return _phases(name, *_messages(96, 42, 8, 8192, 256))


@pytest.fixture(scope="module")
def lassen_fits():
    """bench_exec's fit of ``lassen_8``: the reference's, then the port's
    on the CPU."""
    ref_rec = rx.record_sweeps(REF_MACHINES["lassen_8"])
    rec = tx.record_sweeps(MACHINES["lassen_8"], device=CPU)
    return (ref_rec, rx.calibrate(ref_rec, REF_MACHINES["lassen_8"].params),
            rec, tx.calibrate(rec, MACHINES["lassen_8"].params))


@pytest.mark.parametrize("level", ["postal", "maxrate", "node_aware",
                                   "queue", "contention"])
def test_predicted_costs_and_orderings_equal_the_reference(level,
                                                           lassen_fits):
    ref, ph = _bench_phase()
    for ref_params, params in ((None, None),
                               (lassen_fits[1].params,
                                lassen_fits[3].params)):
        want = rx.predicted_costs(ref, level=level, params=ref_params)
        got = tx.predicted_costs(ph, level=level, params=params, device=CPU)
        assert list(got) == list(want)
        np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                                   rtol=RTOL, atol=ATOL)
        assert tx.ordering(got) == rx.ordering(want)
        assert tx.pairwise_agreement(got, want) == 1.0


def test_ordering_and_agreement_equal_the_reference():
    a = {"standard": 3.0, "two_step": 1.0, "three_step": 1.0, "x": 0.5}
    b = {"standard": 1.0, "two_step": 2.0, "three_step": 3.0, "x": 0.1}
    assert tx.ordering(a) == rx.ordering(a)
    assert tx.pairwise_agreement(a, b) == rx.pairwise_agreement(a, b)
    assert tx.pairwise_agreement({"a": 1.0}, {"a": 2.0}) == 1.0
    with pytest.raises(ValueError, match="different strategies"):
        tx.pairwise_agreement(a, {"standard": 1.0})


def test_time_schedule_and_measure_strategies_on_the_cpu():
    _, ph = _bench_phase()
    sched = tx.build_schedule(ph, "three_step")
    meas = tx.time_schedule(sched, device=CPU, reps=3, warmup=1)
    assert meas.median_s > 0 and len(meas.times_s) == 3
    assert meas.n_rounds == sched.n_rounds > 0
    swept = tx.measure_strategies(ph, device=CPU, reps=1, warmup=1)
    assert list(swept) == list(strategies.strategies_for(ph.machine))
    for name, (s, m) in swept.items():
        _same_schedule(s, tx.build_schedule(ph, name))
        assert m.median_s > 0
    assert tx.launch_overhead(ph, device=CPU, reps=2, warmup=1) > 0


# -- calibration --------------------------------------------------------------

CAL_PRESETS = {
    "lassen": ("lassen_machine", (2, 2, 2)),
    "frontier": ("frontier_machine", (2, 2, 2)),
    "blue_waters": ("blue_waters_machine", (2, 1, 1)),
}


@pytest.fixture(scope="module", params=sorted(CAL_PRESETS))
def calibrated(request):
    fn, dims = CAL_PRESETS[request.param]
    ref_m, m = getattr(ref_machine, fn)(dims), getattr(machine, fn)(dims)
    ref_rec, rec = rx.record_sweeps(ref_m), tx.record_sweeps(m, device=CPU)
    return (ref_m, ref_rec, rx.calibrate(ref_rec, ref_m.params),
            m, rec, tx.calibrate(rec, m.params))


def _same_table(got, want):
    for f in ("alpha", "Rb", "RN"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    assert (got.n_rails, got.gamma, got.delta) == (want.n_rails, want.gamma,
                                                   want.delta)
    assert got.locality_names == want.locality_names


def test_recorded_sweeps_equal_the_reference(calibrated):
    _, ref_rec, _, _, rec, _ = calibrated
    assert rec.machine == ref_rec.machine and rec.ppn_size == ref_rec.ppn_size
    assert np.array_equal(rec.sizes, ref_rec.sizes)
    assert list(rec.pingpong) == list(ref_rec.pingpong)
    for kind, times in ref_rec.pingpong.items():
        np.testing.assert_allclose(rec.pingpong[kind], times, rtol=RTOL,
                                   err_msg=kind)
    assert list(rec.ppn) == list(ref_rec.ppn)
    for kind, (ks_, ts) in ref_rec.ppn.items():
        assert np.array_equal(rec.ppn[kind][0], ks_)
        np.testing.assert_allclose(rec.ppn[kind][1], ts, rtol=RTOL)


def test_calibrated_tables_equal_the_reference(calibrated):
    ref_m, _, ref_res, m, _, res = calibrated
    _same_table(res.params, ref_res.params)
    assert res.n_rails == ref_res.n_rails == m.params.n_rails
    assert res.rails_by_class == ref_res.rails_by_class
    assert res.fitted_classes == ref_res.fitted_classes
    # the fitted alpha absorbs gamma; rates recover the ground truth
    true = m.params
    for kind in res.fitted_classes:
        li = true.class_index(kind)
        np.testing.assert_allclose(res.params.Rb[li], true.Rb[li],
                                   rtol=RTOL)
        np.testing.assert_allclose(res.params.alpha[li],
                                   true.alpha[li] + true.gamma, rtol=RTOL)


def test_record_json_round_trip_and_the_reference_record(calibrated):
    ref_m, ref_rec, ref_res, m, rec, res = calibrated
    back = tx.SweepRecord.from_json(rec.to_json())
    assert back.machine == rec.machine and np.array_equal(back.sizes,
                                                          rec.sizes)
    for kind in rec.pingpong:
        assert np.array_equal(back.pingpong[kind], rec.pingpong[kind])
    for kind in rec.ppn:
        assert np.array_equal(back.ppn[kind][1], rec.ppn[kind][1])
    again = tx.calibrate(back, m.params)
    assert np.array_equal(again.params.alpha, res.params.alpha)
    assert np.array_equal(again.params.RN, res.params.RN)
    # the reference's record, shipped as JSON, fitted by the port
    from_ref = tx.calibrate(tx.SweepRecord.from_json(ref_rec.to_json()),
                            m.params)
    _same_table(from_ref.params, ref_res.params)
    assert from_ref.rails_by_class == ref_res.rails_by_class


def _crossover_verdicts(mods, machine_mod, exec_mod, **kw):
    """``benchmarks/bench_exec.py``'s ``bench_exec_agreement`` loop on one
    implementation: per machine, a table fitted from its recorded sweeps
    and ``best_strategy_many`` over the GPU strategies with it."""
    phase_cls, strat_mod = mods
    out = {}
    for fn, dims in (("lassen_machine", (2, 2, 2)),
                     ("frontier_machine", (2, 2, 1))):
        m = getattr(machine_mod, fn)(dims)
        rec_kw = {"device": CPU} if "device" in kw else {}
        fitted = exec_mod.calibrate(exec_mod.record_sweeps(m, **rec_kw),
                                    m.params).params
        phases = [phase_cls.build(m, *_messages(n, 42, m.n_procs, 8192,
                                                256), n_procs=m.n_procs)
                  for n in (8, 32, 128, 512, 2048)]
        out[m.name] = strat_mod.best_strategy_many(
            phases, strategies=strat_mod.GPU_STRATEGIES, seed=0,
            params=fitted, **kw)
    return out


def test_calibrated_agreement_equals_the_reference():
    want = _crossover_verdicts((RefPhase, ref_strategies), ref_machine, rx,
                               backend="numpy")
    got = _crossover_verdicts((CommPhase, strategies), machine, tx,
                              device=CPU)
    for name, vs in want.items():
        for g, w in zip(got[name], vs):
            assert (g.model_winner, g.sim_winner) == (w.model_winner,
                                                      w.sim_winner)
            for s in w.model:
                np.testing.assert_allclose([g.model[s], g.sim[s]],
                                           [w.model[s], w.sim[s]],
                                           rtol=RTOL, atol=ATOL)
    # every case agrees, and the lassen sweep crosses over from
    # device_direct to host_staged: the reference's 1.0 and 1.0
    assert all(v.agree for vs in got.values() for v in vs)
    winners = [v.sim_winner for v in got["lassen"]]
    assert winners[0] == "device_direct" and winners[-1] == "host_staged"


def test_params_replace_equals_the_reference():
    m, ref_m = MACHINES["lassen_8"], REF_MACHINES["lassen_8"]
    alpha = np.full_like(m.params.alpha, 1e-6)
    got = m.params.replace(alpha=alpha, n_rails=3)
    want = ref_m.params.replace(alpha=alpha, n_rails=3)
    assert got.n_rails == want.n_rails == 3
    assert np.array_equal(got.alpha, want.alpha)
    assert m.params.n_rails != 3 and got is not m.params


# -- no card ------------------------------------------------------------------

def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ph = _phases("lassen_8")
    sched = tx.build_schedule(ph, "two_step")
    delivered = tx.run_reference(sched)
    for call in (lambda: tx.build_executor(sched),
                 lambda: tx.execute(sched),
                 lambda: tx.time_schedule(sched),
                 lambda: tx.launch_overhead(ph),
                 lambda: tx.measure_strategies(ph),
                 lambda: tx.predicted_costs(ph),
                 lambda: tx.record_sweeps(ph.machine),
                 lambda: tx.delivered_digest(delivered, sched)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the host oracles and the planner need no device
    assert np.array_equal(tx.run_reference(sched),
                          tx.reference_delivered(sched))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,strat", CASES, ids=IDS)
def test_the_card_delivers_as_the_cpu(cuda, name, strat):
    _, ph = _phases(name)
    for coloring in tx.COLORINGS:
        sched = tx.build_schedule(ph, strat, coloring=coloring)
        before = ks.LAUNCHES["segment_reduce"]
        got, digest = tx.execute(sched)
        assert ks.LAUNCHES["segment_reduce"] == before + 1
        assert got.device.type == "cuda" and digest.device.type == "cuda"
        want, want_digest = tx.execute(sched, device=CPU)
        assert torch.equal(got.cpu(), want)
        np.testing.assert_allclose(digest.double().cpu().numpy(),
                                   _bincount(sched), rtol=RTOL)
        np.testing.assert_allclose(digest.cpu().numpy(),
                                   want_digest.numpy(), rtol=RTOL)


@pytest.mark.gpu
def test_calibration_and_timing_on_the_card(cuda):
    m = MACHINES["lassen_8"]
    got = tx.calibrate(tx.record_sweeps(m), m.params)
    want = tx.calibrate(tx.record_sweeps(m, device=CPU), m.params)
    _same_table(got.params, want.params)
    _, ph = _bench_phase()
    before = ks.LAUNCHES["segment_reduce"]
    pred = tx.predicted_costs(ph, params=got.params)
    assert ks.LAUNCHES["segment_reduce"] > before
    np.testing.assert_allclose(
        list(pred.values()),
        list(tx.predicted_costs(ph, params=got.params, device=CPU).values()),
        rtol=RTOL, atol=ATOL)
    meas = tx.time_schedule(tx.build_schedule(ph, "standard"), reps=3)
    assert meas.median_s > 0
