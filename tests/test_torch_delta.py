"""Delta re-pricing on the PyTorch port against the JAX package's.

Counterparts of ``tests/test_delta.py``: every mutation chain, edge case,
consumer and search of ``repro.comm.DeltaStack`` / ``repro.sparse``'s
incremental partition machinery runs through ``repro_torch`` on
``device="cpu"`` (the plain K1 and K2) beside ``repro`` on the same inputs.

The port's parity contract (the reference's is bit-identity to a fresh
numpy build; K1's float32 sums on the card vary in the last bits):

* per-message cached fields, the mutated message order, receive counts
  and queue steps are bit-equal to ``repro``'s and to a fresh build;
* float aggregates are within rtol 1e-4 / atol 1e-6 of the reference's
  float64 ones and of a fresh port ``PhaseStack`` on the same device; on
  the CPU the transport rows and byte totals are bit-equal to the fresh
  stack's and link contention is allclose (``DeltaStack.check``);
* fingerprints and ``message_delta`` are bit-equal to the reference's.

Tests marked ``gpu`` hold the device ``DeltaStack`` to a fresh cuda
``PhaseStack`` and skip inside the test without a card.
"""
import dataclasses
import math

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import repro.comm as ref_comm  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.net as ref_net  # noqa: E402
import repro.sparse as ref_sparse  # noqa: E402
from repro.comm.delta import _MaxTree as RefMaxTree  # noqa: E402
from repro_torch.comm import (ArenaOverflowError, CommPhase,  # noqa: E402
                              DeltaStack, PhaseStack, message_delta,
                              pattern_fingerprint, phase_fingerprint)
from repro_torch.comm.delta import _MaxTree  # noqa: E402
from repro_torch.comm.guard import (MessageSizeError,  # noqa: E402
                                    PatternError, RankError)
from repro_torch.comm.stack import put_column  # noqa: E402
from repro_torch.core.models import (MODEL_LEVELS,  # noqa: E402
                                     model_ladder_many, phase_cost_many,
                                     phase_cost_phase)
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.net import machine as port_machine  # noqa: E402
from repro_torch.net.simulator import simulate, simulate_many  # noqa: E402
from repro_torch.sparse import (CommPattern, RowPartition,  # noqa: E402
                                SpmvPatternState, elasticity_like_3d,
                                optimize_partition, poisson_3d,
                                spmv_comm_pattern, spmv_comm_pattern_delta)

RTOL, ATOL = 1e-4, 1e-6
CPU = "cpu"
PRESETS = {
    "blue_waters": ("blue_waters_machine", (2, 2, 2)),
    "tpu_v5e": ("tpu_v5e_machine", (4, 4)),
    "lassen": ("lassen_machine", (2, 2, 2)),
    "frontier": ("frontier_machine", (2, 2, 1)),
}
FIELDS = ("src", "dst", "size", "loc", "proto", "is_net", "send_node",
          "torus_src", "torus_dst", "active_ppn")


def _pair(preset="blue_waters"):
    """(reference machine, port machine) of one preset."""
    fn, dims = PRESETS[preset]
    return getattr(ref_net, fn)(dims), getattr(port_machine, fn)(dims)


BW_REF, BW = _pair()


def _messages(P, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, P, n)
    dst = (src + rng.integers(1, P, n)) % P
    return src, dst, rng.integers(8, 1 << 18, n).astype(float)


def _phases(pair, sizes, seed):
    """The same random phases bound to the reference's and the port's
    machine."""
    (rm, pm), out_ref, out = pair, [], []
    for i, n in enumerate(sizes):
        msgs = _messages(pm.n_procs, n, seed + i)
        out_ref.append(ref_comm.CommPhase.build(rm, *msgs,
                                                n_procs=rm.n_procs))
        out.append(CommPhase.build(pm, *msgs, n_procs=pm.n_procs))
    return out_ref, out


def _sweep(pair=(BW_REF, BW), seed=0):
    return _phases(pair, (0, 1, 40, 300, 2), seed)


def _stacks(phases_pair, verify=False):
    ref, port = phases_pair
    return (ref_comm.DeltaStack.from_phases(ref),
            DeltaStack.from_phases(port, device=CPU, verify=verify))


def _random_delta(n_phases, total, phases, rng, max_rm=25, max_add=12):
    """A random mutation touching a random subset of phases (the reference
    test's generator)."""
    n_rm = int(rng.integers(0, min(max_rm, total) + 1))
    rm = rng.choice(total, size=n_rm, replace=False) if n_rm else None
    add = {}
    for pi in range(n_phases):
        if rng.random() < 0.5:
            continue
        k = int(rng.integers(0, max_add))
        if k == 0:
            continue
        P = phases[pi].n_procs
        src = rng.integers(0, P, k)
        add[pi] = (src, (src + rng.integers(1, P, k)) % P,
                   rng.integers(8, 1 << 18, k).astype(float))
    return rm, add


def _apply_both(ref, port, rng, **kw):
    delta = _random_delta(port.n_phases, port.total_msgs, port.phases, rng,
                          **kw)
    return ref.apply(*delta), port.apply(*delta)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _assert_matches(ref, port):
    """The full contract: message order and per-message fields bit-equal
    to the reference's, the port's own fresh-build check, every ladder level
    and the simulator against the reference (integers bit-equal, floats
    within rtol 1e-4 / atol 1e-6)."""
    assert port.n_phases == ref.n_phases
    assert np.array_equal(port.offsets, ref.offsets)
    for g, w in zip(port.phases, ref.phases):
        for f in FIELDS:
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
    port.check()
    for lvl in MODEL_LEVELS:
        got = phase_cost_many(port, level=lvl)
        want = ref_core.phase_cost_many(ref, level=lvl)
        for g, w in zip(got, want):
            _close([g.transport, g.queue, g.contention, g.total],
                   [w.transport, w.queue, w.contention, w.total])
            assert g.queue == w.queue              # integer counts squared
    got, want = simulate_many(port), ref_net.simulate_many(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close([g.time, g.transport, g.queue, g.contention,
                g.max_link_bytes, g.total_net_bytes],
               [w.time, w.transport, w.queue, w.contention,
                w.max_link_bytes, w.total_net_bytes])
        _close(g.per_proc_transport.double().numpy(), w.per_proc_transport)
        assert np.array_equal(g.per_proc_queue_steps.numpy(),
                              w.per_proc_queue_steps)


# ------------------------------------------------------ fingerprints --------
def test_fingerprints_equal_the_reference():
    ref, port = _sweep(seed=71)
    for r, p in zip(ref, port):
        assert phase_fingerprint(p.src, p.dst, p.size, p.n_procs) == \
            ref_comm.phase_fingerprint(r.src, r.dst, r.size, r.n_procs)
        assert pattern_fingerprint(p) == ref_comm.pattern_fingerprint(r)
    pat = CommPattern(port[3].src, port[3].dst, port[3].size, BW.n_procs)
    assert pattern_fingerprint(pat) == pattern_fingerprint(port[3])
    r_delta, p_delta = _stacks((ref, port))
    assert p_delta.fingerprint() == r_delta.fingerprint()
    rng = np.random.default_rng(3)
    r2, p2 = _apply_both(r_delta, p_delta, rng)
    assert p2.fingerprint() == r2.fingerprint() != p_delta.fingerprint()


def test_message_delta_equals_the_reference():
    rng = np.random.default_rng(73)
    P = BW.n_procs
    old = CommPattern(*_messages(P, 200, 5), P)
    # duplicates on both sides, some survivors, some new triples
    keep = rng.choice(200, 150, replace=False)
    extra = _messages(P, 30, 6)
    dup = rng.choice(150, 10)
    new = CommPattern(np.concatenate([old.src[keep], extra[0],
                                      old.src[keep][dup]]),
                      np.concatenate([old.dst[keep], extra[1],
                                      old.dst[keep][dup]]),
                      np.concatenate([old.size[keep], extra[2],
                                      old.size[keep][dup]]), P)
    rm, add = message_delta(old, new)
    rm_ref, add_ref = ref_comm.message_delta(old, new)
    assert np.array_equal(rm, rm_ref)
    for g, w in zip(add, add_ref):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    # applied to a one-phase arena it yields new's message multiset
    delta = DeltaStack.from_phases([old_phase := CommPhase.build(
        BW, old.src, old.dst, old.size, n_procs=P)], device=CPU)
    out = delta.apply(rm, {0: add}).phases[0]
    key = lambda s, d, z: sorted(zip(s.tolist(), d.tolist(),  # noqa: E731
                                     z.tolist()))
    assert key(out.src, out.dst, out.size) == key(new.src, new.dst, new.size)
    assert old_phase.n_msgs == 200


# ------------------------------------------------------ construction --------
def test_from_phases_accepts_phases_and_stack():
    ref, port = _sweep()
    a = DeltaStack.from_phases(port, device=CPU)
    b = DeltaStack.from_phases(PhaseStack.build(port, device=CPU))
    assert a.n_phases == b.n_phases == len(port)
    assert b.device == torch.device(CPU)          # the stack's own device
    assert phase_cost_many(a) == phase_cost_many(b)
    want = ref_core.phase_cost_many(ref_comm.DeltaStack.from_phases(ref))
    _close([c.total for c in phase_cost_many(a)], [c.total for c in want])


def test_from_phases_rejects_mixed_machines_unbound_and_overridden():
    tpu = _pair("tpu_v5e")[1]
    ph, ph_tpu = (CommPhase.build(m, *_messages(m.n_procs, 10, 0),
                                  n_procs=m.n_procs) for m in (BW, tpu))
    with pytest.raises(ValueError, match="mixed machines"):
        DeltaStack.from_phases([ph, ph_tpu], device=CPU)
    cp = CommPattern(np.array([0]), np.array([1]), np.array([8.0]), 2)
    with pytest.raises(TypeError, match="bound CommPhase"):
        DeltaStack.from_phases([cp], device=CPU)
    # a staged strategy step cannot be mutated: the reference's ValueError
    staged = CommPhase.build(BW, [0, 1], [40, 41], [8.0, 8.0], loc=2)
    with pytest.raises(ValueError, match="machine-classified phases"):
        DeltaStack.from_phases([staged], device=CPU)
    with pytest.raises(ValueError, match="machine-classified phases"):
        ref_comm.DeltaStack.from_phases([ref_comm.CommPhase.build(
            BW_REF, [0, 1], [40, 41], [8.0, 8.0], loc=2)])


def test_generation_zero_matches_fresh_and_reference():
    ref, port = _stacks(_sweep())
    _assert_matches(ref, port)
    assert port._fresh_cache is not None           # check() keeps its build


def test_empty_stack():
    delta = DeltaStack.from_phases([], device=CPU)
    assert delta.n_phases == 0 and delta.total_msgs == 0
    assert phase_cost_many(delta) == []
    assert model_ladder_many(delta) == []
    assert simulate_many(delta) == []
    d2 = delta.apply()
    assert d2.n_phases == 0
    d2.check()


# ------------------------------------------------------ mutation ------------
def test_empty_delta_is_identity():
    ref, port = _stacks(_sweep(seed=3))
    for d2 in (port.apply(), port.apply([], {}), port.apply(None, None)):
        assert phase_cost_many(d2) == phase_cost_many(port)
        for g, w in zip(d2.phases, port.phases):
            assert g is w                          # clean phases are shared
        d2.check()
    _assert_matches(ref.apply(), port.apply())


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_random_move_sequences_match_reference(preset):
    pair = _pair(preset)
    ref, port = _stacks(_sweep(pair, seed=11))
    rng = np.random.default_rng(5)
    for step in range(6):
        ref, port = _apply_both(ref, port, rng)
        if step % 2:          # materialize the lazy routing path mid-chain
            simulate_many(port)
            ref_net.simulate_many(ref)
        _assert_matches(ref, port)


def test_remove_all_from_one_receiver():
    ref, port = _stacks(_phases((BW_REF, BW), (200, 50), 17))
    ph = port.phases[0]
    receiver = int(np.bincount(ph.dst).argmax())
    rm = np.nonzero(ph.dst == receiver)[0]       # phase 0: arena idx == local
    assert rm.size > 0
    ref, port = ref.apply(rm), port.apply(rm)
    assert not (port.phases[0].dst == receiver).any()
    _assert_matches(ref, port)


def test_remove_entire_phase_then_refill():
    ref, port = _stacks(_sweep(seed=23))
    off = port.offsets
    rm = np.arange(off[3], off[4])                # drain phase 3 completely
    ref, port = ref.apply(rm), port.apply(rm)
    assert port.phases[3].n_msgs == 0
    _assert_matches(ref, port)
    refill = {3: ([0, 1, 2], [9, 9, 9], [64.0, 4096.0, 1 << 16])}
    ref, port = ref.apply(None, refill), port.apply(None, refill)
    assert port.phases[3].n_msgs == 3
    _assert_matches(ref, port)


def test_new_receiver_appears():
    """Messages to a process that received nothing before the delta."""
    P = BW.n_procs
    rng = np.random.default_rng(29)
    src = rng.integers(0, P // 2, 80)
    dst = rng.integers(0, P // 2, 80)             # upper half silent
    keep = src != dst
    msgs = (src[keep], dst[keep],
            rng.integers(8, 1 << 16, int(keep.sum())).astype(float))
    ref = ref_comm.DeltaStack.from_phases(
        [ref_comm.CommPhase.build(BW_REF, *msgs, n_procs=P)])
    port = DeltaStack.from_phases([CommPhase.build(BW, *msgs, n_procs=P)],
                                  device=CPU)
    newcomer = P - 1
    assert not (port.phases[0].dst == newcomer).any()
    add = {0: ([0, 3], [newcomer, newcomer], [1 << 14, 1 << 10])}
    ref, port = ref.apply(None, add), port.apply(None, add)
    assert (port.phases[0].dst == newcomer).sum() == 2
    _assert_matches(ref, port)


def test_verify_mode_checks_every_apply():
    ref, port = _stacks(_sweep(seed=31), verify=True)
    rng = np.random.default_rng(7)
    for _ in range(3):
        ref, port = _apply_both(ref, port, rng)   # check() inside
    assert port.verify
    _assert_matches(ref, port)


def test_check_catches_a_drifted_aggregate():
    _, port = _stacks(_sweep(seed=33))
    port = port.apply(*_random_delta(port.n_phases, port.total_msgs,
                                     port.phases, np.random.default_rng(1)))
    port.check()
    st = port._states[3]
    st.row_na = st.row_na.clone()
    st.row_na[0] += 1e-3                           # a stale float sum
    with pytest.raises(AssertionError, match="drifted"):
        port.check()
    # a delta elsewhere shares phase 3's state: verify mode catches it too
    with pytest.raises(AssertionError, match="drifted"):
        port.apply(None, {2: ([0], [1], [8.0])}, verify=True)


# ------------------------------------------------------ validation ----------
def test_apply_validates_inputs():
    ref, port = _stacks(_sweep(seed=37))
    P = port.phases[2].n_procs
    cases = [(ValueError, "duplicate", ([1, 1],)),
             (ValueError, "out of range", ([port.total_msgs],)),
             (ValueError, "out of range", ([-1],)),
             (ValueError, "phase index", (None, {99: ([0], [1], [8.0])})),
             (RankError, "out of range", (None, {2: ([0], [P], [8.0])})),
             (PatternError, "lengths differ",
              (None, {2: ([0, 1], [2], [8.0])})),
             (MessageSizeError, "not finite",
              (None, {2: ([0], [1], [np.nan])}))]
    for exc, match, args in cases:
        with pytest.raises(exc, match=match):
            port.apply(*args)
        with pytest.raises(ValueError, match=match):
            ref.apply(*args)
    # nothing was touched by the refused deltas
    port.check()


def test_columns_outside_int32_raise_the_typed_overflow():
    with pytest.raises(ArenaOverflowError, match="int32 range"):
        put_column(np.array([0, 2 ** 31]), "src", torch.device(CPU))
    assert put_column(np.array([1.5]), "size",
                      torch.device(CPU)).dtype == torch.float32


# ------------------------------------------------------ consumers -----------
def test_model_ladder_many_on_delta():
    ref, port = _stacks(_sweep(seed=41))
    ref, port = _apply_both(ref, port, np.random.default_rng(2))
    got = model_ladder_many(port)
    want_loop = [{lvl: phase_cost_phase(ph, level=lvl, device=CPU)
                  for lvl in MODEL_LEVELS} for ph in port.phases]
    want_ref = ref_core.model_ladder_many(ref)
    for g, w, r in zip(got, want_loop, want_ref):
        for lvl in MODEL_LEVELS:
            _close(g[lvl].total, w[lvl].total)
            _close(g[lvl].total, r[lvl].total)


def test_single_phase_delta_matches_loop():
    """The optimizer case: a one-phase arena still rides the delta caches."""
    ref, port = _stacks(_phases((BW_REF, BW), (300,), 43))
    mv = ([0, 5, 7], {0: ([1], [2], [4096.0])})
    ref, port = ref.apply(*mv), port.apply(*mv)
    got, = phase_cost_many(port)
    _close(got.total, phase_cost_phase(port.phases[0], device=CPU).total)
    _close(got.total, ref_core.phase_cost_many(ref)[0].total)
    assert port._fresh_cache is None               # no fresh arena built


def test_params_override_falls_back_correctly():
    ref, port = _stacks(_sweep(seed=47))
    ref, port = _apply_both(ref, port, np.random.default_rng(3))
    override = dataclasses.replace(BW.params, network_locality=1)
    got = phase_cost_many(port, params=override)
    assert port._fresh_cache is not None           # the reference's delegate
    want = [phase_cost_phase(ph, params=override, device=CPU)
            for ph in port.phases]
    want_ref = ref_core.phase_cost_many(
        ref, params=BW_REF.params.replace(network_locality=1))
    for g, w, r in zip(got, want, want_ref):
        _close(g.total, w.total)
        _close(g.total, r.total)


def test_custom_orders_on_mutated_arena():
    ref, port = _stacks(_sweep(seed=53))
    ref, port = _apply_both(ref, port, np.random.default_rng(4))
    rng = np.random.default_rng(0)
    arrivals = [ph.random_arrival_order(rng) for ph in port.phases]
    before = ks.LAUNCHES["queue_walk"]
    got = simulate_many(port, arrival_orders=arrivals)
    assert ks.LAUNCHES["queue_walk"] == before     # the plain walk on cpu
    want = [simulate(ph, arrival_order=ao, device=CPU)
            for ph, ao in zip(port.phases, arrivals)]
    want_ref = ref_net.simulate_many(ref, arrival_orders=arrivals)
    for g, w, r in zip(got, want, want_ref):
        _close(g.time, w.time)
        _close(g.time, r.time)
        assert torch.equal(g.per_proc_queue_steps, w.per_proc_queue_steps)
        assert np.array_equal(g.per_proc_queue_steps.numpy(),
                              r.per_proc_queue_steps)
    assert port._fresh_cache is None


def test_noise_stream_matches_loop():
    ref, port = _stacks(_phases((BW_REF, BW), (50, 0, 80), 59))
    got = simulate_many(port, rng=np.random.default_rng(5), noise=0.1)
    rng = np.random.default_rng(5)
    want = [simulate(ph, rng=rng, noise=0.1, device=CPU)
            for ph in port.phases]
    want_ref = ref_net.simulate_many(ref, rng=np.random.default_rng(5),
                                     noise=0.1)
    _close([r.time for r in got], [r.time for r in want])
    _close([r.time for r in got], [r.time for r in want_ref])


def test_unknown_device_raises_eagerly():
    # the port has one backend: no ``backend`` argument, and the device is
    # checked when the arena is built
    _, port = _sweep(seed=61)
    with pytest.raises(ValueError, match="unsupported device"):
        DeltaStack.from_phases(port, device="meta")
    delta = DeltaStack.from_phases(port, device=CPU)
    with pytest.raises(TypeError):
        delta.cost_arrays(backend="numpy")
    with pytest.raises(TypeError):
        delta.sim_arrays(backend="numpy")


# ------------------------------------------------------ property test -------
@given(st.integers(0, 10**6))
@settings(max_examples=10, deadline=None)
def test_property_random_mutation_chain(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(0, 150)) for _ in range(3)]
    ref, port = _stacks(_phases((BW_REF, BW), sizes,
                                int(rng.integers(1 << 30))))
    for _ in range(3):
        ref, port = _apply_both(ref, port, rng)
    _assert_matches(ref, port)


# ------------------------------------------------------ _MaxTree ------------
def test_max_tree_point_and_batch_updates():
    rng = np.random.default_rng(67)
    values = rng.integers(0, 100, 37)
    tree, ref = _MaxTree(values), RefMaxTree(values)
    assert tree.max() == values.max()
    for _ in range(50):
        i = int(rng.integers(0, values.size))
        values[i] = int(rng.integers(0, 100))
        tree.update(i, values[i])
        ref.update(i, values[i])
        assert tree.max() == values.max()
    batch = np.unique(rng.integers(0, values.size, 9))
    values[batch] = 0
    tree.update_many(batch, values[batch])
    ref.update_many(batch, values[batch])
    assert tree.max() == values.max()
    assert np.array_equal(tree.tree, ref.tree)
    assert np.array_equal(tree.copy().tree, tree.tree)
    assert _MaxTree(np.zeros(0, dtype=np.int64)).max() == 0


# ============================================== incremental SpMV pattern ====
def _canon(src, dst, size):
    order = np.lexsort((dst, src))
    return src[order], dst[order], size[order]


def _walk(A, P, shift, n, seed):
    """Boundary-shift proposals of a random walk (feasible ones only)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield int(rng.integers(1, P)), int(rng.choice((-shift, shift)))


def test_spmv_state_build_matches_fresh_pattern():
    A = poisson_3d(8)
    part = RowPartition.balanced(A.n_rows, 16)
    state = SpmvPatternState.build(A, part)
    fresh = spmv_comm_pattern(A, part)
    ref = ref_sparse.SpmvPatternState.build(
        ref_sparse.poisson_3d(8), ref_sparse.RowPartition(part.starts))
    for f in ("src", "dst", "size"):
        assert np.array_equal(getattr(state, f), getattr(fresh, f))
        assert np.array_equal(getattr(state, f), getattr(ref, f))
    assert np.array_equal(state.pairs, ref.pairs)
    assert np.array_equal(state.seg, ref.seg)


def test_spmv_delta_matches_fresh_and_reference_over_random_walk():
    A, A_ref = poisson_3d(9), ref_sparse.poisson_3d(9)
    P = 24
    part = RowPartition.balanced(A.n_rows, P)
    state = SpmvPatternState.build(A, part)
    ref = ref_sparse.SpmvPatternState.build(
        A_ref, ref_sparse.RowPartition(part.starts))
    starts = state.starts.copy()
    walked = 0
    for b, d in _walk(A, P, 5, 40, 0):
        ns = starts.copy()
        ns[b] += d
        if not starts[b - 1] < ns[b] < starts[b + 1]:
            continue
        rm, add, state2 = spmv_comm_pattern_delta(state, ns)
        rm_ref, add_ref, ref2 = ref_sparse.spmv_comm_pattern_delta(ref, ns)
        assert np.array_equal(rm, rm_ref)
        assert all(np.array_equal(g, w) for g, w in zip(add, add_ref))
        fresh = spmv_comm_pattern(A, RowPartition(ns))
        got = _canon(state2.src, state2.dst, state2.size)
        want = _canon(fresh.src, fresh.dst, fresh.size)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        cm = np.zeros(P, dtype=bool)
        cm[[b - 1, b]] = True
        assert np.array_equal(rm, np.nonzero(cm[state.src]
                                             | cm[state.dst])[0])
        if walked % 2 == 0:        # alternate accept/reject to walk the
            state, ref, starts = state2, ref2, ns   # lazy-splice chain
            assert np.array_equal(state.pairs, ref.pairs)
        walked += 1
    assert walked > 10


def test_spmv_delta_feeds_delta_stack():
    """The (removed, added) delta drives DeltaStack.apply in lockstep with
    the reference's arena."""
    A = poisson_3d(8)
    P = 16
    state = SpmvPatternState.build(A, RowPartition.balanced(A.n_rows, P))
    port = DeltaStack.from_phases([state.pattern.bind(BW)], device=CPU)
    ref = ref_comm.DeltaStack.from_phases([ref_comm.CommPhase.build(
        BW_REF, state.src, state.dst, state.size, n_procs=P)])
    starts = state.starts.copy()
    for b, d in _walk(A, P, 4, 10, 1):
        ns = starts.copy()
        ns[b] += d
        if not starts[b - 1] < ns[b] < starts[b + 1]:
            continue
        rm, add, state = spmv_comm_pattern_delta(state, ns)
        port, ref = port.apply(rm, {0: add}), ref.apply(rm, {0: add})
        starts = ns
        _assert_matches(ref, port)
        # the delta arena mirrors the state's message order exactly
        for f in ("src", "dst", "size"):
            assert np.array_equal(getattr(port.phases[0], f),
                                  getattr(state, f))


def test_spmv_delta_validates_new_starts():
    A = poisson_3d(6)
    state = SpmvPatternState.build(A, RowPartition.balanced(A.n_rows, 8))
    with pytest.raises(ValueError, match="process count"):
        spmv_comm_pattern_delta(state, state.starts[:-1])
    bad = state.starts.copy()
    bad[-1] += 1
    with pytest.raises(ValueError, match="partition"):
        spmv_comm_pattern_delta(state, bad)
    bad = state.starts.copy()
    bad[1], bad[2] = bad[2] + 5, bad[1]
    with pytest.raises(ValueError, match="partition"):
        spmv_comm_pattern_delta(state, bad)


def test_spmv_delta_noop_returns_same_state():
    A = poisson_3d(6)
    state = SpmvPatternState.build(A, RowPartition.balanced(A.n_rows, 8))
    rm, add, state2 = spmv_comm_pattern_delta(state, state.starts)
    assert rm.size == 0 and add[0].size == 0
    assert state2 is state


# ============================================== the partition optimizer =====
def _held_to_reference(res, ref) -> int:
    """The port's search against the reference's: the same proposals, and
    the same accept decisions and costs (rtol 1e-4) up to the first move the
    two decide differently — which must be a near-tie, a candidate whose
    reference cost is within rtol 1e-4 of the current one (float64 cost
    gaps below float32's resolution are noise to the port).  Returns the
    index of that move (the number of moves when the paths never fork)."""
    assert len(res.moves) == len(ref.moves)
    fork, current = len(ref.moves), ref.initial_cost
    _close(res.initial_cost, ref.initial_cost)
    for i, (g, w) in enumerate(zip(res.moves, ref.moves)):
        assert (g.boundary, g.shift) == (w.boundary, w.shift)
        if fork < len(ref.moves):
            continue
        assert math.isnan(g.cost) == math.isnan(w.cost)
        assert np.array_equal(g.starts, w.starts)
        if not math.isnan(w.cost):
            _close(g.cost, w.cost)
        if g.accepted != w.accepted:
            assert abs(w.cost - current) <= RTOL * current, (i, w.cost,
                                                              current)
            fork = i
        elif w.accepted:
            current = w.cost
    if fork == len(ref.moves):
        _close(res.cost, ref.cost)
        assert np.array_equal(res.partition.starts, ref.partition.starts)
    return fork


def test_optimize_partition_improves_or_holds():
    A = poisson_3d(8)
    res = optimize_partition(A, BW, n_procs=16, moves=24, seed=0, device=CPU)
    assert res.cost <= res.initial_cost
    assert len(res.moves) == 24
    assert res.n_accepted == sum(m.accepted for m in res.moves)
    fresh = spmv_comm_pattern(A, res.partition)
    got = _canon(res.pattern.src, res.pattern.dst, res.pattern.size)
    want = _canon(fresh.src, fresh.dst, fresh.size)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    ref = ref_sparse.optimize_partition(ref_sparse.poisson_3d(8), BW_REF,
                                        n_procs=16, moves=24, seed=0)
    if _held_to_reference(res, ref) == len(ref.moves):
        _close(res.improvement, ref.improvement)


def test_optimize_partition_delta_pricing_matches_rebuild():
    """Every candidate the delta pricer recorded re-prices to the same cost
    under full reconstruction on the same device."""
    A = poisson_3d(8)
    res = optimize_partition(A, BW, n_procs=16, moves=24, seed=3, device=CPU)
    priced = 0
    for mv in res.moves:
        if np.isnan(mv.cost):
            continue
        phase = spmv_comm_pattern(A, RowPartition(mv.starts)).bind(BW)
        _close(mv.cost, phase_cost_phase(phase, device=CPU).total)
        priced += 1
    assert priced > 5


def test_optimize_partition_rebuild_pricer_matches_reference():
    """The reference pricer runs the same search loop end to end."""
    res = optimize_partition(poisson_3d(7), BW, n_procs=12, moves=12,
                             seed=0, pricer="rebuild", device=CPU)
    assert res.cost <= res.initial_cost
    assert len(res.moves) == 12
    ref = ref_sparse.optimize_partition(ref_sparse.poisson_3d(7), BW_REF,
                                        n_procs=12, moves=12, seed=0,
                                        pricer="rebuild")
    _held_to_reference(res, ref)
    delta = optimize_partition(poisson_3d(7), BW, n_procs=12, moves=12,
                               seed=0, device=CPU)
    _held_to_reference(delta, ref)


def test_optimize_partition_verify_mode():
    res = optimize_partition(poisson_3d(6), BW, n_procs=8, moves=8, seed=0,
                             verify=True, device=CPU)
    assert res.cost <= res.initial_cost
    ref = ref_sparse.optimize_partition(ref_sparse.poisson_3d(6), BW_REF,
                                        n_procs=8, moves=8, seed=0,
                                        verify=True)
    _held_to_reference(res, ref)


def test_optimize_partition_rerun_strategies():
    kw = dict(n_procs=12, moves=12, seed=1, rerun_strategies=True)
    res = optimize_partition(poisson_3d(7), BW, device=CPU, **kw)
    ref = ref_sparse.optimize_partition(ref_sparse.poisson_3d(7), BW_REF,
                                        **kw)
    fork = _held_to_reference(res, ref)
    assert len(res.verdicts) == res.n_accepted
    want = dict(ref.verdicts)

    def same(verdict, w):
        assert verdict.model_winner in verdict.model
        assert (verdict.model_winner, verdict.sim_winner) == \
            (w.model_winner, w.sim_winner)
        for name in w.model:
            _close(verdict.model[name], w.model[name])
            _close(verdict.sim[name], w.sim[name])

    for it, verdict in res.verdicts:
        assert res.moves[it].accepted
        if it < fork:                  # the same accepted state as repro's
            same(verdict, want[it])
    if res.verdicts:                   # the last one judged the final phase
        pat = res.pattern
        same(res.verdicts[-1][1], ref_comm.best_strategy(
            ref_comm.CommPhase.build(BW_REF, pat.src, pat.dst, pat.size,
                                     n_procs=pat.n_procs), seed=kw["seed"]))


def test_optimize_partition_validates():
    A = poisson_3d(6)
    with pytest.raises(ValueError, match="n_procs or an explicit part"):
        optimize_partition(A, BW, device=CPU)
    with pytest.raises(ValueError, match="unknown model level"):
        optimize_partition(A, BW, n_procs=8, level="psychic", device=CPU)
    with pytest.raises(ValueError, match="unknown pricer"):
        optimize_partition(A, BW, n_procs=8, pricer="magic", device=CPU)


# ============================================== the reference's candidates ==
def replay(A, machine, moves, n_procs, level, device):
    """Walk recorded candidates (``Move.starts``, in order) through the
    port's delta path, following the recorded accept decisions: per move
    the port's cost (NaN where the recorded move was never priced) and
    whether the port's own search would accept it; and the final arena."""
    state = SpmvPatternState.build(A, RowPartition.balanced(A.n_rows,
                                                            n_procs))
    delta = DeltaStack.from_phases([state.pattern.bind(machine)],
                                   device=device)
    cost = phase_cost_many(delta, level=level)[0].total
    out = []
    for mv in moves:
        if math.isnan(mv.cost):
            out.append((math.nan, False))
            continue
        rm, add, cand_state = spmv_comm_pattern_delta(state, mv.starts)
        cand = delta.apply(rm, {0: add})
        c = phase_cost_many(cand, level=level)[0].total
        out.append((c, c < cost))
        if mv.accepted:
            state, delta, cost = cand_state, cand, c
    return out, delta


def test_replay_of_the_reference_candidates_on_the_bench_delta_setup():
    # benchmarks/bench_delta.py's search (elasticity_like_3d(12), 512 ranks
    # of blue_waters_machine((4, 2, 2)), 64 moves, contention) cut to
    # elasticity_like_3d(9) over 256 ranks and 48 moves
    ref_m = ref_net.blue_waters_machine((4, 2, 2))
    m = port_machine.blue_waters_machine((4, 2, 2))
    kw = dict(n_procs=256, moves=48, seed=0, level="contention")
    ref = ref_sparse.optimize_partition(ref_sparse.elasticity_like_3d(9),
                                        ref_m, **kw)
    A = elasticity_like_3d(9)
    got, _ = replay(A, m, ref.moves, kw["n_procs"], kw["level"], CPU)
    current, compared = ref.initial_cost, 0
    for (c, accept), mv in zip(got, ref.moves):
        if math.isnan(mv.cost):
            assert math.isnan(c)
            continue
        _close(c, mv.cost)
        if abs(mv.cost - current) > RTOL * current:   # a clear verdict
            assert accept == mv.accepted
            compared += 1
        if mv.accepted:
            current = mv.cost
    assert compared > 10 and ref.n_accepted > 3
    # the port's own search forks from the reference's at a near-tie only
    _held_to_reference(optimize_partition(A, m, device=CPU, **kw), ref)


# ============================================== on the card =================
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_delta_stack_matches_a_fresh_cuda_stack(cuda):
    _, port = _sweep(seed=79)
    delta = DeltaStack.from_phases(port, device=cuda)
    rng = np.random.default_rng(9)
    for step in range(4):
        before = ks.LAUNCHES["segment_reduce"]
        delta = delta.apply(*_random_delta(delta.n_phases, delta.total_msgs,
                                           delta.phases, rng))
        assert ks.LAUNCHES["segment_reduce"] > before
        if step % 2:
            simulate_many(delta)
        delta.check()                  # allclose on the card, steps exact
    cpu = DeltaStack.from_phases(delta.phases, device=CPU)
    for lvl in MODEL_LEVELS:
        _close([c.total for c in phase_cost_many(delta, level=lvl)],
               [c.total for c in phase_cost_many(cpu, level=lvl)])


@pytest.mark.gpu
def test_delta_search_on_the_card_builds_no_fresh_arena(cuda, monkeypatch):
    A = elasticity_like_3d(8)
    m = port_machine.blue_waters_machine((4, 2, 2))
    builds = []
    real = PhaseStack.build.__func__

    def counted(cls, *a, **kw):
        builds.append(1)
        return real(cls, *a, **kw)

    kw = dict(n_procs=128, moves=32, seed=0)
    want = optimize_partition(A, m, device=CPU, **kw)
    monkeypatch.setattr(PhaseStack, "build", classmethod(counted))
    before = ks.LAUNCHES["segment_reduce"]
    res = optimize_partition(A, m, **kw)
    assert ks.LAUNCHES["segment_reduce"] > before and not builds
    got, final = replay(A, m, want.moves, kw["n_procs"], "contention", None)
    assert final.device.type == "cuda" and final._fresh_cache is None
    assert not builds
    for (c, _), mv in zip(got, want.moves):
        if not math.isnan(mv.cost):
            _close(c, mv.cost)
    assert res.cost <= res.initial_cost
