"""The paper's measurement path on the PyTorch port against the JAX package's.

Per-phase model ladder and simulator, Algorithm 1's ping-pongs, the
parameter fits, the accuracy tables, the SpGEMM traffic and typed
validation: the same numpy inputs go through ``repro`` and through
``repro_torch`` with ``device="cpu"`` (plain kernel versions).  Integer
outputs (queue steps, patterns) are bit-equal; float outputs are allclose
at rtol 1e-4 / atol 1e-6 to the float64 reference (the port's per-message
times and sums are float32).  Noisy harnesses draw the reference's
lognormal factors from the same seed.

Bounds against the ground-truth tables: the reference's own fit tests hold
its float64 fits to the tables at rel 1e-6 (alpha, R_b, R_N) and 1e-9
(delta).  The port's fits come from float32 times, so they are held to the
reference's fits at rtol 1e-4, and to the tables at rel 1e-4 where they
are checked (``test_port_fits_recover_the_tables``).
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import CommPhase as RefPhase  # noqa: E402
from repro.comm import guard as ref_guard  # noqa: E402
from repro.comm.strategies import two_step as ref_two_step  # noqa: E402
from repro.core import fitting as ref_fit  # noqa: E402
from repro.core import models as ref_models  # noqa: E402
from repro.core import report as ref_report  # noqa: E402
from repro.net import machine as ref_machine  # noqa: E402
from repro.net import pingpong as ref_pp  # noqa: E402
from repro.net import simulator as ref_sim  # noqa: E402
from repro.sparse import (RowPartition as RefPartition,  # noqa: E402
                          build_hierarchy as ref_hierarchy,
                          elasticity_like_3d as ref_elasticity,
                          spgemm_comm_pattern as ref_spgemm,
                          spmv_comm_pattern as ref_spmv)
from repro_torch.comm import guard  # noqa: E402
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.comm.strategies import two_step  # noqa: E402
from repro_torch.core import fitting, models, report  # noqa: E402
from repro_torch.core.params import PROTOCOL_NAMES, CommParams  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.net import machine, pingpong, simulator  # noqa: E402
from repro_torch.sparse import (RowPartition, build_hierarchy,  # noqa: E402
                                elasticity_like_3d, spgemm_comm_pattern,
                                spmv_comm_pattern)

RTOL, ATOL = 1e-4, 1e-6
CPU = "cpu"
PRESETS = {
    "blue_waters": ("blue_waters_machine", (2, 2, 2)),
    "tpu_v5e": ("tpu_v5e_machine", (4, 4)),
    "lassen": ("lassen_machine", (2, 2, 2)),
    "frontier": ("frontier_machine", (2, 2, 1)),
}
BW_KINDS = ("intra_socket", "intra_node", "inter_node")
#: >= 2 sizes per protocol bucket (short <= 512 < eager <= 8192 < rend)
SIZES = np.array([64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0])


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.double().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _pair(preset):
    fn, dims = PRESETS[preset]
    return getattr(ref_machine, fn)(dims), getattr(machine, fn)(dims)


def _messages(P, n, seed):
    """``n`` messages into the first eighth of the ranks, so receivers
    hold tens of messages and custom orders make the walk long."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, max(P // 8, 2), n)
    src = (dst + rng.integers(1, P, n)) % P
    size = rng.integers(8, 1 << 18, n).astype(float)
    return src, dst, size


@pytest.fixture(scope="module", params=sorted(PRESETS))
def phases(request):
    ref_m, m = _pair(request.param)
    msgs = _messages(m.n_procs, 500, 7)
    return (RefPhase.build(ref_m, *msgs, n_procs=ref_m.n_procs),
            CommPhase.build(m, *msgs, n_procs=m.n_procs))


def _orders(phase, kind):
    if kind == "default":
        return None
    if kind == "random":
        return phase.random_arrival_order(np.random.default_rng(11))
    order, bounds = phase.receiver_groups()
    return {p: order[bounds[p]:bounds[p + 1]][::-1]
            for p in range(phase.n_procs) if bounds[p + 1] > bounds[p]}


# -- CommPhase ------------------------------------------------------------------

def test_phase_stats_match_reference(phases):
    ref, ph = phases
    assert ph.total_bytes == ref.total_bytes
    assert ph.net_bytes == ref.net_bytes
    np.testing.assert_array_equal(ph.recv_counts(), ref.recv_counts())
    assert ph.max_msgs_per_proc() == ref.max_msgs_per_proc()
    np.testing.assert_array_equal(ph.class_bytes(), ref.class_bytes())


def test_empty_phase_stats_and_steps():
    ref_m, m = _pair("blue_waters")
    ref = RefPhase.build(ref_m, [], [], [], n_procs=4)
    ph = CommPhase.build(m, [], [], [], n_procs=4)
    assert (ph.total_bytes, ph.net_bytes, ph.max_msgs_per_proc()) == (
        ref.total_bytes, ref.net_bytes, ref.max_msgs_per_proc())
    np.testing.assert_array_equal(ph.queue_steps(device=CPU).numpy(),
                                  ref.queue_steps())
    assert ph.random_arrival_order(np.random.default_rng(0)) == {}


@pytest.mark.parametrize("post,arrive", [("default", "default"),
                                         ("reversed", "default"),
                                         ("default", "random"),
                                         ("reversed", "random")])
def test_queue_steps_bit_equal(phases, post, arrive):
    ref, ph = phases
    want = ref.queue_steps(_orders(ref, post), _orders(ref, arrive))
    got = ph.queue_steps(_orders(ph, post), _orders(ph, arrive), device=CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_arrival_order_equal_dicts(phases):
    ref, ph = phases
    want = ref.random_arrival_order(np.random.default_rng(3))
    got = ph.random_arrival_order(np.random.default_rng(3))
    assert list(got) == list(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p])


# -- the per-phase model ladder ---------------------------------------------------

@pytest.mark.parametrize("node_aware", [True, False])
@pytest.mark.parametrize("use_maxrate", [True, False])
def test_message_time_matches_reference(phases, node_aware, use_maxrate):
    ref, ph = phases
    p, rp = ph.machine.params, ref.machine.params
    want = ref_models.message_time(rp, ref.size, ref.loc, ppn=ref.active_ppn,
                                   node_aware=node_aware,
                                   use_maxrate=use_maxrate)
    got = models.message_time(p, ph.size, ph.loc, ppn=ph.active_ppn,
                              node_aware=node_aware, use_maxrate=use_maxrate,
                              device=CPU)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    # scalar ppn and a size grid, as the Figs. 2-3 comparison calls it
    sizes = np.unique(np.round(np.logspace(0, 6, 40)))
    for li in range(p.n_locality):
        _close(models.message_time(p, sizes, np.full(sizes.shape, li),
                                   node_aware=node_aware,
                                   use_maxrate=use_maxrate, device=CPU),
               ref_models.message_time(rp, sizes, np.full(sizes.shape, li),
                                       node_aware=node_aware,
                                       use_maxrate=use_maxrate))


def _cost_kw(phase, mode):
    m = phase.machine
    kw = dict(n_torus_nodes=m.torus.size, torus_ndim=m.torus.ndim,
              procs_per_torus_node=m.procs_per_torus_node,
              n_procs=phase.n_procs)
    if mode == "node_of":
        kw["node_of"] = m.node_of
    elif mode == "node_of_array":
        kw["node_of"] = m.node_of(np.arange(phase.n_procs))
    elif mode == "node_of_scalar":
        kw["node_of"] = lambda p: int(p) // m.procs_per_node
    elif mode == "active_ppn":
        kw["active_ppn"] = phase.active_ppn
    return kw


def _close_cost(got, want):
    assert isinstance(got, models.CostBreakdown)
    for f in ("transport", "queue", "contention", "total"):
        _close(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("level", models.MODEL_LEVELS)
@pytest.mark.parametrize("mode", ["plain", "node_of", "node_of_array",
                                  "node_of_scalar", "active_ppn"])
def test_phase_cost_matches_reference(phases, level, mode):
    ref, ph = phases
    want = ref_models.phase_cost(ref.machine.params, ref.src, ref.dst,
                                 ref.size, ref.loc, level=level,
                                 **_cost_kw(ref, mode))
    got = models.phase_cost(ph.machine.params, ph.src, ph.dst, ph.size,
                            ph.loc, level=level, device=CPU,
                            **_cost_kw(ph, mode))
    _close_cost(got, want)


def test_phase_cost_runs_its_sums_through_k1_and_refuses_bad_levels(phases):
    ref, ph = phases
    calls = []
    real = ks.segment_reduce
    ks.segment_reduce = lambda *a: calls.append(a) or real(*a)
    try:
        models.phase_cost(ph.machine.params, ph.src, ph.dst, ph.size, ph.loc,
                          device=CPU)
    finally:
        ks.segment_reduce = real
    assert len(calls) == 1 and calls[0][2] == ph.n_procs
    with pytest.raises(ValueError, match="unknown model level"):
        models.phase_cost(ph.machine.params, ph.src, ph.dst, ph.size, ph.loc,
                          level="bogus", device=CPU)


def test_empty_phase_costs_zero():
    ref_m, m = _pair("blue_waters")
    zero = models.CostBreakdown(0.0, 0.0, 0.0, 0.0)
    assert models.phase_cost(m.params, [], [], [], [], device=CPU) == zero
    assert models.phase_cost_phase(CommPhase.build(m, [], [], []),
                                   device=CPU) == zero
    assert models.sequence_cost([], device=CPU) == zero
    assert ref_models.phase_cost(ref_m.params, [], [], [], []).total == 0.0


def test_model_ladder_matches_reference(phases):
    ref, ph = phases
    want = ref_models.model_ladder(ref.machine.params, ref.src, ref.dst,
                                   ref.size, ref.loc,
                                   **_cost_kw(ref, "active_ppn"))
    got = models.model_ladder(ph.machine.params, ph.src, ph.dst, ph.size,
                              ph.loc, device=CPU,
                              **_cost_kw(ph, "active_ppn"))
    assert list(got) == list(want) == list(models.MODEL_LEVELS)
    for lvl in want:
        _close_cost(got[lvl], want[lvl])


def _reclassified(ref_p):
    """A table whose network class starts one row closer (intra-node pairs
    now inject into the network), on both sides."""
    rp = ref_p.replace(network_locality=ref_p.network_locality - 1,
                       alpha=ref_p.alpha * 1.3)
    return rp, CommParams.from_arrays(
        {f: getattr(rp, f) for f in CommParams.__dataclass_fields__})


@pytest.mark.parametrize("level", models.MODEL_LEVELS)
@pytest.mark.parametrize("table", ["own", "reclassified"])
def test_phase_cost_phase_matches_reference(phases, level, table):
    ref, ph = phases
    rp = p = None
    if table == "reclassified":
        rp, p = _reclassified(ref.machine.params)
    want = ref_models.phase_cost_phase(ref, level=level, params=rp)
    got = models.phase_cost_phase(ph, level=level, params=p, device=CPU)
    _close_cost(got, want)


@pytest.mark.parametrize("level", ["node_aware", "contention"])
def test_sequence_cost_of_two_step_matches_reference(phases, level):
    ref, ph = phases
    want = ref_models.sequence_cost(ref_two_step(ref).phases, level=level)
    got = models.sequence_cost(two_step(ph).phases, level=level, device=CPU)
    _close_cost(got, want)


# -- the per-phase simulator -------------------------------------------------------

def _close_result(got, want):
    for f in ("time", "transport", "queue", "contention", "max_link_bytes",
              "total_net_bytes"):
        _close(getattr(got, f), getattr(want, f))
    _close(got.per_proc_transport, want.per_proc_transport)
    np.testing.assert_array_equal(got.per_proc_queue_steps.numpy(),
                                  want.per_proc_queue_steps)


@pytest.mark.parametrize("post,arrive", [("default", "default"),
                                         ("reversed", "random")])
@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_simulate_matches_reference(phases, post, arrive, noise):
    ref, ph = phases
    want = ref_sim.simulate(ref, _orders(ref, post), _orders(ref, arrive),
                            rng=np.random.default_rng(5), noise=noise)
    got = simulator.simulate(ph, _orders(ph, post), _orders(ph, arrive),
                             rng=np.random.default_rng(5), noise=noise,
                             device=CPU)
    _close_result(got, want)


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_simulate_phase_matches_reference(phases, noise):
    ref, ph = phases
    want = ref_sim.simulate_phase(ref.machine, ref.src, ref.dst, ref.size,
                                  recv_post_order=_orders(ref, "reversed"),
                                  rng=np.random.default_rng(2), noise=noise,
                                  validate=True)
    got = simulator.simulate_phase(ph.machine, ph.src, ph.dst, ph.size,
                                   recv_post_order=_orders(ph, "reversed"),
                                   rng=np.random.default_rng(2), noise=noise,
                                   validate=True, device=CPU)
    _close_result(got, want)


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_simulate_sequence_matches_reference(phases, noise):
    ref, ph = phases
    ref_steps, steps = ref_two_step(ref).phases, two_step(ph).phases
    want = ref_sim.simulate_sequence(
        ref_steps, arrival_orders=[_orders(s, "random") for s in ref_steps],
        rng=np.random.default_rng(4), noise=noise)
    got = simulator.simulate_sequence(
        steps, arrival_orders=[_orders(s, "random") for s in steps],
        rng=np.random.default_rng(4), noise=noise, device=CPU)
    assert isinstance(got, simulator.SequenceResult)
    for f in ("time", "transport", "queue", "contention"):
        _close(getattr(got, f), getattr(want, f))
    assert len(got.phases) == len(want.phases)
    for g, w in zip(got.phases, want.phases):
        _close_result(g, w)


def test_simulate_refuses_noise_without_rng_and_empty_phase_draws_none(
        phases):
    ref, ph = phases
    with pytest.raises(ValueError, match="explicit rng"):
        simulator.simulate(ph, noise=0.1, device=CPU)
    empty = CommPhase.build(ph.machine, [], [], [])
    rng = np.random.default_rng(0)
    res = simulator.simulate(empty, rng=rng, noise=0.1, device=CPU)
    assert res.time == 0.0 and res.per_proc_queue_steps.numel() == 0
    assert rng.normal() == np.random.default_rng(0).normal()


# -- Algorithm 1: the ping-pong harnesses -----------------------------------------

@pytest.fixture(scope="module")
def bw():
    return (ref_machine.blue_waters_machine((2, 1, 1)),
            machine.blue_waters_machine((2, 1, 1)))


@pytest.fixture(scope="module")
def line():
    return (ref_machine.blue_waters_machine((4, 1, 1)),
            machine.blue_waters_machine((4, 1, 1)))


def test_pingpong_time_matches_reference(bw):
    ref_m, m = bw
    for a, b in ((0, 1), (0, 16), (0, 32)):
        want = ref_pp.pingpong_time(ref_m, a, b, 3000.0,
                                    rng=np.random.default_rng(9), noise=0.05)
        got = pingpong.pingpong_time(m, a, b, 3000.0,
                                     rng=np.random.default_rng(9), noise=0.05,
                                     device=CPU)
        _close(got, want)


@pytest.mark.parametrize("kind", BW_KINDS)
def test_pingpong_sweep_matches_reference_with_noise(bw, kind):
    ref_m, m = bw
    sizes = np.unique(np.round(np.logspace(0, 6, 20)).astype(int))
    want = ref_pp.pingpong_sweep(ref_m, kind, sizes, reps=3, noise=0.02,
                                 seed=4)
    got = pingpong.pingpong_sweep(m, kind, sizes, reps=3, noise=0.02, seed=4,
                                  device=CPU)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("preset", ["blue_waters", "lassen", "frontier"])
def test_ppn_sweep_matches_reference_with_noise(preset):
    ref_m, m = _pair(preset)
    rk, rt = ref_pp.ppn_sweep(ref_m, float(1 << 20), noise=0.02, seed=2)
    k, t = pingpong.ppn_sweep(m, float(1 << 20), noise=0.02, seed=2,
                              device=CPU)
    np.testing.assert_array_equal(k, rk)
    _close(t, rt)


@pytest.mark.parametrize("order", ["same", "reversed"])
def test_high_volume_pingpong_matches_reference_with_noise(bw, order):
    ref_m, m = bw
    pairs = [(0, 32), (1, 33), (2, 40)]
    want = ref_pp.high_volume_pingpong(ref_m, pairs, 50, 2048.0, order=order,
                                       noise=0.02, seed=3)
    got = pingpong.high_volume_pingpong(m, pairs, 50, 2048.0, order=order,
                                        noise=0.02, seed=3, device=CPU)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close_result(g, w)


@pytest.mark.parametrize("order", ["same", "reversed"])
def test_contention_line_test_matches_reference_with_noise(line, order):
    ref_m, m = line
    want = ref_pp.contention_line_test(ref_m, 4, 65536.0, order=order,
                                       noise=0.02, seed=8)
    got = pingpong.contention_line_test(m, 4, 65536.0, order=order,
                                        noise=0.02, seed=8, device=CPU)
    assert got[1].max_link_bytes > 0
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close_result(g, w)


@pytest.mark.parametrize("kind,expect", [("intra_device", (0, 1)),
                                         ("cross_device", (0, 2)),
                                         ("host_staged", None),
                                         ("bogus", None)])
def test_pair_for_matches_reference(kind, expect):
    ref_m, m = _pair("lassen")
    if expect is None:
        with pytest.raises(ValueError) as want:
            ref_pp._pair_for(ref_m, kind)
        with pytest.raises(ValueError) as got:
            pingpong._pair_for(m, kind)
        assert str(got.value) == str(want.value)
    else:
        assert pingpong._pair_for(m, kind) == ref_pp._pair_for(ref_m, kind)


# -- the parameter fits --------------------------------------------------------------

def _fits(ns, m, line_m, device):
    """Every fit of the paper's calibration on one side's measurements
    (``ns`` holds that side's harnesses and fits)."""
    gt = m.params
    out = {}
    sweeps = {kind: (SIZES, ns.pingpong_sweep(m, kind, SIZES, reps=1,
                                              noise=0.0, **device))
              for kind in BW_KINDS}
    out["table"] = ns.fit_node_aware_table(sweeps, gt)
    out["alpha_beta"] = ns.fit_alpha_beta(*sweeps["inter_node"], gt)
    ks_, ts = ns.ppn_sweep(m, float(1 << 20), noise=0.0, **device)
    li, pi = 2, PROTOCOL_NAMES.index("rend")
    out["RN"] = ns.fit_RN(ks_, ts, float(1 << 20), gt.alpha[li, pi],
                          gt.Rb[li, pi])
    out["rails"] = ns.fit_rails(ks_, ts)
    a_fit, rb_fit = out["table"]["inter_node"]["rend"]
    out["RN_rails"] = ns.fit_RN_rails(ks_, ts, float(1 << 20), a_fit, rb_fit,
                                      rails=out["rails"])
    meas, base, ns_ = [], [], np.array([8, 16, 32, 64])
    for n in ns_:
        meas.append(ns.high_volume_pingpong(m, [(0, 32)], int(n), 4096.0,
                                            order="reversed", **device)[0])
        base.append(ns.high_volume_pingpong(m, [(0, 32)], int(n), 4096.0,
                                            order="same", **device)[0])
    out["gamma"] = ns.fit_gamma(ns_, np.array(meas), np.array(base))
    ells, meas, base = [], [], []
    for size in (1 << 14, 1 << 16, 1 << 18):
        _, r1, _ = ns.contention_line_test(line_m, 4, float(size), **device)
        ells.append(r1.max_link_bytes)
        meas.append(r1.time)
        base.append(r1.time - r1.contention)
    out["delta"] = ns.fit_delta(np.array(ells), np.array(meas),
                                np.array(base))
    return out


def _ns(pp, fit):
    return types.SimpleNamespace(**{
        k: getattr(pp, k) for k in ("pingpong_sweep", "ppn_sweep",
                                    "high_volume_pingpong",
                                    "contention_line_test")}, **{
        k: getattr(fit, k) for k in ("fit_node_aware_table", "fit_alpha_beta",
                                     "fit_RN", "fit_rails", "fit_RN_rails",
                                     "fit_gamma", "fit_delta")})


@pytest.fixture(scope="module")
def fits(bw, line):
    want = _fits(_ns(ref_pp, ref_fit), bw[0], line[0], {})
    got = _fits(_ns(pingpong, fitting), bw[1], line[1], {"device": CPU})
    return got, want


@pytest.mark.parametrize("name", ["table", "alpha_beta", "RN", "rails",
                                  "RN_rails", "gamma", "delta"])
def test_fits_on_port_measurements_match_reference(fits, name):
    got, want = fits
    g, w = got[name], want[name]
    if name == "table":
        assert list(g) == list(w)
        for kind in w:
            assert list(g[kind]) == list(w[kind])
            for proto in w[kind]:
                np.testing.assert_allclose(g[kind][proto], w[kind][proto],
                                           rtol=RTOL)
    elif name == "alpha_beta":
        assert list(g) == list(w)
        for proto in w:
            np.testing.assert_allclose(g[proto], w[proto], rtol=RTOL)
    elif name == "rails":
        assert g == w == 1
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_port_fits_recover_the_tables(fits, bw):
    got, _ = fits
    gt = bw[1].params
    for li, kind in enumerate(BW_KINDS):
        for pi, proto in enumerate(PROTOCOL_NAMES):
            a, rb = got["table"][kind][proto]
            # the simulated ping pays one queue step (gamma) on top of alpha
            assert a == pytest.approx(gt.alpha[li, pi] + gt.gamma, rel=1e-4)
            assert rb == pytest.approx(gt.Rb[li, pi], rel=1e-4)
    assert got["RN"] == pytest.approx(gt.RN[2, 2], rel=1e-4)
    assert got["delta"] == pytest.approx(gt.delta, rel=1e-4)
    # both directions of a reversed exchange walk gamma n(n+1)/2 against
    # the same order's gamma n: the residual is gamma n(n-1), and the n^2
    # form's least squares recovers gamma sum n^3(n-1) / sum n^4
    n = np.array([8.0, 16.0, 32.0, 64.0])
    assert got["gamma"] == pytest.approx(
        gt.gamma * (n ** 3 * (n - 1)).sum() / (n ** 4).sum(), rel=1e-4)


def test_fit_helpers_are_the_references_on_synthetic_points():
    rng = np.random.default_rng(0)
    x, y, z = rng.random(6), rng.random(6), rng.random(6)
    assert fitting.fit_gamma(x, y, z) == ref_fit.fit_gamma(x, y, z)
    assert fitting.fit_delta(x, y, z) == ref_fit.fit_delta(x, y, z)
    zero = np.zeros(3)
    assert fitting.fit_gamma(zero, zero, zero) == 0.0
    assert fitting.fit_delta(zero, zero, zero) == 0.0
    ks_ = np.arange(1.0, 9.0)
    flat = 3e-6 - 1e-8 * ks_
    assert fitting.fit_RN(ks_, flat, 4096.0, 3e-6, 2.9e9) == float("inf")
    assert fitting.fit_RN_rails(ks_, np.full(8, 3e-6), 4096.0, 3e-6,
                                1e12) == float("inf")
    assert fitting.fit_rails(np.array([1.0]), np.array([3e-6])) == 1


# -- the accuracy tables ---------------------------------------------------------

def _ladder_pair(values):
    """The same ladder floats as a port and a reference ladder."""
    mk = (lambda cls: {lvl: cls(t, q, c, t + q + c)
                       for lvl, (t, q, c) in zip(models.MODEL_LEVELS, values)})
    return mk(models.CostBreakdown), mk(ref_models.CostBreakdown)


def test_accuracy_rows_and_tables_are_string_equal(phases):
    ref, ph = phases
    rng = np.random.default_rng(1)
    rows, ref_rows = [], []
    for measured in (1.5e-4, 0.0, 2.25, 12345.0):
        port_ladder, ref_ladder = _ladder_pair(rng.random((5, 3)) * 1e-4)
        del port_ladder["maxrate"], ref_ladder["maxrate"]
        rows.append(report.accuracy_row(measured, port_ladder))
        ref_rows.append(ref_report.accuracy_row(measured, ref_ladder))
    rows[0]["note"], ref_rows[0]["note"] = "L0", "L0"
    assert rows == ref_rows
    for cols in (None, ["measured", "node_aware", "queue_relerr", "note"]):
        assert (report.format_table(rows, cols, title="Fig 10")
                == ref_report.format_table(ref_rows, cols, title="Fig 10"))
    assert report.format_table([], title="x") == ref_report.format_table(
        [], title="x")
    # and on the port's own ladder of a real phase, row for row
    meas = simulator.simulate(ph, device=CPU).time
    got = report.accuracy_row(meas, models.model_ladder(
        ph.machine.params, ph.src, ph.dst, ph.size, ph.loc, device=CPU,
        **_cost_kw(ph, "active_ppn")))
    want = ref_report.accuracy_row(ref_sim.simulate(ref).time,
                                   ref_models.model_ladder(
        ref.machine.params, ref.src, ref.dst, ref.size, ref.loc,
        **_cost_kw(ref, "active_ppn")))
    assert list(got) == list(want)
    _close(np.array(list(got.values())), np.array(list(want.values())))


# -- the SpGEMM traffic and Figs. 10-11 --------------------------------------------

@pytest.fixture(scope="module")
def hierarchies():
    return (ref_hierarchy(ref_elasticity(8)),
            build_hierarchy(elasticity_like_3d(8)))


def test_spgemm_patterns_bit_equal(hierarchies):
    ref_levels, levels = hierarchies
    assert len(levels) == len(ref_levels) >= 3
    for li in range(len(levels) - 1):
        for P in (7, 64, max(levels[li].A.n_rows // 2, 2)):
            want = ref_spgemm(ref_levels[li].A, ref_levels[li + 1].P,
                              RefPartition.balanced(ref_levels[li].A.n_rows,
                                                    P))
            got = spgemm_comm_pattern(levels[li].A, levels[li + 1].P,
                                      RowPartition.balanced(
                                          levels[li].A.n_rows, P))
            assert got.n_procs == want.n_procs
            for f in ("src", "dst", "size"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
    one = RowPartition.balanced(levels[0].A.n_rows, 1)
    assert spgemm_comm_pattern(levels[0].A, levels[1].P, one).n_msgs == 0


def _fig10_11(ns, levels, m, max_procs):
    """Figs. 10-11 as ``benchmarks/bench_paper.bench_amg_spmv_spgemm``
    computes them: per operation, the measured times, the ladders, the
    steps and the three derived rows."""
    out = {}
    for op in ("spmv", "spgemm"):
        tagged = []
        for li, lvl in enumerate(levels):
            part = ns.RowPartition.balanced(
                lvl.A.n_rows, min(max_procs, max(lvl.A.n_rows // 2, 2)))
            if op == "spmv":
                cp = ns.spmv(lvl.A, part)
            elif li + 1 < len(levels):
                cp = ns.spgemm(lvl.A, levels[li + 1].P, part)
            else:
                break
            if cp.n_msgs:
                tagged.append((li, cp.bind(m)))
        phases = [ph for _, ph in tagged]
        arrivals = [ph.random_arrival_order(np.random.default_rng(0))
                    for ph in phases]
        sims = ns.simulate_many(phases, arrival_orders=arrivals)
        ladders = ns.model_ladder_many(phases)
        meas = np.array([r.time for r in sims])
        mod = {lvl: np.array([lad[lvl].total for lad in ladders])
               for lvl in models.MODEL_LEVELS}
        out[op] = dict(
            levels=[li for li, _ in tagged], measured=meas, **mod,
            steps=[np.asarray(r.per_proc_queue_steps) for r in sims],
            underprediction=float(np.max((meas - mod["node_aware"]) / meas)),
            plus_queue_relerr=float(np.mean(np.abs(mod["queue"] - meas)
                                            / meas)),
            queue_contention_share=float(np.max(1.0 - mod["node_aware"]
                                                / meas)))
    return out


def test_fig10_11_small_matches_reference(hierarchies):
    ref_levels, levels = hierarchies
    dims = (4, 2, 2)
    ref_ns = types.SimpleNamespace(
        RowPartition=RefPartition, spmv=ref_spmv, spgemm=ref_spgemm,
        simulate_many=ref_sim.simulate_many,
        model_ladder_many=ref_models.model_ladder_many)
    ns = types.SimpleNamespace(
        RowPartition=RowPartition, spmv=spmv_comm_pattern,
        spgemm=spgemm_comm_pattern,
        simulate_many=functools.partial(simulator.simulate_many, device=CPU),
        model_ladder_many=functools.partial(models.model_ladder_many,
                                            device=CPU))
    ref_m = ref_machine.blue_waters_machine(dims)
    m = machine.blue_waters_machine(dims)
    want = _fig10_11(ref_ns, ref_levels, ref_m, ref_m.n_procs)
    got = _fig10_11(ns, levels, m, m.n_procs)
    for op in want:
        assert got[op]["levels"] == want[op]["levels"]
        for k, w in want[op].items():
            if k == "steps":
                for g, s in zip(got[op][k], w):
                    np.testing.assert_array_equal(g.numpy() if isinstance(
                        g, torch.Tensor) else g, s)
            elif k != "levels":
                _close(got[op][k], w)
    # the paper's reading holds on the port: transport-only models
    # under-predict, the queue term closes most of the gap
    assert got["spmv"]["underprediction"] > 0.0


# -- typed validation ------------------------------------------------------------

BAD = {
    "nan_size": ([0, 1], [1, 0], [8.0, float("nan")], None),
    "negative_size": ([0, 1], [1, 0], [8.0, -1.0], None),
    "negative_rank": ([0, -1], [1, 0], [8.0, 8.0], None),
    "rank_past_n_procs": ([0, 9], [1, 0], [8.0, 8.0], 4),
    "fractional_rank": ([0.0, 1.5], [1, 0], [8.0, 8.0], None),
    "length_mismatch": ([0, 1, 2], [1, 0], [8.0, 8.0], None),
    "rank_past_int32": ([0, 2 ** 31], [1, 0], [8.0, 8.0], None),
    "bad_n_procs": ([0, 1], [1, 0], [8.0, 8.0], 0),
}


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return [c.__name__ for c in type(info.value).__mro__]


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_raises_the_references_pattern_error(case):
    src, dst, size, n_procs = BAD[case]
    ref_m, m = _pair("blue_waters")
    want = _raised(lambda: ref_guard.validate_messages(src, dst, size,
                                                       n_procs))
    assert "PatternError" in want
    assert _raised(lambda: guard.validate_messages(src, dst, size,
                                                   n_procs)) == want
    assert _raised(lambda: CommPhase.build(m, src, dst, size,
                                           n_procs=n_procs,
                                           validate=True)) == want
    assert _raised(lambda: models.phase_cost(
        m.params, src, dst, size, np.zeros(len(src), dtype=int),
        n_procs=n_procs, validate=True, device=CPU)) == want
    if n_procs is None:                # simulate_phase takes no n_procs
        assert _raised(lambda: simulator.simulate_phase(
            m, src, dst, size, validate=True, device=CPU)) == want
        assert _raised(lambda: ref_sim.simulate_phase(
            ref_m, src, dst, size, validate=True)) == want
    phase_like = types.SimpleNamespace(src=np.asarray(src),
                                       dst=np.asarray(dst),
                                       size=np.asarray(size),
                                       n_procs=n_procs)
    assert _raised(lambda: guard.validate_phase(phase_like)) == _raised(
        lambda: ref_guard.validate_phase(phase_like))


def test_validate_passes_good_phases(phases):
    ref, ph = phases
    guard.validate_phase(ph)
    guard.validate_messages([], [], [])
    assert issubclass(guard.ArenaOverflowError, guard.PatternError)
    assert issubclass(guard.PatternError, ValueError)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fits_on_the_card_match_the_cpu(cuda, bw, line):
    before = dict(ks.LAUNCHES)
    got = _fits(_ns(pingpong, fitting), bw[1], line[1], {"device": None})
    want = _fits(_ns(pingpong, fitting), bw[1], line[1], {"device": CPU})
    for kind, per_proto in want["table"].items():
        for proto, v in per_proto.items():
            np.testing.assert_allclose(got["table"][kind][proto], v,
                                       rtol=RTOL)
    for proto, v in want["alpha_beta"].items():
        np.testing.assert_allclose(got["alpha_beta"][proto], v, rtol=RTOL)
    assert got["rails"] == want["rails"]
    for name in ("RN", "RN_rails", "gamma", "delta"):
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL)
    assert ks.LAUNCHES["segment_reduce"] > before["segment_reduce"]
    assert ks.LAUNCHES["queue_walk"] > before["queue_walk"]


@pytest.mark.gpu
@pytest.mark.parametrize("level", models.MODEL_LEVELS)
def test_phase_cost_on_the_card_matches_the_cpu(cuda, phases, level):
    _, ph = phases
    kw = _cost_kw(ph, "node_of")
    before = ks.LAUNCHES["segment_reduce"]
    got = models.phase_cost(ph.machine.params, ph.src, ph.dst, ph.size,
                            ph.loc, level=level, **kw)
    assert ks.LAUNCHES["segment_reduce"] == before + 1
    want = models.phase_cost(ph.machine.params, ph.src, ph.dst, ph.size,
                             ph.loc, level=level, device=CPU, **kw)
    _close_cost(got, want)
