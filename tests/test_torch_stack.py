"""The PyTorch port's PhaseStack against the JAX package's, on all four
machine presets.

The same seeded message sets are bound on both sides and stacked into one
arena each; every aggregate the model ladder and the simulator read is then
compared: queue steps bit-equal (integer work), float aggregates
float32-allclose (rtol 1e-4, atol 1e-6) to the float64 reference.  The port
runs with ``device="cpu"``, where its kernel wrappers take their plain
versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import CommPhase as RefPhase  # noqa: E402
from repro.comm import PhaseStack as RefStack  # noqa: E402
from repro.core.topology import TorusTopology as RefTorus  # noqa: E402
from repro.net import machine as ref_machine  # noqa: E402
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.comm.stack import PhaseStack  # noqa: E402
from repro_torch.core.params import CommParams  # noqa: E402
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.net import machine  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
PRESETS = {
    "blue_waters": ("blue_waters_machine", (2, 2, 2)),
    "tpu_v5e": ("tpu_v5e_machine", (4, 4)),
    "lassen": ("lassen_machine", (2, 2, 2)),
    "frontier": ("frontier_machine", (2, 2, 1)),
}
SIZES = (0, 1, 40, 300, 800, 2)     # empty, single-message and heavy phases


def _messages(P, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, P, n)
    dst = (src + rng.integers(1, P, n)) % P
    size = rng.integers(8, 1 << 18, n).astype(float)
    return src, dst, size


@pytest.fixture(scope="module", params=sorted(PRESETS))
def stacks(request):
    fn, dims = PRESETS[request.param]
    ref_m = getattr(ref_machine, fn)(dims)
    m = getattr(machine, fn)(dims)
    P = m.n_procs
    ref_ph, ph = [], []
    for i, n in enumerate(SIZES):
        msgs = _messages(P, n, i)
        ref_ph.append(RefPhase.build(ref_m, *msgs, n_procs=P))
        ph.append(CommPhase.build(m, *msgs, n_procs=P))
    return RefStack.build(ref_ph), PhaseStack.build(ph, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("node_aware,use_maxrate", [(True, True),
                                                    (False, True),
                                                    (False, False)])
def test_cost_arrays_match_reference(stacks, node_aware, use_maxrate):
    ref, st = stacks
    want = ref.cost_arrays(node_aware=node_aware, use_maxrate=use_maxrate,
                           backend="numpy")
    got = st.cost_arrays(node_aware=node_aware, use_maxrate=use_maxrate)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    _close(got[2], want[2])


def test_cost_arrays_under_substituted_table(stacks):
    ref, st = stacks
    rp = ref.machine.params
    ref_p = rp.replace(alpha=rp.alpha * 1.7, Rb=rp.Rb * 0.6,
                       gamma=rp.gamma * 2)
    p = CommParams.from_arrays(
        {f: getattr(ref_p, f) for f in CommParams.__dataclass_fields__})
    want = ref.cost_arrays(ref_p, backend="numpy")
    got = st.cost_arrays(p)
    for g, w in zip(got, want):
        _close(g, w)


def _arrivals(phases, seed):
    rng = np.random.default_rng(seed)
    return [ph.random_arrival_flat(rng) for ph in phases]


def test_queue_steps_many_bit_equal(stacks):
    ref, st = stacks
    want = ref.queue_steps_many(arrival_orders=_arrivals(ref.phases, 5),
                                recv_post_orders=_arrivals(ref.phases, 6),
                                backend="numpy")
    got = st.queue_steps_many(arrival_orders=_arrivals(st.phases, 5),
                              recv_post_orders=_arrivals(st.phases, 6))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_link_contention_many_matches_reference(stacks):
    ref, st = stacks
    want_link, want_net = ref.link_contention_many(backend="numpy")
    got_link, got_net = st.link_contention_many()
    _close(got_link, want_link)
    _close(got_net, want_net)


def test_phase_link_contention_matches_reference(stacks):
    ref, st = stacks
    for r, p in zip(ref.phases, st.phases):
        np.testing.assert_allclose(p.link_contention(device="cpu"),
                                   r.link_contention(), rtol=RTOL, atol=ATOL)


def test_sim_arrays_match_reference(stacks):
    ref, st = stacks
    want = ref.sim_arrays(arrival_orders=_arrivals(ref.phases, 9),
                          backend="numpy")
    got = st.sim_arrays(arrival_orders=_arrivals(st.phases, 9))
    _close(got.transport, want.transport)
    _close(got.max_link, want.max_link)
    _close(got.net_bytes, want.net_bytes)
    for g, w in zip(got.per_proc, want.per_proc):
        _close(g, w)
    for g, w in zip(got.qsteps, want.qsteps):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dims,wrap", [((4, 3, 5), False), ((6, 4), True),
                                       ((5,), True)])
def test_route_link_ids_equal_reference(dims, wrap):
    rng = np.random.default_rng(len(dims))
    ref, torus = RefTorus(dims, wrap=wrap), TorusTopology(dims, wrap=wrap)
    a = rng.integers(0, ref.size, 500)
    b = rng.integers(0, ref.size, 500)
    want_msg, want_link = ref.route_link_ids(a, b)
    got_msg, got_link = torus.route_link_ids(torch.from_numpy(a),
                                             torch.from_numpy(b))
    np.testing.assert_array_equal(got_msg.numpy(), want_msg)
    np.testing.assert_array_equal(got_link.numpy(), want_link)


def test_stack_rejects_mixed_machines():
    m1, m2 = machine.blue_waters_machine((2, 1, 1)), \
        machine.blue_waters_machine((2, 1, 1))
    with pytest.raises(ValueError, match="mixed machines"):
        PhaseStack.build([CommPhase.build(m1, [0], [1], [8.0]),
                          CommPhase.build(m2, [0], [1], [8.0])],
                         device="cpu")
