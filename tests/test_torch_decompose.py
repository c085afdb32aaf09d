"""HLO collective extraction, decomposition and pricing of the PyTorch port
against the JAX package's.

Counterparts of ``tests/test_hlo_decompose.py``: every case runs through
``repro_torch.core`` (the per-chip sums through K1's plain version on the
CPU) and through ``repro.core`` on the same inputs.  The parse is equal
field by field, message sets and geometry integers bit-equal, and every
``CollectiveCost`` / ``StepCommModel`` float within rtol 1e-4 / atol 1e-6
(the port sums per chip in float32 through K1; the reference in float64).
Also here: the full-width training step that ``chip_smoke.py`` prices on
the card (qwen3-moe-30b-a3b on the 2 x 16 x 16 mesh, 512 chips), and the
K1 site under the post-kernel check.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
from repro.core import hlo as ref_hlo  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.comm import faults, health  # noqa: E402
from repro_torch.core import decompose, hlo  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from test_hlo_decompose import HLO  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_port_health():
    health.reset_health()
    faults._env_cache.clear()
    yield
    health.reset_health()
    faults._env_cache.clear()


@pytest.fixture(scope="module")
def smoke():
    # the script imports nothing of repro, so the step's HLO text lives there
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_ops(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.kind, a.result_bytes, a.count, a.line, a.group_size) == \
            (b.kind, b.result_bytes, b.count, b.line, b.group_size)
        assert a.source_target_pairs == b.source_target_pairs
        if b.groups is None:
            assert a.groups is None
        else:
            assert a.groups.dtype == b.groups.dtype
            np.testing.assert_array_equal(a.groups, b.groups)


def _same_messages(a, b):
    for f in ("src", "dst", "size", "mult"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.rounds, a.outstanding, a.waves) == (b.rounds, b.outstanding,
                                                  b.waves)


def _held_cost(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    assert (g["kind"], g["count"]) == (w["kind"], w["count"])
    for k in w:
        if isinstance(w[k], float):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{w['kind']}.{k}")
    np.testing.assert_allclose(got.model_time, want.model_time, rtol=RTOL,
                               atol=ATOL)


def _held_step(got, want):
    for a, b in zip(got.per_op, want.per_op):
        _held_cost(a, b)
    g, w = got.as_dict(), want.as_dict()
    assert g.keys() == w.keys() and len(g["ops"]) == len(w["ops"])
    for k in w:
        if k != "ops":
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _op_pair(kind, result_bytes, groups=None, pairs=None, count=1):
    return (core.CollectiveOp(kind, result_bytes, groups, pairs, count, ""),
            ref.CollectiveOp(kind, result_bytes, groups, pairs, count, ""))


# ================================================================= parse ==
@pytest.mark.parametrize("type_str", [
    "bf16[8,128]", "(f32[4,4], bf16[2])", "f32[]", "s4[7,3]", "token[]",
    "(f32[2]{0}, pred[3], c128[2,2], u8[], weird[4])",
    "f8e4m3fn[16,16]{1,0}", "(s32[], bf16[4,4096,2048]{2,1,0})"])
def test_shape_bytes_equals_the_reference(type_str):
    assert core.shape_bytes(type_str) == ref.shape_bytes(type_str)
    assert hlo.DTYPE_BYTES == ref_hlo.DTYPE_BYTES
    assert hlo.COLLECTIVE_KINDS == ref_hlo.COLLECTIVE_KINDS


@pytest.mark.parametrize("g,s,dims,perm", [
    (2, 4, [8], None), (4, 2, [2, 4], [1, 0]), (32, 16, [512], None),
    (32, 16, [2, 16, 16], [0, 2, 1]), (256, 2, [2, 256], [1, 0]),
    (8, 8, [4, 4, 4], [2, 0, 1]), (1, 512, [512], None)])
def test_iota_groups_equal_the_reference(g, s, dims, perm):
    got = hlo.parse_iota_groups(g, s, dims, perm)
    want = ref_hlo.parse_iota_groups(g, s, dims, perm)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if perm == [1, 0] and dims == [2, 4]:
        # iota(8).reshape(2,4).T.reshape(4,2) -> rows [0,4],[1,5],...
        assert list(got[0]) == [0, 4] and list(got[1]) == [1, 5]


@pytest.mark.parametrize("trip", [1, 12, 48])
def test_parse_of_the_fixture_equals_the_reference(trip):
    ops = core.parse_collectives(HLO, default_trip_count=trip)
    _same_ops(ops, ref.parse_collectives(HLO, default_trip_count=trip))
    by_kind = {o.kind: o for o in ops}
    assert by_kind["all-reduce"].count == trip       # inside the while body
    assert by_kind["all-gather"].count == 1
    assert by_kind["collective-permute"].source_target_pairs == [
        (0, 16), (16, 32), (32, 0)]
    assert core.collective_summary(ops) == ref.collective_summary(
        ref.parse_collectives(HLO, default_trip_count=trip))


def test_parse_of_explicit_groups_and_comments_equals_the_reference():
    text = HLO.replace(
        "replica_groups=[64,8]<=[512]",
        "replica_groups={{0,1,2,3},{4,5,6,7}}").replace(
        "  %cp = ", "  // %x = bf16[2] all-reduce(%a), replica_groups={}\n"
        "  %cp = ").replace(
        "replica_groups=[32,16]<=[512], dimensions={1}, to_apply",
        "replica_groups={{0,1},{2}}, dimensions={1}, to_apply")
    ops = core.parse_collectives(text, default_trip_count=3)
    _same_ops(ops, ref.parse_collectives(text, default_trip_count=3))
    by_kind = {o.kind: o for o in ops}
    assert by_kind["all-to-all"].groups.tolist() == [[0, 1, 2, 3],
                                                     [4, 5, 6, 7]]
    assert by_kind["reduce-scatter"].groups is None   # ragged: no groups
    assert len(ops) == 5


def test_parse_of_the_full_width_step_equals_the_reference(smoke):
    text = smoke.collective_step_hlo()
    trip = smoke.COLLECTIVES["layers"]
    ops = core.parse_collectives(text, default_trip_count=trip)
    _same_ops(ops, ref.parse_collectives(text, default_trip_count=trip))
    assert [(o.kind, o.count, o.group_size) for o in ops] == [
        ("all-gather", 48, 16), ("all-reduce", 48, 16),
        ("all-to-all", 48, 256), ("all-to-all", 48, 256),
        ("reduce-scatter", 48, 16), ("all-reduce", 1, 2),
        ("all-to-all", 1, 512), ("collective-permute", 1, 2)]
    # the iota layouts XLA prints for the mesh's axes: data groups share
    # (pod, model), model groups are 16 consecutive chips, pod pairs chip c
    # with c + 256
    ag, ar, disp = ops[0].groups, ops[1].groups, ops[2].groups
    assert ag[0].tolist() == list(range(0, 256, 16))
    assert ar[1].tolist() == list(range(16, 32))
    assert ops[5].groups[3].tolist() == [3, 259]
    assert disp.shape == (2, 256) and disp[1, 0] == 256
    assert ops[7].source_target_pairs[-1] == (511, 0)
    assert core.collective_summary(ops) == ref.collective_summary(ops)


# ============================================================ decompose ==
def test_decompose_all_reduce_ring():
    op, rop = _op_pair("all-reduce", 1024.0, np.arange(8).reshape(1, 8))
    ms = core.decompose_collective(op)
    _same_messages(ms, ref.decompose_collective(rop))
    # ring: every device sends 2(k-1) shards of B/k to its neighbor
    assert ms.src.size == 8
    assert np.allclose(ms.size, 1024 / 8) and np.allclose(ms.mult, 14)
    assert ms.outstanding == 1 and ms.waves == 14
    assert ms.size[0] * ms.mult[0] == pytest.approx(2 * 7 / 8 * 1024)


def test_decompose_all_to_all_pairwise():
    op, rop = _op_pair("all-to-all", 800.0, np.arange(4).reshape(1, 4))
    ms = core.decompose_collective(op)
    _same_messages(ms, ref.decompose_collective(rop))
    assert ms.src.size == 4 * 3
    assert ms.outstanding == 3 and ms.waves == 1
    assert np.allclose(ms.size, 200.0)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "ragged-all-to-all", "collective-permute",
                                  "all-reduce-no-groups"])
def test_message_sets_are_bit_equal_to_the_reference(kind):
    rng = np.random.default_rng(len(kind))
    groups = rng.permutation(64).reshape(8, 8)
    groups[3] = groups[3][::-1]
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 64, (20, 2))]
    if kind == "all-reduce-no-groups":
        op, rop = _op_pair("all-reduce", 4096.0)
    elif kind == "collective-permute":
        op, rop = _op_pair(kind, 4096.0, pairs=pairs)
    else:
        op, rop = _op_pair(kind, 4096.0, groups)
    ms, want = core.decompose_collective(op), ref.decompose_collective(rop)
    _same_messages(ms, want)
    both = core.MessageSet.concat([ms, core.MessageSet.empty(), ms])
    _same_messages(both, ref.MessageSet.concat(
        [want, ref.MessageSet.empty(), want]))


def test_geometry_is_integer_equal_to_the_reference():
    g, rg = core.PodGeometry(n_pods=2), ref.PodGeometry(n_pods=2)
    assert g.locality(0, 3) == 0            # same host
    assert g.locality(0, 4) == 1            # same pod ICI
    assert g.locality(0, 256) == 2          # cross pod DCN
    assert g.hops(0, 1) == 1 and g.hops(0, 15) == 1 and g.hops(0, 16) == 1
    assert g.hops(0, 8 * 16 + 8) == 16      # mid-torus: 8 + 8
    a, b = np.meshgrid(np.arange(0, 512, 7), np.arange(0, 512, 5))
    for f in ("pod_of", "host_of"):
        np.testing.assert_array_equal(getattr(g, f)(a), getattr(rg, f)(a))
    for f in ("locality", "hops", "transit_hops"):
        got, want = getattr(g, f)(a, b), getattr(rg, f)(a, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f)
    for x, y in zip(g.hop_components(a, b), rg.hop_components(a, b)):
        np.testing.assert_array_equal(x, y)
    odd, rodd = core.PodGeometry(3, 6, 10, 2), ref.PodGeometry(3, 6, 10, 2)
    np.testing.assert_array_equal(odd.transit_hops(a % 180, b % 180),
                                  rodd.transit_hops(a % 180, b % 180))
    assert (odd.n_devices, odd.chips_per_pod) == (180, 60)


# =============================================================== pricing ==
def _reference_active_senders(host, src, is_net):
    """The reference's per-message loop (``repro/core/decompose.py``,
    ``price_collective``) for one op."""
    act = {}
    for h, p, n in zip(host, src, is_net):
        if n:
            act.setdefault(int(h), set()).add(int(p))
    counts = {h: len(s) for h, s in act.items()}
    return np.asarray([counts.get(int(h), 1) if n else 1
                       for h, n in zip(host, is_net)], dtype=np.float64)


@pytest.mark.parametrize("seed", range(4))
def test_active_senders_per_host_equal_the_reference_loop(seed):
    rng = np.random.default_rng(seed)
    n, n_ops = 400, 3
    op_of = np.sort(rng.integers(0, n_ops, n))
    src = rng.integers(0, 64, n)
    host = src // 4
    is_net = rng.random(n) < (0.3 if seed % 2 else 1.0)
    got = decompose.active_senders_per_host(op_of, host, src, is_net)
    want = np.concatenate([_reference_active_senders(
        host[op_of == k], src[op_of == k], is_net[op_of == k])
        for k in range(n_ops)])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (decompose.active_senders_per_host(op_of, host, src,
                                              np.zeros(n, bool)) == 1).all()


def test_price_ring_vs_a2a_queue():
    """The paper's point, adapted: fragmented many-peer comm pays
    gamma*n^2."""
    params, rparams = core.tpu_v5e(), ref.tpu_v5e()
    geom, rgeom = core.PodGeometry(n_pods=1), ref.PodGeometry(n_pods=1)
    ring, rring = _op_pair("all-reduce", float(1 << 20),
                           np.arange(256).reshape(1, 256))
    a2a, ra2a = _op_pair("all-to-all", float(1 << 20),
                         np.arange(256).reshape(1, 256))
    c_ring = core.price_collective(ring, geom, params, device=CPU)
    c_a2a = core.price_collective(a2a, geom, params, device=CPU)
    _held_cost(c_ring, ref.price_collective(rring, rgeom, rparams))
    _held_cost(c_a2a, ref.price_collective(ra2a, rgeom, rparams))
    assert c_ring.queue < c_a2a.queue       # 255 outstanding transfers vs 1
    assert c_a2a.contention > c_ring.contention   # hop-distance sharing
    assert c_ring.naive_time > 0


def test_price_step_totals():
    params, rparams = core.tpu_v5e(), ref.tpu_v5e()
    geom, rgeom = core.PodGeometry(n_pods=1), ref.PodGeometry(n_pods=1)
    op, rop = _op_pair("all-gather", 4096.0, np.arange(16).reshape(1, 16),
                       count=3)
    m = core.price_step([op], geom, params, device=CPU)
    one = core.price_collective(op, geom, params, device=CPU)
    assert m.model_time == pytest.approx(3 * one.model_time)
    assert m.naive_time == pytest.approx(3 * one.naive_time)
    _held_step(m, ref.price_step([rop], rgeom, rparams))
    empty = core.price_step([], geom, params, device=CPU)
    assert (empty.per_op, empty.model_time, empty.total_msgs) == ([], 0, 0)


def test_dcn_pricing():
    """Cross-pod rings pay DCN latency/bandwidth on pod-crossing messages."""
    params, rparams = core.tpu_v5e(), ref.tpu_v5e()
    geom, rgeom = core.PodGeometry(n_pods=2), ref.PodGeometry(n_pods=2)
    op, rop = _op_pair("all-reduce", float(1 << 20), np.array([[0, 256]]))
    intra, rintra = _op_pair("all-reduce", float(1 << 20),
                             np.array([[0, 4]]))
    c = core.price_collective(op, geom, params, device=CPU)
    ci = core.price_collective(intra, geom, params, device=CPU)
    _held_cost(c, ref.price_collective(rop, rgeom, rparams))
    _held_cost(ci, ref.price_collective(rintra, rgeom, rparams))
    assert c.transport > ci.transport      # DCN much slower than ICI
    assert c.naive_time > ci.naive_time


def test_the_fixture_step_is_held_to_the_reference_in_one_k1_call(
        monkeypatch):
    calls = []
    real = ks.segment_reduce

    def spy(*a):
        calls.append(a[2])
        return real(*a)

    monkeypatch.setattr(ks, "segment_reduce", spy)
    # the fixture's groups span 512 chips: one pod of 256 cannot hold them
    with pytest.raises(IndexError):
        ref.price_step(ref.parse_collectives(HLO, 12), ref.PodGeometry(),
                       ref.tpu_v5e())
    with pytest.raises(IndexError, match="outside the pod's 256 devices"):
        core.price_step(core.parse_collectives(HLO, 12), core.PodGeometry(),
                        core.tpu_v5e(), device=CPU)
    assert calls == []
    for n_pods in (2, 3):
        ops = core.parse_collectives(HLO, default_trip_count=12)
        # an op with no message (a group of one) prices to zeros
        ops.append(core.CollectiveOp("all-reduce", 64.0, np.array([[5]]),
                                     None, 2, ""))
        rops = ref.parse_collectives(HLO, default_trip_count=12)
        rops.append(ref.CollectiveOp("all-reduce", 64.0, np.array([[5]]),
                                     None, 2, ""))
        geom = core.PodGeometry(n_pods=n_pods)
        got = core.price_step(ops, geom, core.tpu_v5e(), device=CPU)
        _held_step(got, ref.price_step(rops, ref.PodGeometry(n_pods=n_pods),
                                       ref.tpu_v5e()))
        assert got.per_op[-1].model_time == 0.0
        # five per-chip sums of the five ops with messages, one call
        assert calls[-1] == 5 * 5 * geom.n_devices
    assert len(calls) == 2


def test_the_full_width_step_is_held_to_the_reference(smoke):
    text = smoke.collective_step_hlo()
    trip = smoke.COLLECTIVES["layers"]
    pod = smoke.COLLECTIVES["pod"]
    got = core.price_step(core.parse_collectives(text, trip),
                          core.PodGeometry(**pod), core.tpu_v5e(),
                          device=CPU)
    want = ref.price_step(ref.parse_collectives(text, trip),
                          ref.PodGeometry(**pod), ref.tpu_v5e())
    _held_step(got, want)
    for c in got.per_op:
        assert c.model_time > 0 and c.naive_time > 0
    # the expert all-to-alls (255 peers a chip) pay far more than
    # bytes / link_bw: the paper's thesis on the pod
    a2a = [c for c in got.per_op if c.kind == "all-to-all" and c.count > 1]
    assert len(a2a) == 2
    assert all(c.model_time > 100 * c.naive_time for c in a2a)


@pytest.mark.parametrize("site", ["kernel.segment_reduce",
                                  "stack.device_store"])
def test_the_k1_site_under_corrupt_with_parity_raises(site, monkeypatch):
    ops = core.parse_collectives(HLO, default_trip_count=12)
    geom, params = core.PodGeometry(n_pods=2), core.tpu_v5e()
    clean = core.price_step(ops, geom, params, device=CPU)
    monkeypatch.setenv("REPRO_STACK_VERIFY", "parity")
    with pytest.warns(RuntimeWarning, match="BackendVerifyError"):
        with faults.inject(site, "corrupt") as spec:
            with pytest.raises(ks.BackendVerifyError, match="parity"):
                core.price_step(ops, geom, params, device=CPU)
    assert spec.fired == 1
    assert health.get_health().events_for("cpu", site)
    with faults.inject(site, "corrupt"):       # the check off: no error
        monkeypatch.delenv("REPRO_STACK_VERIFY")
        off = core.price_step(ops, geom, params, device=CPU)
    assert off.transport != clean.transport
    again = core.price_step(ops, geom, params, device=CPU)
    assert again.as_dict() == clean.as_dict()


def test_params_carry_the_reference_pod_constants():
    from repro.core import params as ref_params
    from repro_torch.core import params
    names = [n for n in vars(ref_params) if n.startswith("V5E_")]
    assert len(names) == 7
    for n in names:
        assert getattr(params, n) == getattr(ref_params, n), n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_price_step_is_held_to_the_cpu(cuda, smoke):
    ops = core.parse_collectives(smoke.collective_step_hlo(),
                                 smoke.COLLECTIVES["layers"])
    geom, params = core.PodGeometry(**smoke.COLLECTIVES["pod"]), \
        core.tpu_v5e()
    ks.reset_launches()
    got = core.price_step(ops, geom, params)
    assert ks.LAUNCHES["segment_reduce"] == 1
    _held_step(got, core.price_step(ops, geom, params, device=CPU))
