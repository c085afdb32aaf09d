"""The LLM workload registry of the PyTorch port against the JAX package's.

The derivations are host numpy in both packages, so every routing
histogram and every derived pattern (``src``, ``dst``, ``size``, dtypes
and ``n_procs``) is held bit-equal to ``repro.workloads`` on the same
arguments, and every ``ValueError`` the reference raises, the port raises
with the same text.  The 21-row sweep on ``device="cpu"`` (the plain
kernel versions) gives the reference's rows in the same order and all 42
of its winners; its costs are float32 aggregates, held to the reference's
float64 ones at rtol 1e-4.  The ``gpu`` test holds the sweep on the card to
the cpu sweep with K1 and K2 launched.  Last, the three port faults found
against the reference (typed arena overflow, a queue-walk arrival that is
not a permutation, ``pingpong_sweep`` with no reps), each with a case that
failed before its fix.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import workloads as ref  # noqa: E402
from repro.comm import guard as ref_guard  # noqa: E402
from repro.net import machine as ref_machine  # noqa: E402
from repro.net import pingpong as ref_pp  # noqa: E402
from repro_torch import configs, workloads  # noqa: E402
from repro_torch.comm import guard  # noqa: E402
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.comm.stack import PhaseStack  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.net import machine, pingpong  # noqa: E402
from test_workloads_golden import GOLDEN  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
CPU = "cpu"
MOE = ("qwen3-moe-30b-a3b", "deepseek-moe-16b")


def _cfgs(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    return getattr(configs, get)(arch), getattr(ref_configs, get)(arch)


def _same_pattern(got, want):
    assert got.n_procs == want.n_procs
    for f in ("src", "dst", "size"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.n_msgs == want.n_msgs
    assert got.total_bytes == want.total_bytes
    assert got.max_msgs_per_proc() == want.max_msgs_per_proc()


def _same_moe(got, want):
    for a, b in ((got.counts, want.counts), (got.sent, want.sent)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.capacity, got.token_bytes, got.n_ranks, got.dropped_tokens) \
        == (want.capacity, want.token_bytes, want.n_ranks,
            want.dropped_tokens)
    assert [lbl for lbl, _ in got.phases()] == \
        [lbl for lbl, _ in want.phases()]
    for (_, g), (_, w) in zip(got.phases(), want.phases()):
        _same_pattern(g, w)


def _both_raise(port_call, ref_call, exc=ValueError):
    with pytest.raises(exc) as want:
        ref_call()
    with pytest.raises(exc) as got:
        port_call()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# -- routing histograms -------------------------------------------------------
@pytest.mark.parametrize("n_ranks,tokens,n_experts,top_k,seed,conc", [
    (2, 1, 2, 1, 0, 0.3), (4, 16, 8, 2, 1, 0.3), (8, 64, 32, 3, 7, 1.0),
    (16, 32, 64, 6, 123, 0.1), (64, 256, 128, 8, 0, 0.3),
    (3, 5, 7, 7, 2**31 - 1, 5.0)])
def test_synthetic_routing_counts_bit_equal(n_ranks, tokens, n_experts,
                                            top_k, seed, conc):
    got = workloads.synthetic_routing_counts(n_ranks, tokens, n_experts,
                                             top_k, seed=seed,
                                             concentration=conc)
    want = ref.synthetic_routing_counts(n_ranks, tokens, n_experts, top_k,
                                        seed=seed, concentration=conc)
    assert got.dtype == want.dtype and got.shape == (n_ranks, n_experts)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n_ranks * tokens * top_k


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("smoke,n_ranks,tokens,seed", [
    (True, 4, 16, 0), (True, 2, 33, 5), (False, 8, 64, 3),
    (False, 64, 256, 0)])
def test_router_routing_counts_bit_equal(arch, smoke, n_ranks, tokens, seed):
    cfg, rcfg = _cfgs(arch, smoke)
    got = workloads.router_routing_counts(cfg, n_ranks, tokens, seed=seed)
    want = ref.router_routing_counts(rcfg, n_ranks, tokens, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n_ranks * tokens * cfg.n_experts_active


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("tokens", [1, 16, 256, 4096, 100_003])
def test_a2a_capacity_equals_reference(arch, tokens):
    cfg, rcfg = _cfgs(arch, False)
    assert workloads.a2a_capacity(tokens, cfg) == \
        ref.a2a_capacity(tokens, rcfg)


@pytest.mark.parametrize("capacity", [0, 1, 3, 8, 10_000])
@pytest.mark.parametrize("seed", [0, 4])
def test_pattern_from_counts_bit_equal_with_clipping(capacity, seed):
    counts = np.random.default_rng(seed).integers(0, 12, (8, 16))
    got = workloads.pattern_from_counts(counts, 64, capacity, act_bytes=4)
    want = ref.pattern_from_counts(counts, 64, capacity, act_bytes=4)
    _same_moe(got, want)
    assert got.dropped_tokens == int(np.maximum(counts - capacity, 0).sum())


def test_pattern_from_counts_of_a_self_only_histogram_is_empty():
    counts = np.zeros((4, 4), np.int64)
    np.fill_diagonal(counts, 9)          # every token stays on its rank
    got = workloads.pattern_from_counts(counts, 32, 8)
    _same_moe(got, ref.pattern_from_counts(counts, 32, 8))
    assert got.dispatch.n_msgs == 0 and got.dropped_tokens == 4


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("source", ["synthetic", "router"])
@pytest.mark.parametrize("smoke,n_ranks,tokens,seed", [
    (True, 4, 16, 11), (False, 64, 256, 0)])
def test_moe_a2a_pattern_bit_equal(arch, source, smoke, n_ranks, tokens,
                                   seed):
    cfg, rcfg = _cfgs(arch, smoke)
    got = workloads.moe_a2a_pattern(cfg, n_ranks, tokens, seed=seed,
                                    source=source)
    want = ref.moe_a2a_pattern(rcfg, n_ranks, tokens, seed=seed,
                               source=source)
    _same_moe(got, want)


# -- pipeline and tensor-parallel traffic -------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-3b", "tinyllama-1.1b",
                                  "qwen3-32b"])
@pytest.mark.parametrize("n_stages,n_micro,mb_tokens,n_procs", [
    (2, 1, 1, None), (4, 2, 16, 64), (8, 8, 512, 64), (3, 5, 7, 9)])
def test_pipeline_p2p_pattern_bit_equal(arch, n_stages, n_micro, mb_tokens,
                                        n_procs):
    cfg, rcfg = _cfgs(arch, False)
    _same_pattern(
        workloads.pipeline_p2p_pattern(cfg, n_stages, n_micro, mb_tokens,
                                       n_procs=n_procs, dtype_bytes=2),
        ref.pipeline_p2p_pattern(rcfg, n_stages, n_micro, mb_tokens,
                                 n_procs=n_procs, dtype_bytes=2))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("tp", [2, 7, 8, 64])
def test_row_parallel_ops_per_layer_equals_reference(arch, tp):
    cfg, rcfg = _cfgs(arch, False)
    assert workloads.row_parallel_ops_per_layer(cfg, tp) == \
        ref.row_parallel_ops_per_layer(rcfg, tp)


@pytest.mark.parametrize("arch,smoke", [("llama3.2-3b", False),
                                        ("llama3.2-3b", True),
                                        ("qwen3-moe-30b-a3b", False),
                                        ("deepseek-moe-16b", True),
                                        ("hymba-1.5b", False)])
@pytest.mark.parametrize("tp,tokens,n_groups", [(2, 16, 1), (8, 2048, 1),
                                                (4, 33, 3)])
def test_tp_collective_patterns_bit_equal(arch, smoke, tp, tokens, n_groups):
    cfg, rcfg = _cfgs(arch, smoke)
    got = workloads.tp_collective_patterns(cfg, tp, tokens, n_groups=n_groups)
    want = ref.tp_collective_patterns(rcfg, tp, tokens, n_groups=n_groups)
    assert (got.payload_bytes, got.n_ops, got.tp, got.per_rank_bytes) == \
        (want.payload_bytes, want.n_ops, want.tp, want.per_rank_bytes)
    assert [lbl for lbl, _ in got.phases()] == \
        [lbl for lbl, _ in want.phases()]
    for (_, g), (_, w) in zip(got.phases(), want.phases()):
        _same_pattern(g, w)


# -- the registry -------------------------------------------------------------
def test_registry_constants_equal_reference():
    from repro_torch.workloads import registry
    assert registry.WORKLOADS == ref.registry.WORKLOADS
    assert [dataclasses.astuple(s) for s in workloads.DEFAULT_SCENARIOS] == \
        [dataclasses.astuple(s) for s in ref.DEFAULT_SCENARIOS]
    assert [f.name for f in dataclasses.fields(workloads.SweepRow)] == \
        [f.name for f in dataclasses.fields(ref.SweepRow)]
    assert workloads.ACT_BYTES == ref.ACT_BYTES
    got, want = workloads.default_machines(), ref.default_machines()
    assert list(got) == list(want)
    for name in want:
        assert got[name].n_procs == want[name].n_procs == 64


@pytest.mark.parametrize("idx", range(len(ref.DEFAULT_SCENARIOS)))
def test_scenario_patterns_bit_equal(idx):
    sc = workloads.DEFAULT_SCENARIOS[idx]
    got = workloads.scenario_patterns(sc)
    want = ref.scenario_patterns(ref.DEFAULT_SCENARIOS[idx])
    assert [lbl for lbl, _ in got] == [lbl for lbl, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _same_pattern(g, w)
        assert g.n_procs == sc.n_ranks and (g.src != g.dst).all()


# -- errors -------------------------------------------------------------------
def _err_cases():
    moe = ("qwen3-moe-30b-a3b", True)
    dense = ("llama3.2-3b", True)
    return {
        "top_k above n_experts": (None, lambda w, c:
                                  w.synthetic_routing_counts(2, 4, 3, 4)),
        "router of a dense config": (dense, lambda w, c:
                                     w.router_routing_counts(c, 2, 4)),
        "counts not 2-d": (None, lambda w, c: w.pattern_from_counts(
            np.ones(4), 8, 8)),
        "experts indivisible over ranks": (None, lambda w, c:
                                           w.pattern_from_counts(
                                               np.ones((3, 8)), 8, 8)),
        "unknown source": (moe, lambda w, c: w.moe_a2a_pattern(
            c, 4, 16, source="uniform")),
        "one stage": (dense, lambda w, c: w.pipeline_p2p_pattern(c, 1, 2, 8)),
        "no microbatch": (dense, lambda w, c: w.pipeline_p2p_pattern(
            c, 2, 0, 8)),
        "stages indivisible over ranks": (dense, lambda w, c:
                                          w.pipeline_p2p_pattern(
                                              c, 3, 2, 16, n_procs=64)),
        "tp of 1": (dense, lambda w, c: w.tp_collective_patterns(c, 1, 16)),
        "no row-parallel op": (dense, lambda w, c: w.tp_collective_patterns(
            c, 7, 16)),
        "unknown workload": (None, lambda w, c: w.Scenario(
            name="x", arch="llama3.2-3b", workload="ring", n_ranks=4,
            tokens_per_rank=8)),
        "negative pipeline payload": (dense, lambda w, c:
                                      w.pipeline_p2p_pattern(c, 2, 2, -8)),
    }


@pytest.mark.parametrize("case", list(_err_cases()))
def test_every_reference_error_is_raised_by_the_port(case):
    arch, call = _err_cases()[case]
    cfg, rcfg = _cfgs(*arch) if arch else (None, None)
    _both_raise(lambda: call(workloads, cfg), lambda: call(ref, rcfg))


def test_unknown_arch_raises_key_error_in_both():
    sc = workloads.Scenario(name="x", arch="gpt-2", workload="moe_a2a",
                            n_ranks=4, tokens_per_rank=8)
    rsc = ref.Scenario(**dataclasses.asdict(sc))
    with pytest.raises(KeyError) as want:
        ref.scenario_patterns(rsc)
    with pytest.raises(KeyError) as got:
        workloads.scenario_patterns(sc)
    # the port's registry names its own ids after the reference's
    extra = "".join(f", {a!r}" for a in configs.PORT_ONLY_IDS)
    assert str(got.value) == str(want.value).replace("]\"", extra + "]\"")


# -- the sweep ----------------------------------------------------------------
@pytest.fixture(scope="module")
def rows():
    return workloads.sweep(device=CPU), ref.sweep()


def test_sweep_rows_in_the_reference_order(rows):
    got, want = rows
    assert len(got) == len(want) == 21
    for g, w in zip(got, want):
        assert (g.machine, g.scenario, g.phase, g.n_msgs, g.total_bytes) == \
            (w.machine, w.scenario, w.phase, w.n_msgs, w.total_bytes)


def test_sweep_winners_equal_reference_and_golden(rows):
    got, want = rows
    win = {(r.machine, r.scenario, r.phase): (r.model_winner, r.sim_winner)
           for r in got}
    assert win == {(r.machine, r.scenario, r.phase):
                   (r.model_winner, r.sim_winner) for r in want}
    assert win == GOLDEN
    assert all(r.agree for r in got)


def test_sweep_costs_allclose_and_never_degraded(rows):
    got, want = rows
    for g, w in zip(got, want):
        assert isinstance(g.model, float) and isinstance(g.sim, float)
        np.testing.assert_allclose(g.model, w.model, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.sim, w.sim, rtol=RTOL, atol=ATOL)
        assert g.degraded is False


def test_winner_table_string_equal(rows):
    got, want = rows
    assert workloads.winner_table(got) == ref.winner_table(want)


SMALL = (("moe", dict(arch="deepseek-moe-16b", workload="moe_a2a",
                      n_ranks=32, tokens_per_rank=64, seed=3)),
         ("tp", dict(arch="tinyllama-1.1b", workload="tp_collective",
                     n_ranks=16, tokens_per_rank=128)),
         ("pipe", dict(arch="qwen3-32b", workload="pipeline_p2p",
                       n_ranks=32, tokens_per_rank=64, n_stages=4,
                       n_microbatches=3)))


@pytest.mark.parametrize("level", ["node_aware", "contention"])
@pytest.mark.parametrize("seed", [0, 5])
def test_small_sweep_matches_reference(level, seed):
    scen = [workloads.Scenario(name=n, **kw) for n, kw in SMALL]
    rscen = [ref.Scenario(name=n, **kw) for n, kw in SMALL]
    machines = {"frontier": machine.frontier_machine((2, 1, 1)),
                "blue_waters": machine.blue_waters_machine((1, 1, 1))}
    rmachines = {"frontier": ref_machine.frontier_machine((2, 1, 1)),
                 "blue_waters": ref_machine.blue_waters_machine((1, 1, 1))}
    got = workloads.sweep(scen, machines, level=level, seed=seed, device=CPU)
    want = ref.sweep(rscen, rmachines, level=level, seed=seed)
    assert len(got) == len(want) == 2 * 5
    for g, w in zip(got, want):
        assert (g.machine, g.scenario, g.phase, g.n_msgs, g.model_winner,
                g.sim_winner) == (w.machine, w.scenario, w.phase, w.n_msgs,
                                  w.model_winner, w.sim_winner)
        np.testing.assert_allclose([g.model, g.sim], [w.model, w.sim],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("workload,tokens", [("pipeline_p2p", -64),
                                             ("tp_collective", float("nan"))])
def test_sweep_validation_raises_the_reference_error(workload, tokens):
    kw = dict(name="bad", arch="llama3.2-3b", workload=workload, n_ranks=8,
              tokens_per_rank=tokens, n_stages=2, n_microbatches=2)
    with pytest.raises(ref_guard.PatternError) as want:
        ref.sweep([ref.Scenario(**kw)], validate=True)
    with pytest.raises(guard.PatternError) as got:
        workloads.sweep([workloads.Scenario(**kw)], validate=True,
                        device=CPU)
    assert type(got.value).__name__ == type(want.value).__name__ == \
        "MessageSizeError"
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)


def test_comm_pattern_methods_equal_reference():
    from repro.sparse.partition import CommPattern as RefPattern
    from repro_torch.sparse.partition import CommPattern
    m, rm = machine.lassen_machine((2, 1, 1)), \
        ref_machine.lassen_machine((2, 1, 1))
    args = (np.array([0, 5, 9, 9, 31]), np.array([9, 9, 0, 31, 5]),
            np.array([8.0, 4096.0, 1e6, 0.0, 64.0]), 32)
    pat, rpat = CommPattern(*args), RefPattern(*args)
    assert pat.validate(where="here") is pat
    assert (pat.total_bytes, pat.max_msgs_per_proc()) == \
        (rpat.total_bytes, rpat.max_msgs_per_proc())
    ph, rph = pat.bind(m, validate=True), rpat.bind(rm, validate=True)
    for f in ("src", "dst", "size", "loc", "proto", "send_node",
              "active_ppn"):
        np.testing.assert_array_equal(getattr(ph, f), getattr(rph, f))
    for strategy in ("standard", "two_step", "three_step", "host_staged",
                     "device_direct"):
        plan, rplan = pat.rewrite(m, strategy), rpat.rewrite(rm, strategy)
        assert plan.roles == rplan.roles
        for a, b in zip(plan.phases, rplan.phases):
            for f in ("src", "dst", "size", "loc"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    bad = (np.array([0, 40]), np.array([1, 2]), np.array([1.0, 2.0]), 32)
    _both_raise(lambda: CommPattern(*bad).validate(where="w"),
                lambda: RefPattern(*bad).validate(where="w"))
    _both_raise(lambda: CommPattern(*bad).bind(m, validate=True),
                lambda: RefPattern(*bad).bind(rm, validate=True))
    with pytest.raises(guard.RankError):
        CommPattern(*bad).validate()


def test_chip_smoke_holds_the_sweep_to_the_reference_winners():
    # the script imports nothing of repro, so it carries the table as data
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.REGISTRY_WINNERS == GOLDEN


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sweep_on_the_card_matches_the_cpu(cuda, rows):
    ks.reset_launches()
    got = workloads.sweep()
    launches = dict(ks.LAUNCHES)
    assert launches["segment_reduce"] > 0 and launches["queue_walk"] > 0
    for g, c in zip(got, rows[0]):
        assert (g.machine, g.scenario, g.phase, g.model_winner,
                g.sim_winner) == (c.machine, c.scenario, c.phase,
                                  c.model_winner, c.sim_winner)
        np.testing.assert_allclose([g.model, g.sim], [c.model, c.sim],
                                   rtol=RTOL, atol=ATOL)


# -- port faults found against the reference ----------------------------------
def test_arena_overflow_is_the_typed_pattern_error():
    m = machine.blue_waters_machine((2, 1, 1))
    stack = PhaseStack.build([CommPhase.build(m, [0, 1], [1, 0], [8.0, 8.0])],
                             device=CPU)
    with pytest.raises(guard.ArenaOverflowError, match="int32 range") as e:
        stack._put(np.array([2 ** 31, 0], dtype=np.int64), "column")
    assert isinstance(e.value, guard.PatternError)
    assert isinstance(e.value, ValueError)
    with pytest.raises(guard.ArenaOverflowError, match="int32 range"):
        stack._put(np.array([0, -2 ** 31 - 1], dtype=np.int64), "column")
    assert stack._put(np.array([2 ** 31 - 1, -2 ** 31]), "column").dtype == \
        torch.int32


def _walk_args(posted, arrival, bounds, dev="cpu"):
    return [torch.tensor(a, dtype=torch.int64, device=dev)
            for a in (posted, arrival, bounds)]


@pytest.mark.parametrize("posted,arrival,bounds", [
    ([0, 1], [0, 0], [0, 2]),
    ([0, 1, 0, 2, 1], [0, 1, 2, 2, 0], [0, 2, 5]),
    ([1, 0, 0], [1, 1, 0], [0, 2, 3])])
def test_queue_walk_rejects_an_arrival_that_is_not_a_permutation(
        posted, arrival, bounds):
    for fn in (ks.queue_walk, ks.queue_walk_plain):
        with pytest.raises(ValueError, match="arrival must be permutations"):
            fn(*_walk_args(posted, arrival, bounds))
    # a permutation in the same layout still walks
    ok = [list(range(b - a)) for a, b in zip(bounds[:-1], bounds[1:])]
    flat = [i for r in ok for i in r]
    assert ks.queue_walk(*_walk_args(flat, flat, bounds)).tolist() == \
        [1] * len(flat)


@pytest.mark.gpu
def test_queue_walk_refuses_a_repeated_arrival_before_any_launch(cuda):
    before = ks.LAUNCHES["queue_walk"]
    with pytest.raises(ValueError, match="arrival must be permutations"):
        ks.queue_walk(*_walk_args([0, 1], [0, 0], [0, 2], cuda))
    assert ks.LAUNCHES["queue_walk"] == before


@pytest.mark.parametrize("reps", [0, -1])
def test_pingpong_sweep_without_reps_gives_one_nan_a_size(reps):
    m = machine.blue_waters_machine((2, 1, 1))
    rm = ref_machine.blue_waters_machine((2, 1, 1))
    got = pingpong.pingpong_sweep(m, "inter_node", [1e3, 1e4], reps=reps,
                                  device=CPU)
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = ref_pp.pingpong_sweep(rm, "inter_node", [1e3, 1e4], reps=reps)
    assert got.shape == want.shape == (2,)
    assert np.isnan(got).all() and np.isnan(want).all()
    assert pingpong.pingpong_sweep(m, "inter_node", [], reps=0,
                                   device=CPU).shape == (0,)
