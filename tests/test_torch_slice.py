"""The PyTorch port's main path against the JAX package's, end to end.

An AMG hierarchy of the elasticity-like operator is partitioned per level,
its SpMV halo patterns are bound to a Blue Waters partition, and
``best_strategy_many`` rewrites every level into every node-aware strategy
and prices the candidates with the model ladder and the simulator.  The
port (``device="cpu"``: plain kernel versions) must pick the same model and
simulator winners as the reference, with totals float32-allclose (rtol
1e-4, atol 1e-6).  The reference runs on its numpy backend and once on its
Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import GPU_STRATEGIES as REF_GPU  # noqa: E402
from repro.comm import CommPhase as RefPhase  # noqa: E402
from repro.comm import best_strategy_many as ref_best_many  # noqa: E402
from repro.comm.health import get_health  # noqa: E402
from repro.core import model_ladder_many as ref_ladder  # noqa: E402
from repro.exec import calibrate, record_sweeps  # noqa: E402
from repro.net import machine as ref_machine  # noqa: E402
from repro.sparse import (RowPartition as RefPartition,  # noqa: E402
                          build_hierarchy as ref_hierarchy,
                          elasticity_like_3d as ref_elasticity,
                          spmv_comm_pattern as ref_spmv)
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.comm.strategies import (GPU_STRATEGIES,  # noqa: E402
                                         best_strategy_many)
from repro_torch.core.models import MODEL_LEVELS, model_ladder_many  # noqa: E402
from repro_torch.core.params import CommParams  # noqa: E402
from repro_torch.net import machine  # noqa: E402
from repro_torch.sparse.amg import build_hierarchy  # noqa: E402
from repro_torch.sparse.partition import (RowPartition,  # noqa: E402
                                          spmv_comm_pattern, stack_patterns)
from repro_torch.sparse.problems import elasticity_like_3d  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
DIMS = (4, 2, 2)


def _patterns(levels, partition, spmv, n_procs):
    return [spmv(lvl.A, partition.balanced(lvl.A.n_rows,
                                           min(n_procs, lvl.A.n_rows // 2)))
            for lvl in levels]


@pytest.fixture(scope="module")
def amg():
    ref_m = ref_machine.blue_waters_machine(DIMS)
    m = machine.blue_waters_machine(DIMS)
    ref_pats = _patterns(ref_hierarchy(ref_elasticity(8)), RefPartition,
                         ref_spmv, ref_m.n_procs)
    pats = _patterns(build_hierarchy(elasticity_like_3d(8)), RowPartition,
                     spmv_comm_pattern, m.n_procs)
    return ref_m, ref_pats, m, pats


def _assert_same_verdicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.model_winner == w.model_winner
        assert g.sim_winner == w.sim_winner
        assert list(g.model) == list(w.model)
        for s in w.model:
            np.testing.assert_allclose(g.model[s], w.model[s], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(g.sim[s], w.sim[s], rtol=RTOL,
                                       atol=ATOL)


def test_spmv_patterns_equal_reference(amg):
    _, ref_pats, _, pats = amg
    assert len(pats) == len(ref_pats) == 3
    for g, w in zip(pats, ref_pats):
        assert g.n_procs == w.n_procs
        for f in ("src", "dst", "size"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_best_strategy_many_matches_numpy_reference(amg):
    ref_m, ref_pats, m, pats = amg
    want = ref_best_many(ref_pats, ref_m, backend="numpy")
    got = best_strategy_many(pats, m, device="cpu")
    _assert_same_verdicts(got, want)
    # the sweep crosses over: aggregation wins the fine levels
    assert [v.model_winner for v in got] == ["three_step", "three_step",
                                             "standard"]
    # the one-pattern entry point is the same sweep
    one = pats[1].best_strategy(m, device="cpu")
    assert one.model == got[1].model and one.sim == got[1].sim


def test_best_strategy_many_matches_pallas_reference(amg):
    ref_m, ref_pats, m, pats = amg
    want = ref_best_many(ref_pats, ref_m, backend="pallas")
    # device_guard falls back to numpy silently: prove Pallas served it
    assert get_health().n_events == 0
    _assert_same_verdicts(best_strategy_many(pats, m, device="cpu"), want)


def test_model_ladder_many_matches_reference(amg):
    ref_m, ref_pats, m, pats = amg
    want = ref_ladder([p.bind(ref_m) for p in ref_pats])
    got = model_ladder_many(stack_patterns(pats, m, device="cpu"))
    for g, w in zip(got, want):
        for lvl in MODEL_LEVELS:
            np.testing.assert_allclose(
                [getattr(g[lvl], f) for f in ("transport", "queue",
                                              "contention", "total")],
                [getattr(w[lvl], f) for f in ("transport", "queue",
                                              "contention", "total")],
                rtol=RTOL, atol=ATOL)


def test_lassen_gpu_pair_matches_reference():
    ref_m = ref_machine.lassen_machine((2, 2, 2))
    m = machine.lassen_machine((2, 2, 2))
    ref_ph, ph = [], []
    for n in (8, 32, 128, 512, 2048):
        rng = np.random.default_rng(42)
        P = m.n_procs
        src = rng.integers(0, P, n)
        dst = (src + rng.integers(1, P, n)) % P
        size = rng.integers(256, 8192, n).astype(float)
        ref_ph.append(RefPhase.build(ref_m, src, dst, size, n_procs=P))
        ph.append(CommPhase.build(m, src, dst, size, n_procs=P))
    want = ref_best_many(ref_ph, strategies=REF_GPU, backend="numpy")
    got = best_strategy_many(ph, strategies=GPU_STRATEGIES, device="cpu")
    _assert_same_verdicts(got, want)
    # the crossover the pair exists for: direct for few messages, staged
    # through the host for many
    assert got[0].model_winner == "device_direct"
    assert got[-1].model_winner == "host_staged"


def test_fitted_table_carries_across(amg):
    ref_m, ref_pats, m, pats = amg
    fitted = calibrate(record_sweeps(ref_machine.blue_waters_machine(
        (2, 1, 1))), ref_m.params).params
    assert fitted is not ref_m.params
    want = ref_best_many(ref_pats, ref_m, params=fitted, backend="numpy")
    got = best_strategy_many(
        pats, m, params=CommParams.from_arrays(dataclasses.asdict(fitted)),
        device="cpu")
    _assert_same_verdicts(got, want)
