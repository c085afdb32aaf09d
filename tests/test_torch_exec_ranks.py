"""The execution layer across ranks against the JAX package's.

``build_executor(schedule, mesh=)`` runs each simulated rank as a member
of a process group, here a world of 8 ranks as threads
(``launch.mesh.run_ranks``, ``device="cpu"``), as the reference runs each
on one of 8 forced host devices.  For every host preset x strategy x
coloring (40 seeded messages, as ``tests/test_exec.py`` draws them) the
matrix every rank returns from ``execute(..., mesh=)`` is bit-equal to
the reference's numpy ``run_reference`` of the reference's own schedule
and to the port's virtual-rank executor, and the digest is within rtol
1e-4 of the float64 ``np.bincount(unit_dst, payload)``.  The edge cases
of ``tests/test_exec.py`` (no message, messages to self, one rank) run
with no round; each round sends one message per pair of its ``perm``,
of the round's ``pack`` width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import repro.exec as rx  # noqa: E402
from repro.comm import strategies as ref_strategies  # noqa: E402
from repro.comm.phase import CommPhase as RefPhase  # noqa: E402
import repro_torch.exec as tx  # noqa: E402
from repro_torch.comm import strategies  # noqa: E402
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.launch.mesh import make_rank_mesh, run_ranks  # noqa: E402

CPU = "cpu"
REF_MACHINES = rx.host_machines()
MACHINES = tx.host_machines()
CASES = [(name, strat) for name, m in REF_MACHINES.items()
         for strat in ref_strategies.strategies_for(m)]
IDS = [f"{m}-{s}" for m, s in CASES]


def _messages(n=40, seed=0, n_procs=8):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_procs, n)
    dst = (src + rng.integers(1, n_procs, n)) % n_procs
    return src, dst, rng.integers(1, 6000, n).astype(float)


def _across_ranks(sched):
    """``execute(sched, mesh=)`` on a world of ``n_procs`` thread ranks:
    each rank's (delivered, digest)."""
    def rank(r):
        mesh = make_rank_mesh(sched.n_procs, CPU)
        return tx.execute(sched, device=CPU, mesh=mesh)
    return run_ranks(sched.n_procs, rank, device=CPU)


def _check(sched, want):
    bincount = np.bincount(sched.unit_dst,
                           weights=sched.payload.astype(float),
                           minlength=sched.n_procs)
    virtual = tx.build_executor(sched, device=CPU)()
    assert torch.equal(virtual, torch.from_numpy(want))
    for delivered, digest in _across_ranks(sched):
        assert delivered.dtype == torch.int32
        assert torch.equal(delivered, virtual)
        np.testing.assert_allclose(digest.double().numpy(), bincount,
                                   rtol=1e-4)


@pytest.mark.parametrize("name,strat", CASES, ids=IDS)
def test_ranks_deliver_bit_equal_to_the_reference(name, strat):
    msgs = _messages()
    ref = RefPhase.build(REF_MACHINES[name], *msgs, n_procs=8)
    ph = CommPhase.build(MACHINES[name], *msgs, n_procs=8)
    for coloring in tx.COLORINGS:
        sched = tx.build_schedule(ph, strat, coloring=coloring)
        want = rx.run_reference(rx.build_schedule(ref, strat,
                                                  coloring=coloring))
        _check(sched, want)


def test_edge_cases_run_with_no_round():
    m = MACHINES["lassen_8"]
    empty = CommPhase.build(m, [], [], [], n_procs=8)
    selfmsg = CommPhase.build(m, [0, 3, 5], [0, 3, 5], [64.0, 1024.0, 0.0],
                              n_procs=8)
    onerank = CommPhase.build(m, [0, 0], [0, 0], [100.0, 200.0], n_procs=1)
    for phase in (empty, selfmsg, onerank):
        for strat in strategies.strategies_for(m):
            sched = tx.build_schedule(phase, strat)
            assert sched.n_rounds == 0
            _check(sched, rx.run_reference(sched))


def test_each_round_is_one_message_per_pair(monkeypatch):
    # the split sizes of every ppermute are the round's perm pairs, each of
    # the round's pack width: the messages the pricing plan counts
    sched = tx.build_schedule(CommPhase.build(MACHINES["blue_waters_8"],
                                              *_messages(n=64, seed=3),
                                              n_procs=8), "three_step")
    rounds = [rnd for ph in sched.phases for rnd in ph.rounds]
    assert len(rounds) > 2
    calls = {}
    real = dist.all_to_all_single

    def spy(output, input, output_split_sizes=None, input_split_sizes=None,
            **kwargs):
        calls.setdefault(dist.get_rank(), []).append(
            (list(input_split_sizes), list(output_split_sizes)))
        return real(output, input, output_split_sizes, input_split_sizes,
                    **kwargs)

    monkeypatch.setattr(dist, "all_to_all_single", spy)
    _across_ranks(sched)
    for r in range(8):
        assert len(calls[r]) == len(rounds)
        for rnd, (send, recv) in zip(rounds, calls[r]):
            width = rnd.pack.shape[1]
            want_send, want_recv = [0] * 8, [0] * 8
            for s, d in rnd.perm:
                if s == r:
                    want_send[d] = width
                if d == r:
                    want_recv[s] = width
            assert (send, recv) == (want_send, want_recv)
    msgs = sum(len(rnd.perm) for rnd in rounds)
    assert msgs == sum(sum(v > 0 for v in send) for r in range(8)
                       for send, _ in calls[r])


def test_timed_and_swept_across_ranks():
    m = MACHINES["lassen_8"]
    ph = CommPhase.build(m, *_messages(), n_procs=8)
    sched = tx.build_schedule(ph, "standard")

    def rank(r):
        mesh = make_rank_mesh(8, CPU)
        meas = tx.time_schedule(sched, device=CPU, mesh=mesh, reps=3,
                                warmup=1)
        swept = tx.measure_strategies(ph, ["standard", "two_step"],
                                      device=CPU, mesh=mesh, reps=1,
                                      warmup=1)
        return meas, swept, tx.launch_overhead(ph, device=CPU, mesh=mesh,
                                               reps=1, warmup=1)

    for meas, swept, overhead in run_ranks(8, rank, device=CPU):
        assert meas.n_rounds == sched.n_rounds and len(meas.times_s) == 3
        assert meas.median_s > 0 and overhead > 0
        assert sorted(swept) == ["standard", "two_step"]


def test_a_mesh_of_another_size_is_refused():
    sched = tx.build_schedule(CommPhase.build(MACHINES["lassen_8"],
                                              *_messages(), n_procs=8),
                              "standard")

    def rank(r):
        return tx.build_executor(sched, device=CPU,
                                 mesh=make_rank_mesh(4, CPU))

    with pytest.raises(ValueError, match="holds 4 ranks"):
        run_ranks(4, rank, device=CPU)
