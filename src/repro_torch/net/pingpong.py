"""Ping-pong harnesses (paper Section 4, Algorithm 1) on the simulator.

These generate the measurement sets the paper collects on Blue Waters:
classic two-process ping-pongs split by locality (Figs. 2-3), the ppn sweep
behind the max-rate R_N measurement, the HighVolumePingPong with
same/reversed receive ordering (Figs. 4-5) and the 1-D Gemini-line
contention test (Figs. 6-7, 9).

Port note: each harness binds every phase it measures on the host and
prices them all in one :func:`~repro_torch.net.simulator.simulate_many`
call on ``device`` (``None`` = CUDA), listed in the order the reference
simulates them one by one.  ``simulate_many`` draws one lognormal factor
per non-empty phase in list order from the harness's numpy generator, so
noisy results equal the reference's under the same seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.comm.phase import CommPhase
from repro_torch.device import resolve_device

from .machine import MachineSpec
from .simulator import PhaseResult, simulate_many


def _pair_for(machine: MachineSpec, kind: str) -> tuple[int, int]:
    """A canonical process pair on ``machine`` for a locality-class ``kind``.

    Hetero kinds: ``intra_device`` needs more than one rank per device;
    ``cross_device`` is the next device over; the network-path kinds
    (``host_staged`` / ``device_direct``) give a cross-node pair and demand
    that the machine is *configured* with that path (its ``locality`` is
    what classifies the pair) — a mismatch raises instead of silently
    measuring the other path's rate class.
    """
    ppn = machine.procs_per_node
    if kind in ("intra_socket", "closest", "intra_device"):
        if kind == "intra_device" and machine.procs_per_device < 2:
            raise ValueError(
                f"{machine.name} has {machine.procs_per_device} rank(s) per "
                "device; no intra-device pair exists")
        return 0, 1
    if kind in ("intra_node", "cross_device"):
        if machine.devices_per_node:
            return 0, machine.procs_per_device       # next device over
        if machine.sockets_per_node > 1:
            return 0, ppn // machine.sockets_per_node  # cross-socket
        return 0, 1
    if kind in ("inter_node", "host_staged", "device_direct"):
        if kind != "inter_node":
            want = machine.params.class_index(kind)  # raises w/o the class
            if machine.cross_node_locality != want:
                have = machine.params.locality_names[
                    machine.cross_node_locality]
                raise ValueError(
                    f"{machine.name} is configured with network path "
                    f"{have!r}; rebuild the preset with "
                    f"network_path={kind!r} to measure that class")
        return 0, ppn * machine.nodes_per_torus_node  # next torus node over
    raise ValueError(f"unknown pair kind {kind!r}")


def _ping(machine: MachineSpec, a: int, b: int, size: float) -> CommPhase:
    """The one-message phase ``a -> b`` of ``size`` bytes."""
    return CommPhase.build(machine, [a], [b], [size])


def pingpong_time(machine: MachineSpec, a: int, b: int, size: float,
                  rng=None, noise: float = 0.0, device=None) -> float:
    """Half round-trip time for a single message of ``size`` bytes."""
    t1, t2 = (r.time for r in simulate_many(
        [_ping(machine, a, b, size), _ping(machine, b, a, size)],
        rng=rng, noise=noise, device=device))
    return 0.5 * (t1 + t2)


def pingpong_sweep(machine: MachineSpec, kind: str, sizes,
                   reps: int = 4, noise: float = 0.02,
                   seed: int = 0, device=None) -> np.ndarray:
    """Mean ping-pong time per size for a locality class (Figs. 2-3 data).

    Every ping of the sweep is one phase of one :func:`simulate_many`
    call, ordered size, then rep, then ``a -> b`` before ``b -> a``.
    """
    a, b = _pair_for(machine, kind)
    sizes = [float(s) for s in sizes]
    phases = [ph for s in sizes for _ in range(reps)
              for ph in (_ping(machine, a, b, s), _ping(machine, b, a, s))]
    if not phases:                # reps <= 0: no ping, one NaN a size
        resolve_device(device)
        return np.full(len(sizes), np.nan)
    times = [r.time for r in simulate_many(
        phases, rng=np.random.default_rng(seed), noise=noise,
        device=device)]
    out, k = [], 0
    for _ in sizes:
        ts = []
        for _ in range(reps):
            ts.append(0.5 * (times[k] + times[k + 1]))
            k += 2
        out.append(np.mean(ts))
    return np.asarray(out)


def ppn_sweep(machine: MachineSpec, size: float, max_ppn: int | None = None,
              noise: float = 0.0, seed: int = 0,
              device=None) -> tuple[np.ndarray, np.ndarray]:
    """Inter-node exchange with k = 1..ppn active pairs (max-rate R_N data).

    Process i on node 0 sends one ``size``-byte message to process i on the
    next torus node over.  Returns (ppn values, phase times).
    """
    max_ppn = max_ppn or machine.procs_per_node
    other = machine.procs_per_node * machine.nodes_per_torus_node
    ks = np.arange(1, max_ppn + 1)
    phases = [CommPhase.build(machine, np.arange(k), other + np.arange(k),
                              np.full(k, float(size))) for k in ks]
    res = simulate_many(phases, rng=np.random.default_rng(seed), noise=noise,
                        device=device)
    return ks, np.asarray([r.time for r in res])


def high_volume_pingpong(machine: MachineSpec, pairs, n: int, size: float,
                         order: str = "same", noise: float = 0.0,
                         seed: int = 0, device=None
                         ) -> tuple[float, PhaseResult, PhaseResult]:
    """Algorithm 1: each (a, b) pair exchanges ``n`` messages of ``size`` bytes.

    ``order='same'``: receives posted in arrival order (O(n) queue cost).
    ``order='reversed'``: receives posted opposite to arrival order — every
    arrival walks the whole remaining queue (O(n^2), paper Fig. 4 right).
    Returns (total time, phase a->b, phase b->a); both directions are one
    :func:`simulate_many` call, so reversed orders reach kernel K2 once.
    """
    pairs = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
    src = np.repeat(pairs[:, 0], n)
    dst = np.repeat(pairs[:, 1], n)
    sizes = np.full(src.shape, float(size))

    def post_order(dsts):
        if order == "same":
            return None
        po = {}
        for p in np.unique(dsts):
            ids = np.nonzero(dsts == p)[0]
            po[int(p)] = ids[::-1]          # posted opposite to arrival
        return po

    r1, r2 = simulate_many(
        [CommPhase.build(machine, src, dst, sizes),
         CommPhase.build(machine, dst, src, sizes)],
        recv_post_orders=[post_order(dst), post_order(src)],
        rng=np.random.default_rng(seed), noise=noise, device=device)
    return r1.time + r2.time, r1, r2


def contention_line_test(machine: MachineSpec, n: int, size: float,
                         order: str = "same", noise: float = 0.0,
                         seed: int = 0, device=None
                         ) -> tuple[float, PhaseResult, PhaseResult]:
    """Paper Fig. 6: Geminis G0..G3 on a line; G0->G2 and G1->G3 pairwise.

    All bytes funnel through the single G1-G2 link, producing contention that
    the max-rate + queue model misses (Fig. 7) and the delta*ell term captures
    (Fig. 9).  ``machine`` should be a 1-D line partition, e.g.
    ``blue_waters_machine((4, 1, 1))``.
    """
    ppt = machine.procs_per_torus_node
    pairs = [(0 * ppt + j, 2 * ppt + j) for j in range(ppt)]
    pairs += [(1 * ppt + j, 3 * ppt + j) for j in range(ppt)]
    return high_volume_pingpong(machine, pairs, n, size, order=order,
                                noise=noise, seed=seed, device=device)
