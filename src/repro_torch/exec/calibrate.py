"""Fitted parameter tables from recorded ping-pong sweeps.

The model-vs-measured comparison is only honest if the model side does not
peek at the simulator's ground-truth rate tables.  This module closes that
loop the way the paper does: *record* the measurement suite once
(:func:`record_sweeps` — per-locality ping-pong size sweeps over **both**
network paths, plus the ppn saturation sweep per path), optionally ship it
as JSON (:meth:`SweepRecord.to_json`), and *fit* a fresh
:class:`~repro_torch.core.params.CommParams` from the record alone
(:func:`calibrate`): per-class (alpha, R_b) tables via
:func:`repro_torch.core.fitting.fit_node_aware_table`, the rail count via
:func:`repro_torch.core.fitting.fit_rails`, and the per-rail injection cap R_N
via the rails-exact :func:`repro_torch.core.fitting.fit_RN_rails`.

Two conventions to know when reading fitted numbers:

* the simulator charges one queue step per received message, so a
  single-message ping-pong pays ``alpha + gamma``; the fitted alpha
  *absorbs* gamma.  That is a feature, not a bias — every model prediction
  made with fitted params prices that same per-message step implicitly,
  and gamma/delta themselves keep their base values (they need the
  dedicated high-volume/contention harnesses, out of scope here).
* network-path kinds are measured on a machine *rebuilt* with that path
  (``cross_node_locality`` repointed), mirroring how a real calibration
  run re-launches the benchmark with a different transport setting.

Port note: the sweeps run on the port's simulator on ``device`` (``None``
= CUDA), whose phase times are float32; the fits are the port's float64
numpy copies of the reference's.  So a fitted table holds to the
reference's within rel 1e-4 (as the port's fits in
``tests/test_torch_paper.py``), not the reference's own 1e-6.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.comm.phase import CommPhase
from repro_torch.core.fitting import (fit_node_aware_table, fit_rails,
                                      fit_RN_rails)
from repro_torch.core.params import PROTOCOL_NAMES, CommParams
from repro_torch.device import resolve_device
from repro_torch.net.machine import MachineSpec
from repro_torch.net.pingpong import pingpong_sweep, ppn_sweep
from repro_torch.net.simulator import simulate

#: Default ping-pong size grid: two sizes per protocol regime or better
#: under the default thresholds (short <= 512 < eager <= 8192 < rend).
DEFAULT_SIZES = (64.0, 256.0, 1024.0, 4096.0,
                 16384.0, 65536.0, 262144.0, 1048576.0)

#: Default ppn-sweep message size: deep in the rendezvous regime so the
#: injection cap binds early (the staircase fit needs saturation).
PPN_SIZE = float(1 << 20)


@dataclasses.dataclass(frozen=True)
class SweepRecord:
    """One machine's recorded measurement suite.

    ``pingpong[kind]`` holds the ping-pong times for ``sizes`` (one entry
    per locality-class kind, network paths measured on the matching
    rebuilt machine); ``ppn[kind]`` holds the ``(ks, times)`` saturation
    sweep at ``ppn_size`` bytes per network-path kind; ``machine`` is the
    preset name the record came from.
    """

    machine: str
    sizes: np.ndarray
    pingpong: dict
    ppn_size: float
    ppn: dict

    def to_json(self) -> str:
        """Serialize the record to a JSON string (arrays as lists) — the
        on-disk form a real calibration run would ship."""
        return json.dumps({
            "machine": self.machine,
            "sizes": np.asarray(self.sizes).tolist(),
            "pingpong": {k: np.asarray(v).tolist()
                         for k, v in self.pingpong.items()},
            "ppn_size": self.ppn_size,
            "ppn": {k: [np.asarray(ks).tolist(), np.asarray(ts).tolist()]
                    for k, (ks, ts) in self.ppn.items()},
        })

    @classmethod
    def from_json(cls, text: str) -> "SweepRecord":
        """Rebuild a record from its :meth:`to_json` string ``text``."""
        d = json.loads(text)
        return cls(machine=d["machine"],
                   sizes=np.asarray(d["sizes"], dtype=np.float64),
                   pingpong={k: np.asarray(v, dtype=np.float64)
                             for k, v in d["pingpong"].items()},
                   ppn_size=float(d["ppn_size"]),
                   ppn={k: (np.asarray(ks, dtype=np.float64),
                            np.asarray(ts, dtype=np.float64))
                        for k, (ks, ts) in d["ppn"].items()})


def _with_network_path(machine: MachineSpec, kind: str) -> MachineSpec:
    """``machine`` rebuilt so cross-node pairs are born with class ``kind``
    (identity when already configured that way)."""
    want = machine.params.class_index(kind)
    if machine.cross_node_locality == want:
        return machine
    return dataclasses.replace(machine, cross_node_locality=want)


def sweep_kinds(machine: MachineSpec) -> tuple[tuple[str, ...],
                                               tuple[str, ...]]:
    """The measurable locality kinds of ``machine`` as
    ``(pingpong_kinds, network_kinds)``: device classes plus both network
    paths on heterogeneous machines, the socket/node/network split on
    classic CPU machines.  ``network_kinds`` additionally get the ppn
    saturation sweep."""
    if machine.devices_per_node:
        kinds = []
        if machine.procs_per_device >= 2:
            kinds.append("intra_device")
        kinds.append("cross_device")
        net = tuple(k for k in ("host_staged", "device_direct")
                    if machine.params.has_class(k))
        return tuple(kinds) + ("h2d",) + net, net
    kinds = []
    if machine.sockets_per_node > 1:
        kinds += ["intra_socket", "intra_node"]
    return tuple(kinds) + ("inter_node",), ("inter_node",)


def _h2d_sweep(machine: MachineSpec, sizes, noise: float,
               seed: int, device) -> np.ndarray:
    """Host<->device copy sweep: one coalesced self-copy per size at the
    ``h2d`` rate class (the staging phases of ``host_staged`` price the
    same way)."""
    loc = machine.params.class_index("h2d")
    rng = np.random.default_rng(seed)
    out = []
    for s in sizes:
        ph = CommPhase.build(machine, [0], [0], [float(s)], loc=loc)
        out.append(simulate(ph, rng=rng, noise=noise, device=device).time)
    return np.asarray(out)


def record_sweeps(machine: MachineSpec, sizes=DEFAULT_SIZES,
                  ppn_size: float = PPN_SIZE, reps: int = 1,
                  noise: float = 0.0, seed: int = 0,
                  device=None) -> SweepRecord:
    """Run the full measurement suite on ``machine``, simulated on
    ``device`` (``None`` = CUDA), and return the :class:`SweepRecord`.

    ``sizes`` is the ping-pong size grid (``DEFAULT_SIZES`` spans every
    protocol regime), ``ppn_size`` the saturation-sweep message size,
    ``reps`` / ``noise`` / ``seed`` the per-measurement averaging count,
    multiplicative noise level and RNG seed passed through to
    :func:`repro_torch.net.pingpong.pingpong_sweep` /
    :func:`repro_torch.net.pingpong.ppn_sweep` (noiseless by default: the
    round-trip tests demand exact recovery).
    """
    dev = resolve_device(device)
    sizes = np.asarray(sizes, dtype=np.float64)
    kinds, net_kinds = sweep_kinds(machine)
    pingpong, ppn = {}, {}
    for kind in kinds:
        if kind == "h2d":
            pingpong[kind] = _h2d_sweep(machine, sizes, noise, seed, dev)
            continue
        var = (_with_network_path(machine, kind)
               if kind in net_kinds else machine)
        pingpong[kind] = pingpong_sweep(var, kind, sizes, reps=reps,
                                        noise=noise, seed=seed, device=dev)
    for kind in net_kinds:
        var = _with_network_path(machine, kind)
        ppn[kind] = ppn_sweep(var, ppn_size, noise=noise, seed=seed,
                              device=dev)
    return SweepRecord(machine=machine.name, sizes=sizes, pingpong=pingpong,
                       ppn_size=float(ppn_size), ppn=ppn)


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """A fitted table and its provenance: ``params`` is the fitted
    :class:`~repro_torch.core.params.CommParams` (drive model predictions with
    it), ``n_rails`` the recovered rail count, ``rails_by_class`` the
    per-network-kind staircase fits it was reconciled from, and
    ``fitted_classes`` the locality kinds whose (alpha, R_b) rows came
    from the record (untouched rows keep the base table's values)."""

    params: CommParams
    n_rails: int
    rails_by_class: dict
    fitted_classes: tuple


def calibrate(record: SweepRecord, base: CommParams) -> CalibrationResult:
    """Fit a parameter table from ``record`` alone.

    ``base`` supplies the table *shape* (locality classes, protocol
    thresholds) and the values of anything the record cannot see (gamma,
    delta, unmeasured classes); every measured kind's (alpha, R_b) row,
    the rail count and the per-rail R_N cap are replaced by fits.  The
    fitted alpha absorbs the simulator's per-message queue step (see the
    module docstring); R_N is fitted for the rendezvous row of each
    network kind via :func:`repro_torch.core.fitting.fit_RN_rails`, staying at
    the base value (usually ``inf``) elsewhere.
    """
    alpha = np.array(base.alpha, dtype=np.float64)
    Rb = np.array(base.Rb, dtype=np.float64)
    RN = np.array(base.RN, dtype=np.float64)

    table = fit_node_aware_table(
        {k: (record.sizes, v) for k, v in record.pingpong.items()}, base)
    for kind, fits in table.items():
        li = base.class_index(kind)
        for proto, (a, rb) in fits.items():
            pi = PROTOCOL_NAMES.index(proto)
            alpha[li, pi] = a
            Rb[li, pi] = rb

    rails_by_class = {kind: fit_rails(ks, ts)
                      for kind, (ks, ts) in record.ppn.items()}
    n_rails = (int(round(float(np.median(list(rails_by_class.values())))))
               if rails_by_class else base.n_rails)

    for kind, (ks, ts) in record.ppn.items():
        li = base.class_index(kind)
        pi = int(base.protocol_of(np.asarray([record.ppn_size]))[0])
        RN[li, pi] = fit_RN_rails(ks, ts, record.ppn_size,
                                  alpha[li, pi], Rb[li, pi], rails=n_rails)

    fitted = base.replace(alpha=alpha, Rb=Rb, RN=RN, n_rails=n_rails)
    return CalibrationResult(params=fitted, n_rails=n_rails,
                             rails_by_class=rails_by_class,
                             fitted_classes=tuple(sorted(table)))
