"""Recover model parameters from (simulated) measurements — paper Section 3-4.

The paper calibrates every parameter from ping-pong style tests on at most
eight nodes and then applies the model at 512 nodes unchanged.  We follow the
same recipe: :mod:`repro_torch.net.pingpong` generates the measurements, the
fits here recover (alpha, R_b) per locality x protocol, R_N from a ppn sweep,
gamma from reversed-order HighVolumePingPong residuals and delta from the
Gemini-line contention residuals.

Port note: host numpy, plain float64 least squares on a few dozen points,
as in the reference; the measurements come from the device.
"""
from __future__ import annotations

import numpy as np

from .params import CommParams, PROTOCOL_NAMES


def _lstsq(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    sol, *_ = np.linalg.lstsq(np.asarray(A, dtype=np.float64),
                              np.asarray(y, dtype=np.float64), rcond=None)
    return sol


def fit_alpha_beta(sizes, times, params: CommParams) -> dict[str, tuple[float, float]]:
    """Fit postal (alpha, R_b) per protocol from a single-pair size sweep.

    Returns {protocol: (alpha, Rb)}.  Protocol buckets follow ``params``'
    size thresholds.
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    proto = params.protocol_of(sizes)
    out: dict[str, tuple[float, float]] = {}
    for pi, name in enumerate(PROTOCOL_NAMES):
        m = proto == pi
        if m.sum() < 2:
            continue
        s, t = sizes[m], times[m]
        # scale columns for conditioning: t = a + (1/Rb) * s
        scale = s.max()
        A = np.stack([np.ones_like(s), s / scale], axis=1)
        a, b = _lstsq(A, t)
        beta = max(b / scale, 1e-16)
        out[name] = (max(float(a), 0.0), float(1.0 / beta))
    return out


def fit_node_aware_table(sweeps: dict[str, tuple[np.ndarray, np.ndarray]],
                         params: CommParams) -> dict[str, dict[str, tuple[float, float]]]:
    """Fit the full Table-1 structure.

    ``sweeps[locality_name] = (sizes, times)`` from
    :func:`repro_torch.net.pingpong.pingpong_sweep`.  Returns
    {locality: {protocol: (alpha, Rb)}}.
    """
    return {loc: fit_alpha_beta(sizes, times, params)
            for loc, (sizes, times) in sweeps.items()}


def fit_RN(ks, times, size: float, alpha: float, Rb: float) -> float:
    """Recover the node injection bandwidth R_N from a ppn sweep.

    Model: T(k) = alpha + k*size / min(R_N, k*R_b).  In the saturated regime
    T grows linearly in k with slope size/R_N; fit the slope over the upper
    half of the sweep.
    """
    ks = np.asarray(ks, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    hi = ks >= max(4, ks.max() / 2)          # paper: >=4 procs/node saturate
    if hi.sum() < 2:
        hi = ks >= np.median(ks)
    A = np.stack([np.ones(hi.sum()), ks[hi]], axis=1)
    _, slope = _lstsq(A, times[hi])
    if slope <= 0:
        return float("inf")
    RN = size / float(slope)
    # never report an injection cap above the unsaturated aggregate rate
    return float(RN)


def fit_RN_rails(ks, times, size: float, alpha: float, Rb: float,
                 rails: int = 1, rel_margin: float = 0.05) -> float:
    """Multi-rail-exact R_N recovery from a ppn sweep.

    :func:`fit_RN` regresses a straight line through the saturated sweep,
    which is exact only for single-rail machines — with ``rails`` > 1 the
    saturated curve is the *staircase* ``T(k) = alpha + x*size/R_N`` with
    ``x = ceil(k / rails)``, whose secant slope is not ``size/R_N``.  Given
    the rail count (recover it first with :func:`fit_rails`), invert the
    staircase point-wise instead: every saturated point yields
    ``R_N = x*size / (T(k) - alpha)`` exactly; return the median over the
    points whose time ``times`` exceeds the unsaturated plateau
    ``alpha + size/Rb`` by more than ``rel_margin`` (relative).  Pass the
    *fitted* ``alpha`` (which absorbs the simulator's per-message queue
    step) and ``Rb`` for the sweep's ``size`` protocol class, and the
    sweeps' ``ks`` process counts — the queue offset then cancels out of
    the subtraction.  Returns ``inf`` when no point saturates (the cap
    never binds within the sweep, matching an uncapped rate table)."""
    ks = np.asarray(ks, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    x = np.ceil(ks / float(rails))
    flat = alpha + size / Rb
    sat = times > flat * (1.0 + rel_margin)
    if not sat.any():
        return float("inf")
    return float(np.median(x[sat] * size / (times[sat] - alpha)))


def fit_rails(ks, times, rel_tol: float = 1e-9) -> int:
    """Recover the per-node NIC (rail) count from a ppn saturation sweep.

    Under the multi-rail max-rate model the sweep obeys
    ``T(k) = alpha + ceil(k / r) * size / min(R_N, ceil(k / r) * R_b)``:
    below saturation the ceil cancels out of the ratio (T is flat in k),
    and once the per-rail cap ``R_N`` binds, T is a *staircase* that steps
    up only when ``ceil(k / r)`` increments — every ``r``-th process.  The
    rail count is therefore the step period: the median spacing between
    consecutive rises when the sweep holds two or more, or the length of
    the leading plateau before a single rise.  Use a rendezvous-regime
    ``size`` (as for :func:`fit_RN`) so the cap binds early in the sweep.

    Returns 1 when no rise is seen — a single rail and an unsaturated
    sweep are indistinguishable from the measurement.
    """
    ks = np.asarray(ks, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    d = np.diff(times)
    if d.size == 0:
        return 1
    thresh = rel_tol * float(np.abs(times).max())
    rises = np.nonzero(d > thresh)[0]
    if rises.size == 0:
        return 1
    if rises.size >= 2:
        return int(round(float(np.median(np.diff(ks[rises])))))
    # one rise: the first step ends the leading plateau of length r
    return int(round(float(ks[rises[0] + 1] - ks[0])))


def fit_gamma(n_msgs, measured, modeled_no_queue) -> float:
    """gamma from reversed-order HighVolumePingPong: T - T_model ~ gamma*n^2."""
    n = np.asarray(n_msgs, dtype=np.float64)
    resid = np.asarray(measured, dtype=np.float64) - np.asarray(modeled_no_queue, dtype=np.float64)
    x = n * n
    denom = float((x * x).sum())
    if denom == 0:
        return 0.0
    return float(max((x * resid).sum() / denom, 0.0))


def fit_delta(ells, measured, modeled_no_contention) -> float:
    """delta from contention tests: T - T_model ~ delta * ell."""
    x = np.asarray(ells, dtype=np.float64)
    resid = (np.asarray(measured, dtype=np.float64)
             - np.asarray(modeled_no_contention, dtype=np.float64))
    denom = float((x * x).sum())
    if denom == 0:
        return 0.0
    return float(max((x * resid).sum() / denom, 0.0))
