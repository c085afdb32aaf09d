"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print the card;
2. hold K1 (segment reduce) and K2 (queue walk) to their plain PyTorch
   versions on the card, on ragged shapes;
3. the small slice: ``best_strategy_many`` over the AMG hierarchy of
   ``elasticity_like_3d(16)`` on ``blue_waters_machine((4, 4, 2))``, on
   cuda and on cpu — identical winners, totals allclose;
4. the full-width slice: ``elasticity_like_3d(40)`` (192,000 dof), its AMG
   hierarchy, each level partitioned over ``min(8192, rows // 2)`` ranks of
   ``blue_waters_machine((8, 8, 4))`` (8,192 ranks), swept by
   ``best_strategy_many`` on cuda with the launch counts set to 0 just
   before; every kernel input of that run is captured and each kernel's
   output there is held to its plain version;
5. one ``{"kernels": [...]}`` JSON line: launches on the full-width run,
   worst error against the plain version, and CUDA-event times of the
   kernel, its plain version and the one-call PyTorch yardstick, each
   summed over every call the full-width run made, beside the least time
   the card could take for the same calls;
6. the card's name and power limit as ``nvidia-smi`` reports them, then,
   last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is available or
the port's sources are not beside the script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
INT32_LANES_PER_SM = 64            # Hopper SM: 64 INT32 lanes
SMS = 132
RTOL, ATOL = 1e-4, 1e-6
FULL = {"nx": 40, "torus": (8, 8, 4), "max_ranks": 8192}
SMALL = {"nx": 16, "torus": (4, 4, 2)}
KERNEL_ROWS = {
    "segment_reduce": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/comm_stack.py:410"),
    "queue_walk": ("src/repro_torch/kernels/csrc/queue_walk.cu",
                   "src/repro/kernels/comm_stack.py:647"),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sync_time(fn):
    """(result, wall seconds) of ``fn()`` ending in a device sync."""
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


# -- phase 2: kernel parity ------------------------------------------------

def k1_err(ks, values, ids, n_seg) -> float:
    """K1 against its plain version on one input; returns the worst abs
    error.  Sums: within ATOL + RTOL x the segment's sum of magnitudes (the
    atomics reorder the additions; for non-negative values — every input
    of the main path — this is allclose at rtol 1e-4 / atol 1e-6).
    Maxima: equal, since a maximum does not depend on order."""
    sums, maxs = ks.segment_reduce(values, ids, n_seg)
    want_s, want_m = ks.segment_reduce_plain(values, ids, n_seg)
    if n_seg == 0:
        return 0.0, 0.0
    scale, _ = ks.segment_reduce_plain(values.abs(), ids, n_seg)
    err = (sums - want_s).abs()
    if bool((err > ATOL + RTOL * scale).any()):
        raise AssertionError(f"segment_reduce sums off by up to "
                             f"{float(err.max())} (n={values.numel()}, "
                             f"n_seg={n_seg})")
    torch.testing.assert_close(maxs, want_m, rtol=0, atol=0)
    rel = float((err / scale.clamp_min(ATOL / RTOL)).max())
    return float(torch.maximum(err.max(), (maxs - want_m).abs().max())), rel


def k2_check(ks, posted, arrival, bounds) -> int:
    """K2 against its plain version on one input: bit-equal or raise;
    returns the worst abs difference in steps (0 for an empty walk)."""
    got = ks.queue_walk(posted, arrival, bounds)
    want = ks.queue_walk_plain(posted, arrival, bounds)
    if not torch.equal(got, want):
        bad = int(torch.nonzero(got != want)[0])
        raise AssertionError(f"queue_walk differs from its plain version at "
                             f"arrival {bad}: {int(got[bad])} vs "
                             f"{int(want[bad])}")
    return int((got - want).abs().max()) if got.numel() else 0


def kernel_parity(ks, dev) -> None:
    rng = np.random.default_rng(0)
    worst = 0.0
    # ragged: n = 0, 1, 513 (many empty segments), 10^6 (many / few segments)
    for n, n_seg in ((0, 5), (1, 1), (1, 7), (513, 2000), (1_000_000, 300_000),
                     (1_000_000, 3)):
        vals = torch.from_numpy(
            (rng.standard_normal(n) * 1e3).astype(np.float32)).to(dev)
        ids = torch.from_numpy(
            rng.integers(0, n_seg, n).astype(np.int32)).to(dev)
        worst = max(worst, k1_err(ks, vals, ids, n_seg)[0])
    log(f"K1 parity: 6 ragged shapes, max abs err {worst:.3g}")
    for n_regions, max_count in ((1, 1), (3, 0), (40, 25), (2, 2000),
                                 (50_000, 64)):
        counts = rng.integers(0, max_count + 1, n_regions)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        posted = [rng.permutation(c) for c in counts]
        arrival = [rng.permutation(c) for c in counts]
        k2_check(ks, *(torch.from_numpy(np.concatenate(a).astype(np.int64)
                                        if len(a) else np.zeros(0, np.int64)
                                        ).to(dev)
                       for a in (posted, arrival)),
                 torch.from_numpy(bounds.astype(np.int64)).to(dev))
    log("K2 parity: 5 region layouts, bit-equal")


# -- phases 3 and 4: the slice ------------------------------------------------

def amg_patterns(nx: int, machine, max_ranks: int):
    from repro_torch.sparse.amg import build_hierarchy
    from repro_torch.sparse.partition import RowPartition, spmv_comm_pattern
    from repro_torch.sparse.problems import elasticity_like_3d

    A = elasticity_like_3d(nx)
    levels = build_hierarchy(A)
    pats = [spmv_comm_pattern(
        lvl.A, RowPartition.balanced(lvl.A.n_rows,
                                     min(max_ranks, lvl.A.n_rows // 2)))
        for lvl in levels]
    return A, levels, pats


def check_verdicts(verdicts, strategies) -> None:
    for v in verdicts:
        for table in (v.model, v.sim):
            vals = np.asarray(list(table.values()))
            if not (np.isfinite(vals).all() and (vals > 0).all()):
                raise AssertionError(f"non-finite or non-positive totals: "
                                     f"{table}")
        if v.model_winner not in strategies or v.sim_winner not in strategies:
            raise AssertionError("winner outside the strategy set")


def small_slice() -> None:
    from repro_torch.comm.strategies import STRATEGIES, best_strategy_many
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine(SMALL["torus"])
    _, levels, pats = amg_patterns(SMALL["nx"], m, m.n_procs)
    gpu, t_gpu = sync_time(lambda: best_strategy_many(pats, m))
    t = time.perf_counter()
    cpu = best_strategy_many(pats, m, device="cpu")
    t_cpu = time.perf_counter() - t
    check_verdicts(gpu, STRATEGIES)
    for lvl, (g, c) in enumerate(zip(gpu, cpu)):
        if (g.model_winner, g.sim_winner) != (c.model_winner, c.sim_winner):
            raise AssertionError(
                f"small slice level {lvl}: cuda picks {g.model_winner}/"
                f"{g.sim_winner}, cpu {c.model_winner}/{c.sim_winner}")
        for s in c.model:
            np.testing.assert_allclose(g.model[s], c.model[s], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(g.sim[s], c.sim[s], rtol=RTOL,
                                       atol=ATOL)
    log(f"small slice: elasticity_like_3d({SMALL['nx']}), {len(levels)} "
        f"levels, {m.n_procs} ranks; winners (model/sim) "
        f"{[(v.model_winner, v.sim_winner) for v in gpu]} equal on cuda "
        f"({t_gpu:.2f} s) and cpu ({t_cpu:.2f} s), totals allclose")


def full_slice(ks):
    """The full-width run, with launches counted and kernel inputs
    captured; returns (launch counts, captured inputs)."""
    from repro_torch.comm import strategies
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine(FULL["torus"])
    t = time.perf_counter()
    A, levels, pats = amg_patterns(FULL["nx"], m, FULL["max_ranks"])
    t_setup = time.perf_counter() - t
    log(f"full slice: elasticity_like_3d({FULL['nx']}): {A.n_rows} dof, "
        f"{A.nnz} nnz, {len(levels)} AMG levels "
        f"{[lvl.A.n_rows for lvl in levels]}, ranks "
        f"{[p.n_procs for p in pats]} on blue_waters_machine("
        f"{FULL['torus']}) ({m.n_procs} ranks); operator + hierarchy + "
        f"patterns {t_setup:.2f} s (host)")

    captured = {name: [] for name in ks.LAUNCHES}
    real = {name: getattr(ks, name) for name in ks.LAUNCHES}
    real_cands, real_price = strategies.candidate_set, \
        strategies.price_candidates
    split = {}
    sizes = {}

    def spy(name):
        def call(*args):
            captured[name].append(args)
            return real[name](*args)
        return call

    def timed_cands(*a, **kw):
        out, split["rewrite"] = sync_time(lambda: real_cands(*a, **kw))
        sizes["arena"] = out.n_msgs
        sizes["phases"] = len(out.phases)
        return out

    def timed_price(*a, **kw):
        out, split["pricing"] = sync_time(lambda: real_price(*a, **kw))
        return out

    for name in real:
        setattr(ks, name, spy(name))
    strategies.candidate_set = timed_cands
    strategies.price_candidates = timed_price
    torch.cuda.reset_peak_memory_stats()
    try:
        ks.reset_launches()
        verdicts, wall = sync_time(
            lambda: strategies.best_strategy_many(pats, m))
        launches = dict(ks.LAUNCHES)
    finally:
        for name, fn in real.items():
            setattr(ks, name, fn)
        strategies.candidate_set = real_cands
        strategies.price_candidates = real_price
    peak = torch.cuda.max_memory_allocated()
    check_verdicts(verdicts, strategies.STRATEGIES)
    log(f"full slice arena: {sizes['arena']} messages in "
        f"{sizes['phases']} candidate phases")
    for lvl, (v, p) in enumerate(zip(verdicts, pats)):
        log(f"  level {lvl}: {p.n_procs} ranks, {p.n_msgs} msgs; model "
            f"picks {v.model_winner}, simulator picks {v.sim_winner}; model "
            + ", ".join(f"{s}={v.model[s]:.6g}" for s in v.model)
            + "; sim " + ", ".join(f"{s}={v.sim[s]:.6g}" for s in v.sim))
    bind = wall - split["rewrite"] - split["pricing"]
    log(f"full slice best_strategy_many wall {wall:.3f} s: bind {bind:.3f} "
        f"s + rewrite {split['rewrite']:.3f} s (host) + pricing "
        f"{split['pricing']:.3f} s (device passes with host order "
        f"assembly); max_memory_allocated {peak} bytes")
    log(f"full slice launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the full-width "
                                 "run")
    device_share(lambda: strategies.best_strategy_many(pats, m))
    return launches, captured


def device_share(fn) -> None:
    """Run ``fn`` again under ``torch.profiler`` and print the device-busy
    share of its wall time (sum of device self time over the wall time of
    the profiled run) and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    # device-side events only (kernels, copies): a CPU op's row repeats
    # the device time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("profiled rerun: the profiler saw no device time (not measured)")
        return
    log(f"profiled rerun: wall {wall:.3f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.2f} % of wall, idle {100 - 100 * busy / wall:.2f}"
        f" %); device time by kernel:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


# -- phase 5: kernel figures ------------------------------------------------

def k2_chain_ops(ks, posted, arrival, bounds):
    """(ops of the longest region's serial chain, ops of all regions) of
    K2 on this input: each region builds span + 1 tree cells, then pays one
    step per prefix-chain and per removal-chain link of every arrival."""
    b, starts, counts, toff, span, _ = ks._queue_layout(posted, arrival,
                                                        bounds)
    region = torch.repeat_interleave(
        torch.arange(counts.numel(), device=b.device), counts,
        output_size=b.numel())
    p = b + 1
    sp = span[region]
    links = torch.zeros_like(p)
    i = p.clone()
    while bool((i > 0).any()):
        links += (i > 0).long()
        i -= i & -i
    i = p.clone()
    while bool((i <= sp).any()):
        links += (i <= sp).long()
        i += i & -i
    per_region = torch.where(counts > 0, span + 1, torch.zeros_like(span))
    per_region.index_add_(0, region, links)
    return int(per_region.max()), int(per_region.sum())


def k1_call_figures(ks, values, ids, n_seg) -> dict:
    """CUDA-event times of one K1 call: the wrapper as the main path calls
    it, the launch alone, the plain version and the one-call PyTorch
    yardstick, beside the bytes bound (8 B read per message, 8 B written
    per segment)."""
    idx = ids.long()
    s_out = torch.empty(n_seg, device=values.device)
    m_out = torch.empty(n_seg, device=values.device)

    def library():
        s_out.zero_().index_add_(0, idx, values)
        m_out.zero_().scatter_reduce_(0, idx, values, "amax",
                                      include_self=False)

    reps = 20
    return dict(
        ms=cuda_ms(lambda: ks.segment_reduce(values, ids, n_seg), reps),
        kernel_ms=cuda_ms(lambda: ks._segment_reduce_cuda(values, ids, n_seg),
                          reps),
        plain_ms=cuda_ms(lambda: ks.segment_reduce_plain(values, ids, n_seg),
                         reps),
        library_ms=cuda_ms(library, reps),
        bound_ms=(8 * values.numel() + 8 * n_seg) / HBM_BYTES_PER_S * 1e3)


def k2_call_figures(ks, posted, arrival, bounds, clock_hz) -> dict:
    """CUDA-event times of one K2 call (wrapper with its layout ops, the
    launch alone, the plain lock-step version) beside its bound: the
    larger of its bytes (4 B in and 8 B out per arrival, 16 B per region),
    its longest region's serial chain at one step per SM clock, and all
    regions' steps over every INT32 lane of the card."""
    N, R = posted.numel(), bounds.numel() - 1
    chain, total = k2_chain_ops(ks, posted, arrival, bounds)
    layout = ks._queue_layout(posted, arrival, bounds)
    t_bytes = (4 * N + 16 * R + 8 * N) / HBM_BYTES_PER_S
    t_chain = chain / clock_hz
    t_total = total / (INT32_LANES_PER_SM * SMS * clock_hz)
    counts = bounds[1:] - bounds[:-1]
    return dict(
        ms=cuda_ms(lambda: ks.queue_walk(posted, arrival, bounds), 10),
        kernel_ms=cuda_ms(lambda: ks._queue_walk_cuda(*layout), 10),
        plain_ms=cuda_ms(lambda: ks.queue_walk_plain(posted, arrival, bounds),
                         2),
        bound_ms=max(t_bytes, t_chain, t_total) * 1e3,
        bound_by="bytes" if t_bytes >= max(t_chain, t_total) else
        "operations",
        arrivals=N, regions=R, longest=int(counts.max()) if R else 0,
        chain_steps=chain, all_steps=total)


def kernel_rows(ks, launches, captured, clock_hz):
    """One row per kernel over every call the full-width run made: each
    call is held to the plain version, and the row's times and bound are
    sums over those calls (the slowest call is named beside them)."""
    rows = []
    calls = captured["segment_reduce"]
    errs = [k1_err(ks, *c) for c in calls]
    figs = [k1_call_figures(ks, *c) for c in calls]
    for (v, _, n_seg), f in zip(calls, figs):
        log(f"K1 full-width call n={v.numel()}, n_seg={n_seg}: wrapper "
            f"{f['ms']:.4f} ms, launch alone {f['kernel_ms']:.4f} ms, plain "
            f"{f['plain_ms']:.4f} ms, library {f['library_ms']:.4f} ms, "
            f"bound {f['bound_ms']:.5f} ms (bytes)")
    slow = max(range(len(calls)), key=lambda k: figs[k]["kernel_ms"])
    total = {k: sum(f[k] for f in figs) for k in
             ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"K1 over the full-width run's {len(calls)} calls: wrapper "
        f"{total['ms']:.4f} ms, launch alone {total['kernel_ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f}"
        f" ms, bound {total['bound_ms']:.5f} ms; worst relative error "
        f"{max(r for _, r in errs):.3g}")
    rows.append(dict(name="segment_reduce", route="cuda",
                     source=KERNEL_ROWS["segment_reduce"][0],
                     replaces=KERNEL_ROWS["segment_reduce"][1],
                     launches=launches["segment_reduce"],
                     max_abs_err=max(e for e, _ in errs), ms=total["ms"],
                     plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                     bound_by="bytes", library_ms=total["library_ms"],
                     kernel_ms=total["kernel_ms"], calls=len(calls),
                     slowest_call=dict(n=calls[slow][0].numel(),
                                       n_seg=calls[slow][2], **figs[slow])))
    calls = captured["queue_walk"]
    errs = [k2_check(ks, *c) for c in calls]
    figs = [k2_call_figures(ks, *c, clock_hz) for c in calls]
    for f in figs:
        log(f"K2 full-width call: {f['arrivals']} arrivals in {f['regions']} "
            f"regions, longest region {f['longest']} arrivals, serial chain "
            f"{f['chain_steps']} steps, all regions {f['all_steps']} steps; "
            f"wrapper {f['ms']:.4f} ms, launch alone {f['kernel_ms']:.4f} ms, "
            f"plain {f['plain_ms']:.4f} ms, bound {f['bound_ms']:.5f} ms "
            f"({f['bound_by']}); bit-equal")
    total = {k: sum(f[k] for f in figs) for k in
             ("ms", "kernel_ms", "plain_ms", "bound_ms")}
    slow = max(range(len(calls)), key=lambda k: figs[k]["kernel_ms"])
    rows.append(dict(name="queue_walk", route="cuda",
                     source=KERNEL_ROWS["queue_walk"][0],
                     replaces=KERNEL_ROWS["queue_walk"][1],
                     launches=launches["queue_walk"], max_abs_err=max(errs),
                     ms=total["ms"], plain_ms=total["plain_ms"],
                     bound_ms=total["bound_ms"],
                     bound_by=figs[slow]["bound_by"], library_ms=None,
                     kernel_ms=total["kernel_ms"], calls=len(calls),
                     slowest_call=figs[slow]))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import comm_stack as ks

    dev = torch.device("cuda")
    log(f"card: {nvidia_smi('name,power.limit')}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t = time.perf_counter()
    build_logs = ks.build_kernels()
    log(f"build: {sorted(build_logs)} compiled in "
        f"{time.perf_counter() - t:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernel_parity(ks, dev)
    small_slice()
    launches, captured = full_slice(ks)
    rows = kernel_rows(ks, launches, captured, clock_mhz * 1e6)
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
