"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. build the five CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), print their register and spill
   lines and the card;
2. hold K1 (segment reduce), K2 (queue walk), K3 (block-ELL SpMV), K4
   (flash attention) and K5 (SSD intra-chunk step) to their plain PyTorch
   versions on the card, on ragged shapes; K1 also on sorted runs, random
   ids and one hot segment below its shared-memory capacity and on sorted,
   random and short-run ids above it, each on the path the wrapper picks
   and forced onto each path that applies; K4 also at hymba-1.5b's and
   llama3.2-3b's full attention shapes in bf16 (timed beside SDPA), with
   every bf16 case counted on its tensor-core kernel; K5 also on ragged q
   and at hymba-1.5b's and mamba2-130m's full prefill shapes, every case
   counted on its tensor-core (split-TF32) path;
3. the small slice: ``best_strategy_many`` over the AMG hierarchy of
   ``elasticity_like_3d(16)`` on ``blue_waters_machine((4, 4, 2))``, on
   cuda and on cpu — identical winners, totals allclose; then one V-cycle
   on that hierarchy on cuda and on cpu, held together;
4. the full-width slice: ``elasticity_like_3d(40)`` (192,000 dof), its AMG
   hierarchy, each level partitioned over ``min(8192, rows // 2)`` ranks of
   ``blue_waters_machine((8, 8, 4))`` (8,192 ranks), swept by
   ``best_strategy_many`` on cuda with K1's and K2's counts set to 0 just
   before; every kernel input of that run is captured and each kernel's
   output there is held to its plain version, and the path each K1 call
   took is logged;
5. the full-width V-cycle on the same hierarchy: ``DeviceHierarchy.build``
   timed, every operator held to its plain version at each lane count K3
   takes (1-32), a ``cols`` past the block columns refused before any
   launch, one V(2,2) cycle on cuda with K3's count set to 0 just before
   (every SpMV is one K3 launch: 85 on the 6-level hierarchy) and its
   inputs captured, the same recursion again on device vectors under
   ``torch.cuda.set_sync_debug_mode("error")`` (no SpMV waits for the
   device), held to the same cycle on cpu, then 10 cycles with the
   relative residual computed on the host in float64;
6. the model, small: hymba-1.5b's smoke config and hymba-1.5b at full
   width cut to 2 layers, float32 weights, one 256-token prompt, ``prefill``
   then 8 greedy ``decode_step`` calls on cuda and on cpu — logits within
   1e-4 relative L2, the same tokens;
7. the model, full width: hymba-1.5b (32 layers, d_model 1600) in bf16 with
   random weights from ``init_params(seed=0)``, 4 seeded prompts of 2048
   tokens through ``make_prefill_step`` (cache of 2080 positions) with K4's
   and K5's counts set to 0 just before (32 launches each, one a layer, all
   on the tensor cores, and none during decode) and every K4
   and K5 input captured, then 32 greedy
   ``make_serve_step`` decode steps; prefill and decode times, peak device
   memory and the device busy share of a profiled prefill; then
   ``ServeEngine`` at full width (4 slots, 6 seeded requests of 2-7 prompt
   tokens, 8 new tokens each);
8. one ``{"kernels": [...]}`` JSON line: launches on the full-width runs,
   worst error against the plain version, and CUDA-event times of the
   wrapper, the launch alone, the plain version and the one-call PyTorch
   yardstick, each summed over every call the full-width run made, beside
   the least time the card could take for the same calls; K1's row adds
   its launches by path and each call's path, K3's its lanes per operator
   and its bound over every padded slot (``bound_padded_ms``); K4's row adds
   its ``path`` ("wgmma"), its TFLOP/s launch alone and ``vs_library``
   (launch alone over SDPA), K5's its ``path`` ("mma.sync 3xTF32"), and
   both their ``tc_launches``;
9. the card's name and power limit as ``nvidia-smi`` reports them, then,
   last, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32 (TF32 is switched off), so the
plain versions are exact references up to the order of their sums.  Exits
non-zero, printing no result, when no CUDA device is available or the
port's sources are not beside the script.
"""
from __future__ import annotations

import dataclasses
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
    "spmv_block_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                       "src/repro/kernels/spmv_ell.py:27"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd.cu",
                        "src/repro/kernels/ssd.py:25"),
}
# K3 against its plain version: both sum the same float32 products of a row,
# in another order (no atomics, so the card's result does not change from
# run to run); each sum is off by far less than 1e-5 of the row's sum of
# magnitudes.  bfloat16 outputs may round one ulp (2^-8) apart on top.
K3_RTOL = 1e-5
BF16_ULP = 2.0 ** -8
# The V-cycle on cuda against cpu: 85 such SpMVs and the Jacobi updates in
# float32; relative L2 gap allowed, the same bound the CPU tests hold the
# float32 cycle to against the float64 reference (measured there: ~1.5e-7).
VCYCLE_RTOL = 1e-5
# peak rates of one H100 SXM (data sheet, dense): bf16 and TF32 on the
# tensor cores, float32 outside them (float32 inputs keep float32 products:
# TF32 is off for torch; K5 splits each float32 product into three TF32 ones)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# K4 and K5 against their plain versions: the same float32 products summed
# in another order, held to the reference's own kernel-test bounds
# (tests/test_kernels.py: flash 2e-5, SSD 2e-4); a bfloat16 output may in
# addition round one ulp apart, at most 2^-7 of its magnitude.  K4's
# bfloat16 kernel rounds the softmax weights p to bf16 before P V (as a
# TPU's matrix unit does at default precision), which moves a row by at most
# 2^-9 max_j |v_j|: held to 2^-8 of the max over the keys of its (batch, kv
# head) on top (tests/test_torch_attention.py checks the bound on an
# emulation of that arithmetic).
K4_TOL = 2e-5
K5_TOL = 2e-4
BF16_REL_ULP = 2.0 ** -7
BF16_P_TOL = 2.0 ** -8
# the model on cuda against cpu, float32 weights: relative L2 of every
# logits row (prefill and each decode step)
MODEL_RTOL = 1e-4
HYMBA = {"arch": "hymba-1.5b", "batch": 4, "prompt": 2048, "max_seq": 2080,
         "decode": 32, "small_prompt": 256, "small_decode": 8,
         "engine": {"slots": 4, "requests": 6, "max_new": 8, "max_seq": 64}}


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

def k1_err(ks, values, ids, n_seg, path=None) -> float:
    """K1 against its plain version on one input, through the wrapper or,
    with ``path``, the launch alone on that path; returns the worst abs
    error and the worst error relative to the bound.  Sums: within ATOL +
    RTOL x the segment's sum of magnitudes of the float64 sum (the kernel
    adds in another order; for non-negative values — every input of the
    main path — this is allclose at rtol 1e-4 / atol 1e-6; the float32
    plain version's own atomics drift past it on one hot segment of 10^6
    messages).  Maxima: equal to the plain version's, since a maximum does
    not depend on order."""
    sums, maxs = (ks.segment_reduce(values, ids, n_seg) if path is None else
                  ks._segment_reduce_cuda(values, ids, n_seg, path))
    _, want_m = ks.segment_reduce_plain(values, ids, n_seg)
    if n_seg == 0:
        return 0.0, 0.0
    want_s = ks.segment_reduce_plain(values.double(), ids, n_seg)[0]
    scale, _ = ks.segment_reduce_plain(values.double().abs(), ids, n_seg)
    err = (sums - want_s).abs()
    if bool((err > ATOL + RTOL * scale).any()):
        raise AssertionError(f"segment_reduce sums off by up to "
                             f"{float(err.max())} (n={values.numel()}, "
                             f"n_seg={n_seg})")
    torch.testing.assert_close(maxs, want_m, rtol=0, atol=0)
    rel = float((err / (ATOL + RTOL * scale)).max())
    return float(torch.maximum(err.max().float(),
                               (maxs - want_m).abs().max())), rel


def k1_inputs(rng, dev):
    """(label, values, ids, n_seg) of K1's parity phase: ragged sizes, then
    the shapes its redesign is for, each below and above the shared-memory
    capacity ``ks.K1_BIN_CAP`` (4,096 segments)."""
    def t(vals, ids):
        return (torch.from_numpy(np.asarray(vals, np.float32)).to(dev),
                torch.from_numpy(np.asarray(ids, np.int32)).to(dev))
    for n, n_seg in ((0, 5), (1, 1), (1, 7), (513, 2000), (1_000_000, 3)):
        yield (f"n {n}, {n_seg} random ids",
               *t(rng.standard_normal(n) * 1e3, rng.integers(0, n_seg, n)),
               n_seg)
    phase = np.repeat(np.arange(46), rng.integers(30_000, 55_000, 46))
    yield "46 sorted runs", *t(rng.exponential(1e3, phase.size), phase), 46
    hot = np.full(1_500_000, 7)
    hot[rng.integers(0, hot.size, 1000)] = rng.integers(0, 50, 1000)
    yield "one hot segment", *t(rng.exponential(10.0, hot.size), hot), 50
    yield "random ids, 300 segments", *t(rng.standard_normal(1_000_003),
                                         rng.integers(0, 300, 1_000_003)), 300
    ids = np.sort(rng.integers(0, 400_000, 2_000_000))
    yield "sorted ids above capacity", *t(rng.exponential(1.0, ids.size),
                                          ids), 400_000
    yield "random ids above capacity", *t(
        rng.standard_normal(1_000_000) * 1e3,
        rng.integers(0, 300_000, 1_000_000)), 300_000
    keys = np.repeat(np.sort(rng.integers(0, 36_000, 1_500_000)),
                     rng.integers(1, 5, 1_500_000))
    yield "short runs above capacity", *t(rng.exponential(1.0, keys.size),
                                          keys), 36_000


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
    worst, rel, cases = 0.0, 0.0, 0
    for label, vals, ids, n_seg in k1_inputs(rng, dev):
        paths = ["global"] + (["smem"] if n_seg <= ks.K1_BIN_CAP else [])
        for path in [None, *paths]:
            e, r = k1_err(ks, vals, ids, n_seg, path)
            worst, rel, cases = max(worst, e), max(rel, r), cases + 1
        log(f"  K1 {label} (n {vals.numel()}, {n_seg} segments): wrapper "
            f"takes {ks.k1_path(n_seg)}; {' and '.join(paths)} path held "
            f"to the plain version")
    log(f"K1 parity: {cases} cases, max abs err {worst:.3g}, worst error "
        f"{rel:.3g} of the bound")
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


def k3_err(ell, blocks, cols, x, lanes=None) -> float:
    """K3 against its plain version on one input, through the wrapper or,
    with ``lanes``, the launch alone with that many threads a row; returns
    the worst abs error, or raises if a row is off by more than K3_RTOL of
    its sum of magnitudes (plus one bfloat16 rounding step of the
    output)."""
    got = (ell.spmv_block_ell(blocks, cols, x) if lanes is None else
           ell._spmv_block_ell_cuda(blocks, cols, x, lanes))
    want = ell.spmv_block_ell_plain(blocks, cols, x)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"spmv_block_ell gave {got.dtype} "
                             f"{tuple(got.shape)}, expected {want.dtype} "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not got.numel():
        return 0.0
    scale = ell.spmv_block_ell_plain(blocks.float().abs(), cols,
                                     x.float().abs())
    tol = K3_RTOL * scale
    if x.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * want.abs()
    err = (got - want).abs()
    if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
        bad = int(torch.argmax(err - tol))
        raise AssertionError(f"spmv_block_ell off at row {bad}: "
                             f"{float(got[bad])} vs {float(want[bad])} "
                             f"(blocks {tuple(blocks.shape)}, {x.dtype})")
    return float(err.max())


def k3_parity(dev) -> None:
    """K3 on ragged shapes: bs 3 (the scalar path), 4, 8 and 16; max_bpr 0
    and 1; a rectangular P and its P^T; rows past n; float32, bfloat16 and
    mixed; an x that is not 16-byte aligned."""
    from repro_torch.kernels import spmv_ell as ell
    from repro_torch.sparse.amg import build_hierarchy
    from repro_torch.sparse.csr import CSR, eye
    from repro_torch.sparse.problems import elasticity_like_3d, poisson_3d

    rng = np.random.default_rng(1)
    P = build_hierarchy(elasticity_like_3d(8))[1].P          # 1536 x 145
    mats = {"poisson_3d(7)": poisson_3d(7), "P": P, "P^T": P.transpose(),
            "eye(37)": eye(37),                               # max_bpr 1
            "zero 21x13": CSR(np.zeros(22, np.int64), np.zeros(0, np.int64),
                              np.zeros(0), (21, 13))}         # max_bpr 0
    worst, n = 0.0, 0
    for name, A in mats.items():
        for bs in (3, 4, 8, 16):
            blocks, cols, _ = ell.csr_to_block_ell(A, bs, dev)
            ncb = -(-A.n_cols // bs)
            x = torch.from_numpy(rng.standard_normal(ncb * bs + 1)
                                 .astype(np.float32)).to(dev)
            for xb, xx in ((blocks, x[:-1]), (blocks, x[1:]),
                           (blocks.bfloat16(), x[:-1].bfloat16()),
                           (blocks.bfloat16(), x[:-1])):
                worst = max(worst, k3_err(ell, xb, cols, xx))
                n += 1
    torch.cuda.synchronize()
    log(f"K3 parity: {n} cases ({', '.join(mats)}; bs 3, 4, 8, 16; float32, "
        f"unaligned x, bfloat16, mixed), max abs err {worst:.3g}")


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
    return levels


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def small_vcycle(levels) -> None:
    """One V-cycle on the small hierarchy on cuda and on cpu, held
    together at VCYCLE_RTOL (relative L2)."""
    from repro_torch.sparse.amg import DeviceHierarchy, vcycle

    h = DeviceHierarchy.build(levels)
    b = np.random.default_rng(0).standard_normal(levels[0].A.n_rows)
    x_gpu, t_gpu = sync_time(lambda: vcycle(h, b))
    x_cpu = vcycle(h.to("cpu"), b)
    rel = rel_l2(x_gpu, x_cpu)
    if not rel <= VCYCLE_RTOL or not bool(torch.isfinite(x_gpu).all()):
        raise AssertionError(f"small V-cycle: cuda vs cpu relative L2 {rel}")
    log(f"small V-cycle: elasticity_like_3d({SMALL['nx']}), levels "
        f"{[lvl.A.n_rows for lvl in levels]}; cuda ({t_gpu * 1e3:.2f} ms) vs "
        f"cpu relative L2 {rel:.3g} (limit {VCYCLE_RTOL})")


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

    captured = {name: [] for name in ("segment_reduce", "queue_walk")}
    real = {name: getattr(ks, name) for name in captured}
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
    return launches, captured, levels


def full_vcycle(levels):
    """The full-width V-cycle with K3's count set to 0 just before and every
    K3 input captured; returns (launches, captured calls, operator label of
    every captured call, host CSR of every label, K3's device ms over a
    profiled cycle)."""
    from repro_torch.kernels import spmv_ell as ell
    from repro_torch.sparse.amg import DeviceHierarchy, vcycle

    A = levels[0].A
    h, t_build = sync_time(lambda: DeviceHierarchy.build(levels, bs=8))
    tensors = [t for lv in h.levels for op in (lv.A, lv.P, lv.PT) if op
               for t in op] + [lv.dinv for lv in h.levels]
    label, host = {}, {}
    for k, (lv, hl) in enumerate(zip(h.levels, levels)):
        label[lv.A[0].data_ptr()] = f"L{k} A"
        host[f"L{k} A"] = hl.A
        if lv.P is not None:
            label[lv.P[0].data_ptr()] = f"L{k} P"
            label[lv.PT[0].data_ptr()] = f"L{k} P^T"
            host[f"L{k} P"] = hl.P
            host[f"L{k} P^T"] = hl.P.transpose()
    max_bpr = [tuple(op[0].shape[1] for op in (lv.A, lv.P, lv.PT) if op)
               for lv in h.levels]
    log(f"full V-cycle: DeviceHierarchy.build {t_build:.3f} s (host "
        f"block-ELL conversion + copies), {len(h.levels)} levels, "
        f"{sum(t.numel() * t.element_size() for t in tensors)} bytes on the "
        f"card; max_bpr per level (A, P, P^T): {max_bpr}")

    k3_lanes_parity(ell, h, label)
    b = np.random.default_rng(0).standard_normal(A.n_rows)
    vcycle(h, b)                                      # warm-up, not counted
    captured = []
    real = ell.spmv_block_ell

    def spy(*args):
        captured.append(args)
        return real(*args)

    ell.spmv_block_ell = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        ell.reset_launches()
        x_gpu, wall = sync_time(lambda: vcycle(h, b))
        launches = ell.LAUNCHES["spmv_block_ell"]
    finally:
        ell.spmv_block_ell = real
    peak = torch.cuda.max_memory_allocated()
    expected = 7 * (len(levels) - 1) + 50
    log(f"full V-cycle launches: {{'spmv_block_ell': {launches}}} (expected "
        f"{expected}: 7 per level above the coarsest, 50 on it)")
    if launches != expected:
        raise AssertionError(f"spmv_block_ell launched {launches} times on "
                             f"the full-width V-cycle, expected {expected}")
    no_sync_cycle(h, b, x_gpu)
    x_cpu, t_cpu = sync_time(lambda: vcycle(h.to("cpu"), b))
    rel = rel_l2(x_gpu, x_cpu)
    if not rel <= VCYCLE_RTOL or not bool(torch.isfinite(x_gpu).all()):
        raise AssertionError(f"full V-cycle: cuda vs cpu relative L2 {rel}")
    walls = [sync_time(lambda: vcycle(h, b))[1] for _ in range(5)]
    log(f"full V-cycle: one cycle on cuda {wall * 1e3:.3f} ms wall (counted "
        f"run), 5 more {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; "
        f"max_memory_allocated {peak} bytes; cpu plain cycle {t_cpu:.3f} s, "
        f"cuda vs cpu relative L2 {rel:.3g} (limit {VCYCLE_RTOL})")
    # K3's own device time over a whole cycle: the CUDA-event times of
    # k3_row include the host's launch cost, which the small calls wait on
    k3_device = [(us, n) for us, n, key in device_share(lambda: vcycle(h, b))
                 if "ell_rows" in key]
    device_ms = sum(us for us, _ in k3_device) / 1e3 if k3_device else None
    log(f"full V-cycle: K3 device time under the profiler "
        f"{device_ms} ms over {sum(n for _, n in k3_device)} launches")

    x, res = None, []
    for _ in range(10):
        x = vcycle(h, b, x)
        r = b - A.spmv(x.double().cpu().numpy())
        res.append(float(np.linalg.norm(r) / np.linalg.norm(b)))
    log("full V-cycle: relative residual over 10 cycles (host float64 "
        "CSR.spmv): " + ", ".join(f"{r:.3e}" for r in res))
    falling = all(nxt < cur / 2 for cur, nxt in zip(res, res[1:])
                  if cur > 1e-5)
    if not (res[-1] < 1e-3 and falling):
        raise AssertionError(f"full V-cycle residuals do not fall: {res}")
    return launches, captured, [label[c[0].data_ptr()] for c in captured], \
        host, device_ms


def k3_lanes_parity(ell, h, label) -> None:
    """Every operator of the hierarchy at every lane count K3 takes, each
    held to the plain version (``k3_err`` with the launch forced); then a
    ``cols`` with an id past the block columns must raise before any
    launch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, n = 0.0, 0
    ops = [op for lv in h.levels for op in (lv.A, lv.P, lv.PT) if op]
    for blocks, cols in ops:
        x = torch.randn(int(cols.max()) * blocks.shape[2] + blocks.shape[2],
                        generator=gen, device="cuda")
        for lanes in (1, 2, 4, 8, 16, 32):
            worst = max(worst, k3_err(ell, blocks, cols, x, lanes))
            n += 1
    torch.cuda.synchronize()
    picked = []
    for blocks, _ in ops:
        nbr, max_bpr, bs, _ = blocks.shape
        picked.append(f"{label[blocks.data_ptr()]} "
                      f"{ell.lanes_for(nbr * bs, bs, max_bpr)}")
    log(f"K3 lanes parity: {len(ops)} operators of the full hierarchy x "
        f"lanes 1-32 ({n} launches), max abs err {worst:.3g}; lanes picked: "
        + ", ".join(picked))
    blocks, cols = h.levels[0].A
    bad = cols.clone()
    bad[-1, 0] = blocks.shape[0]                  # one past the last column
    before = ell.LAUNCHES["spmv_block_ell"]
    try:
        ell.spmv_block_ell(blocks, bad, h.levels[0].dinv)
    except ValueError as e:
        if ell.LAUNCHES["spmv_block_ell"] != before:
            raise AssertionError("K3 launched on out-of-range cols") from e
        log(f"K3 refuses out-of-range cols before launching: {e}")
    else:
        raise AssertionError("K3 took a block-column id past the columns")


def no_sync_cycle(h, b, want) -> None:
    """One full-width cycle's recursion on device vectors under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for
    the device raises, so no SpMV of the cycle syncs; the result must equal
    the counted cycle's."""
    from repro_torch.sparse.amg import _vcycle

    lv = h.levels[0]
    bp = torch.zeros(lv.dinv.numel(), device="cuda")
    bp[:lv.n] = torch.from_numpy(b.astype(np.float32)).cuda()
    xp = torch.zeros_like(bp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _vcycle(h, bp, xp, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rel = rel_l2(got[:lv.n], want)
    if not rel <= VCYCLE_RTOL:
        raise AssertionError(f"cycle under sync debug mode: relative L2 "
                             f"{rel} from the counted cycle")
    log(f"full V-cycle recursion under set_sync_debug_mode('error'): no "
        f"sync, relative L2 {rel:.3g} from the counted cycle")


def device_share(fn) -> list:
    """Run ``fn`` again under ``torch.profiler`` and print the device-busy
    share of its wall time (sum of device self time over the wall time of
    the profiled run) and the device time by kernel; returns the
    ``(device us, count, kernel name)`` rows."""
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
        return rows
    log(f"profiled rerun: wall {wall:.3f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.2f} % of wall, idle {100 - 100 * busy / wall:.2f}"
        f" %); device time by kernel:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return rows


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
        log(f"K1 full-width call n={v.numel()}, n_seg={n_seg}, path "
            f"{ks.k1_path(n_seg)}: wrapper "
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
                     paths={p: launches[f"segment_reduce_{p}"]
                            for p in ("smem", "global")},
                     call_paths=[ks.k1_path(c[2]) for c in calls],
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


def k3_read_slots(ell, blocks, cols) -> int:
    """Slots K3 reads on this input: every slot, or, for a pair in
    ``csr_to_block_ell``'s layout (``padding_at_end``), slot 0 of each
    block row and every slot at a block column other than 0 (the rest is
    padding, where the kernel stops)."""
    nbr, max_bpr = cols.shape
    if not ell.padding_at_end(blocks, cols) or max_bpr == 0:
        return nbr * max_bpr
    return nbr + int((cols[:, 1:] != 0).sum())


def k3_call_figures(ell, blocks, cols, x, S) -> dict:
    """CUDA-event times of one K3 call (the wrapper as the V-cycle calls it,
    the launch alone, the plain version, and ``S @ x`` with ``S`` the same
    matrix as a float32 ``torch.sparse_csr_tensor``, the one-call PyTorch
    yardstick) beside its bytes bound: the blocks K3 must read (padding
    past a block row's last block excluded: ``k3_read_slots``), ids and x
    read once and y written once at 3.35 TB/s; ``bound_padded_ms`` counts
    every slot, as the kernel's first bound did."""
    nbr, max_bpr, bs, _ = blocks.shape
    xs = x[:S.shape[1]]
    rest = (cols.numel() * 4 + x.numel() * x.element_size()
            + nbr * bs * x.element_size())
    block_bytes = bs * bs * blocks.element_size()
    moved = k3_read_slots(ell, blocks, cols) * block_bytes + rest
    padded = nbr * max_bpr * block_bytes + rest
    reps = 20
    return dict(
        ms=cuda_ms(lambda: ell.spmv_block_ell(blocks, cols, x), reps),
        kernel_ms=cuda_ms(lambda: ell._spmv_block_ell_cuda(blocks, cols, x),
                          reps),
        plain_ms=cuda_ms(lambda: ell.spmv_block_ell_plain(blocks, cols, x),
                         reps),
        library_ms=cuda_ms(lambda: S @ xs, reps),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bytes=moved,
        bound_padded_ms=padded / HBM_BYTES_PER_S * 1e3,
        lanes=ell.lanes_for(nbr * bs, bs, max_bpr))


def k3_row(launches, captured, labels, host, device_ms) -> dict:
    """K3's row over every call of the full-width V-cycle: each call held to
    the plain version, times and bound summed, one line per operator, the
    slowest call named beside the sums, and the kernel's device time over
    the cycle as the profiler saw it (``device_ms``)."""
    from repro_torch.kernels import spmv_ell as ell

    dev = captured[0][0].device
    sparse = {name: torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr), torch.from_numpy(M.indices),
        torch.from_numpy(M.data.astype(np.float32)), size=M.shape,
        device=dev) for name, M in host.items()}
    errs = [k3_err(ell, *c) for c in captured]
    figs = [k3_call_figures(ell, *c, sparse[name])
            for c, name in zip(captured, labels)]
    keys = ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_padded_ms")
    for name in dict.fromkeys(labels):
        mine = [k for k, lab in enumerate(labels) if lab == name]
        blocks = captured[mine[0]][0]
        tot = {k: sum(figs[i][k] for i in mine) for k in keys}
        M = host[name]
        log(f"K3 {name}: {len(mine)} call(s), {M.shape[0]} x {M.shape[1]}, "
            f"{M.nnz} nnz, block-ELL {tuple(blocks.shape)} "
            f"({figs[mine[0]]['bytes']} bytes a call), lanes "
            f"{figs[mine[0]]['lanes']}; summed: wrapper "
            f"{tot['ms']:.4f} ms, launch alone {tot['kernel_ms']:.4f} ms "
            f"({sum(figs[i]['bytes'] for i in mine) / tot['kernel_ms'] / 1e6:.0f}"
            f" GB/s), plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms "
            f"(bytes; every slot {tot['bound_padded_ms']:.5f})")
    total = {k: sum(f[k] for f in figs) for k in keys}
    slow = max(range(len(figs)), key=lambda k: figs[k]["kernel_ms"])
    log(f"K3 over the full-width V-cycle's {len(figs)} calls: wrapper "
        f"{total['ms']:.4f} ms, launch alone {total['kernel_ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f}"
        f" ms, bound {total['bound_ms']:.5f} ms "
        f"({sum(f['bytes'] for f in figs)} bytes; every slot "
        f"{total['bound_padded_ms']:.5f} ms); device {device_ms} ms; "
        f"wrapper / launch alone {total['ms'] / total['kernel_ms']:.3f}; "
        f"slowest call "
        f"{labels[slow]}; max abs err {max(errs):.3g}")
    return dict(name="spmv_block_ell", route="cuda",
                source=KERNEL_ROWS["spmv_block_ell"][0],
                replaces=KERNEL_ROWS["spmv_block_ell"][1], launches=launches,
                max_abs_err=max(errs), ms=total["ms"],
                plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                bound_by="bytes", library_ms=total["library_ms"],
                kernel_ms=total["kernel_ms"], device_ms=device_ms,
                bound_padded_ms=total["bound_padded_ms"],
                lanes={lab: figs[labels.index(lab)]["lanes"]
                       for lab in dict.fromkeys(labels)},
                calls=len(figs),
                slowest_call=dict(op=labels[slow], **figs[slow]))


# -- phase 2 (continued): K4 and K5 parity --------------------------------------

def k4_err(fa, q, k, v, causal) -> float:
    """K4 against its plain version on one input; returns the worst abs
    error, or raises past K4_TOL + K4_TOL |want| (for bf16 outputs plus one
    bf16 ulp and BF16_P_TOL max_j |v_j| for the rounded p)."""
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention gave {got.dtype} "
                             f"{tuple(got.shape)}, expected {want.dtype} "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    tol = K4_TOL + K4_TOL * want.abs()
    if q.dtype == torch.bfloat16:
        rep = q.shape[2] // k.shape[2]
        vmax = v.float().abs().amax(dim=(1, 3)).repeat_interleave(rep, 1)
        tol = tol + BF16_REL_ULP * want.abs() \
            + BF16_P_TOL * vmax[:, None, :, None]
    err = (got - want).abs()
    if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention off by up to "
                             f"{float(err.max())} (q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, {q.dtype}, causal {causal})")
    return float(err.max())


def k5_err(ssd, dtx, Bm, Cm, cumA) -> float:
    """K5 against its plain version on one input (y and S_c); returns the
    worst abs error, or raises past K5_TOL."""
    got = ssd.ssd_intra_chunk(dtx, Bm, Cm, cumA)
    want = ssd.ssd_intra_chunk_plain(dtx, Bm, Cm, cumA)
    worst = 0.0
    for g, w, what in zip(got, want, ("y", "S_c")):
        if g.shape != w.shape:
            raise AssertionError(f"ssd_intra_chunk {what} has shape "
                                 f"{tuple(g.shape)}, expected "
                                 f"{tuple(w.shape)}")
        err = (g - w).abs()
        if bool((err > K5_TOL + K5_TOL * w.abs()).any()) \
                or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_intra_chunk {what} off by up to "
                                 f"{float(err.max())} (dtx "
                                 f"{tuple(dtx.shape)}, B {tuple(Bm.shape)})")
        worst = max(worst, float(err.max()))
    return worst


# K4 at full width beside the main path's shape: (label, B, S, H, KH, D)
K4_WIDE = (("hymba-1.5b", 4, 2048, 25, 5, 64),
           ("llama3.2-3b", 4, 2048, 24, 8, 128))
# K5 at the full prefill shapes of 4 x 2048 tokens in chunks of 128:
# (label, G1 = batch x chunks, heads, q, n, p)
K5_WIDE = (("hymba-1.5b", 64, 50, 128, 16, 64),
           ("mamba2-130m", 64, 24, 128, 128, 64))


def k5_inputs(gen, G1, h, q, n, p):
    """K5's inputs as ``nn.ssm.ssd_chunked`` passes them: dtx and cumA
    transposed views of [G1, q, h, x], B and C [G1, 1, q, n] expanded over
    the heads (stride 0), cumA a cumulative sum of decays in (-0.1, 0]."""
    dev = "cuda"
    dtx = torch.randn(G1, q, h, p, generator=gen, device=dev)
    Bm, Cm = (torch.randn(G1, 1, q, n, generator=gen, device=dev)
              .expand(G1, h, q, n) for _ in range(2))
    a = -0.1 * torch.rand(G1, q, h, generator=gen, device=dev)
    cumA = a.cumsum(1).permute(0, 2, 1)[..., None]
    return dtx.permute(0, 2, 1, 3), Bm, Cm, cumA


def k4_k5_parity(dev) -> None:
    """K4 on D 16/32/64/128, rep 1 and 5, causal and full, S 1, 63, 200
    (not multiples of the 64-row tile) and 2048, float32 and bfloat16, then
    causal bf16 at hymba-1.5b's and llama3.2-3b's full attention shapes
    (timed beside SDPA and the bound); K5 on q 1/16/24/64/100/128 (ragged
    q is padded inside the kernel), n 8/16/128, p 16/64 with B and C
    expanded over 5 heads (stride 0) and dtx and cumA transposed views, on
    p 18 and a column-strided dtx (copied four bytes at a time), and at
    hymba-1.5b's and mamba2-130m's full prefill shapes, every launch on
    the tensor-core path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    gen = torch.Generator(device=dev).manual_seed(2)
    worst, n = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    fa.reset_launches()
    n_bf16 = 0
    for D in (16, 32, 64, 128):
        for rep in (1, 5):
            for causal in (True, False):
                for S in (1, 63, 200, 2048):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v = (torch.randn(2, S, h, D, generator=gen,
                                               device=dev).to(dtype)
                                   for h in (2 * rep, 2, 2))
                        worst[dtype] = max(worst[dtype],
                                           k4_err(fa, q, k, v, causal))
                        n += 1
                        n_bf16 += dtype == torch.bfloat16
    wide = []
    for label, B, S, H, KH, D in K4_WIDE:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev)
                   .bfloat16() for h in (H, KH, KH))
        wide.append((label, q, k, v, k4_err(fa, q, k, v, True)))
        worst[torch.bfloat16] = max(worst[torch.bfloat16], wide[-1][-1])
        n += 1
        n_bf16 += 1
    torch.cuda.synchronize()
    if fa.LAUNCHES["flash_attention_tc"] != n_bf16:
        raise AssertionError(f"{fa.LAUNCHES['flash_attention_tc']} of "
                             f"{n_bf16} bf16 K4 cases ran on the tensor "
                             f"cores")
    log(f"K4 parity: {n} cases (D 16/32/64/128, rep 1/5, causal and full, "
        f"S 1/63/200/2048, float32 and bfloat16; 2 full-width bf16), max abs"
        f" err float32 {worst[torch.float32]:.3g}, bfloat16 "
        f"{worst[torch.bfloat16]:.3g}; {fa.LAUNCHES['flash_attention_tc']} "
        f"of {n_bf16} bf16 cases on the tensor-core path")
    for label, q, k, v, err in wide:
        f = k4_call_figures(fa, q, k, v, True)
        log(f"K4 at {label}'s attention shape (q {list(q.shape)}, k/v "
            f"{list(k.shape)}, bf16, causal): launch alone "
            f"{f['kernel_ms']:.4f} ms ({f['flops'] / f['kernel_ms'] / 1e9:.1f}"
            f" TFLOP/s), SDPA {f['library_ms']:.4f} ms, plain "
            f"{f['plain_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
            f"({f['bound_by']}); max abs err {err:.3g}")
    worst5, n = 0.0, 0
    ssd.reset_launches()
    for q in (1, 16, 24, 64, 100, 128):
        for nn in (8, 16, 128):
            for p in (16, 64):
                worst5 = max(worst5, k5_err(ssd, *k5_inputs(gen, 6, 5, q, nn,
                                                             p)))
                n += 1
    # dtx copied four bytes at a time: a head dim that is not a multiple of
    # 4, and columns that are not adjacent
    for q, nn, p, strided in ((100, 16, 18, False), (128, 16, 64, True)):
        dtx, *rest = k5_inputs(gen, 6, 5, q, nn, p)
        if strided:
            dtx = dtx.mT.contiguous().mT
        worst5 = max(worst5, k5_err(ssd, dtx, *rest))
        n += 1
    wide = {}
    for label, *shape in K5_WIDE:
        wide[label] = k5_err(ssd, *k5_inputs(gen, *shape))
        worst5 = max(worst5, wide[label])
        n += 1
    torch.cuda.synchronize()
    if ssd.LAUNCHES["ssd_intra_chunk_tc"] != n:
        raise AssertionError(f"{ssd.LAUNCHES['ssd_intra_chunk_tc']} of {n} "
                             f"K5 cases ran on the tensor cores")
    log(f"K5 parity: {n} cases (q 1/16/24/64/100/128, n 8/16/128, p 16/64; "
        f"B and C expanded over 5 heads, dtx and cumA transposed views; p 18 "
        f"and column-strided dtx; "
        f"full width " + ", ".join(f"{k} {v:.3g}" for k, v in wide.items())
        + f"), max abs err {worst5:.3g} (limit {K5_TOL} + {K5_TOL} |want|); "
        f"{ssd.LAUNCHES['ssd_intra_chunk_tc']} of {n} on the tensor-core "
        f"path")


# -- phases 6 and 7: the model ---------------------------------------------------

def greedy(model, cfg, tokens, steps: int, device, max_seq: int):
    """``prefill`` then ``steps`` greedy ``decode_step`` calls; returns
    (every logits row on the host, the greedy tokens)."""
    from repro_torch.nn import decode_step, prefill

    S = tokens.shape[1]
    logits, cache = prefill(model, cfg, tokens, max_seq=max_seq,
                            device=device)
    rows, toks = [logits.double().cpu()], []
    for i in range(steps):
        tok = logits.argmax(-1)
        toks.append(tok.cpu())
        logits, cache = decode_step(model, cfg, cache, tok, S + i,
                                    device=device)
        rows.append(logits.double().cpu())
    toks.append(logits.argmax(-1).cpu())
    return rows, torch.stack(toks, 1)


def small_model() -> None:
    """hymba-1.5b's smoke config and its full width cut to 2 layers, float32
    weights, on cuda and on cpu: logits within MODEL_RTOL relative L2 of
    each other at every step, the same greedy tokens."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.nn import init_params, params_from_numpy, params_to_numpy

    S, steps = HYMBA["small_prompt"], HYMBA["small_decode"]
    for label, cfg in (("smoke config", get_smoke_config(HYMBA["arch"])),
                       ("full width cut to 2 layers", dataclasses.replace(
                           get_config(HYMBA["arch"]), n_layers=2))):
        gpu = init_params(cfg, seed=0).float()
        cpu = params_from_numpy(params_to_numpy(gpu), cfg, device="cpu",
                                dtype=torch.float32)
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, S))
        (rows_g, toks_g), t_gpu = sync_time(lambda: greedy(
            gpu, cfg, torch.from_numpy(tokens).cuda(), steps, None,
            S + steps))
        t = time.perf_counter()
        rows_c, toks_c = greedy(cpu, cfg, torch.from_numpy(tokens), steps,
                                "cpu", S + steps)
        t_cpu = time.perf_counter() - t
        rels = [rel_l2(g, c) for g, c in zip(rows_g, rows_c)]
        if not max(rels) <= MODEL_RTOL or not all(
                bool(torch.isfinite(r).all()) for r in rows_g):
            raise AssertionError(f"small model ({label}): cuda vs cpu logits "
                                 f"relative L2 {rels}")
        if not torch.equal(toks_g, toks_c):
            raise AssertionError(f"small model ({label}): greedy tokens "
                                 f"differ: cuda {toks_g.tolist()}, cpu "
                                 f"{toks_c.tolist()}")
        log(f"small model, hymba-1.5b {label} ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}), float32, 1 x {S}-token prompt + "
            f"{steps} greedy steps: cuda {t_gpu:.3f} s, cpu {t_cpu:.3f} s; "
            f"logits relative L2 worst {max(rels):.3g} (limit {MODEL_RTOL}),"
            f" tokens equal {toks_g[0].tolist()}")


def full_model():
    """hymba-1.5b at full width in bf16: prefill of 4 x 2048 tokens with K4
    and K5 counted and their inputs captured, 32 greedy decode steps, a
    profiled prefill and the serving engine.  Returns (launches, captured
    calls, device ms of K4 and K5 over the profiled prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import init_params

    cfg = get_config(HYMBA["arch"])
    B, S, steps = HYMBA["batch"], HYMBA["prompt"], HYMBA["decode"]
    model, t_init = sync_time(lambda: init_params(cfg, seed=0))
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"full model: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim}, {cfg.ssm_heads} SSM heads (state {cfg.ssm_state}, "
        f"chunk {cfg.ssm_chunk}), vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for p in model.parameters())} parameters, {n_bytes}"
        f" bytes on the card (bf16 weights, float32 norms and SSM scalars), "
        f"init_params(seed=0) {t_init:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    batch = {"tokens": tokens}
    prefill_step = make_prefill_step(cfg, max_seq=HYMBA["max_seq"])
    serve_step = make_serve_step(cfg)

    t_warm = sync_time(lambda: prefill_step(model, batch))[1]
    torch.cuda.reset_peak_memory_stats()
    t_pre = sync_time(lambda: prefill_step(model, batch))[1]
    peak = torch.cuda.max_memory_allocated()

    captured = {"flash_attention": [], "ssd_intra_chunk": []}
    real = {name: getattr(ops, name) for name in captured}

    def spy(name):
        def call(*args, **kw):
            captured[name].append((args, kw))
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(ops, name, spy(name))
    try:
        fa.reset_launches()
        ssd.reset_launches()
        (logits, cache), t_counted = sync_time(
            lambda: prefill_step(model, batch))
        launches = {**fa.LAUNCHES, **ssd.LAUNCHES}
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    log(f"full model prefill launches: {launches} (expected "
        f"{cfg.n_layers} each, one a layer)")
    for name, n in launches.items():
        if n != cfg.n_layers:
            raise AssertionError(f"{name} launched {n} times in the "
                                 f"full-width prefill, expected "
                                 f"{cfg.n_layers}")
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite")
    for name, t in cache["layers"].items():
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"prefill cache {name} is not finite")
    log(f"full model prefill {B} x {S} tokens: {t_pre:.4f} s wall "
        f"({B * S / t_pre:.0f} tokens/s; warm-up {t_warm:.3f} s, counted "
        f"run {t_counted:.3f} s); max_memory_allocated {peak} bytes; cache "
        + ", ".join(f"{k} {tuple(t.shape)} {str(t.dtype)[6:]}"
                    for k, t in cache["layers"].items()))

    tok, walls, out = logits.argmax(-1), [], []
    for i in range(steps):
        (logits, cache), w = sync_time(
            lambda: serve_step(model, cache, tok, S + i))
        walls.append(w)
        tok = logits.argmax(-1)
        out.append(tok)
    if {**fa.LAUNCHES, **ssd.LAUNCHES} != launches:
        raise AssertionError(f"decode launched K4 or K5: {fa.LAUNCHES}, "
                             f"{ssd.LAUNCHES}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("decode logits are not finite")
    step_ms = 1e3 * sum(walls[1:]) / (steps - 1)
    log(f"full model decode: {steps} greedy steps from position {S}, "
        f"{step_ms:.3f} ms a step after the first ({walls[0] * 1e3:.3f} ms), "
        f"{B / step_ms * 1e3:.1f} tokens/s; no K4 or K5 launch; row 0's "
        f"tokens {torch.stack(out, 1)[0].tolist()}")

    rows = device_share(lambda: prefill_step(model, batch))
    # None where the profiler saw no device time
    dev_ms = {name: sum(us for us, _, key in rows if tag in key) / 1e3
              if rows else None
              for name, tag in (("flash_attention", "flash_fwd"),
                                ("ssd_intra_chunk", "ssd_intra"))}
    log(f"full model prefill: kernel device time under the profiler "
        f"{dev_ms} ms")
    del cache
    serve_engine(cfg, model, fa, ssd)
    return launches, captured, dev_ms


def serve_engine(cfg, model, fa, ssd) -> None:
    """``ServeEngine`` at full width with ``launch/serve.py``'s defaults:
    every request finishes with its 8 tokens, and no kernel runs (the
    engine ingests prompts through decode, as the reference's does)."""
    from repro_torch.serve import Request, ServeEngine

    e = HYMBA["engine"]
    eng = ServeEngine(cfg, model, batch_slots=e["slots"],
                      max_seq=e["max_seq"])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=uid, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(2, 8))).tolist(),
        max_new_tokens=e["max_new"]) for uid in range(e["requests"])]
    for r in reqs:
        eng.submit(r)
    before = {**fa.LAUNCHES, **ssd.LAUNCHES}
    done, wall = sync_time(lambda: eng.run_until_done(max_ticks=2000))
    if len(done) != e["requests"] or any(
            len(r.output) != e["max_new"] for r in reqs):
        raise AssertionError(f"ServeEngine finished {len(done)} of "
                             f"{e['requests']} requests: "
                             f"{[(r.uid, len(r.output)) for r in reqs]}")
    if {**fa.LAUNCHES, **ssd.LAUNCHES} != before:
        raise AssertionError("ServeEngine launched K4 or K5")
    new = sum(len(r.output) for r in reqs)
    log(f"ServeEngine at full width: {e['slots']} slots, {len(reqs)} "
        f"requests of {[len(r.prompt) for r in reqs]} prompt tokens, "
        f"{new} new tokens in {wall:.3f} s ({new / wall:.1f} tokens/s)")
    for r in reqs:
        log(f"  req {r.uid}: prompt {r.prompt} -> {r.output}")


# -- phase 8: K4 and K5 figures ---------------------------------------------------

def k4_call_figures(fa, q, k, v, causal) -> dict:
    """CUDA-event times of one K4 call (the wrapper, the launch alone, the
    plain version and ``scaled_dot_product_attention`` with
    ``enable_gqa``, the one-call PyTorch yardstick) beside its bound: the
    larger of its flops (the causal triangle, 4D a pair) at the peak rate
    of its dtype and its bytes (q, k, v read once, the output written
    once) at 3.35 TB/s."""
    import torch.nn.functional as F

    B, S, H, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = B * H * pairs * 4 * D
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / (BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS)
    t_bytes = moved / HBM_BYTES_PER_S
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    reps = 3
    return dict(
        ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal), reps),
        kernel_ms=cuda_ms(lambda: fa._flash_attention_cuda(q, k, v, causal),
                          reps),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                         reps),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, bytes=moved)


def k5_call_figures(ssd, dtx, Bm, Cm, cumA) -> dict:
    """CUDA-event times of one K5 call (the wrapper, the launch alone, the
    plain version; no single PyTorch call computes it) beside its bound:
    the larger of its bytes (dtx, cumA, y and S_c once a program, B and C
    once a (batch, chunk), float32) at 3.35 TB/s and the tensor-core flops
    of its products at the card's TF32 rate, three TF32 products for each
    float32 one (the lower triangle of C B^T once a (batch, chunk), then a
    head's scores times dtx and S_c).  ``bound_f32_ms`` is the bound of
    the CUDA-core kernel K5 replaced, kept to compare with: every float32
    flop (C B^T per head, the decay, both products) at the float32 rate."""
    G1, h, q, p = dtx.shape
    n = Bm.shape[-1]
    G = G1 * h
    moved = 4 * (2 * G * q * p + G * q + 2 * G1 * q * n + G * n * p)
    tri = q * (q + 1) // 2
    flops = G * (tri * (2 * n + 1 + 2 * p) + q * n + 2 * q * n * p)
    tc_flops = 3 * (G1 * tri * 2 * n + G * (tri * 2 * p + 2 * q * n * p))
    t_ops, t_bytes = tc_flops / TF32_FLOPS, moved / HBM_BYTES_PER_S
    heads = (G, h, q, n, p)
    reps = 5
    return dict(
        ms=cuda_ms(lambda: ssd.ssd_intra_chunk(dtx, Bm, Cm, cumA), reps),
        kernel_ms=cuda_ms(lambda: ssd._ssd_intra_chunk_cuda(
            dtx, Bm, Cm, cumA, *heads), reps),
        plain_ms=cuda_ms(lambda: ssd.ssd_intra_chunk_plain(dtx, Bm, Cm, cumA),
                         reps),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_f32_ms=max(flops / F32_FLOPS, t_bytes) * 1e3,
        flops=flops, tc_flops=tc_flops, bytes=moved)


def model_kernel_rows(launches, captured, dev_ms) -> list:
    """The K4 and K5 rows over the 32 calls of the full-width prefill: each
    call held to its plain version, times and bounds summed, and the
    kernel's device time over a profiled prefill (``dev_ms``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    rows = []
    for name, err_of, figs_of in (
            ("flash_attention",
             lambda a, kw: k4_err(fa, *a, kw.get("causal", True)),
             lambda a, kw: k4_call_figures(fa, *a, kw.get("causal", True))),
            ("ssd_intra_chunk", lambda a, kw: k5_err(ssd, *a),
             lambda a, kw: k5_call_figures(ssd, *a))):
        calls = captured[name]
        errs = [err_of(a, kw) for a, kw in calls]
        figs = [figs_of(a, kw) for a, kw in calls]
        keys = [k for k in ("ms", "kernel_ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_f32_ms", "flops", "tc_flops",
                            "bytes") if k in figs[0]]
        total = {k: sum(f[k] for f in figs) for k in keys}
        shapes = [tuple(t.shape) for t in calls[0][0]]
        log(f"{name} over the full-width prefill's {len(calls)} calls "
            f"(inputs {shapes}, {calls[0][0][0].dtype}): wrapper "
            f"{total['ms']:.4f} ms, launch alone {total['kernel_ms']:.4f} ms "
            f"({total['flops'] / total['kernel_ms'] / 1e9:.2f} TFLOP/s, "
            f"{total['bytes'] / total['kernel_ms'] / 1e6:.0f} GB/s), device "
            f"{dev_ms[name]} ms (profiled prefill), plain "
            f"{total['plain_ms']:.4f} ms, library "
            + (f"{total['library_ms']:.4f} ms" if "library_ms" in total
               else "none")
            + f", bound {total['bound_ms']:.4f} ms ({figs[0]['bound_by']}: "
            f"{total['flops']} flops, {total['bytes']} bytes"
            + (f"; {total['tc_flops']} split-TF32 flops; as float32 on the "
               f"CUDA cores {total['bound_f32_ms']:.4f} ms"
               if "tc_flops" in total else "")
            + f"); max abs err {max(errs):.3g}")
        rows.append(dict(name=name, route="cuda", source=KERNEL_ROWS[name][0],
                         replaces=KERNEL_ROWS[name][1],
                         launches=launches[name], max_abs_err=max(errs),
                         ms=total["ms"], plain_ms=total["plain_ms"],
                         bound_ms=total["bound_ms"],
                         bound_by=figs[0]["bound_by"],
                         library_ms=total.get("library_ms"),
                         kernel_ms=total["kernel_ms"],
                         device_ms=dev_ms[name], calls=len(calls),
                         flops=total["flops"], bytes=total["bytes"],
                         inputs=[list(s) for s in shapes],
                         **{k: total[k] for k in ("bound_f32_ms", "tc_flops")
                            if k in total}))
    k4, k5 = rows
    k4.update(path="wgmma",
              tflops=k4["flops"] / k4["kernel_ms"] / 1e9,
              vs_library=k4["kernel_ms"] / k4["library_ms"],
              tc_launches=launches["flash_attention_tc"])
    k5.update(path="mma.sync 3xTF32",
              tflops=k5["tc_flops"] / k5["kernel_ms"] / 1e9,
              tc_launches=launches["ssd_intra_chunk_tc"])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import comm_stack as ks

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {nvidia_smi('name,power.limit')}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t = time.perf_counter()
    build_logs = ks.build_kernels()
    log(f"build: {sorted(build_logs)} compiled in "
        f"{time.perf_counter() - t:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                log(f"  {name}: {line.split(chr(39))[1]}")
            elif ("registers" in line or "spill" in line or "warning" in line
                  or "wgmma" in line):
                log(f"    {line.strip()}")

    kernel_parity(ks, dev)
    k3_parity(dev)
    k4_k5_parity(dev)
    small_vcycle(small_slice())
    launches, captured, levels = full_slice(ks)
    k3_run = full_vcycle(levels)
    small_model()
    model_run = full_model()
    rows = kernel_rows(ks, launches, captured, clock_mhz * 1e6)
    rows.append(k3_row(*k3_run))
    rows.extend(model_kernel_rows(*model_run))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
