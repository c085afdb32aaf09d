"""The two device kernels of the PhaseStack passes and their plain versions.

K1, :func:`segment_reduce`
    Per-segment sum *and* maximum of float32 values keyed by int32 segment
    ids, in one pass (``csrc/segment_reduce.cu``).  The stack's transport
    sums, per-phase byte sums and the link-contention reduction all go
    through it.  Runs of equal ids are folded within a lane and a warp, and
    blocks keep their partial sums in shared-memory bins: every segment has
    a bin when ``n_seg <= K1_BIN_CAP`` (the smem path), else a block bins
    the window of ids its chunk spans (the global path, :func:`k1_path`).
    Plain version: :func:`segment_reduce_plain` (``index_add_`` +
    ``scatter_reduce(..., "amax")``).
K2, :func:`queue_walk`
    The exact receive-queue walk: for every arrival of every receiver
    region, the 1-based position of its match in the still-unmatched posted
    queue (``csrc/queue_walk.cu``).  One thread an arrival counts the
    earlier arrivals of its region that matched a smaller posted slot, from
    its block's window of slots staged in shared memory; no tree, no serial
    chain.  Plain version: :func:`queue_walk_plain`, the lock-step Fenwick
    rounds in torch ops, an independent algorithm.

Each wrapper checks device, dtype, shape, contiguity and index ranges and
raises on anything else.  A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises — there is no fallback.  Every
launch adds one to :data:`LAUNCHES`, so a run can show that its main path
went through the kernels.

Each wrapper call, on either device, is the fault site
``kernel.segment_reduce`` or ``kernel.queue_walk``
(:mod:`repro_torch.comm.faults`): an armed raise or timeout fires before
the work, and the output then passes :func:`verified` — an armed ``nan`` /
``corrupt`` spec poisons it, and the ``REPRO_STACK_VERIFY`` post-kernel
check (``finite`` | ``parity``, :func:`verify_mode`) rejects the damage
with :class:`BackendVerifyError`, recorded in the health ledger.  A
rejected output is never replaced by the plain result: the error reaches
the caller.  The private launchers (``_segment_reduce_cuda``,
``_queue_walk_cuda``) are raw: no site, no check.

The kernels are built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` into ``_build/``, bound with ``ctypes``); ``build_kernels`` is
re-exported here.  Nothing is compiled when the module is imported.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .build import build_kernels, count, kernel, launch  # noqa: F401

#: Kernel launches per wrapper since the counts were last reset.
LAUNCHES = {"segment_reduce": 0, "segment_reduce_smem": 0,
            "segment_reduce_global": 0, "queue_walk": 0}

_P = ctypes.c_void_p
_ARGTYPES = {
    "segment_reduce": (_P, _P, ctypes.c_longlong, ctypes.c_int, _P,
                       ctypes.c_int),
    "queue_walk": (_P, _P, ctypes.c_int, ctypes.c_int, _P),
}
_INT32_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, device: torch.device, *args) -> None:
    launch(kernel(name, name, _ARGTYPES[name]), device, *args)
    count(LAUNCHES, name)


# -- the post-kernel check ------------------------------------------------------

#: Allowed ``REPRO_STACK_VERIFY`` values: ``''`` (off), ``finite`` (reject
#: non-finite float outputs), ``parity`` (hold outputs to the plain version
#: on CPU copies of the inputs, float sums in float64).
VERIFY_MODES = ("", "finite", "parity")


class BackendVerifyError(RuntimeError):
    """A device output failed the ``REPRO_STACK_VERIFY`` post-kernel check."""


def verify_mode() -> str:
    """The active post-kernel check, from ``REPRO_STACK_VERIFY``.

    ``finite`` rejects NaN/inf in float outputs; ``parity`` recomputes the
    plain version and rejects outputs off it (integers bit-equal, floats
    allclose at rtol 1e-4 / atol 1e-6 in float64).  Either rejection is a
    :class:`BackendVerifyError`.  An unknown value raises ``ValueError``
    naming the allowed modes.
    """
    mode = os.environ.get("REPRO_STACK_VERIFY", "")
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"unknown REPRO_STACK_VERIFY value {mode!r}; allowed values: "
            f"{VERIFY_MODES}")
    return mode


def _leaves(value) -> tuple:
    return value if isinstance(value, tuple) else (value,)


def _check_finite(value) -> None:
    for leaf in _leaves(value):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise BackendVerifyError(
                "device output contains non-finite values "
                "(REPRO_STACK_VERIFY=finite)")


def _check_parity(value, ref, exact: bool = False) -> None:
    for got, want in zip(_leaves(value), _leaves(ref)):
        g, w = got.cpu(), want.cpu()
        if g.shape != w.shape:
            ok = False
        elif exact or not (g.is_floating_point() or w.is_floating_point()):
            # integer outputs (and copies) are bit-equal by contract;
            # allclose would let a +1 shift on large values slide under rtol
            ok = torch.equal(g, w.to(g.dtype))
        else:
            ok = torch.allclose(g.double(), w.double(), rtol=1e-4, atol=1e-6,
                                equal_nan=False)
        if not ok:
            raise BackendVerifyError(
                "device output does not match the plain version "
                "(REPRO_STACK_VERIFY=parity)")


def verified(site: str, out, plain, exact: bool = False):
    """``out`` of the device site ``site`` (a tensor or a tuple of them),
    poisoned by an armed ``nan`` / ``corrupt`` spec at ``site``, then held
    to the active :func:`verify_mode`: ``plain()`` computes the reference
    for ``parity`` (on CPU copies of the inputs), compared bit for bit when
    ``exact``.  A rejection is recorded in the health ledger under the
    output's device and raised as :class:`BackendVerifyError`; nothing is
    returned in its place."""
    from repro_torch.comm import faults
    from repro_torch.comm.health import get_health

    out = faults.poison(site, out)
    mode = verify_mode()
    if not mode:
        return out
    try:
        if mode == "finite":
            _check_finite(out)
        else:
            _check_parity(out, plain(), exact)
    except BackendVerifyError as e:
        get_health().record_failure(str(_leaves(out)[0].device), site, e)
        raise
    return out


def _fail_point(site: str) -> None:
    # comm imports this module, hence the late import
    from repro_torch.comm import faults
    faults.fail_point(site)


# K1's geometry, mirrored from ``csrc/segment_reduce.cu`` (kBinCap,
# kThreads, kItems, kMinPerBlock, kMaxBlocks): keep the two in step.
#: Shared-memory bins a K1 block holds.
K1_BIN_CAP = 4096
K1_THREADS = 256
K1_ITEMS = 4
K1_MIN_PER_BLOCK = 4096
K1_MAX_BLOCKS = 132 * 4


def k1_path(n_seg: int) -> str:
    """K1's path for ``n_seg`` segments: ``"smem"`` when every segment has
    a shared-memory bin in each block, else ``"global"`` (each block bins
    the window of ids its chunk spans, when that fits, and sends its run
    updates to global atomics otherwise)."""
    return "smem" if int(n_seg) <= K1_BIN_CAP else "global"


def k1_grid(n: int) -> tuple[int, int]:
    """``(blocks, messages a block)`` of K1 on ``n`` messages, as
    ``per_block_for`` in the ``.cu`` computes them: at least
    ``K1_MIN_PER_BLOCK`` messages a block, at most ``K1_MAX_BLOCKS``
    blocks, rounded up to whole block steps of ``K1_THREADS * K1_ITEMS``
    messages (no blocks for ``n == 0``: K1 then only zeroes its
    outputs)."""
    step = K1_THREADS * K1_ITEMS
    if n <= 0:
        return 0, step
    blocks = min(-(-n // K1_MIN_PER_BLOCK), K1_MAX_BLOCKS)
    per = -(-n // blocks)                    # ceil(n / blocks) ...
    per = -(-per // step) * step             # ... in whole block steps
    return -(-n // per), per


def _check(t, dtype, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{what} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} lies on unsupported device {t.device}")


def _same_device(*ts) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {dev} and "
                             f"{t.device}")
    return dev


# -- K1: fused segment reduce ----------------------------------------------------

def segment_reduce_plain(values: torch.Tensor, ids: torch.Tensor,
                         n_seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``index_add_`` for the sums and
    ``scatter_reduce(..., "amax", include_self=False)`` over a zero row for
    the maxima (an empty segment keeps its 0)."""
    idx = ids.long()
    sums = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
    sums.index_add_(0, idx, values)
    maxs = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
    maxs.scatter_reduce_(0, idx, values, "amax", include_self=False)
    return sums, maxs


def segment_reduce(values: torch.Tensor, ids: torch.Tensor,
                   n_seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment ``(sums, maxima)`` of ``values`` (float32 ``[n]``) keyed
    by ``ids`` (int32 ``[n]``, each in ``[0, n_seg)``), both float32
    ``[n_seg]``; an empty segment reports sum 0 and max 0.

    On CUDA tensors this is one call of K1 on the path :func:`k1_path`
    picks, whose sums are float32-allclose (rtol 1e-4, atol 1e-6) to a
    sequential sum, not bit-equal, and whose maxima are exact; on CPU
    tensors it is :func:`segment_reduce_plain`.  On either device the call
    is the fault site ``kernel.segment_reduce`` and its output passes
    :func:`verified`.
    """
    _check(values, torch.float32, "values")
    _check(ids, torch.int32, "ids")
    dev = _same_device(values, ids)
    n_seg = int(n_seg)
    n = values.numel()
    if ids.numel() != n:
        raise ValueError(f"values has {n} entries but ids has {ids.numel()}")
    if not 0 <= n_seg <= _INT32_MAX:
        raise ValueError(f"n_seg must be in [0, 2^31 - 1], got {n_seg}")
    if n:
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= n_seg:
            raise ValueError(f"segment ids must lie in [0, {n_seg}), got "
                             f"[{lo}, {hi}]")
    _fail_point("kernel.segment_reduce")
    out = (segment_reduce_plain(values, ids, n_seg) if dev.type == "cpu"
           else _segment_reduce_cuda(values, ids, n_seg))
    # parity's reference sums in float64: the float32 plain version adds a
    # segment's values one by one on the CPU, which drifts past rtol 1e-4
    # on a segment of 10^5-10^6 messages where K1 does not
    return verified("kernel.segment_reduce", out,
                    lambda: segment_reduce_plain(values.cpu().double(),
                                                 ids.cpu(), n_seg))


def _segment_reduce_cuda(values: torch.Tensor, ids: torch.Tensor,
                         n_seg: int, path: str | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's launch on checked CUDA inputs, on ``path`` (``None``: the one
    :func:`k1_path` picks; ``"global"`` takes any ``n_seg``, ``"smem"``
    only up to ``K1_BIN_CAP``).  One buffer holds the sums, the maxima and
    the kernel's one scratch word; the two results are views of it."""
    path = path or k1_path(n_seg)
    if path not in ("smem", "global") or (path == "smem"
                                          and n_seg > K1_BIN_CAP):
        raise ValueError(f"K1 has no path {path!r} for {n_seg} segments")
    out = torch.empty(2 * n_seg + 1, dtype=torch.float32,
                      device=values.device)
    if n_seg:
        _launch("segment_reduce", values.device, values.data_ptr(),
                ids.data_ptr(), values.numel(), n_seg, out.data_ptr(),
                int(path == "smem"))
        count(LAUNCHES, f"segment_reduce_{path}")
    return out[:n_seg], out[n_seg:2 * n_seg]


# -- K2: receive-queue walk ------------------------------------------------------

# K2's geometry, mirrored from ``csrc/queue_walk.cu`` (kThreads, kTile): keep
# the two in step.  One thread an arrival, K2_THREADS a block; a block's
# window of posted slots goes through shared memory K2_TILE words at a time.
K2_THREADS = 256
K2_TILE = 2048


def _queue_layout(posted: torch.Tensor, arrival: torch.Tensor,
                  bounds: torch.Tensor):
    """Checked region layout of a queue walk, as torch ops on the inputs'
    device: ``b`` (region-local posted slot of every arrival), region
    ``starts``/``counts``, private tree offsets ``toff`` and power-of-two
    ``span`` per region, and the tree length (every region's ``span + 1``
    cells plus one shared sink) — the reference layout of
    ``_queue_layout`` in the JAX package.  Raises unless ``posted`` and
    ``arrival`` are both permutations within each region (the reference
    checks neither; a repeated arrival would make K2 and the plain walk
    disagree)."""
    for t, what in ((posted, "posted"), (arrival, "arrival"),
                    (bounds, "bounds")):
        _check(t, torch.int64, what)
    dev = _same_device(posted, arrival, bounds)
    N = posted.numel()
    if arrival.numel() != N or bounds.numel() < 1:
        raise ValueError("posted and arrival must have equal lengths and "
                         "bounds at least one entry")
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    if (int(bounds[0]) != 0 or int(bounds[-1]) != N
            or (N and bool((counts < 0).any()))):
        raise ValueError(f"bounds must rise from 0 to {N}")
    region_of = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), counts, output_size=N)
    start_of = starts[region_of]
    count_of = counts[region_of]
    for t, what in ((posted, "posted"), (arrival, "arrival")):
        if N and bool(((t < 0) | (t >= count_of)).any()):
            raise ValueError(f"{what} holds an index outside its region")
    pos = torch.full((N,), -1, dtype=torch.int64, device=dev)
    pos[start_of + posted] = torch.arange(N, device=dev) - start_of
    b = pos[start_of + arrival]
    # a slot no posted index names leaves b < 0; a slot that two arrivals
    # name is counted twice: both checks ride the one host read
    hits = torch.zeros(N, dtype=torch.int64, device=dev)
    hits.index_add_(0, start_of + arrival, torch.ones_like(arrival))
    if N and bool(((b < 0) | (hits != 1)).any()):
        raise ValueError("posted and arrival must be permutations within "
                         "each region")
    v = (counts - 1).clamp_min(0)          # next power of two >= count
    for sh in (1, 2, 4, 8, 16, 32):
        v = v | (v >> sh)
    span = v + 1
    toff = torch.cumsum(span + 1, 0) - (span + 1)
    tree_len = int((span + 1).sum()) + 1
    return b, starts, counts, toff, span, tree_len


def queue_walk_plain(posted: torch.Tensor, arrival: torch.Tensor,
                     bounds: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the lock-step batched Fenwick walk in torch ops.

    Region ``r`` owns slots ``bounds[r]:bounds[r+1]`` of ``posted`` /
    ``arrival`` (int64, region-local message indices); returns int64 steps
    per arrival in the same layout.  All regions advance together, one
    round per arrival depth, each round one maskless prefix gather chain
    and one scatter-add removal chain over every still-active region;
    chains that climb past their region's span park at the shared sink.
    """
    return _queue_walk_lockstep(*_queue_layout(posted, arrival, bounds))


def _queue_walk_lockstep(b, starts, counts, toff, span,
                         tree_len: int) -> torch.Tensor:
    """The lock-step rounds of :func:`queue_walk_plain` on a checked layout
    (:func:`_queue_layout`)."""
    dev = b.device
    N = b.numel()
    steps = torch.zeros(N, dtype=torch.int64, device=dev)
    if N == 0:
        return steps
    # initial trees: local slot i of region r holds the count of unmatched
    # posted slots in (i - lowbit(i), i]
    li = (torch.arange(tree_len - 1, device=dev)
          - torch.repeat_interleave(toff, span + 1, output_size=tree_len - 1))
    c_rep = torch.repeat_interleave(counts, span + 1,
                                    output_size=tree_len - 1)
    lo = li - (li & -li)
    tree = torch.zeros(tree_len, dtype=torch.int64, device=dev)
    tree[:-1] = torch.minimum(li, c_rep) - torch.minimum(lo, c_rep)
    sink = tree_len - 1
    depth = int(span.max()).bit_length()
    regions = torch.nonzero(counts).flatten()
    for j in range(int(counts.max())):
        act = regions[counts[regions] > j]
        if act.numel() == 0:
            break
        s = starts[act] + j
        p = b[s] + 1
        base = toff[act]
        i = p.clone()
        acc = torch.zeros_like(p)
        for _ in range(depth):
            acc += tree[base + i]
            i -= i & -i
        steps[s] = acc
        i = p.clone()
        idx = base + i
        minus = torch.full_like(p, -1)
        bound = span[act]
        for _ in range(depth):
            tree.index_add_(0, idx, minus)
            i += i & -i
            idx = torch.where(i > bound, sink, base + i)
    return steps


def queue_walk(posted: torch.Tensor, arrival: torch.Tensor,
               bounds: torch.Tensor) -> torch.Tensor:
    """Exact receive-queue walk lengths for many receiver regions.

    Same contract as :func:`queue_walk_plain` (int64 in, int64 steps out,
    bit-equal for any schedule).  On CUDA tensors the layout is computed
    with torch ops on the card and K2 walks every region in one launch
    (int32 inside); on CPU tensors this is :func:`queue_walk_plain`.  On
    either device the call is the fault site ``kernel.queue_walk`` and its
    output passes :func:`verified`.
    Raises when the tree would not fit int32 indexing.
    """
    layout = _queue_layout(posted, arrival, bounds)
    tree_len = layout[-1]
    if tree_len - 1 >= _INT32_MAX:
        raise ValueError(f"queue walk tree of {tree_len} cells exceeds "
                         "int32 indexing")
    _fail_point("kernel.queue_walk")
    steps = (_queue_walk_lockstep(*layout) if posted.device.type == "cpu"
             else _queue_walk_cuda(*layout[:2]))
    return verified("kernel.queue_walk", steps,
                    lambda: queue_walk_plain(posted.cpu(), arrival.cpu(),
                                             bounds.cpu()))


def _queue_walk_cuda(b: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """K2's launch on a checked CUDA layout: ``b`` and ``starts`` of
    :func:`_queue_layout`, contiguous int64 with every value below 2^31,
    read as they are (the kernel narrows them to int32).  Arrival ``j`` of
    a region gets ``b[j] + 1`` minus the count of its region's earlier
    arrivals with a smaller ``b``; only the steps are allocated here, no
    scratch."""
    steps = torch.empty(b.numel(), dtype=torch.int64, device=b.device)
    if b.numel():
        _launch("queue_walk", b.device, b.data_ptr(), starts.data_ptr(),
                b.numel(), starts.numel(), steps.data_ptr())
    return steps
