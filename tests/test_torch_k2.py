"""K2 (the receive-queue walk) as the CUDA kernel computes it.

``csrc/queue_walk.cu`` gives each arrival one thread, which counts the
earlier arrivals of its region that matched a smaller posted slot:
``steps[j] = b[j] + 1 - #{j' < j in its region : b[j'] < b[j]}``.  The
kernel cannot run on the CPU, so :func:`k2_emulate` repeats its order in
numpy: one thread an arrival in blocks of ``K2_THREADS``, each thread's
region start by the kernel's binary search over ``starts``, and the
block's window of slots staged ``K2_TILE`` words at a time.  The emulation
is held bit-equal to the port's plain version (the lock-step Fenwick
rounds, an independent algorithm), to the reference's Pallas kernel in
interpret mode and to the reference's numpy walk.  The ``gpu`` test holds
the kernel to the plain version on the card and skips without one.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.comm.health import get_health  # noqa: E402
from repro.comm.primitives import batched_queue_traversal_steps  # noqa: E402
from repro.comm.primitives import queue_traversal_steps  # noqa: E402
from repro.kernels import comm_stack as ref_ks  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402

CSRC = Path(ks.__file__).resolve().parent / "csrc"


def k2_emulate(b, starts, threads=ks.K2_THREADS, tile=ks.K2_TILE):
    """K2's steps in the kernel's order: block by block, each thread's
    region start by its binary search over ``starts``, the block's window
    ``b[start of its first thread's region .. its last arrival)`` tile by
    tile, each thread counting the smaller slots of the part of a tile in
    ``[its region's start, g)``."""
    b = np.asarray(b, np.int32)
    starts = np.asarray(starts, np.int32)
    n, n_regions = b.size, starts.size
    steps = np.zeros(n, np.int64)
    if n == 0 or n_regions == 0:
        return steps
    for first in range(0, n, threads):
        g = first + np.arange(threads)
        live = g < n
        g = np.where(live, g, first)
        last = min(first + threads, n) - 1
        lo = np.zeros(threads, np.int64)
        hi = np.full(threads, n_regions, np.int64)
        while (hi - lo > 1).any():
            more = hi - lo > 1
            mid = lo + (hi - lo) // 2
            up = more & (starts[np.minimum(mid, n_regions - 1)] <= g)
            lo = np.where(up, mid, lo)
            hi = np.where(more & ~up, mid, hi)
        s = starts[lo]
        bj = np.where(live, b[g], 0)
        less = np.zeros(threads, np.int64)
        t0 = int(s[0])
        while t0 < last:
            length = min(tile, last - t0)
            words = b[t0:t0 + length]
            frm = np.maximum(s, t0) - t0
            to = np.where(live, np.minimum(g, t0 + length) - t0, frm)
            k = np.arange(length)
            inside = (k >= frm[:, None]) & (k < to[:, None])
            less += (inside & (words[None, :] < bj[:, None])).sum(1)
            t0 += length
        steps[g[live]] = (bj + 1 - less)[live]
    return steps


def _layout(counts, seed):
    """(posted, arrival, bounds) int64 with random permutations in each
    region of ``counts``."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cat = lambda xs: (np.concatenate(xs).astype(np.int64) if len(xs) else
                      np.zeros(0, np.int64))
    return (cat([rng.permutation(c) for c in counts]),
            cat([rng.permutation(c) for c in counts]), bounds)


def full_width_counts(rng, n):
    """Region sizes drawn like the full-width sweep's call (122,867 regions
    there: median 15, p90 26, p99 108, max 174): most regions hold 5-26
    arrivals, 1.5 % of them 60-174."""
    counts = rng.integers(5, 27, n)
    big = rng.random(n) < 0.015
    counts[big] = rng.integers(60, 175, int(big.sum()))
    return counts


def _emulated(posted, arrival, bounds, **geometry):
    b, starts = ks._queue_layout(*(torch.from_numpy(a) for a in
                                   (posted, arrival, bounds)))[:2]
    return k2_emulate(b.numpy(), starts.numpy(), **geometry)


def _plain(posted, arrival, bounds):
    return ks.queue_walk(*(torch.from_numpy(a) for a in
                           (posted, arrival, bounds))).numpy()


LAYOUTS = {
    "empty regions between": [3, 0, 0, 5, 0, 2, 0, 0, 0, 4],
    "empty regions around": [0, 0, 4, 0, 3, 0, 0],
    "empty regions at the end": [6, 7, 1, 0, 0, 0],
    "all regions empty": [0, 0, 0],
    "single-arrival regions": [1] * 120 + [0, 1, 0, 0] + [1] * 150,
    "a block boundary inside a region": [250, 20, 3, 300, 0, 40],
    "a run of 300 empty regions inside a block": [5] + [0] * 300 + [7, 9],
    "a region longer than a tile": [5, 3000, 7],
    "a region longer than several tiles": [2, 7000, 1],
    "the full-width size mix": full_width_counts(
        np.random.default_rng(5), 3000),
}
# the reference's Pallas kernel runs one interpreted round an arrival
PALLAS_LAYOUTS = ["empty regions between", "empty regions around",
                  "empty regions at the end", "single-arrival regions",
                  "a block boundary inside a region",
                  "a run of 300 empty regions inside a block"]


def test_k2_mirror_matches_the_cuda_constants():
    text = (CSRC / "queue_walk.cu").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert c == {"kThreads": ks.K2_THREADS, "kTile": ks.K2_TILE}
    # the tile and the window start fit a block's static shared memory
    assert 4 * (ks.K2_TILE + 1) <= 48 * 1024


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_emulation_bit_equal_to_plain_and_numpy_reference(name):
    posted, arrival, bounds = _layout(LAYOUTS[name], len(name))
    want = batched_queue_traversal_steps(posted, arrival, bounds)
    got = _emulated(posted, arrival, bounds)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(_plain(posted, arrival, bounds), want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PALLAS_LAYOUTS)
def test_emulation_bit_equal_to_pallas_interpret(name):
    posted, arrival, bounds = _layout(LAYOUTS[name], len(name))
    pallas = ref_ks.queue_walk(posted, arrival, bounds, backend="pallas")
    # the reference falls back to numpy silently: prove Pallas served it
    assert get_health().n_events == 0
    np.testing.assert_array_equal(_emulated(posted, arrival, bounds), pallas)


def test_long_region_matches_the_scalar_oracle():
    # five 2,048-word tiles, checked against the per-process Fenwick walk
    posted, arrival, bounds = _layout([9, 10_000, 4], 10)
    got = _emulated(posted, arrival, bounds)
    want = np.concatenate([queue_traversal_steps(posted[a:z], arrival[a:z])
                           for a, z in zip(bounds[:-1], bounds[1:])])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threads", [2, 4])
def test_the_region_start_search_lands_past_empty_regions(threads):
    # starts 0, 0, 0, 2, 2, 5, 5: empty regions share the next one's start,
    # and the search must give the start of the region that holds g
    posted, arrival, bounds = _layout([0, 0, 2, 0, 3, 0, 1], 0)
    b, starts = ks._queue_layout(*(torch.from_numpy(a) for a in
                                   (posted, arrival, bounds)))[:2]
    assert starts.tolist() == [0, 0, 0, 2, 2, 5, 5]
    np.testing.assert_array_equal(
        k2_emulate(b.numpy(), starts.numpy(), threads=threads, tile=2),
        batched_queue_traversal_steps(posted, arrival, bounds))


@settings(max_examples=40, deadline=None)
@given(counts=st.lists(st.one_of(st.integers(0, 40), st.just(0)),
                      max_size=24),
       seed=st.integers(0, 2 ** 16),
       geometry=st.sampled_from([(ks.K2_THREADS, ks.K2_TILE), (4, 8),
                                 (32, 5), (8, 64)]))
def test_emulation_bit_equal_on_ragged_layouts(counts, seed, geometry):
    # small geometries put block edges and tile edges inside the regions
    posted, arrival, bounds = _layout(counts, seed)
    threads, tile = geometry
    want = batched_queue_traversal_steps(posted, arrival, bounds)
    np.testing.assert_array_equal(_plain(posted, arrival, bounds), want)
    np.testing.assert_array_equal(
        _emulated(posted, arrival, bounds, threads=threads, tile=tile), want)


# -- the CUDA kernel ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_queue_walk_matches_plain_version(cuda):
    rng = np.random.default_rng(19)
    layouts = [[3, 10_000, 0, 2],                     # five tiles
               full_width_counts(rng, 100_000),       # the full-width mix
               [0, 0, 5, 0, 0, 0, 1, 0, 300, 0, 0]]   # runs of empty ones
    before = ks.LAUNCHES["queue_walk"]
    for i, counts in enumerate(layouts):
        t = [torch.from_numpy(a).to(cuda) for a in _layout(counts, i)]
        got = ks.queue_walk(*t)
        assert got.dtype == torch.int64
        assert torch.equal(got, ks.queue_walk_plain(*t))
    assert ks.LAUNCHES["queue_walk"] == before + len(layouts)
