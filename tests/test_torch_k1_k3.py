"""K1 (segment reduce) and K3 (block-ELL SpMV) as redesigned for the H100:
their summation orders, path and lane pickers, and K3's range check.

The CUDA kernels cannot run on the CPU, so the order in which each adds
its float32 values is emulated here in numpy, step by step as the
``.cu`` sources do it, and held to a float64 sum within the kernels' own
tolerances: K1's lane runs, warp-wide segmented scan, block bins and
flush (rtol 1e-4 / atol 1e-6 against the sum of ``|values|``, maxima
exact), and K3's lane-split slots and shuffle tree (1e-5 of a row's sum of
magnitudes).  The pickers' constants are read back from the ``.cu``
sources, so the Python mirrors cannot drift from them.  The ``gpu`` tests
hold both kernels, on every path and forced lane count, to their plain
versions on the card and skip without one.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.spmv_ell import \
    csr_to_block_ell as ref_to_ell  # noqa: E402
from repro.sparse import poisson_3d as ref_poisson  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402
from repro_torch.kernels import spmv_ell as ell  # noqa: E402
from repro_torch.sparse import (DeviceHierarchy, build_hierarchy,  # noqa: E402
                                elasticity_like_3d, poisson_3d)

CSRC = Path(ks.__file__).resolve().parent / "csrc"
RTOL, ATOL = 1e-4, 1e-6        # K1 against a sequential sum
K3_RTOL = 1e-5                 # K3 against a row's sum of magnitudes
F32 = np.float32


def _constants(source: str) -> dict:
    """The integer ``constexpr`` constants of a kernel source, evaluated in
    order (each may use the ones before it)."""
    text = (CSRC / source).read_text()
    out = {}
    for name, expr in re.findall(
            r"constexpr (?:int|long long) (k\w+) = ([^;]+);", text):
        out[name] = eval(re.sub(r"(\d)LL", r"\1", expr).replace("/", "//"),
                         {}, dict(out))                  # noqa: S307
    return out


# -- K1: the mirror of the .cu and its summation order -----------------------

def test_k1_mirror_matches_the_cuda_constants():
    c = _constants("segment_reduce.cu")
    assert c["kBinCap"] == ks.K1_BIN_CAP
    assert c["kThreads"] == ks.K1_THREADS
    assert c["kItems"] == ks.K1_ITEMS
    assert c["kMinPerBlock"] == ks.K1_MIN_PER_BLOCK
    assert c["kMaxBlocks"] == ks.K1_MAX_BLOCKS
    # 8 B of bins a segment must fit a block's static shared memory
    assert 8 * ks.K1_BIN_CAP <= 48 * 1024 - 1024


@pytest.mark.parametrize("n_seg,path", [
    (1, "smem"), (46, "smem"), (4096, "smem"), (4097, "global"),
    (35_697, "global"), (376_832, "global")])
def test_k1_path_picker(n_seg, path):
    assert ks.k1_path(n_seg) == path


@pytest.mark.parametrize("n", [1, 3759, 4096, 35_697, 1_922_438, 4_689_748,
                               10 ** 9])
def test_k1_grid_covers_every_message_in_whole_steps(n):
    blocks, per = ks.k1_grid(n)
    step = ks.K1_THREADS * ks.K1_ITEMS
    assert per % step == 0 and (blocks == 1 or per >= ks.K1_MIN_PER_BLOCK)
    assert 1 <= blocks <= ks.K1_MAX_BLOCKS
    assert (blocks - 1) * per < n <= blocks * per


def _enc(v):
    b = np.asarray(v, F32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _dec(u):
    u = np.asarray(u, np.uint32)
    b = np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u).astype(np.uint32)
    return np.where(u == 0, F32(0), b.view(F32)).astype(F32)


def k1_emulate(values, ids, n_seg, path=None, stats=None):
    """K1's arithmetic in float32, in the order ``segment_reduce.cu`` does
    it: blocks in turn, each warp's range in steps of 32 lanes x kItems
    messages, each update applied the moment the kernel issues it (the
    card's atomics add in some order of the same partials).  ``stats``, a
    dict, receives the number of updates issued to bins or global rows."""
    values = np.asarray(values, F32)
    ids = np.asarray(ids, np.int64)
    n = values.size
    sums = np.zeros(n_seg, F32)
    maxs = np.zeros(n_seg, np.uint32)
    updates = 0
    if n == 0 or n_seg == 0:
        return sums, _dec(maxs)
    path = path or ks.k1_path(n_seg)
    blocks, per = ks.k1_grid(n)
    warps, items = ks.K1_THREADS // 32, ks.K1_ITEMS
    for b in range(blocks):
        b0, b1 = b * per, min(n, (b + 1) * per)
        if path == "smem":
            lo, span = 0, n_seg
        else:
            mn, mx = int(ids[b0:b1].min()), int(ids[b0:b1].max())
            lo, span = mn, (mx - mn + 1 if mx - mn < ks.K1_BIN_CAP else 0)
        bsum = np.zeros(span, F32)
        bmax = np.zeros(span, np.uint32)

        def put(i, s, m):
            nonlocal updates
            if i < 0:
                return
            updates += 1
            if 0 <= i - lo < span:
                bsum[i - lo] = F32(bsum[i - lo] + s)
                bmax[i - lo] = max(bmax[i - lo], m)
            else:
                sums[i] = F32(sums[i] + s)
                maxs[i] = max(maxs[i], m)

        per_warp = per // warps
        for w in range(warps):
            w0 = b0 + w * per_warp
            w1 = min(w0 + per_warp, b1)
            cid, csum, cmax = -1, F32(0), np.uint32(0)
            for base in range(w0, w1, 32 * items):
                k = base + np.arange(32 * items)
                inside = k < w1
                v = np.where(inside, values[np.minimum(k, n - 1)],
                             F32(0)).astype(F32).reshape(32, items)
                idv = np.where(inside, ids[np.minimum(k, n - 1)],
                               -1).reshape(32, items)
                first = idv[:, 0].copy()
                hs = np.zeros(32, F32)
                hm = np.zeros(32, np.uint32)
                ts = v[:, 0].copy()
                tm = _enc(v[:, 0])
                tid = idv[:, 0].copy()
                uniform = np.ones(32, bool)
                for lane in range(32):
                    for j in range(1, items):
                        if idv[lane, j] == tid[lane]:
                            ts[lane] = F32(ts[lane] + v[lane, j])
                            tm[lane] = max(tm[lane], _enc(v[lane, j]))
                        else:
                            if uniform[lane]:
                                hs[lane], hm[lane] = ts[lane], tm[lane]
                                uniform[lane] = False
                            else:
                                put(tid[lane], ts[lane], tm[lane])
                            tid[lane] = idv[lane, j]
                            ts[lane] = v[lane, j]
                            tm[lane] = _enc(v[lane, j])
                prev_last = np.concatenate([[cid], tid[:-1]])
                next_first = np.concatenate([first[1:], [first[-1]]])
                if first[0] == cid:
                    if uniform[0]:
                        ts[0] = F32(csum + ts[0])
                        tm[0] = max(cmax, tm[0])
                    else:
                        hs[0] = F32(csum + hs[0])
                        hm[0] = max(cmax, hm[0])
                else:
                    put(cid, csum, cmax)
                start = ~uniform | (first != prev_last)
                start[0] = True
                d = 1
                while d < 32:
                    s_up = np.concatenate([ts[:d], ts[:-d]])
                    m_up = np.concatenate([tm[:d], tm[:-d]])
                    f_up = np.concatenate([start[:d], start[:-d]])
                    take = (np.arange(32) >= d) & ~start
                    ts = np.where(take, (s_up + ts).astype(F32), ts)
                    tm = np.where(take, np.maximum(m_up, tm), tm)
                    start = np.where(np.arange(32) >= d, start | f_up, start)
                    d *= 2
                for lane in range(32):
                    if not uniform[lane]:
                        if lane > 0 and first[lane] == prev_last[lane]:
                            hs[lane] = F32(ts[lane - 1] + hs[lane])
                            hm[lane] = max(tm[lane - 1], hm[lane])
                        put(first[lane], hs[lane], hm[lane])
                for lane in range(31):
                    if next_first[lane] != tid[lane]:
                        put(tid[lane], ts[lane], tm[lane])
                cid, csum, cmax = int(tid[31]), ts[31], tm[31]
            put(cid, csum, cmax)
        for k in np.nonzero(bmax)[0]:
            sums[lo + k] = F32(sums[lo + k] + bsum[k])
            maxs[lo + k] = max(maxs[lo + k], bmax[k])
    if stats is not None:
        stats["updates"] = updates
    return sums, _dec(maxs)


def _k1_case(case, seed=0):
    rng = np.random.default_rng(seed)
    if case == "sorted runs":          # phase_id: 46 runs of ~435 messages
        counts = rng.integers(200, 700, 46)
        ids = np.repeat(np.arange(46), counts)
        vals = rng.exponential(1e3, ids.size)
        return vals, ids, 46
    if case == "random ids":
        return rng.exponential(1.0, 20_001), rng.integers(0, 300, 20_001), 300
    if case == "one hot segment":
        ids = np.full(18_000, 7)
        ids[rng.integers(0, ids.size, 40)] = rng.integers(0, 50, 40)
        return rng.exponential(10.0, ids.size), ids, 50
    if case == "signed values":
        return (rng.standard_normal(9_001) * 1e3, rng.integers(0, 37, 9_001),
                37)
    if case == "empty segments":       # ids only on even segments
        return rng.exponential(1.0, 5_000), 2 * rng.integers(0, 150, 5_000), \
            301
    if case == "sorted, above capacity":   # global path, windows fit
        ids = np.sort(rng.integers(0, 30_000, 24_000))
        return rng.exponential(1.0, ids.size), ids, 30_000
    if case == "random, above capacity":   # global path, windows too wide
        return (rng.standard_normal(14_000), rng.integers(0, 9_000, 14_000),
                9_000)
    if case == "short runs, above capacity":   # the contention call's shape
        keys = np.repeat(np.sort(rng.integers(0, 6_000, 3_000)),
                         rng.integers(1, 4, 3_000))
        return rng.exponential(1.0, keys.size), keys, 6_000
    raise KeyError(case)


K1_CASES = ["sorted runs", "random ids", "one hot segment", "signed values",
            "empty segments", "sorted, above capacity",
            "random, above capacity", "short runs, above capacity"]


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_summation_order_within_tolerance_of_float64(case):
    vals, ids, n_seg = _k1_case(case)
    v32 = vals.astype(F32)
    got_s, got_m = k1_emulate(v32, ids, n_seg)
    want = np.zeros(n_seg)
    np.add.at(want, ids, v32.astype(np.float64))
    scale = np.zeros(n_seg)
    np.add.at(scale, ids, np.abs(v32.astype(np.float64)))
    assert np.all(np.abs(got_s - want) <= ATOL + RTOL * scale)
    # maxima bit-equal to the plain version; an empty segment reports 0
    _, plain_m = ks.segment_reduce(torch.from_numpy(v32),
                                   torch.from_numpy(ids.astype(np.int32)),
                                   n_seg)
    np.testing.assert_array_equal(got_m.view(np.uint32),
                                  plain_m.numpy().view(np.uint32))
    assert not got_s[np.bincount(ids, minlength=n_seg) == 0].any()


@pytest.mark.parametrize("case", ["sorted runs", "signed values",
                                  "empty segments"])
def test_k1_global_path_agrees_where_both_apply(case):
    vals, ids, n_seg = _k1_case(case, seed=3)
    v32 = vals.astype(F32)
    s_smem, m_smem = k1_emulate(v32, ids, n_seg, "smem")
    s_glob, m_glob = k1_emulate(v32, ids, n_seg, "global")
    np.testing.assert_array_equal(m_smem, m_glob)
    scale = np.zeros(n_seg)
    np.add.at(scale, ids, np.abs(v32.astype(np.float64)))
    assert np.all(np.abs(s_smem - s_glob) <= 2 * (ATOL + RTOL * scale))


def test_k1_runs_cut_the_updates():
    """Sorted runs issue one update a run within each warp range, random
    ids about one a message: the count the redesign exists for."""
    _, per = ks.k1_grid(20_001)
    per_warp = per // (ks.K1_THREADS // 32)

    def pieces(ids):          # runs, cut at every warp range's ends
        return sum(1 + int((np.diff(ids[k:k + per_warp]) != 0).sum())
                   for k in range(0, ids.size, per_warp))
    stats = {}
    vals, ids, n_seg = _k1_case("sorted runs")
    k1_emulate(vals.astype(F32), ids, n_seg, stats=stats)
    assert stats["updates"] == pieces(ids) < ids.size / 50
    vals, ids, n_seg = _k1_case("random ids")
    k1_emulate(vals.astype(F32), ids, n_seg, stats=stats)
    assert stats["updates"] == pieces(ids) > ids.size * 0.99


def test_k1_encoding_preserves_the_float_order():
    v = np.array([-np.inf, -3e38, -1.0, -1e-40, -0.0, 0.0, 1e-40, 1.0,
                  3e38, np.inf], F32)
    e = _enc(v)
    assert np.all(np.diff(e.astype(np.int64)) > 0) and np.all(e > 0)
    np.testing.assert_array_equal(_dec(e).view(np.uint32), v.view(np.uint32))


# -- K3: lanes, the lane-split order and the range check ---------------------

def test_k3_lanes_mirror_matches_the_cuda_constants():
    c = _constants("spmv_ell.cu")
    assert c["kMaxLanes"] == ell.K3_MAX_LANES
    # a row's lanes must share a warp and a block
    assert 32 % c["kMaxLanes"] == 0 and c["kThreads"] % 32 == 0


@pytest.mark.parametrize("n_rows,bs,max_bpr", [
    (192_000, 8, 27), (15_792, 8, 120), (15_792, 8, 74), (2_184, 8, 90),
    (2_184, 8, 79), (384, 8, 43), (24, 8, 3), (96, 8, 12), (5, 3, 0),
    (1, 1, 1), (4_000, 16, 200), (640, 32, 64), (30, 3, 100),
    (10 ** 6, 4, 40)])
def test_k3_lanes_picker(n_rows, bs, max_bpr):
    lanes = ell.lanes_for(n_rows, bs, max_bpr)
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= ell.K3_MAX_LANES
    floor = 1 << (32 // bs).bit_length() - 1 if max_bpr >= ell.K3_LONG_ROW \
        else 1
    # no more lanes than the fill, the floor or the slots call for
    assert (lanes <= floor or n_rows * lanes // 2 < ell.K3_FILL_THREADS
            and lanes // 2 < max_bpr)
    assert lanes >= min(floor, ell.K3_MAX_LANES)


@pytest.mark.parametrize("name,n_rows,max_bpr,lanes", [
    ("L0 A", 192_000, 27, 4), ("L1 A", 15_792, 74, 4),
    ("L1 P^T", 15_792, 120, 4), ("L1 P", 192_000, 12, 1),
    ("L2 A", 2_184, 90, 32), ("L2 P", 15_792, 12, 4), ("L3 P", 2_184, 11, 16),
    ("L5 A", 24, 3, 4)])
def test_k3_lanes_picks_the_fastest_measured_on_the_v_cycle(name, n_rows,
                                                            max_bpr, lanes):
    """The picks at the full-width V-cycle's operators (8 x 8 blocks): the
    lane counts with the least device time on an H100 (PERF.md §6),
    or within 5 % of it."""
    assert ell.lanes_for(n_rows, 8, max_bpr) == lanes


def k3_emulate(blocks, cols, x, lanes, skip_pad=False):
    """K3's float32 arithmetic in ``spmv_ell.cu``'s order: lane ``l`` of a
    row sums slots ``l, l + lanes, ...``, each as ``bs`` fused
    multiply-adds in column order; a shuffle butterfly then adds the lanes'
    sums (offsets lanes/2, ..., 1).  ``skip_pad``: a lane stops at its
    first slot ``s >= 1`` at block column 0."""
    nbr, max_bpr, bs, _ = blocks.shape
    xb = x.reshape(-1, bs)
    y = np.zeros(nbr * bs, F32)
    for r in range(nbr):
        for i in range(bs):
            acc = np.zeros(lanes, F32)
            for lane in range(lanes):
                a = F32(0)
                for s in range(lane, max_bpr, lanes):
                    if skip_pad and s > 0 and cols[r, s] == 0:
                        break
                    row, xs = blocks[r, s, i], xb[cols[r, s]]
                    for j in range(bs):        # fma: one rounding
                        a = F32(np.float64(row[j]) * np.float64(xs[j])
                                + np.float64(a))
                acc[lane] = a
            off = lanes // 2
            while off:
                acc = (acc + acc[np.arange(lanes) ^ off]).astype(F32)
                off //= 2
            y[r * bs + i] = acc[0]
    return y


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_k3_lane_split_order_at_120_slots_within_float64(lanes):
    rng = np.random.default_rng(lanes)
    nbr, max_bpr, bs, ncb = 3, 120, 8, 400
    blocks = rng.standard_normal((nbr, max_bpr, bs, bs)).astype(F32)
    cols = rng.integers(0, ncb, (nbr, max_bpr)).astype(np.int32)
    x = rng.standard_normal(ncb * bs).astype(F32)
    got = k3_emulate(blocks, cols, x, lanes)
    gathered = x.reshape(-1, bs)[cols].astype(np.float64)
    want = np.einsum("rsij,rsj->ri", blocks.astype(np.float64),
                     gathered).reshape(-1)
    scale = np.einsum("rsij,rsj->ri", np.abs(blocks.astype(np.float64)),
                      np.abs(gathered)).reshape(-1)
    assert np.all(np.abs(got - want) <= K3_RTOL * scale)
    # and the same sums as the plain version, within the same bound
    plain = ell.spmv_block_ell_plain(torch.from_numpy(blocks),
                                     torch.from_numpy(cols),
                                     torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - plain) <= 2 * K3_RTOL * scale)


@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_k3_stopping_at_padding_changes_no_bit(lanes):
    levels = build_hierarchy(elasticity_like_3d(4))
    blocks, cols, _ = ell.csr_to_block_ell(levels[1].P.transpose(), 8, "cpu")
    assert ell.padding_at_end(blocks, cols)
    assert int((cols[:, 1:] == 0).sum()) > 0         # it has padding
    x = np.random.default_rng(0).standard_normal(
        int(cols.max()) * 8 + 8).astype(F32)
    b, c = blocks.numpy(), cols.numpy()
    np.testing.assert_array_equal(k3_emulate(b, c, x, lanes, True),
                                  k3_emulate(b, c, x, lanes))


def test_padding_at_end_vouches_only_for_the_pair_as_made():
    A = poisson_3d(5)
    blocks, cols, _ = ell.csr_to_block_ell(A, 4, "cpu")
    other_b, other_c, _ = ell.csr_to_block_ell(A, 4, "cpu")
    assert ell.padding_at_end(blocks, cols)
    assert not ell.padding_at_end(blocks, other_c)      # another pair
    assert not ell.padding_at_end(blocks.bfloat16(), cols)
    assert not ell.padding_at_end(blocks, ell.check_cols(cols.clone()))
    moved = ell.move_ell(other_b, other_c, "cpu")
    assert ell.padding_at_end(*moved)
    blocks[0, -1, 0, 0] = 1.0                           # into a padding slot
    assert not ell.padding_at_end(blocks, cols)
    other_c[0, 0] = 0
    assert not ell.padding_at_end(*moved)


def _ell(n=5, bs=4):
    return ell.csr_to_block_ell(poisson_3d(n), bs, "cpu")


def test_csr_to_block_ell_records_its_range_check():
    blocks, cols, _ = _ell()
    ref_b, ref_c, _ = ref_to_ell(ref_poisson(5), bs=4)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(ref_c))
    assert ell.checked_bound(cols) == int(cols.max()) + 1
    x = torch.ones(blocks.shape[0] * 4)
    before = ell.RANGE_CHECKS["spmv_block_ell"]
    ell.spmv_block_ell(blocks, cols, x)
    assert ell.RANGE_CHECKS["spmv_block_ell"] == before      # no aminmax


@pytest.mark.parametrize("bad", [-1, "n_cols"])
def test_out_of_range_cols_raise_at_conversion(bad):
    A = poisson_3d(4).copy()
    A.indices[5] = -1 if bad == -1 else A.n_cols   # would wrap into range
    with pytest.raises(ValueError, match="block-column ids"):
        ell.csr_to_block_ell(A, 4, "cpu")


@pytest.mark.parametrize("bad", [-1, "ncb"])
def test_out_of_range_cols_raise_through_spmv(bad):
    blocks, cols, _ = _ell()
    x = torch.ones(blocks.shape[0] * 4)
    cols = cols.clone()                  # a clone carries no check record
    cols[1, 0] = -1 if bad == -1 else blocks.shape[0]
    with pytest.raises(ValueError, match="block-column ids"):
        ell.spmv_block_ell(blocks, cols, x)


def test_a_checked_cols_edited_in_place_is_checked_again():
    blocks, cols, _ = _ell()
    x = torch.ones(blocks.shape[0] * 4)
    cols[2, 1] = blocks.shape[0] + 3          # bumps cols._version
    assert ell.checked_bound(cols) is None
    with pytest.raises(ValueError, match="block-column ids"):
        ell.spmv_block_ell(blocks, cols, x)
    cols.view(-1)[cols.shape[1] * 2 + 1] = 0  # through a view: checked again
    before = ell.RANGE_CHECKS["spmv_block_ell"]
    ell.spmv_block_ell(blocks, cols, x)
    assert ell.RANGE_CHECKS["spmv_block_ell"] == before + 1


@pytest.mark.parametrize("short", [4, 12])
def test_a_wrong_length_x_raises(short):
    blocks, cols, _ = _ell()
    x = torch.ones(blocks.shape[0] * 4 - short)
    with pytest.raises(ValueError):
        ell.spmv_block_ell(blocks, cols, x)
    with pytest.raises(ValueError):
        ell.spmv_block_ell(blocks, cols, torch.ones(blocks.shape[0] * 4 + 1))


def test_device_hierarchy_to_checks_each_operator_once():
    levels = build_hierarchy(elasticity_like_3d(4))
    h = DeviceHierarchy.build(levels, bs=8, device="cpu")
    for lv in h.levels:
        for op in (lv.A, lv.P, lv.PT):
            if op is not None:
                assert ell.checked_bound(op[1]) is not None
    before = ell.RANGE_CHECKS["spmv_block_ell"]
    again = h.to("cpu")
    n_ops = sum(op is not None for lv in h.levels
                for op in (lv.A, lv.P, lv.PT))
    assert ell.RANGE_CHECKS["spmv_block_ell"] == before + n_ops
    for lv in again.levels:
        for op in (lv.A, lv.P, lv.PT):
            if op is not None:
                assert ell.checked_bound(op[1]) is not None


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_k1_paths_match_plain_version(cuda):
    before = dict(ks.LAUNCHES)
    calls = {"smem": 0, "global": 0}
    for case in K1_CASES:
        vals, ids, n_seg = _k1_case(case, seed=5)
        v = torch.from_numpy(vals.astype(F32)).to(cuda)
        i = torch.from_numpy(ids.astype(np.int32)).to(cuda)
        want_s, want_m = ks.segment_reduce_plain(v, i, n_seg)
        scale = ks.segment_reduce_plain(v.abs(), i, n_seg)[0]
        paths = ["global"] + (["smem"] if n_seg <= ks.K1_BIN_CAP else [])
        for path in paths:
            for off in (0, 1):             # 16-byte aligned and not
                s, m = ks._segment_reduce_cuda(v[off:], i[off:], n_seg, path) \
                    if off else ks._segment_reduce_cuda(v, i, n_seg, path)
                ws, wm = (want_s, want_m) if not off else \
                    ks.segment_reduce_plain(v[1:], i[1:], n_seg)
                sc = scale if not off else \
                    ks.segment_reduce_plain(v[1:].abs(), i[1:], n_seg)[0]
                assert bool(((s - ws).abs() <= ATOL + RTOL * sc).all()), case
                assert torch.equal(m, wm), case
                calls[path] += 1
    assert ks.LAUNCHES["segment_reduce"] == before["segment_reduce"] + sum(
        calls.values())
    for path, n in calls.items():
        key = f"segment_reduce_{path}"
        assert ks.LAUNCHES[key] == before[key] + n


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_cuda_k3_forced_lanes_match_plain_version(cuda, lanes):
    levels = build_hierarchy(elasticity_like_3d(8))
    mats = [levels[0].A, levels[1].P.transpose(), levels[1].A,
            poisson_3d(5)]
    rng = np.random.default_rng(lanes)
    for A in mats:
        for bs in (3, 4, 8, 16):
            blocks, cols, _ = ell.csr_to_block_ell(A, bs, cuda)
            ncb = -(-A.n_cols // bs)
            x = torch.from_numpy(rng.standard_normal(ncb * bs).astype(F32)
                                 ).to(cuda)
            for b, xx in ((blocks, x), (blocks.bfloat16(), x.bfloat16())):
                got = ell._spmv_block_ell_cuda(b, cols, xx, lanes)
                want = ell.spmv_block_ell_plain(b, cols, xx).float()
                scale = ell.spmv_block_ell_plain(b.float().abs(), cols,
                                                 xx.float().abs())
                tol = K3_RTOL * scale + (2 ** -8 * want.abs()
                                         if xx.dtype == torch.bfloat16 else 0)
                assert bool(((got.float() - want).abs() <= tol).all()), \
                    (A.shape, bs, lanes, xx.dtype)
