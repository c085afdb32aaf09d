"""Kernels K1 (fused segment reduce) and K2 (Fenwick queue walk) of the
PyTorch port against the JAX package's Pallas kernels.

On the CPU every wrapper takes its plain PyTorch version; those are held to
the Pallas kernels run in interpret mode (``backend="pallas"``) and to the
numpy references, on the same seeded inputs.  K1 is float32-allclose
(rtol 1e-4, atol 1e-6: atomics and chunked sums add in different orders),
K2 is integer work and bit-equal.  The CUDA kernels themselves are held to
the plain versions by the ``gpu`` test, which skips without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm.health import get_health  # noqa: E402
from repro.comm.primitives import batched_queue_traversal_steps  # noqa: E402
from repro.comm.primitives import \
    queue_traversal_steps as ref_oracle  # noqa: E402
from repro.kernels import comm_stack as ref_ks  # noqa: E402
from repro_torch.comm.primitives import queue_traversal_steps  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


def _segments(seed, n, n_seg, signed=False):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n) * 10.0
    if not signed:
        vals = np.abs(vals)
    ids = rng.integers(0, n_seg, n) if n else np.zeros(0, dtype=np.int64)
    return vals, ids


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a).astype(dtype))


def _pallas_segreduce(vals, ids, n_seg):
    out = ref_ks.fused_segment_reduce(vals, ids, n_seg)
    # device_guard falls back to numpy silently: prove Pallas served it
    assert get_health().n_events == 0
    return out


# -- K1 ----------------------------------------------------------------------
@pytest.mark.parametrize("n,n_seg,signed", [
    (0, 5, False), (1, 1, False), (7, 3, False), (513, 2, False),
    (2000, 300, False), (5000, 1, False), (7, 3, True)])
def test_segment_reduce_plain_matches_pallas(n, n_seg, signed):
    vals, ids = _segments(n * 31 + n_seg, n, n_seg, signed)
    want_s, want_m = _pallas_segreduce(vals, ids, n_seg)
    got_s, got_m = ks.segment_reduce(_t(vals, np.float32),
                                     _t(ids, np.int32), n_seg)
    assert got_s.dtype == got_m.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=RTOL, atol=ATOL)


def test_segment_reduce_empty_segments_report_zero():
    vals, ids = np.array([3.0]), np.array([2])
    want_s, want_m = _pallas_segreduce(vals, ids, 4)
    got_s, got_m = ks.segment_reduce(_t(vals, np.float32),
                                     _t(ids, np.int32), 4)
    np.testing.assert_array_equal(got_s.numpy(), [0.0, 0.0, 3.0, 0.0])
    np.testing.assert_array_equal(got_m.numpy(), [0.0, 0.0, 3.0, 0.0])
    np.testing.assert_allclose(got_s.numpy(), want_s)
    np.testing.assert_allclose(got_m.numpy(), want_m)


def test_segment_reduce_plain_matches_numpy_reference():
    vals, ids = _segments(3, 4000, 97)
    got_s, got_m = ks.segment_reduce_plain(_t(vals, np.float32),
                                           _t(ids, np.int32), 97)
    np.testing.assert_allclose(got_s.numpy(),
                               ref_ks._segment_sum_numpy(vals, ids, 97),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_m.numpy(),
                               ref_ks._segment_max_numpy(vals, ids, 97),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["id_high", "id_negative", "dtype", "shape"])
def test_segment_reduce_rejects_bad_input(bad):
    vals = torch.ones(4)
    ids = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    if bad == "id_high":
        ids[3] = 4
    elif bad == "id_negative":
        ids[0] = -1
    elif bad == "dtype":
        ids = ids.long()
    else:
        vals = torch.ones(5)
    with pytest.raises((ValueError, TypeError)):
        ks.segment_reduce(vals, ids, 4)


# -- K2 ----------------------------------------------------------------------
def _regions(seed, n_regions, max_count):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count + 1, n_regions)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    posted = [rng.permutation(c) for c in counts]
    arrival = [rng.permutation(c) for c in counts]
    cat = lambda xs: (np.concatenate(xs).astype(np.int64) if xs else
                      np.zeros(0, dtype=np.int64))
    return cat(posted), cat(arrival), bounds


def _walk(posted, arrival, bounds):
    return ks.queue_walk(*(torch.from_numpy(a) for a in
                           (posted, arrival, bounds))).numpy()


@pytest.mark.parametrize("n_regions,max_count", [(1, 1), (3, 0), (5, 9),
                                                 (40, 25), (2, 200)])
def test_queue_walk_plain_bit_equal_to_pallas_and_numpy(n_regions,
                                                        max_count):
    posted, arrival, bounds = _regions(n_regions * 1000 + max_count,
                                       n_regions, max_count)
    want = batched_queue_traversal_steps(posted, arrival, bounds)
    pallas = ref_ks.queue_walk(posted, arrival, bounds, backend="pallas")
    assert get_health().n_events == 0
    got = _walk(posted, arrival, bounds)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got, want)


def test_queue_walk_ragged_regions_match_scalar_oracle():
    # an empty region sandwiched between ragged ones
    posted = np.array([2, 0, 1, 0, 3, 1, 0, 2])
    arrival = np.array([1, 2, 0, 0, 2, 0, 3, 1])
    bounds = np.array([0, 3, 3, 4, 8])
    got = _walk(posted, arrival, bounds)
    regions = list(zip(bounds[:-1], bounds[1:]))
    want = np.concatenate([queue_traversal_steps(posted[a:b], arrival[a:b])
                           for a, b in regions])
    ref = np.concatenate([ref_oracle(posted[a:b], arrival[a:b])
                          for a, b in regions])
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(got, want)


def test_queue_walk_rejects_indices_outside_their_region():
    posted = torch.tensor([0, 1, 0, 1])
    arrival = torch.tensor([1, 0, 2, 0])     # 2 lies outside region 1
    bounds = torch.tensor([0, 2, 4])
    with pytest.raises(ValueError, match="outside its region"):
        ks.queue_walk(posted, arrival, bounds)


# -- the CUDA kernels ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    before = dict(ks.LAUNCHES)
    for n, n_seg, signed in ((0, 5, False), (1, 1, False), (513, 2, False),
                             (100_000, 3000, False), (100_000, 3000, True)):
        vals, ids = _segments(n, n, n_seg, signed)
        v, i = _t(vals, np.float32).to(cuda), _t(ids, np.int32).to(cuda)
        got = ks.segment_reduce(v, i, n_seg)
        want = ks.segment_reduce_plain(v, i, n_seg)
        if signed:     # cancellation: a sum's error scales with |values|
            scale = ks.segment_reduce_plain(v.abs(), i, n_seg)[0]
            assert bool(((got[0] - want[0]).abs()
                         <= ATOL + RTOL * scale).all())
        else:
            torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
        # a maximum does not depend on the order: exact
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    walks = 0                  # an empty walk (no arrivals) launches nothing
    for n_regions, max_count in ((1, 1), (40, 25), (2, 200), (3000, 60)):
        t = [torch.from_numpy(a).to(cuda)
             for a in _regions(n_regions, n_regions, max_count)]
        walks += t[0].numel() > 0
        assert torch.equal(ks.queue_walk(*t), ks.queue_walk_plain(*t))
    assert ks.LAUNCHES["segment_reduce"] == before["segment_reduce"] + 5
    assert ks.LAUNCHES["queue_walk"] == before["queue_walk"] + walks
