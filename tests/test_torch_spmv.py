"""Kernel K3 (block-ELL SpMV) and the AMG V-cycle of the PyTorch port
against the JAX package.

On the CPU the SpMV wrapper takes its plain PyTorch version; it is held to
``repro``'s Pallas kernel run in interpret mode at the reference's own
tolerances (float32 rtol/atol 1e-5, bfloat16 0.05).  The conversion into
block-ELL is bit-equal to the reference's, the host SpMV equal at rtol
1e-12, and the float32 V-cycle within 1e-5 relative L2 of the float64
reference (the gap measured on these problems is about 1.5e-7).  The CUDA
kernel itself is held to the plain version by the ``gpu`` test, which skips
without a card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.spmv_ell import \
    csr_to_block_ell as ref_to_ell  # noqa: E402
from repro.kernels.spmv_ell import spmv_block_ell as ref_spmv  # noqa: E402
from repro.sparse import CSR as RefCSR  # noqa: E402
from repro.sparse import build_hierarchy as ref_hierarchy  # noqa: E402
from repro.sparse import diag as ref_diag  # noqa: E402
from repro.sparse import elasticity_like_3d as ref_elasticity  # noqa: E402
from repro.sparse import eye as ref_eye  # noqa: E402
from repro.sparse import poisson_3d as ref_poisson  # noqa: E402
from repro.sparse import vcycle as ref_vcycle  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spmv_ell as ell  # noqa: E402
from repro_torch.sparse import (CSR, DeviceHierarchy, build_hierarchy,  # noqa: E402
                                diag, elasticity_like_3d, eye, poisson_3d,
                                vcycle)

BLOCK_SIZES = [4, 8, 16]


def _port(A: RefCSR) -> CSR:
    return CSR(A.indptr.copy(), A.indices.copy(), A.data.copy(), A.shape)


@functools.cache
def _matrix(name: str) -> RefCSR:
    """The reference matrices of these tests, by name."""
    if name == "poisson_3d(6)":
        return ref_poisson(6)
    if name == "elasticity_like_3d(4)":
        return ref_elasticity(4)
    if name in ("P", "P^T"):
        P = ref_hierarchy(ref_elasticity(4))[1].P        # 192 x 24
        return P if name == "P" else P.transpose()
    rng = np.random.default_rng(7)
    if name == "empty rows":                             # 37 x 29, ragged
        dense = rng.standard_normal((37, 29)) * (rng.random((37, 29)) < 0.2)
        dense[[0, 5, 6, 7, 20, 36]] = 0.0
    else:                                                # "all zero"
        dense = np.zeros((21, 13))
    r, c = np.nonzero(dense)
    return RefCSR.from_coo(r, c, dense[r, c], dense.shape)


MATRICES = ["poisson_3d(6)", "elasticity_like_3d(4)", "P", "P^T",
            "empty rows", "all zero"]


def _x(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# -- conversion ----------------------------------------------------------------
@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("name", MATRICES)
def test_csr_to_block_ell_is_bit_equal_to_reference(name, bs):
    A = _matrix(name)
    want_b, want_c, want_m = ref_to_ell(A, bs=bs)
    blocks, cols, max_bpr = ell.csr_to_block_ell(_port(A), bs=bs,
                                                 device="cpu")
    assert max_bpr == want_m
    assert blocks.dtype == torch.float32 and cols.dtype == torch.int32
    assert tuple(blocks.shape) == want_b.shape
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(blocks.numpy().view(np.uint32),
                                  np.asarray(want_b).view(np.uint32))


def test_ops_exports_the_spmv_entry_points_only():
    # since K4 and K5 were ported, the SpMV entries stand beside theirs:
    # the same public entry points as the reference's kernels.ops
    from repro.kernels import ops as ref_ops
    assert sorted(ops.__all__) == sorted(ref_ops.__all__)
    assert {"spmv_block_ell", "csr_to_block_ell"} <= set(ops.__all__)
    blocks, cols, max_bpr = ops.csr_to_block_ell(_port(_matrix("all zero")),
                                                 bs=8, device="cpu")
    assert max_bpr == 0
    assert tuple(blocks.shape) == (3, 0, 8, 8) and tuple(cols.shape) == (3, 0)
    x = torch.zeros(16)
    assert ops.spmv_block_ell(blocks, cols, x).tolist() == [0.0] * 24


# -- SpMV ----------------------------------------------------------------------
def _both(name, bs, seed, bf16=False):
    """(port tensors, reference arrays) of one SpMV on matrix ``name``,
    with x drawn for every padded column; float32, or bfloat16 blocks and
    x with ``bf16``."""
    A = _matrix(name)
    rb, rc, _ = ref_to_ell(A, bs=bs)
    x = _x(-(-A.n_cols // bs) * bs, seed)
    blocks, cols, _ = ell.csr_to_block_ell(_port(A), bs=bs, device="cpu")
    if not bf16:
        return (blocks, cols, torch.from_numpy(x)), (rb, rc, jnp.asarray(x))
    return ((blocks.to(torch.bfloat16), cols,
             torch.from_numpy(x).to(torch.bfloat16)),
            (rb.astype(jnp.bfloat16), rc, jnp.asarray(x, jnp.bfloat16)))


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("name", MATRICES[:5])
def test_spmv_plain_matches_pallas_float32(name, bs):
    (blocks, cols, x), ref_args = _both(name, bs, seed=bs)
    y = ell.spmv_block_ell(blocks, cols, x)
    want = ref_spmv(*ref_args, interpret=True)
    assert y.dtype == torch.float32 and y.shape == (blocks.shape[0] * bs,)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["poisson_3d(6)", "elasticity_like_3d(4)",
                                  "P^T"])
def test_spmv_plain_matches_pallas_bfloat16(name):
    (blocks, cols, x), ref_args = _both(name, 8, seed=3, bf16=True)
    y = ell.spmv_block_ell(blocks, cols, x)
    want = ref_spmv(*ref_args, interpret=True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


def test_spmv_mixed_dtypes_match_reference_oracle():
    (blocks, cols, x), (rb, rc, rx) = _both("P", 4, seed=5)
    y = ell.spmv_block_ell(blocks, cols, x.to(torch.bfloat16))
    want = ref_oracles.spmv_block_ell_ref(rb, rc, rx.astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


def test_spmv_with_no_slots_gives_zeros():
    (blocks, cols, x), (rb, rc, rx) = _both("all zero", 8, seed=1)
    y = ell.spmv_block_ell(blocks, cols, x)
    np.testing.assert_array_equal(y.numpy(), np.zeros(24, np.float32))
    np.testing.assert_array_equal(
        np.asarray(ref_oracles.spmv_block_ell_ref(rb, rc, rx)), y.numpy())


def test_spmv_matches_host_csr_on_real_rows():
    A = _matrix("elasticity_like_3d(4)")
    blocks, cols, _ = ell.csr_to_block_ell(_port(A), bs=8, device="cpu")
    x = np.zeros(blocks.shape[0] * 8)
    x[:A.n_rows] = _x(A.n_rows, 11)
    y = ell.spmv_block_ell(blocks, cols, torch.from_numpy(x).float())
    np.testing.assert_allclose(y[:A.n_rows].numpy(), _port(A).spmv(x[:A.n_rows]),
                               rtol=1e-4, atol=1e-4)
    assert not y[A.n_rows:].any()


def test_cpu_spmv_launches_no_kernel():
    (blocks, cols, x), _ = _both("P", 8, seed=2)
    before = ell.LAUNCHES["spmv_block_ell"]
    ell.spmv_block_ell(blocks, cols, x)
    assert ell.LAUNCHES["spmv_block_ell"] == before


def _bad_inputs(case):
    (blocks, cols, x), _ = _both("P", 4, seed=0)
    if case == "cols int64":
        return blocks, cols.long(), x
    if case == "blocks float64":
        return blocks.double(), cols, x
    if case == "x float16":
        return blocks, cols, x.half()
    if case == "blocks not square":
        return blocks[..., :3].contiguous(), cols, x
    if case == "cols shape":
        return blocks, cols[:, :1].contiguous(), x
    if case == "x length":
        return blocks, cols, x[:-1].contiguous()
    if case == "x 2-D":
        return blocks, cols, x.reshape(-1, 4)
    if case == "col past ncb":
        return blocks, cols, x[:-4].contiguous()
    if case == "negative col":
        cols = cols.clone()
        cols[0, 0] = -1
        return blocks, cols, x
    if case == "x not contiguous":
        return blocks, cols, torch.stack([x, x], 1)[:, 0]
    if case == "x on meta":
        return blocks, cols, x.to("meta")
    return blocks, cols, x.numpy()                       # "x not a tensor"


@pytest.mark.parametrize("case", [
    "cols int64", "blocks float64", "x float16", "blocks not square",
    "cols shape", "x length", "x 2-D", "col past ncb", "negative col",
    "x not contiguous", "x on meta", "x not a tensor"])
def test_spmv_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        ell.spmv_block_ell(*_bad_inputs(case))


# -- host CSR API --------------------------------------------------------------
@pytest.mark.parametrize("name", MATRICES)
def test_host_spmv_and_csr_api_match_reference(name):
    A = _matrix(name)
    B = _port(A)
    x = np.random.default_rng(4).standard_normal(A.n_cols)
    np.testing.assert_allclose(B.spmv(x), A.spmv(x), rtol=1e-12, atol=0)
    np.testing.assert_allclose(B @ x, A @ x, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(B.to_dense(), A.to_dense())
    s = np.arange(1.0, A.n_rows + 1)
    np.testing.assert_array_equal(B.scale_rows(s).data, A.scale_rows(s).data)
    for i in (0, A.n_rows - 1):
        for got, want in zip(B.row(i), A.row(i)):
            np.testing.assert_array_equal(got, want)
    C = B.copy()
    C.data[:] = 0.0
    np.testing.assert_array_equal(B.data, A.data)
    G, R = B @ _port(A.transpose()), A @ A.transpose()
    np.testing.assert_array_equal(G.indptr, R.indptr)
    np.testing.assert_allclose(G.data, R.data, rtol=1e-12)


def test_eye_and_diag_match_reference():
    d = np.array([2.0, -1.0, 0.5])
    for got, want in ((eye(4), ref_eye(4)), (diag(d), ref_diag(d))):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.to_dense(), want.to_dense())


# -- the V-cycle ---------------------------------------------------------------
PROBLEMS = {"elasticity_like_3d(8)": (elasticity_like_3d, ref_elasticity, 8),
            "poisson_3d(6)": (poisson_3d, ref_poisson, 6)}


@functools.cache
def _hierarchies(problem: str):
    port_fn, ref_fn, nx = PROBLEMS[problem]
    return build_hierarchy(port_fn(nx)), ref_hierarchy(ref_fn(nx))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_vcycle_on_cpu_matches_reference(problem):
    levels, ref_levels = _hierarchies(problem)
    b = np.random.default_rng(0).standard_normal(levels[0].A.n_rows)
    x = vcycle(levels, b, device="cpu")
    assert x.dtype == torch.float32 and x.shape == b.shape
    assert _rel(x.double().numpy(), ref_vcycle(ref_levels, b)) < 1e-5
    # a second cycle from a given start, on a hierarchy built once
    h = DeviceHierarchy.build(levels, device="cpu")
    x2 = vcycle(h, b, x)
    want = ref_vcycle(ref_levels, b, x.double().numpy())
    assert _rel(x2.double().numpy(), want) < 1e-5


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_ten_vcycles_converge(problem):
    levels, _ = _hierarchies(problem)
    A = levels[0].A
    h = DeviceHierarchy.build(levels, device="cpu")
    b = np.random.default_rng(0).standard_normal(A.n_rows)
    x = None
    for _ in range(10):
        x = vcycle(h, b, x)
    res = np.linalg.norm(b - A.spmv(x.double().numpy()))
    assert res < 1e-3 * np.linalg.norm(b)


def test_vcycle_runs_every_spmv_through_the_wrapper(monkeypatch):
    levels, _ = _hierarchies("elasticity_like_3d(8)")
    h = DeviceHierarchy.build(levels, device="cpu")
    calls = []
    real = ell.spmv_block_ell

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(ell, "spmv_block_ell", spy)
    vcycle(h, np.ones(levels[0].A.n_rows))
    # 2 + 1 + 2 smoother/residual SpMVs and P^T, P per non-coarsest level,
    # 50 sweeps on the coarsest
    assert len(calls) == 7 * (len(levels) - 1) + 50


def test_device_hierarchy_layout():
    levels, ref_levels = _hierarchies("elasticity_like_3d(8)")
    h = DeviceHierarchy.build(levels, bs=8, device="cpu")
    assert len(h.levels) == len(levels) and h.levels[0].P is None
    for lv, host, ref in zip(h.levels, levels, ref_levels):
        n = host.A.n_rows
        assert lv.n == n and lv.dinv.numel() == -(-n // 8) * 8
        np.testing.assert_allclose(lv.dinv[:n].numpy(),
                                   1.0 / ref.A.diagonal(), rtol=1e-7)
        assert not lv.dinv[n:].any()
        want_b, want_c, _ = ref_to_ell(ref.A, bs=8)
        np.testing.assert_array_equal(lv.A[0].numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(lv.A[1].numpy(), np.asarray(want_c))
        if ref.P is not None:
            want_b, want_c, _ = ref_to_ell(ref.P.transpose(), bs=8)
            np.testing.assert_array_equal(lv.PT[0].numpy(),
                                          np.asarray(want_b))
            np.testing.assert_array_equal(lv.PT[1].numpy(),
                                          np.asarray(want_c))
    moved = h.to("cpu")
    assert moved.levels[1].P[0].data_ptr() == h.levels[1].P[0].data_ptr()


def test_vcycle_rejects_a_wrong_length_or_device():
    levels, _ = _hierarchies("poisson_3d(6)")
    h = DeviceHierarchy.build(levels, device="cpu")
    with pytest.raises(ValueError, match="entries"):
        vcycle(h, np.ones(levels[0].A.n_rows + 1))
    with pytest.raises(ValueError, match="lies on"):
        vcycle(h, np.ones(levels[0].A.n_rows), device="cuda")


# -- the CUDA kernel -----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_spmv_matches_plain_version(cuda):
    before = ell.LAUNCHES["spmv_block_ell"]
    launches = 0
    for name in MATRICES:
        for bs in BLOCK_SIZES:
            for dtype in (torch.float32, torch.bfloat16):
                (blocks, cols, x), _ = _both(name, bs, seed=bs)
                args = (blocks.to(cuda, dtype), cols.to(cuda),
                        x.to(cuda, dtype))
                got = ell.spmv_block_ell(*args)
                want = ell.spmv_block_ell_plain(*args)
                tol = 1e-5 if dtype == torch.float32 else 0.05
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                launches += got.numel() > 0
    assert ell.LAUNCHES["spmv_block_ell"] == before + launches
