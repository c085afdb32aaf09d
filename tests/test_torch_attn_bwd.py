"""K4's backward: which path each input takes, the plain version and its
row statistics on the CPU, and the tensor-core kernels against autograd of
the plain forward on the card.

Bounds, each named where it is held:

* ``flash_attention_backward_plain`` bit-equal to the backward as it was
  before the kernels (float32 torch ops, one block of queries at a time);
* the plain row statistics: ``lse`` within 1e-5 relative of
  ``torch.logsumexp`` of the scaled, masked scores (a running max and sum
  over blocks of keys, the same terms in another order) and ``delta``
  equal to ``rowsum(dO * O)``;
* on the card (``K4_BF16_RTOL``): each of the kernels' dq, dk and dv
  within 2^-6 of the largest entry of ``torch.autograd`` of
  ``flash_attention_plain`` on the same bf16 inputs.  The kernels round P
  and dS to bf16 before their products (2^-9 of each term, the reference's
  own rounding in its bf16 einsums), each gradient is rounded to bf16 on
  both sides (2^-9 of an entry), ``delta`` reads the forward's bf16 output
  (whose P was rounded to bf16); the terms' rounding errors add as a
  random walk, well inside 2^-6 of the largest entry (0.003-0.008 measured
  on an H100).  ``lse`` within 2^-16 absolute of the plain row statistics:
  both sum float32 terms, in another order, the kernel's from
  ``ex2.approx`` (2^-22 relative a term);
* dq, dk and dv bit-equal between two calls (no atomics: every sum runs
  in a fixed order).

This file imports no JAX: its card tests run on a host without it.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

K4_BF16_RTOL = 2.0 ** -6
LSE_ATOL = 2.0 ** -16
STATS_RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def rel_max(a, b) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    err = float((a.float() - b.float()).abs().max())
    return err / float(b.float().abs().max()) if err else 0.0


def qkv(rng, B, S, H, KH, D, dtype=torch.float32):
    """Seeded ``(q, k, v, dout)`` of one attention, numpy-drawn."""
    return tuple(torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
        np.float32)).to(dtype) for h in (H, KH, KH, H))


def spans_module():
    """The benchmark's ``bench/harness/spans.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "bench_harness_spans", ROOT / "bench" / "harness" / "spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- which path each input takes ------------------------------------------------
@pytest.mark.parametrize("device,dtype,kernel", [
    ("cuda", torch.bfloat16, True), ("cuda", torch.float32, False),
    ("cpu", torch.bfloat16, False), ("cpu", torch.float32, False),
    ("meta", torch.bfloat16, False), ("meta", torch.float32, False)])
def test_backward_path_follows_device_and_dtype(monkeypatch, device, dtype,
                                                kernel):
    def stub(*args):
        raise AssertionError("the kernels' entry was called")

    monkeypatch.setattr(fa, "_flash_attention_backward_cuda", stub)
    want = stub if kernel else fa.flash_attention_backward_plain
    q = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert fa._backward_entry(q) is want


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_off_the_card_is_the_plain_version(monkeypatch, device,
                                                    dtype):
    def stub(*args):
        raise AssertionError("the kernels' entry was called")

    monkeypatch.setattr(fa, "_flash_attention_backward_cuda", stub)
    q, k, v, dout = (t.to(device) for t in qkv(np.random.default_rng(1),
                                               2, 19, 4, 2, 16, dtype))
    out = fa.flash_attention_plain(q, k, v)
    got = fa.flash_attention_backward(q, k, v, out, dout)
    want = fa.flash_attention_backward_plain(q, k, v, out, dout)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert g.device.type == device
        if device == "cpu":
            assert torch.equal(g, w)


# -- the plain version ------------------------------------------------------------
def _backward_as_before(q, k, v, out, dout, causal=True):
    """The backward as it stood before K4's backward kernels, for every
    input: float32 torch ops, one block of ``backward_rows`` queries."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    rep = H // KH
    scale = 1.0 / D ** 0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty(B, S, H, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, S, KH, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    delta = (dout.float() * out.float()).sum(-1).reshape(
        B, S, KH, rep).permute(0, 2, 3, 1)
    rows = fa.backward_rows(B, H, S)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        ke = s1 if causal else S
        qb = q[:, s0:s1].float().reshape(B, s1 - s0, KH, rep, D)
        dob = dout[:, s0:s1].float().reshape(B, s1 - s0, KH, rep, D)
        kb, vb = kf[:, :ke], vf[:, :ke]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qb, kb) * scale
        if causal:
            s = s.masked_fill(pos[s0:s1, None] < pos[None, :ke], fa.NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv[:, :ke] += torch.einsum("bhrqk,bqhrd->bkhd", p, dob)
        ds = torch.einsum("bqhrd,bkhd->bhrqk", dob, vb)
        ds = p * (ds - delta[..., s0:s1, None])
        dq[:, s0:s1] = torch.einsum("bhrqk,bkhd->bqhrd", ds, kb).reshape(
            B, s1 - s0, H, D) * scale
        dk[:, :ke] += torch.einsum("bhrqk,bqhrd->bkhd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_is_bit_equal_to_the_torch_op_backward(
        monkeypatch, causal, rep, dtype):
    rng = np.random.default_rng(rep + 10 * causal)
    q, k, v, dout = qkv(rng, 2, 41, 2 * rep, 2, 16, dtype)
    out = fa.flash_attention_plain(q, k, v, causal)
    # blocks of 7 rows, the last ragged
    monkeypatch.setattr(fa, "BACKWARD_BLOCK_ELEMS", 2 * 2 * rep * 41 * 7)
    got = fa.flash_attention_backward_plain(q, k, v, out, dout, causal)
    for g, w in zip(got, _backward_as_before(q, k, v, out, dout, causal)):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("S,block", [(37, None), (64, None), (50, 3)])
@pytest.mark.parametrize("rep", [1, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_row_stats_are_the_logsumexp_and_rowsum(monkeypatch, causal,
                                                      rep, S, block):
    rng = np.random.default_rng(S + rep)
    B, KH, D = 2, 2, 16
    H = KH * rep
    q, k, v, dout = qkv(rng, B, S, H, KH, D)
    if block:  # blocks of `block` keys, the last ragged
        monkeypatch.setattr(fa, "BACKWARD_BLOCK_ELEMS", B * H * S * block)
        assert fa.backward_rows(B, H, S) == block
    out = fa.flash_attention_plain(q, k, v, causal)
    lse, delta = fa.backward_row_stats_plain(q, k, out, dout, causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(rep, dim=2)) / D ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=STATS_RTOL,
                               atol=0)
    assert torch.equal(delta, (dout * out).sum(-1).permute(0, 2, 1))


def test_the_benchmark_span_records_the_backward_on_the_cpu():
    spans = spans_module()
    q, k, v, dout = (t.requires_grad_(i < 3) for i, t in enumerate(
        qkv(np.random.default_rng(3), 2, 24, 4, 2, 16)))
    calls = spans.Calls()
    with spans.installed(calls):
        calls.on = True
        torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), dout)
    assert calls.shapes["bench.attn_bwd"] == [(2, 24, 4, 2, 16, True)]


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_inputs(B, S, H, KH, D, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, S, h, D, generator=gen, device="cuda")
                 .bfloat16() for h in (H, KH, KH, H))


def check_against_plain(q, k, v, dout, causal):
    """The kernels' (dq, dk, dv, lse) against autograd of the plain forward
    and the plain row statistics; returns the kernels' gradients."""
    out = fa._flash_attention_cuda(q, k, v, causal)
    dq, dk, dv, lse, delta = fa._backward_launch(q, k, v, out, dout, causal)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*leaves, causal),
                               leaves, dout)
    for g, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(torch.isfinite(g).all()), name
        assert rel_max(g, w) <= K4_BF16_RTOL, (name, rel_max(g, w))
    lse_w, delta_w = fa.backward_row_stats_plain(q, k, out, dout, causal)
    torch.testing.assert_close(lse, lse_w, rtol=0, atol=LSE_ATOL)
    assert rel_max(delta, delta_w) <= STATS_RTOL
    return dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", [64, 1000, 4096])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 5])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_kernels_match_autograd_of_plain(cuda, D, rep, causal, S, B):
    q, k, v, dout = card_inputs(B, S, 2 * rep, 2, D, S + D + rep)
    check_against_plain(q, k, v, dout, causal)


@pytest.mark.gpu
def test_hymba_training_shape_launches_the_kernels_once_a_backward(cuda):
    B, S, H, KH, D = 2, 4096, 25, 5, 64
    q, k, v, dout = card_inputs(B, S, H, KH, D, 0)
    dq, dk, dv = check_against_plain(q, k, v, dout, True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    got = torch.autograd.grad(ops.flash_attention(*leaves), leaves, dout)
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert fa.LAUNCHES["flash_attention_tc"] == \
        before["flash_attention_tc"] + 1
    assert all(torch.equal(g, w) for g, w in zip(got, (dq, dk, dv)))


@pytest.mark.gpu
def test_the_benchmark_span_records_the_kernels_calls(cuda):
    from torch.profiler import ProfilerActivity, profile

    spans = spans_module()
    q, k, v, dout = card_inputs(2, 300, 10, 2, 128, 7)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    calls = spans.Calls()
    before = fa.LAUNCHES["flash_attention_bwd"]
    with spans.installed(calls), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls.on = True
        torch.autograd.grad(ops.flash_attention(*leaves, causal=False),
                            leaves, dout)
        torch.cuda.synchronize()
    assert calls.shapes["bench.attn_bwd"] == [(2, 300, 10, 2, 128, False)]
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    # the kernels book to the operator inside the span, so the span's
    # device time (what attn_bwd_roofline.train reads) holds them
    host = [e for e in prof.events() if e.name == "bench.attn_bwd"
            and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(host) == 1 and host[0].device_time_total > 0


def test_the_backward_operator_has_no_cpu_kernel():
    t = torch.zeros(1, 64, 2, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 64, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.flash_attention_bwd(
            t, kv, kv, t, t, t.clone(), kv.clone(), kv.clone(),
            torch.zeros(1, 2, 64), torch.zeros(1, 2, 64), True)
