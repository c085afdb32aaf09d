"""The counts of bench/counts against hand counts at small shapes."""
import pytest

import counts
from counts import model as cm
from counts import ops
from conftest import SMOKE
from harness import manifest


def _config(name, smoke=True):
    import json
    cell = next(c for c in manifest.load_manifest()["configs"]
                if c["name"] == name)
    c = json.loads((manifest.BENCH.parent / cell["file"]).read_text())
    return dict(c, **SMOKE[name]) if smoke else c


def test_attention_forward_by_hand():
    # B 1, S 3, H 2, KH 1, D 4: causal pairs 1 + 2 + 3 = 6 a head,
    # 2 products of 2 D FLOPs a pair
    flops, moved = ops.attention_fwd(1, 3, 2, 1, 4)
    assert flops == 2 * 6 * 2 * 2 * 4
    # q and o: 3 x 2 x 4 each, k and v: 3 x 1 x 4 each, bf16
    assert moved == 2 * (2 * 24 + 2 * 12)
    assert ops.attention_fwd(1, 3, 2, 1, 4, causal=False)[0] \
        == 2 * 9 * 2 * 2 * 4


def test_attention_backward_is_four_products():
    f, _ = ops.attention_fwd(2, 5, 4, 2, 8)
    fb, mb = ops.attention_bwd(2, 5, 4, 2, 8)
    assert fb == 2 * f
    assert mb == 2 * (4 * 2 * 5 * 4 * 8 + 4 * 2 * 5 * 2 * 8)


def _ssd_flops_by_loops(G1, h, q, n, p):
    """Multiply-adds of the naive loops, two FLOPs each."""
    fl = 0
    for _ in range(G1):
        for i in range(q):
            for j in range(i + 1):
                fl += 2 * n                 # C_i . B_j, once a (batch, chunk)
        for _ in range(h):
            for i in range(q):
                for j in range(i + 1):
                    fl += 2 * p             # scores_ij dtx_j
            fl += 2 * q * n * p             # S_c = B^T (decay * dtx)
    return fl


@pytest.mark.parametrize("shape", [(1, 1, 4, 2, 3), (2, 3, 5, 4, 2)])
def test_ssd_intra_flops_by_loops(shape):
    assert ops.ssd_intra(*shape)[0] == _ssd_flops_by_loops(*shape)


def test_ssd_intra_bytes_by_hand():
    G1, h, q, n, p = 2, 3, 4, 5, 6
    moved = ops.ssd_intra(G1, h, q, n, p)[1]
    # dtx in, y out: G q p each; cumA G q; B, C: G1 q n each; S_c G n p
    assert moved == 4 * (2 * 6 * 4 * 6 + 6 * 4 + 2 * 2 * 4 * 5 + 6 * 5 * 6)


def test_least_seconds_takes_the_larger_bound():
    assert ops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert ops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert ops.least_seconds(495e12, 1.0, "tf32") == pytest.approx(1.0)


def test_hybrid_matmul_params_equal_the_port_model():
    from repro_torch.nn.model import abstract_params
    from harness.weights import arch_config

    c = _config("hymba-1.5b")
    model = abstract_params(arch_config(c))
    want = sum(p.numel() for n, p in model.named_parameters()
               if n.startswith("layers.") and p.dim() >= 2)
    assert cm.layer_matmul_params(c) == want


def test_moe_active_params_by_hand():
    c = _config("deepseek-moe-16b")
    d, f, ff = 64, 32, 128
    attn = 2 * d * 64 + 2 * d * 64      # 4 heads and 4 kv heads of 16
    moe = d * 8 + (2 + 1) * 3 * d * f   # router, top-2 plus 1 shared
    dense = attn + 3 * d * ff
    assert cm.layer_matmul_params(c) == 2 * (attn + moe) + dense


def test_published_sizes():
    hy = cm.layer_matmul_params(_config("hymba-1.5b", smoke=False))
    ds = cm.layer_matmul_params(_config("deepseek-moe-16b", smoke=False))
    # the port's hymba: every layer with its own attention and mixer
    assert 1.5e9 < hy < 1.6e9
    assert 2.3e9 < ds < 2.5e9        # the paper's 2.8 B active less 0.42 B


def test_prefill_and_train_flops_by_hand():
    c = dict(_config("hymba-1.5b"), n_layers=1)
    N = cm.layer_matmul_params(c)
    B, S, H, D = 2, 8, 4, 16
    attn = B * H * (S * (S + 1) // 2) * 4 * D
    assert counts.prefill_flops(c, B, S) == 2 * B * S * N + attn \
        + 2 * B * 64 * 256
    assert counts.train_flops(c, B, S) == 3 * (2 * B * S * N + attn
                                               + 2 * B * S * 64 * 256)


def test_union_counts_overlap_once():
    from harness.trace import gaps_within, union
    merged = union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert merged == [(0, 3), (5, 6)]
    assert list(gaps_within(merged, -1, 7)) == [(-1, 0), (3, 5), (6, 7)]


def test_idle_gaps_named_by_the_innermost_open_span():
    from harness.trace import name_gaps
    spans = sorted([(0, 10, "bench.step"), (2, 4, "bench.layer"),
                    (6, 9, "bench.read")])
    got = name_gaps([(1, 1.5), (3, 3.5), (7, 8), (11, 12)], spans)
    assert got == {"bench.step": 0.5, "bench.layer": 0.5, "bench.read": 1,
                   "bench.stretch": 1}


class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _Event:
    """The fields of a profiler event that the trace reduction reads."""

    def __init__(self, name, kind, a, b, device_total=0.0, note=False):
        from torch.autograd import DeviceType
        self.name, self.time_range = name, _Range(a, b)
        self.device_type = DeviceType.CUDA if kind == "cuda" \
            else DeviceType.CPU
        self.device_time_total = device_total
        self.is_user_annotation = note


def test_trace_counts_a_span_once_and_the_union_of_activity():
    from harness.trace import summarize
    events = [
        _Event("bench.stretch", "cpu", 0, 100),
        _Event("bench.attn_core", "cpu", 10, 20, device_total=30.0),
        # the profiler's device-side copy of the span: no activity, no span
        _Event("bench.attn_core", "cuda", 40, 70, note=True),
        _Event("k4", "cuda", 40, 70),
        _Event("gemm", "cuda", 60, 80),
    ]
    t = summarize(events, {"bench.attn_core": [(1, 8, 2, 1, 64, True)]},
                  [(1, 8)])
    assert t.device_s("bench.attn_core") == 30.0 / 1e6
    assert t.busy_s == 40 / 1e6 and t.window_s == 100 / 1e6
    assert dict(t.device_ops) == {"k4": 30 / 1e6, "gemm": 20 / 1e6}
    assert sum(v for _, v in t.idle_gaps) == pytest.approx(60 / 1e6)
