"""The per-layer metrics read from the program's own recorder
(``repro_torch.obs``): their values on a stubbed snapshot, None without a
trace, without the span or counter, or without the recorder (a program
that predates it), and a traced smoke run on the CPU, where the counters
read and the spans, which have no device times there, do not."""
import sys
import time
import types

import pytest

from conftest import smoke_cell
from harness import cli, manifest

from repro_torch import obs

SPAN_METRICS = {
    "ssm_ms_per_ktok.prefill": ("hymba-1.5b.prefill-long",
                                ("repro_torch.ssm",)),
    "ssd_inter_ms_per_ktok.prefill": ("hymba-1.5b.prefill-long",
                                      ("repro_torch.ssd_inter",)),
    "moe_shuffle_ms_per_ktok.prefill": (
        "deepseek-moe-16b.prefill-chat",
        ("repro_torch.moe.route", "repro_torch.moe.dispatch",
         "repro_torch.moe.combine")),
}
STEPS = [(8, 2048), (4, 4096), (2, 8192)]          # 49,152 tokens


def _reader(metric: str, cell: str):
    return manifest.metric_reader(manifest.load_cell(cell), metric)


def _run(steps=STEPS):
    return types.SimpleNamespace(trace=types.SimpleNamespace(steps=steps))


def _span(name: str, i: int, device_ms=None):
    start = 1_000_000 * i
    return obs.Span(name, i, None, None, 1, start, start + 10, {},
                    device=None if device_ms is None else 0,
                    device_start_ns=None if device_ms is None else start,
                    device_end_ns=None if device_ms is None
                    else start + round(device_ms * 1e6))


def _stub(monkeypatch, spans=(), counters=None):
    snap = obs.Snapshot(tuple(spans), dict(counters or {}), {}, 0)
    monkeypatch.setattr(obs, "snapshot", lambda: snap)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_is_device_ms_per_thousand_tokens(monkeypatch, metric):
    cell, names = SPAN_METRICS[metric]
    spans = [_span(n, 10 * i + j, 1.5 + j)
             for i in range(3) for j, n in enumerate(names)]
    spans.append(_span("repro_torch.layer", 99, 1000.0))     # not read
    _stub(monkeypatch, spans)
    want_ms = 3 * sum(1.5 + j for j in range(len(names)))
    got = _reader(metric, cell)(_run())
    assert got == pytest.approx(want_ms / 49.152, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_is_none_without_trace_span_or_device_times(
        monkeypatch, metric):
    cell, names = SPAN_METRICS[metric]
    read = _reader(metric, cell)
    _stub(monkeypatch, [_span(names[0], 1, 2.0)])
    assert read(types.SimpleNamespace(trace=None)) is None
    _stub(monkeypatch, [_span("repro_torch.layer", 1, 2.0)])
    assert read(_run()) is None
    _stub(monkeypatch, [_span(n, i) for i, n in enumerate(names)])
    assert read(_run()) is None                   # recorded on the CPU


def test_slot_fill_is_kept_over_slots(monkeypatch):
    read = _reader("moe_slot_fill.prefill", "deepseek-moe-16b.prefill-chat")
    _stub(monkeypatch, counters={"moe.assignments": 98304 * 27,
                                 "moe.slots": 123392 * 27,
                                 "moe.kept": 90000 * 27})
    assert read(_run()) == pytest.approx(100 * 90000 / 123392, rel=1e-12)
    assert read(types.SimpleNamespace(trace=None)) is None
    _stub(monkeypatch, counters={})
    assert read(_run()) is None
    _stub(monkeypatch, counters={"moe.slots": 0, "moe.kept": 0})
    assert read(_run()) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS) +
                         ["moe_slot_fill.prefill"])
def test_every_reader_is_none_where_the_program_has_no_recorder(
        monkeypatch, metric):
    cell = SPAN_METRICS.get(metric, ("deepseek-moe-16b.prefill-chat",))[0]
    read = _reader(metric, cell)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "obs")
    assert read(_run()) is None


def test_traced_smoke_run_reads_the_slot_fill_from_the_program():
    obs.reset()
    out = cli.run_cell(smoke_cell("deepseek-moe-16b.prefill-chat"), 5, 0.3,
                       True, "cpu", time.time())
    assert out.result["correct"]
    metrics = out.result["metrics"]
    assert 0 < metrics["moe_slot_fill.prefill"]["value"] <= 100
    # spans record on the CPU, but without device times no span metric
    assert "moe_shuffle_ms_per_ktok.prefill" not in metrics
    snap = obs.snapshot()
    assert snap.named("repro_torch.moe.route") and snap.steps >= 1
    assert snap.counters["moe.kept"] <= snap.counters["moe.assignments"]
    obs.reset()
