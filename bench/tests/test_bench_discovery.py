"""The harness finds a configuration, a traffic mix, a metric and a cell's
limits by name: a throwaway set of them in a temporary directory runs with
no file of the benchmark edited."""
import json
import shutil
import time

from conftest import SMOKE, SMOKE_TRAFFIC
from harness import cli, manifest


def test_a_new_cell_is_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (bench / sub).mkdir(parents=True)
    conf = json.loads((manifest.BENCH / "configs" / "hymba-1.5b.json")
                      .read_text())
    conf = dict(conf, arch="tiny-hybrid", **SMOKE["hymba-1.5b"])
    (bench / "configs" / "tiny-hybrid.json").write_text(json.dumps(conf))
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(
        dict(SMOKE_TRAFFIC["prefill_closed"], driver="prefill_closed")))
    (bench / "limits" / "tiny-hybrid.tiny-mix.json").write_text(json.dumps(
        {"token_gap": 1.0, "logits_rel": 0.1, "cache_rel": 0.1}))
    (bench / "metrics" / "steps_seen.count.py").write_text(
        "def read(run):\n    return len(run.window.steps)\n")
    spec = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"],
        "run_seconds": 10,
        "configs": [{"name": "tiny-hybrid", "source": "test",
                     "file": "bench/configs/tiny-hybrid.json", "reduced": [],
                     "why": "test"}],
        "workloads": [{"name": "tiny-hybrid.tiny-mix",
                       "config": "tiny-hybrid", "traffic": "tiny-mix",
                       "chips": 1, "why": "test"}],
        "end_to_end": [
            {"name": "prefill_tokens_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "steps_seen.count", "unit": "steps", "better": "higher",
             "source": "program_counter", "layer": "test",
             "moves": "prefill_tokens_per_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p: p.read_bytes() for p in manifest.BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}

    cell = manifest.load_cell("tiny-hybrid.tiny-mix",
                              tmp_path / "BENCHMARK.json")
    assert cell.bench == bench and cell.config["arch"] == "tiny-hybrid"
    assert [m.name for m in cell.per_layer] == ["steps_seen.count"]
    out = cli.run_cell(cell, 99, 0.3, True, "cpu", time.time())
    assert out.result["correct"]
    assert out.result["metrics"]["steps_seen.count"]["value"] >= 1
    out = cli.run_cell(cell, 99, 0.3, False, "cpu", time.time())
    assert set(out.result["metrics"]) == {"prefill_tokens_per_s", "setup_s"}

    after = {p: p.read_bytes() for p in manifest.BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before
    shutil.rmtree(bench)
