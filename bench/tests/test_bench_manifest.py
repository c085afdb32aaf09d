"""BENCHMARK.json against the contract it is written to, and every file it
names present."""
import json
import re

import pytest

from harness import manifest

SPEC = manifest.load_manifest()
ROOT = manifest.MANIFEST.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = {w["name"]: w for w in SPEC["workloads"]}
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def _cells_of(metric):
    return metric.get("workloads", list(CELLS))


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51


def test_command_and_paths_stay_inside():
    assert len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in SPEC["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


def test_names_and_units():
    every = [c["name"] for c in SPEC["configs"]] + list(CELLS) + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(every) == len(set(every))
    for n in every:
        assert NAME.match(n), n
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_each_pair_once_and_every_config_used():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in SPEC["configs"]} == {p[0] for p in pairs}


def test_setup_s_bound_and_name():
    assert E2E["setup_s"]["bound"] <= 0.25
    assert "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    c = manifest.load_cell(cell)
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert c.limits


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_moves_a_metric_reported_in_each_of_its_cells(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert m["moves"] in E2E
    for cell in _cells_of(m):
        assert cell in CELLS
        assert cell in _cells_of(E2E[m["moves"]])
    assert (manifest.BENCH / "metrics" / f"{metric}.py").exists()


def test_layer_names_are_one_line():
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_budget_of_a_full_check_fits():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_files_of_every_cell_exist(cell):
    w = CELLS[cell]
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("bench/configs/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"]
    assert data["source"] and data["assumed"]
    assert (manifest.BENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert (manifest.BENCH / "limits" / f"{cell}.json").exists()
