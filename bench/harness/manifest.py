"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` lists configurations, cells and metrics.  Everything
that belongs to one of them is a file of its own, found by name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names the
  module of :mod:`harness` that runs it (``prefill_closed``,
  ``train_steps``);
- a per-layer metric: ``metrics/<name>.py``, with one function
  ``read(run)`` that returns the value or None;
- the limits of a cell's output check: ``limits/<cell>.json``.

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = BENCH.parent / "BENCHMARK.json"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: str | None = None
    layer: str | None = None
    workloads: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell with everything its files hold: ``config`` the
    configuration file's object, ``traffic`` the mix's, ``limits`` the
    output check's, ``end_to_end`` and ``per_layer`` the metrics it
    reports."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple
    per_layer: tuple
    bench: Path

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _metric(entry: dict) -> Metric:
    w = entry.get("workloads")
    return Metric(entry["name"], entry["unit"], entry["better"],
                  entry["source"], entry.get("moves"), entry.get("layer"),
                  None if w is None else tuple(w))


def _applies(m: Metric, cell: str) -> bool:
    return m.workloads is None or cell in m.workloads


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str, manifest: Path = MANIFEST,
              bench: Path | None = None) -> Cell:
    """The cell ``name`` of the manifest at ``manifest``, its files read
    from ``bench`` (the manifest's ``bench/`` when None)."""
    manifest = Path(manifest)
    root = manifest.parent
    bench = Path(bench) if bench is not None else root / "bench"
    spec = load_manifest(manifest)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {manifest}; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits_file = bench / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text())
    e2e = tuple(m for m in map(_metric, spec["end_to_end"])
                if _applies(m, name))
    e2e_names = {m.name for m in e2e}
    per_layer = tuple(m for m in map(_metric, spec["per_layer"])
                      if _applies(m, name) and m.moves in e2e_names)
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config,
                traffic, limits, e2e, per_layer, bench)


def metric_reader(cell: Cell, name: str):
    """The ``read`` function of ``metrics/<name>.py`` under the cell's
    ``bench/`` (loaded by path: a metric's name holds dots)."""
    path = cell.bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
