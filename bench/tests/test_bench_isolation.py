"""The benchmark loads nothing of JAX or the JAX package, reads nothing of
the JAX package's benchmark, and its reference takes nothing of the
program."""
import ast
import json
import os
import subprocess
import sys

import pytest

from harness import manifest

BENCH = manifest.BENCH
ROOT = BENCH.parent

_PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {src!r}]
import harness.cli, harness.prefill_closed, harness.train_steps, calibrate
import reference.model, reference.prefill, reference.train, counts
from harness import manifest
for cell in [w["name"] for w in manifest.load_manifest()["workloads"]]:
    c = manifest.load_cell(cell)
    for m in c.per_layer:
        manifest.metric_reader(c, m.name)
import repro_torch.launch.steps, repro_torch.nn.model
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_fresh_interpreter_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(bench=str(BENCH),
                                             src=str(ROOT / "src"))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops


def test_forbidden_check_compares_whole_names(monkeypatch):
    from harness import cli
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro_torch_extra" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in cli.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_reference_and_counts_import_nothing_of_the_program(sub):
    for path in (BENCH / sub).glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("repro", "repro_torch", "jax",
                                              "harness"), (path, name)


def test_no_file_reads_the_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_stack" not in text
        assert "benchmarks/" not in text and "benchmarks." not in text
