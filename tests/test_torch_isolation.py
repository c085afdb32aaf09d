"""The PyTorch port stands alone and runs on the card unless asked not to.

No module of ``repro_torch``, nor ``chip_smoke.py``, may import JAX or any
module of the JAX package ``repro`` — checked in a fresh interpreter, since
this test process imports both.  With no CUDA device, an entry point called
with ``device=None`` raises instead of running on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.comm.primitives import grouped_queue_steps  # noqa: E402
from repro_torch.comm.stack import PhaseStack  # noqa: E402
from repro_torch.comm.strategies import best_strategy_many  # noqa: E402
from repro_torch.net.machine import blue_waters_machine  # noqa: E402
from repro_torch.sparse.partition import CommPattern  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len([k for k in sys.modules if k.startswith("repro_torch.")]))
sys.exit("imported: " + ", ".join(bad) if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    assert int(res.stdout.split()[-1]) >= 15     # every module was imported


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = blue_waters_machine((2, 1, 1))
    pat = CommPattern(np.array([0, 40]), np.array([40, 0]),
                      np.array([64.0, 64.0]), m.n_procs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        best_strategy_many([pat], m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PhaseStack.build([pat.bind(m)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CommPhase.build(m, [0], [40], [8.0]).link_contention()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grouped_queue_steps(np.array([1, 1]), 2,
                            arrival_order={1: np.array([1, 0])})
    # asked for explicitly, the host runs the plain versions
    assert best_strategy_many([pat], m, device="cpu")[0].model_winner
    assert grouped_queue_steps(np.array([1, 1]), 2,
                               arrival_order={1: np.array([1, 0])},
                               device="cpu").tolist() == [0, 3]
