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

from repro_torch import configs  # noqa: E402
from repro_torch.comm.delta import DeltaStack  # noqa: E402
from repro_torch.comm.phase import CommPhase  # noqa: E402
from repro_torch.comm.primitives import grouped_queue_steps  # noqa: E402
from repro_torch.comm.stack import PhaseStack  # noqa: E402
from repro_torch.comm.strategies import best_strategy_many  # noqa: E402
from repro_torch.core import (CollectiveOp, PodGeometry,  # noqa: E402
                              price_collective, price_step, tpu_v5e)
from repro_torch.core.models import phase_cost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import spmv_ell as ell  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.net import pingpong_sweep, simulate_phase  # noqa: E402
from repro_torch.net.machine import blue_waters_machine  # noqa: E402
from repro_torch.nn import (decode_step, forward_logits,  # noqa: E402
                            init_cache, init_params, params_from_numpy,
                            params_to_numpy, prefill)
from repro_torch.serve import ServeEngine, StrategyService  # noqa: E402
from repro_torch.sparse import (DeviceHierarchy, build_hierarchy,  # noqa: E402
                                optimize_partition, poisson_3d, vcycle)
from repro_torch.sparse.partition import CommPattern  # noqa: E402
from repro_torch.workloads import Scenario, sweep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(" ".join(k for k in sys.modules if k.startswith("repro_torch.")))
sys.exit("imported: " + ", ".join(bad) if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    # every module was imported: the V-cycle's and K3's, the model
    # slice's (nn, configs, launch, serve, K4, K5), the workload
    # registry's, delta re-pricing's (comm.delta, sparse.optimize), the
    # strategy service's, the execution layer's, collective pricing's
    # (core.hlo, core.decompose), training's (train, data, ckpt, the
    # two drivers) and the programs across ranks (parallel.collectives,
    # compression, pipeline, ep_a2a) among them
    mods = set(res.stdout.split())
    assert len(mods) >= 90
    assert {"repro_torch.core.hlo", "repro_torch.core.decompose",
            "repro_torch.serve.strategy", "repro_torch.serve.admission",
            "repro_torch.serve.cache", "repro_torch.comm.health",
            "repro_torch.comm.faults", "repro_torch.comm.delta",
            "repro_torch.sparse.optimize", "repro_torch.exec",
            "repro_torch.exec.plan", "repro_torch.exec.presets",
            "repro_torch.exec.reference", "repro_torch.exec.lower",
            "repro_torch.exec.measure",
            "repro_torch.exec.calibrate", "repro_torch.train",
            "repro_torch.train.optim", "repro_torch.train.trainer",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.launch.train", "repro_torch.launch.serve",
            "repro_torch.parallel", "repro_torch.parallel.sharding",
            "repro_torch.parallel.context", "repro_torch.parallel.autotune",
            "repro_torch.parallel.collectives",
            "repro_torch.parallel.compression",
            "repro_torch.parallel.pipeline", "repro_torch.parallel.ep_a2a",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline", "repro_torch.launch.perf"} <= mods


# Reads the reference package's ``__init__`` as text (its ``__all__`` and
# the submodule each name is imported from), so neither jax nor ``repro`` is
# imported; prints the names re-exported, then the names left out.  A name
# the ``__init__`` defines itself is looked up in the port's package.  Names
# given after the path are the port's own exports, absent from the
# reference's ``__all__``.
_EXPORTS = """
import ast, importlib, sys
pkg, ref_init, extra = sys.argv[1], sys.argv[2], set(sys.argv[3:])
tree = ast.parse(open(ref_init).read())
home, ref_all = {}, None
for node in tree.body:
    if isinstance(node, ast.ImportFrom) and node.level == 1:
        for a in node.names:
            home[a.asname or a.name] = (node.module, a.name)
    elif isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
        ref_all = ast.literal_eval(node.value)
port = importlib.import_module("repro_torch." + pkg)
ported, left = [], []
for name in ref_all:
    sub, orig = home.get(name, (None, name))
    try:
        mod = importlib.import_module("repro_torch." + pkg
                                      + ("." + sub if sub else ""))
    except ModuleNotFoundError:
        left.append(name)
        continue
    if not hasattr(mod, orig):
        left.append(name)
        continue
    assert getattr(port, name, None) is getattr(mod, orig), name
    ported.append(name)
assert sorted(set(port.__all__) - extra) == sorted(ported), (port.__all__,
                                                           ported)
assert extra <= set(port.__all__) and not extra & set(ref_all), extra
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print(" ".join(ported))
print(" ".join(left))
"""


@pytest.mark.parametrize("pkg,must,extra", [
    ("comm", ("best_strategy_many", "PhaseStack", "CommPhase",
              "grouped_queue_steps", "per_proc_sums", "PatternError",
              "validate_phase", "DeltaStack", "ARENA_TYPES",
              "message_delta", "pattern_fingerprint", "phase_fingerprint",
              "FaultSpec", "InjectedFault", "InjectedTimeout", "inject",
              "FAULT_SITES", "FAULT_MODES", "BackendHealth",
              "CircuitBreaker", "HealthEvent", "get_health",
              "reset_health", "injected_payload", "delivered_payload"),
     ("BackendUnavailable",)),
    ("core", ("phase_cost_many", "CommParams", "TorusTopology", "phase_cost",
              "sequence_cost", "fit_alpha_beta", "CollectiveOp",
              "parse_collectives", "collective_summary", "shape_bytes",
              "PodGeometry", "MessageSet", "decompose_collective",
              "price_collective", "price_step", "StepCommModel",
              "CollectiveCost"), ()),
    ("net", ("simulate_many", "blue_waters_machine", "MachineSpec",
             "simulate", "simulate_phase", "pingpong_sweep",
             "contention_line_test"), ()),
    ("sparse", ("spmv_comm_pattern", "spgemm_comm_pattern", "CSR",
                "SpmvPatternState", "spmv_comm_pattern_delta", "Move",
                "OptimizeResult", "optimize_partition"),
     ("DeviceHierarchy",)),
    ("configs", ("ARCH_IDS", "get_config", "all_configs", "SHAPES",
                 "all_cells"), ("PORT_ONLY_IDS", "ALL_IDS")),
    ("workloads", ("sweep", "winner_table", "DEFAULT_SCENARIOS",
                   "moe_a2a_pattern", "tp_collective_patterns",
                   "pipeline_p2p_pattern"), ()),
    ("serve", ("StrategyService", "ServiceResult", "AdmissionQueue",
               "Deadline", "RetryPolicy", "Overloaded", "DeadlineExceeded",
               "ArenaCache", "ServeEngine", "Request"), ()),
    ("exec", ("build_schedule", "run_reference", "delivered_digest",
              "build_executor", "execute", "time_schedule",
              "predicted_costs", "pairwise_agreement", "record_sweeps",
              "calibrate", "host_machines", "lassen_8"), ()),
    ("nn", ("lm_loss", "forward_logits", "prefill", "decode_step",
            "init_params", "init_cache", "param_shapes", "cache_shapes"),
     ("Model", "params_from_numpy", "params_to_numpy", "forward_hidden")),
    ("train", ("AdamWConfig", "init_opt_state", "adamw_update", "schedule",
               "Trainer", "TrainConfig"), ()),
    ("data", ("SyntheticTokens", "shard_assignment"), ()),
    ("ckpt", ("save_checkpoint", "load_checkpoint", "latest_step",
              "CheckpointManager"), ()),
    ("parallel", ("MeshPlan", "make_mesh_plan", "param_pspecs",
                  "batch_pspecs", "cache_pspecs", "shardings"),
     ("quantize_int8", "compressed_psum", "dp_grads_compressed",
      "stack_stages", "gpipe", "moe_ffn_ep"))])
def test_packages_export_every_ported_name_of_the_reference(pkg, must, extra):
    # every name of repro.<pkg>.__all__ that the port defines in the
    # counterpart submodule is the same object at repro_torch.<pkg>, and
    # repro_torch.<pkg>.__all__ lists exactly those and the port's own
    # ``extra`` names
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", _EXPORTS, pkg,
         str(ROOT / "src" / "repro" / pkg / "__init__.py"), *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    ported, left = (line.split() for line in res.stdout.splitlines()[:2])
    assert set(must) <= set(ported), ported
    if pkg in ("nn", "train", "data", "ckpt", "parallel", "core", "configs",
               "workloads", "serve", "exec"):
        assert left == [], left
    if pkg == "comm":
        # the port has one backend, so no STACK_BACKENDS
        assert left == ["STACK_BACKENDS"], left


# Every module of the JAX package has its counterpart in the port, but the
# three ROADMAP exempts (the array-namespace shim, the kernels' jnp oracle
# and the shard_map shim the port replaces with torch.distributed).
_EXEMPT = {"comm/xp.py", "kernels/ref.py", "parallel/_jax_compat.py"}


def test_the_port_has_every_module_of_the_reference():
    ref = {p.relative_to(ROOT / "src" / "repro").as_posix()
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert ref - port == _EXEMPT


@pytest.mark.parametrize("mod,names", [
    ("parallel/compression.py", ("quantize_int8", "compressed_psum",
                                 "dp_grads_compressed")),
    ("parallel/pipeline.py", ("stack_stages", "gpipe")),
    ("parallel/ep_a2a.py", ("_local_dispatch", "moe_ffn_ep")),
    ("exec/lower.py", ("initial_buffers", "build_executor", "execute")),
    ("exec/measure.py", ("time_schedule", "launch_overhead",
                         "measure_strategies"))])
def test_programs_across_ranks_port_every_function_and_argument(mod, names):
    # each top-level function of the reference's module (read as text: no
    # jax) is in the port's with every argument the reference names (the
    # port's ``mesh`` is a torch DeviceMesh), the public ones exported;
    # ``compressed_psum`` reduces over a process group where the reference
    # names a shard_map axis, and the port's digest has one backend, K1
    renamed = {"axis_name": "group", "digest_backend": None}
    import ast
    import importlib
    import inspect
    tree = ast.parse((ROOT / "src" / "repro" / mod).read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    assert set(names) <= set(funcs)
    port = importlib.import_module(
        "repro_torch." + mod[:-3].replace("/", "."))
    package = importlib.import_module("repro_torch." + mod.split("/")[0])
    for name in names:
        f = funcs[name]
        args = [a.arg for a in f.args.args + f.args.kwonlyargs]
        if name in ("compressed_psum", "execute"):
            args = [renamed.get(a, a) for a in args if renamed.get(a, a)]
        have = inspect.signature(getattr(port, name)).parameters
        assert set(args) <= set(have), (name, args, list(have))
        if not name.startswith("_") and name != "initial_buffers":
            assert getattr(package, name) is getattr(port, name), name


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
    ph = pat.bind(m)
    ring = CollectiveOp("all-reduce", 1024.0, np.arange(8).reshape(1, 8),
                        None, 1, "")
    tiny = Scenario(name="tiny", arch="llama3.2-3b",
                    workload="pipeline_p2p", n_ranks=64, tokens_per_rank=8,
                    n_stages=2, n_microbatches=1)
    for call in (lambda: phase_cost(m.params, ph.src, ph.dst, ph.size,
                                    ph.loc),
                 lambda: DeltaStack.from_phases([ph]),
                 lambda: optimize_partition(poisson_3d(4), m, n_procs=4,
                                            moves=2),
                 lambda: simulate_phase(m, [0], [40], [8.0]),
                 lambda: pingpong_sweep(m, "inter_node", [8.0, 64.0]),
                 lambda: ph.queue_steps(arrival_order={40: np.array([0])}),
                 lambda: sweep([tiny], {"blue_waters": m}),
                 lambda: StrategyService(m),
                 lambda: price_collective(ring, PodGeometry(), tpu_v5e()),
                 lambda: price_step([ring], PodGeometry(), tpu_v5e())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for explicitly, the host runs the plain versions
    assert best_strategy_many([pat], m, device="cpu")[0].model_winner
    assert grouped_queue_steps(np.array([1, 1]), 2,
                               arrival_order={1: np.array([1, 0])},
                               device="cpu").tolist() == [0, 3]
    assert phase_cost(m.params, ph.src, ph.dst, ph.size, ph.loc,
                      device="cpu").total > 0
    assert simulate_phase(m, [0], [40], [8.0], device="cpu").time > 0
    assert pingpong_sweep(m, "inter_node", [8.0, 64.0],
                          device="cpu").shape == (2,)
    assert ph.queue_steps(device="cpu").sum() == ph.n_msgs
    row, = sweep([tiny], {"blue_waters": m}, device="cpu")
    assert (row.n_msgs, row.degraded) == (1, False)
    assert DeltaStack.from_phases([ph], device="cpu").device.type == "cpu"
    assert optimize_partition(poisson_3d(4), m, n_procs=4, moves=2,
                              device="cpu").cost > 0
    assert StrategyService(m, device="cpu").query(pat).ok
    assert price_collective(ring, PodGeometry(), tpu_v5e(),
                            device="cpu").transport > 0
    assert price_step([ring], PodGeometry(), tpu_v5e(),
                      device="cpu").model_time > 0


def test_vcycle_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    levels = build_hierarchy(poisson_3d(4))
    b = np.ones(levels[0].A.n_rows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vcycle(levels, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceHierarchy.build(levels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell.csr_to_block_ell(levels[0].A)
    h = DeviceHierarchy.build(levels, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h.to(None)
    # only a tensor on the CPU takes the plain version
    blocks, cols = h.levels[0].A
    x = torch.ones(blocks.shape[0] * blocks.shape[2])
    with pytest.raises(ValueError, match="unsupported device"):
        ell.spmv_block_ell(blocks.to("meta"), cols.to("meta"), x.to("meta"))
    # asked for explicitly, the host runs the plain versions
    assert vcycle(levels, b, device="cpu").shape == b.shape
    assert vcycle(h, b).shape == b.shape


def test_model_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    cfg = configs.get_smoke_config("hymba-1.5b")
    model = init_params(cfg, device="cpu")
    tree = params_to_numpy(model)
    tokens = np.ones((1, 16), dtype=np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_params(cfg),
                 lambda: params_from_numpy(tree, cfg),
                 lambda: init_cache(cfg, 1, 16),
                 lambda: forward_logits(model, cfg, tokens),
                 lambda: prefill(model, cfg, tokens),
                 lambda: decode_step(model, cfg, init_cache(cfg, 1, 16,
                                                            device="cpu"),
                                     tokens[:, 0], 0),
                 lambda: make_prefill_step(cfg)(model, {"tokens": tokens}),
                 lambda: make_serve_step(cfg)(model, None, tokens[:, 0], 0),
                 lambda: ServeEngine(cfg, model)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for explicitly, the host runs the plain versions
    logits, cache = prefill(model, cfg, tokens, device="cpu")
    assert logits.shape == (1, cfg.vocab_size)
    assert ServeEngine(cfg, model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("which", ["flash_attention", "ssd_intra_chunk"])
def test_kernel_wrappers_never_run_the_plain_version_off_the_cpu(
        monkeypatch, which):
    # a wrapper takes its plain version only because its tensors lie on the
    # CPU: told they lie on the card, it goes to the kernel, and a kernel
    # that cannot be built raises instead of falling back
    mod = fa if which == "flash_attention" else ssd
    real_check = mod._check

    def on_card(*args):
        out = real_check(*args)
        dev = torch.device("cuda")
        return (dev,) + out[1:] if isinstance(out, tuple) else dev

    def no_kernel(*_):
        raise RuntimeError("nvcc not found")

    def plain(*_, **__):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(mod, "_check", on_card)
    monkeypatch.setattr(mod, "kernel", no_kernel)
    monkeypatch.setattr(mod, f"{which}_plain", plain)
    if which == "flash_attention":
        args = [torch.zeros(1, 8, 2, 16)] * 3
    else:
        args = [torch.zeros(2, 8, 4), torch.zeros(2, 8, 3),
                torch.zeros(2, 8, 3), torch.zeros(2, 8, 1)]
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(mod, which)(*args)
    assert mod.LAUNCHES == before
