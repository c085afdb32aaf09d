"""Runtime of the port against the JAX package: checkpoints (round trip,
corruption, keep-last-k, async, the reference's on-disk format both
ways), crash-resume equality, the data pipeline (bit-equal batches,
re-dispatch, prefetch), the straggler watchdog and the two command-line
drivers.  The counterpart of ``tests/test_runtime.py``; its elastic
re-mesh restore waits for the port's parallel layout, and its two serving
cases have theirs in ``tests/test_torch_model.py``.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as ref_ckpt  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro import data as ref_data  # noqa: E402
from repro import nn as ref_nn  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, latest_step,  # noqa: E402
                              load_checkpoint, save_checkpoint)
from repro_torch.data import SyntheticTokens, shard_assignment  # noqa: E402
from repro_torch.nn import (forward_logits, init_params,  # noqa: E402
                            params_from_numpy, params_to_numpy)
from repro_torch.train import AdamWConfig, TrainConfig, Trainer  # noqa: E402
from repro_torch.train.optim import (init_opt_state,  # noqa: E402
                                     opt_state_from_numpy,
                                     opt_state_to_numpy)

ROOT = Path(__file__).resolve().parents[1]


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


# ------------------------------------------------------------- ckpt ---------
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    t2 = load_checkpoint(str(tmp_path), 7, t)
    for (k, a), (_, b) in zip(leaves(t), leaves(t2)):
        assert b.dtype == a.dtype and b.device == a.device, k
        assert torch.equal(a, b), k
    # bf16 stored as float32, as the reference stores it
    assert np.load(tmp_path / "step_7" / "b__c.npy").dtype == np.float32


def test_checkpoint_detects_corruption(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    f = next(p for p in os.listdir(tmp_path / "step_1") if p.endswith(".npy")
             and p.startswith("a"))
    path = tmp_path / "step_1" / f
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        load_checkpoint(str(tmp_path), 1, t)


def test_checkpoint_manager_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t, wait=True)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_async_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    th = mgr.save(5, t, wait=False)
    # the leaves are on the host already: writing into the tensors now
    # does not reach the checkpoint
    t["a"].fill_(-1.0)
    th.join(timeout=60)
    assert not th.is_alive()
    mgr.wait()
    assert latest_step(str(tmp_path)) == 5
    back = load_checkpoint(str(tmp_path), 5, _tree())
    assert torch.equal(back["a"], torch.arange(12.0).reshape(3, 4))


# ------------------------------------------------ the reference's format ----
def _ref_state(arch):
    params = ref_nn.init_params(ref_configs.get_smoke_config(arch), 0)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(1)
    state = ref_optim.init_opt_state(params)
    state["m"] = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape), jnp.float32), state["m"])
    state["step"] = jnp.asarray(4, jnp.int32)
    return params, state


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-moe-16b"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    params, state = _ref_state(arch)
    ref_ckpt.save_checkpoint(str(tmp_path), 3, {"params": params,
                                                "opt": state})
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, device="cpu").float()
    like = {"params": _nest({k: torch.from_numpy(v) for k, v in
                             leaves(params_to_numpy(model))}),
            "opt": opt_state_to_numpy(init_opt_state(model))}
    assert latest_step(str(tmp_path)) == 3
    tree = load_checkpoint(str(tmp_path), 3, like)
    flat = dict(leaves(tree["params"]))
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in flat.values())
    got = params_from_numpy(_nest({k: v.numpy() for k, v in flat.items()}),
                            cfg, device="cpu", dtype=torch.float32)
    opt = opt_state_from_numpy(tree["opt"], got, device="cpu")
    assert int(opt["step"]) == 4
    want_m = dict(leaves(jax.tree.map(np.asarray, state["m"])))
    for k, a in leaves(opt_state_to_numpy(opt)["m"]):
        np.testing.assert_array_equal(a, want_m[k])
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    logits, _ = forward_logits(got, cfg, tokens, device="cpu")
    want, _ = ref_nn.forward_logits(params, ref_configs.get_smoke_config(
        arch), jnp.asarray(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-small"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, seed=3, device="cpu")
    state = init_opt_state(model)
    for t in state["v"].values():
        t.uniform_()
    state["step"] += 9
    save_checkpoint(str(tmp_path), 9, {"params": params_to_numpy(model),
                                       "opt": opt_state_to_numpy(state)})
    rcfg = ref_configs.get_smoke_config(arch)
    r_like = ref_nn.init_params(rcfg, 0)          # bf16, as the port's
    tree = ref_ckpt.load_checkpoint(str(tmp_path), 9, {
        "params": r_like, "opt": ref_optim.init_opt_state(r_like)})
    assert int(tree["opt"]["step"]) == 9
    want_v = dict(leaves(opt_state_to_numpy(state)["v"]))
    for k, a in leaves(jax.tree.map(np.asarray, tree["opt"]["v"])):
        np.testing.assert_array_equal(a, want_v[k])
    # the weights come back in the reference's dtypes, bit for bit
    for (k, a), (_, b) in zip(sorted(leaves(jax.tree.map(
            lambda x: np.asarray(x, np.float32), tree["params"]))),
            sorted(leaves(params_to_numpy(model)))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    inputs = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 16))}
    if cfg.encoder_layers:
        inputs["enc_frames"] = np.random.default_rng(1).standard_normal(
            (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), tree["params"])
    want, _ = ref_nn.forward_logits(f32, rcfg, **{
        k: jnp.asarray(v) for k, v in inputs.items()})
    got, _ = forward_logits(model.float(), cfg, device="cpu", **inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------- crash-resume equality ----
def _train(cfg, data, steps, ckpt_dir, device="cpu"):
    t = Trainer(cfg, TrainConfig(steps=steps, ckpt_every=3,
                                 ckpt_dir=ckpt_dir, log_every=100),
                AdamWConfig(warmup_steps=2, total_steps=10), device=device)
    return t.run(data)


def test_crash_resume_bitwise(tmp_path):
    """Train 6 steps straight == train 3, 'crash', resume 3 more."""
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq_len=16)
    full = _train(cfg, data, 6, str(tmp_path / "a"))
    _train(cfg, data, 3, str(tmp_path / "b"))       # writes ckpt at step 3
    resumed = _train(cfg, data, 6, str(tmp_path / "b"))    # resumes from 3
    assert [r["step"] for r in resumed["history"]] == [5]
    for (k, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), k
    for name, m in full["opt_state"]["m"].items():
        assert torch.equal(m, resumed["opt_state"]["m"][name]), name
    assert int(resumed["opt_state"]["step"]) == 6


# ------------------------------------------------------------- data ---------
@pytest.mark.parametrize("family,kw", [
    ("dense", {}), ("vlm", {"d_model": 12}),
    ("audio", {"d_model": 8, "encoder_seq": 6})])
def test_batches_are_bit_equal_to_the_reference(family, kw):
    for shards, shard in ((1, 0), (4, 2)):
        port = SyntheticTokens(1000, batch=8, seq_len=16, n_shards=shards,
                               shard=shard, seed=5, family=family, **kw)
        ref = ref_data.SyntheticTokens(1000, batch=8, seq_len=16,
                                       n_shards=shards, shard=shard, seed=5,
                                       family=family, **kw)
        for step in (0, 7):
            for s in (None, 1):
                a, b = port.batch_at(step, s), ref.batch_at(step, s)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_data_determinism_and_redispatch():
    d = SyntheticTokens(1000, batch=8, seq_len=16, n_shards=4, shard=2)
    a = d.batch_at(5)
    b = d.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = d.batch_at(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # failure re-dispatch: any survivor can recompute shard 2's batch
    assign = shard_assignment(8, alive_hosts=[0, 1, 3])
    assert sorted(sum(assign.values(), [])) == list(range(8))
    assert all(h in (0, 1, 3) for h in assign)
    assert assign == ref_data.shard_assignment(8, alive_hosts=[0, 1, 3])
    with pytest.raises(ValueError, match="multiple"):
        SyntheticTokens(1000, batch=6, seq_len=16, n_shards=4)


def test_data_prefetch_iterator():
    d = SyntheticTokens(100, batch=2, seq_len=8)
    it = iter(d)
    b1 = next(it)
    b2 = next(it)
    assert b1["tokens"].shape == (2, 8)
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b2["tokens"], d.batch_at(1)["tokens"])


# ---------------------------------------------------------- watchdog --------
def test_straggler_watchdog(tmp_path):
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    data = SyntheticTokens(cfg.vocab_size, batch=2, seq_len=16)

    def hook(step):
        if step == 8:
            time.sleep(6.0)     # injected straggler

    # fixed SLA (not the running median) so background CPU load cannot
    # inflate the baseline and mask the injected straggler; fresh ckpt dir so
    # no stale checkpoint short-circuits the run
    t = Trainer(cfg, TrainConfig(steps=10, ckpt_every=100,
                                 ckpt_dir=str(tmp_path / "wd"), log_every=100,
                                 sla_seconds=1.5, sla_tolerance=3.0),
                AdamWConfig(), step_hook=hook, device="cpu")
    t.run(data)
    assert any(s == 8 for s, _ in t.stragglers)


def test_watchdog_takes_the_running_median_without_an_sla(tmp_path):
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    t = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)), device="cpu")
    times = []
    for step, dt in enumerate([1.0, 1.0, 1.0, 1.0, 5.0, 1.0, 3.5]):
        times.append(dt)
        t._watchdog(step, dt, times)
    # no SLA before 5 steps; then 3 x the median of the last 20
    assert t.stragglers == [(4, 5.0), (6, 3.5)]


# ------------------------------------------------------------- drivers ------
@pytest.mark.parametrize("module,args,expect", [
    ("train", ["--steps", "4", "--batch", "2", "--seq", "16"], "loss "),
    ("serve", ["--requests", "3", "--max-new", "4"], "req 2:")])
def test_command_line_drivers_run_on_the_cpu(tmp_path, module, args, expect):
    if module == "train":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--smoke",
         "--device", "cpu", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert expect in res.stdout
    if module == "train":
        assert latest_step(str(tmp_path / "ckpt")) == 4


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_crash_resume_bitwise_under_deterministic_algorithms(
        cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq_len=64)
    torch.use_deterministic_algorithms(True)
    try:
        full = _train(cfg, data, 6, str(tmp_path / "a"), cuda)
        _train(cfg, data, 3, str(tmp_path / "b"), cuda)
        resumed = _train(cfg, data, 6, str(tmp_path / "b"), cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    for (k, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), k
