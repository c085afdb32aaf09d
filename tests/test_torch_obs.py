"""The port's recorder (``repro_torch.obs``) on the CPU.

Off, a span and a counter read one flag and do nothing else: no
``record_function``, no CUDA event, no tensor op, and the model's outputs
are bit for bit those of a run with the recorder on.  On, spans nest by
thread, carry the step id of the step span around them, and a step span
keeps the K1-K5 launches made in it; under ``torch.profiler`` only the
active cycle records.  The MoE counters equal a count by hand from the
router's choices and the capacity.
"""
import collections
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

from repro_torch import configs, obs  # noqa: E402
from repro_torch.kernels import flash_attention, ssd  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_train_step)
from repro_torch.nn import init_params, moe  # noqa: E402
from repro_torch.train.optim import AdamWConfig, init_opt_state  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _raise(*a, **kw):
    raise AssertionError("touched while recording is off")


def _tokens(cfg, B=2, S=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g)


# -- off ----------------------------------------------------------------------
def test_off_a_span_enters_no_record_function_and_makes_no_event(
        monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(obs, "_launch_counts", _raise)
    assert not obs.on()
    assert obs.span("a") is obs.span("b", x=1) is obs.step("c")
    with obs.step("s"), obs.span("a", x=1):
        obs.count("n", 3)
        obs.count("t", torch.ones((), dtype=torch.int64))
    cfg = configs.get_smoke_config("deepseek-moe-16b")
    model = init_params(cfg, device="cpu")
    make_prefill_step(cfg, device="cpu")(model, {"tokens": _tokens(cfg)})
    snap = obs.snapshot()
    assert snap.spans == () and snap.counters == {} and snap.steps == 0


def test_off_a_counter_runs_no_tensor_op():
    """The MoE layer computes its local and kept counts (a sum, and a
    clamp and a sum, a routing chunk) only while recording: off, it runs
    every op it runs on but those three."""
    from torch.overrides import TorchFunctionMode

    class Ops(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = collections.Counter()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names[getattr(func, "__name__", str(func))] += 1
            return func(*args, **(kwargs or {}))

    cfg = configs.get_smoke_config("deepseek-moe-16b")
    x = torch.randn(2, 16, cfg.d_model)
    p = {k: torch.randn(sh) * 0.1
         for k, sh in moe.moe_param_shapes(cfg).items()}
    with Ops() as off:
        moe.moe_ffn(x, p, cfg)
    with obs.recording(), Ops() as on:
        moe.moe_ffn(x, p, cfg)
    assert not off.names - on.names
    extra = on.names - off.names
    # on, besides the spans' record_function ops and a shape read
    assert {k: v for k, v in extra.items()
            if "record_function" not in k and k != "__get__"} == \
        {"clamp": 1, "sum": 2}


# -- when it records ----------------------------------------------------------
def test_only_the_profilers_active_cycle_records():
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        assert not obs.on()
        with obs.span("repro_torch.warm"):
            pass
        prof.step()
        assert obs.on()
        with obs.step("repro_torch.active", B=1), \
                obs.span("repro_torch.inner"):
            torch.ones(4).sum()
        prof.step()
    assert not obs.on()
    with obs.span("repro_torch.after"):
        pass
    names = [s.name for s in obs.snapshot().spans]
    assert sorted(names) == ["repro_torch.active", "repro_torch.inner"]
    # the spans lie in the profiler's own timeline
    seen = {e.name for e in prof.events()}
    assert {"repro_torch.active", "repro_torch.inner"} <= seen
    assert "repro_torch.warm" not in seen


def test_recording_nests_and_holds_for_every_thread():
    assert not obs.on()
    with obs.recording():
        with obs.recording():
            assert obs.on()
        seen = []
        t = threading.Thread(target=lambda: seen.append(obs.on()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [True]
    assert not obs.on()


# -- what a span records -------------------------------------------------------
def test_parents_steps_and_threads_with_two_threads():
    barrier = threading.Barrier(2, timeout=10)

    def worker(tag):
        with obs.step(f"step.{tag}", tag=tag):
            barrier.wait()
            with obs.span(f"outer.{tag}"):
                barrier.wait()
                with obs.span(f"inner.{tag}", k=tag):
                    barrier.wait()
            barrier.wait()

    with obs.recording():
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    snap = obs.snapshot()
    by = {s.name: s for s in snap.spans}
    assert len(by) == 6 and snap.steps == 2
    for tag in ("a", "b"):
        st, out, inn = (by[f"{n}.{tag}"] for n in ("step", "outer", "inner"))
        assert st.parent is None and st.step == st.id
        assert out.parent == st.id and inn.parent == out.id
        assert out.step == inn.step == st.id
        assert st.thread == out.thread == inn.thread
        assert inn.attrs == {"k": tag} and st.attrs == {"tag": tag}
        assert st.host_start_ns <= out.host_start_ns <= inn.host_start_ns
        assert inn.host_end_ns <= out.host_end_ns <= st.host_end_ns
        assert inn.device_s is None          # no CUDA here
    assert by["step.a"].thread != by["step.b"].thread
    assert by["step.a"].id != by["step.b"].id


def test_a_span_on_a_thread_with_no_open_span_takes_the_latest_step():
    with obs.recording():
        with obs.step("repro_torch.train_step") as st:
            done = []

            def other():
                with obs.span("repro_torch.attn_bwd"):
                    done.append(1)

            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and done
    bwd = obs.snapshot().named("repro_torch.attn_bwd")[0]
    assert bwd.parent is None and bwd.step == st.id


def test_a_span_closes_when_its_body_raises():
    with obs.recording():
        with pytest.raises(ValueError), obs.span("repro_torch.x"):
            raise ValueError
        with obs.span("repro_torch.y") as y:
            pass
    assert y.parent is None
    assert [s.name for s in obs.snapshot().spans] == ["repro_torch.x",
                                                     "repro_torch.y"]


def test_launches_are_folded_in_per_step(monkeypatch):
    monkeypatch.setitem(ssd.LAUNCHES, "ssd_intra_chunk", 5)
    monkeypatch.setitem(flash_attention.LAUNCHES, "flash_attention", 2)
    from repro_torch.kernels.build import count
    with obs.recording():
        for n in (1, 3):
            with obs.step("repro_torch.prefill_step"):
                for _ in range(n):
                    count(ssd.LAUNCHES, "ssd_intra_chunk",
                          "ssd_intra_chunk_tc")
                    count(flash_attention.LAUNCHES, "flash_attention")
        count(ssd.LAUNCHES, "ssd_intra_chunk")     # outside every step
    snap = obs.snapshot()
    steps = snap.named("repro_torch.prefill_step")
    assert [s.launches for s in steps] == [
        {"ssd_intra_chunk": n, "ssd_intra_chunk_tc": n, "flash_attention": n}
        for n in (1, 3)]
    assert snap.steps == 2
    assert snap.launches == {"ssd_intra_chunk": 4, "ssd_intra_chunk_tc": 4,
                             "flash_attention": 4}
    assert snap.launches_per_step()["flash_attention"] == 2.0


def test_snapshot_clears_nothing_and_reset_clears_everything():
    with obs.recording():
        with obs.step("repro_torch.s"):
            obs.count("n", 2)
            obs.count("t", torch.tensor(5))
    a, b = obs.snapshot(), obs.snapshot()
    assert a == b and a.counters == {"n": 2, "t": 5}
    obs.reset()
    c = obs.snapshot()
    assert c.spans == () and c.counters == {} and c.steps == 0


def test_device_counts_fold_and_keep_their_sum():
    with obs.recording():
        for i in range(3 * obs._FOLD + 7):
            obs.count("t", torch.tensor(i))
    assert len(obs._REC.device["t"]) < obs._FOLD
    n = 3 * obs._FOLD + 7
    assert obs.snapshot().counters["t"] == n * (n - 1) // 2


def test_no_update_is_lost_across_many_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(200):
                with obs.step("repro_torch.s"), obs.span("repro_torch.x"):
                    obs.count("n", 1)
                    obs.count("t", torch.ones((), dtype=torch.int64))

        with obs.recording():
            threads = [threading.Thread(target=worker) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = obs.snapshot()
    assert snap.counters == {"n": 3200, "t": 3200}
    assert snap.steps == 3200 and len(snap.spans) == 6400
    assert len({s.id for s in snap.spans}) == 6400
    xs = snap.named("repro_torch.x")
    parents = {s.id: s for s in snap.named("repro_torch.s")}
    assert all(parents[x.parent].thread == x.thread for x in xs)


# -- the model under the recorder ----------------------------------------------
def _prefill_and_step(arch, record: bool):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, seed=3, device="cpu")
    toks = _tokens(cfg, seed=4)
    prefill = make_prefill_step(cfg, device="cpu")
    train = make_train_step(cfg, AdamWConfig(warmup_steps=1), device="cpu")
    ctx = obs.recording() if record else obs.span("unused")
    with ctx:
        logits, cache = prefill(model, {"tokens": toks})
        model, state, met = train(model, init_opt_state(model),
                                  {"tokens": toks})
    return logits, cache, dict(model.named_parameters()), met


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-moe-16b"])
def test_outputs_are_bit_identical_with_the_recorder_on_and_off(arch):
    off = _prefill_and_step(arch, False)
    assert obs.snapshot().spans == ()
    on = _prefill_and_step(arch, True)
    snap = obs.snapshot()
    assert torch.equal(off[0], on[0])
    for group in off[1]:
        for k, t in off[1][group].items():
            assert torch.equal(t, on[1][group][k]), (group, k)
    for k, t in off[2].items():
        assert torch.equal(t, on[2][k]), k
    for k, t in off[3].items():
        assert torch.equal(t, on[3][k]), k
    names = collections.Counter(s.name for s in snap.spans)
    cfg = configs.get_smoke_config(arch)
    layers = cfg.n_layers
    assert names["repro_torch.prefill_step"] == 1
    assert names["repro_torch.train_step"] == 1
    assert snap.steps == 2
    for n in ("grads", "loss", "optimizer", "cache"):
        assert names[f"repro_torch.{n}"] == 1, n
    # prefill's layers, the training forward's and the recompute of the
    # checkpointed (not the leading dense) layers
    dense = cfg.first_dense_layers
    assert names["repro_torch.layer"] == 3 * layers - dense
    if arch == "hymba-1.5b":
        for n in ("attention", "attn_core", "ssm", "ssd_intra", "ssd_inter",
                  "mlp"):
            assert names[f"repro_torch.{n}"] == 3 * layers, n
        assert names["repro_torch.attn_bwd"] == layers
        assert names["repro_torch.ssd_bwd"] == layers
    else:
        for n in ("moe", "moe.route", "moe.dispatch", "moe.experts",
                  "moe.combine", "moe.shared"):
            assert names[f"repro_torch.{n}"] == 3 * (layers - dense), n
        assert names["repro_torch.mlp"] == 2 * dense
    steps = {s.id: s.name for s in snap.spans if s.launches is not None}
    assert all(s.step in steps for s in snap.spans)
    core = snap.named("repro_torch.attn_core")[0]
    assert core.attrs == dict(B=2, S=32, H=cfg.n_heads, KH=cfg.n_kv_heads,
                              D=cfg.d_head, causal=True)
    assert snap.named("repro_torch.prefill_step")[0].attrs == dict(B=2, L=32)


# -- the MoE counters ----------------------------------------------------------
def _by_hand(xf, router, cfg, C):
    """(assignments, slots, kept) of routing chunks ``xf`` [D, T, d] by a
    loop over experts."""
    D, T, _ = xf.shape
    _, _, idx = moe.top_k(xf.float() @ router.float(), cfg.n_experts_active)
    kept = 0
    for g in range(D):
        for e in range(cfg.n_experts):
            kept += min(int((idx[g] == e).sum()), C)
    return D * T * cfg.n_experts_active, D * cfg.n_experts * C, kept


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("chunks", [1, 3])
def test_moe_counters_equal_a_count_by_hand(monkeypatch, capacity_factor,
                                           chunks):
    import dataclasses
    cfg = dataclasses.replace(configs.get_smoke_config("deepseek-moe-16b"),
                              capacity_factor=capacity_factor)
    chunk = 32
    monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", chunk)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, chunks * chunk // 2, cfg.d_model, generator=g)
    p = {k: torch.randn(sh, generator=g) / sh[-2] ** 0.5
         for k, sh in moe.moe_param_shapes(cfg).items()}
    with obs.recording():
        moe.moe_ffn(x, p, cfg)
    c = obs.snapshot().counters
    T = chunk if chunks > 1 else x.shape[0] * x.shape[1]
    C = moe.capacity(T, cfg)
    want = [0, 0, 0]
    for xc in x.reshape(1, chunks, T, cfg.d_model).unbind(1):
        for i, v in enumerate(_by_hand(xc, p["router"], cfg, C)):
            want[i] += v
    assert [c["moe.assignments"], c["moe.slots"], c["moe.kept"]] == want
    if capacity_factor == 0.5:
        assert want[2] < want[0]                   # drops are counted
    assert 0 < want[2] <= min(want[0], want[1])


# -- on the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: spans time themselves with CUDA "
                    "events only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_spans_get_device_times_on_the_host_clock(cuda):
    a = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with obs.recording():
        with obs.step("repro_torch.s"):
            with obs.span("repro_torch.mm"):
                for _ in range(20):
                    a = a @ a / 2048 ** 0.5
            with obs.span("repro_torch.empty"):
                pass
    snap = obs.snapshot()
    s, mm, empty = (snap.named(n)[0] for n in
                    ("repro_torch.s", "repro_torch.mm", "repro_torch.empty"))
    for x in (s, mm, empty):
        assert x.device == torch.cuda.current_device()
        assert x.device_start_ns <= x.device_end_ns
    assert s.device_start_ns <= mm.device_start_ns
    assert mm.device_end_ns <= empty.device_start_ns <= s.device_end_ns
    # 20 products of 2048^3 take far longer on the card than their launches
    assert mm.device_s > 10 * empty.device_s
    assert snap.device_s("repro_torch.mm", "repro_torch.empty") == \
        pytest.approx(mm.device_s + empty.device_s)
    # the device ran the product after its launch, before the snapshot
    assert mm.device_end_ns >= mm.host_start_ns
    obs.reset()
    with obs.recording(), obs.span("repro_torch.again"):
        pass
    assert len(obs._REC.pool[mm.device]) == 4    # 6 pooled, 2 taken again
