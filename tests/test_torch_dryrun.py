"""The port's dry run (``repro_torch.launch.dryrun``): cells traced on a fake
world and their collectives priced, held to Megatron's arithmetic, to the
reference's ``lower_cell`` on the same cut cell, and read back by the
port's roofline.

Every trace here runs on a fake world of 8 ranks as a (2, 4) mesh of
``("data", "model")`` with smoke or cut configs, and prices on the CPU.
The tables are counts and byte sizes, held exactly.
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.parallel import autotune  # noqa: E402
from repro_torch.workloads import row_parallel_ops_per_layer  # noqa: E402

MESH = (2, 4)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
#: The cut the side-by-side test gives both packages (through
#: ``cfg_overrides``): llama3.2-3b at two layers and small widths that
#: divide the model axis.
CUT = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
           vocab_size=1024)


def _smoke(arch, **cut):
    """Every field of ``arch``'s smoke config, as ``cfg_overrides``, with
    the fields of ``cut`` replaced."""
    return dict(dataclasses.asdict(configs.get_smoke_config(arch)), **cut)


def _trace(arch, shape, mesh_shape=MESH, cut=None, **kw):
    return dryrun.trace_cell(arch, shape, False, mesh_shape=mesh_shape,
                             cfg_overrides=_smoke(arch, **(cut or {})),
                             device="cpu", **kw)


def _ops(art, kind, axis, result_bytes=None):
    return sum(o["count"] for o in art["collective_ops"]
               if o["kind"] == kind and o["op"].endswith(f"over {axis}")
               and (result_bytes is None or o["result_bytes"] == result_bytes))


@pytest.fixture(scope="module")
def prefills():
    return {ss: _trace("llama3.2-3b", "prefill_32k", seq_shard=ss)
            for ss in (False, True)}


def _activation_bytes(cfg, shape):
    """B/2 * S * d * 2: one data shard's [B, S, d] bf16 activations."""
    return shape.global_batch // MESH[0] * shape.seq_len * cfg.d_model * 2


def test_prefill_all_reduces_are_megatrons(prefills):
    cfg = configs.get_smoke_config("llama3.2-3b")
    art = prefills[False]
    n = _activation_bytes(cfg, configs.SHAPES["prefill_32k"])
    rp = row_parallel_ops_per_layer(cfg, MESH[1])
    assert rp == 2
    # one all-reduce a row-parallel product a layer, and the vocab-parallel
    # embedding's one, each of a data shard's activations in bf16
    assert _ops(art, "all-reduce", "model", n) == rp * cfg.n_layers + 1
    assert _ops(art, "all-reduce", "model") == rp * cfg.n_layers + 1
    assert _ops(art, "reduce-scatter", "model") == 0
    assert art["status"] == "ok" and art["traced_microbatches"] == 1


def test_sequence_sharding_turns_them_into_reduce_scatter_all_gather_pairs(
        prefills):
    cfg = configs.get_smoke_config("llama3.2-3b")
    art = prefills[True]
    n = _activation_bytes(cfg, configs.SHAPES["prefill_32k"])
    rp = row_parallel_ops_per_layer(cfg, MESH[1])
    assert _ops(art, "all-reduce", "model", n) == 0
    # each row-parallel product (and the embedding) reduce-scattered to
    # the sequence-sharded residual, each mixer's input gathered back
    # (and the final norm's, before the logits)
    assert _ops(art, "reduce-scatter", "model", n // MESH[1]) == \
        rp * cfg.n_layers + 1
    assert _ops(art, "all-gather", "model", n) == rp * cfg.n_layers + 1
    assert art["collectives"]["reduce-scatter"]["ops"] >= rp * cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "hymba-1.5b"])
def test_one_microbatch_counted_per_slice_equals_the_full_trace(arch):
    short = _trace(arch, "train_4k", microbatch_override=2)
    full = _trace(arch, "train_4k", microbatch_override=2,
                  full_microbatches=True)
    assert short["microbatches"] == full["microbatches"] == 2
    assert (short["traced_microbatches"], full["traced_microbatches"]) == \
        (1, 2)
    assert short["collective_ops"] == full["collective_ops"]
    assert short["cost"]["flops_per_device"] == \
        full["cost"]["flops_per_device"]
    # the float32 loss accumulator's first addition (a host scalar and a
    # DTensor) moves a few bytes fewer than the next ones
    for k in ("bytes_per_device", "transcendentals"):
        assert short["cost"][k] == pytest.approx(full["cost"][k], rel=1e-9,
                                                 abs=256), k
    # a train cell reduces its gradients over the data axis
    assert _ops(full, "all-reduce", "data") \
        + _ops(full, "reduce-scatter", "data") > 0
    assert full["collectives"]


_REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.launch.dryrun import lower_cell
cut = json.loads(sys.argv[1])
art = lower_cell("llama3.2-3b", "prefill_32k", False, seq_shard=False,
                 calibrate=False, cfg_overrides=cut, mesh_shape=(2, 4))
print(json.dumps({"ops": [(o["kind"], o["count"], o["payload_bytes"])
                          for o in art["comm_model"]["ops"]],
                  "collectives": art["collectives"],
                  "flops": art["cost"]["flops_per_device"]}))
"""


def test_side_by_side_with_the_reference_lower_cell():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                          json.dumps(CUT)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    art = dryrun.trace_cell("llama3.2-3b", "prefill_32k", False,
                            seq_shard=False, cfg_overrides=CUT,
                            mesh_shape=MESH, device="cpu")
    shape = configs.SHAPES["prefill_32k"]
    elems = shape.global_batch // MESH[0] * shape.seq_len * CUT["d_model"]
    # XLA's CPU backend all-reduces a bf16 sum in float32 (its
    # ``*_promoted`` reducers), so the reference's row-parallel all-reduces
    # carry 4 bytes an element where the port's carry bf16's 2: the same
    # elements, the same count (2 a layer, and the vocab-parallel
    # embedding's one)
    ref_ar = sum(c for k, c, b in ref["ops"]
                 if k == "all-reduce" and b == 4 * elems)
    got_ar = _ops(art, "all-reduce", "model", 2 * elems)
    assert ref_ar == got_ar == 2 * CUT["n_layers"] + 1
    print("reference:", json.dumps(ref["collectives"]))
    print("port:", json.dumps(art["collectives"]))


# -- artifacts ----------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A train cell of qwen3-moe-30b-a3b at full width cut to 2 layers, as
    the CLI writes it."""
    art = dryrun.trace_cell("qwen3-moe-30b-a3b", "train_4k", False,
                            mesh_shape=MESH, cfg_overrides={"n_layers": 2},
                            device="cpu")
    d = tmp_path_factory.mktemp("dryrun_torch")
    with open(dryrun.cell_path(art["arch"], art["shape"], art["mesh"],
                               str(d)), "w") as f:
        json.dump(art, f, indent=1, default=float)
    return d


# The reference's artifact schema (``repro.launch.dryrun.lower_cell``).
SCHEMA = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch",
          "n_params", "n_active_params", "status", "lower_s", "compile_s",
          "seq_shard", "q_chunk", "memory", "cost", "collectives",
          "comm_model", "scan_trip_count"}


def _check_priced(a):
    assert a["comm_model"]["model_time"] >= 0
    assert a["comm_model"]["naive_time"] >= 0
    if a["kind"] == "train":
        # training always reduces gradients -> collectives must exist
        assert a["collectives"], (a["arch"], a["shape"], a["mesh"])


def _check_flops(a):
    if a["kind"] != "train":
        return
    chips = 1
    for s in a.get("mesh_shape") or ((2, 16, 16) if "2x16x16" in a["mesh"]
                                     else (16, 16)):
        chips *= s
    model = 6 * a["n_active_params"] * a["global_batch"] * a["seq_len"] \
        / chips
    lo = 0.3 if "moe" in a["arch"] else 0.8
    assert lo * model < a["cost"]["flops_per_device"] < 6 * model, a["arch"]


def test_artifact_has_the_reference_schema_and_reads_back(artifact):
    files = glob.glob(os.path.join(str(artifact), "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        a = json.load(f)
    assert SCHEMA <= set(a)
    assert set(a["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes", "peak_bytes"}
    assert a["cost"]["flops_per_device_raw"] == a["cost"]["flops_per_device"]
    assert "unfused" in a["bytes_note"]
    _check_priced(a)
    _check_flops(a)
    rows, skips = roofline.load(art_dir=str(artifact))
    assert len(rows) == 1 and not skips
    r = rows[0]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert 0.0 < r["model/hlo"]
    assert r["coll_bienz_s"] == a["comm_model"]["model_time"]
    md = roofline.to_markdown(rows, skips)
    assert "qwen3-moe-30b-a3b" in md
    # the machine's rates are arguments
    r2 = roofline.analyze(a, peak_flops=2e12, hbm_bw=1e9, hbm_bytes=2**40)
    assert r2["compute_s"] == pytest.approx(
        a["cost"]["flops_per_device"] / 2e12)
    assert r2["fits"]
    score = autotune.score_traced(a)
    assert score["comm_model_s"] == a["comm_model"]["model_time"]
    cand = autotune.LayoutCandidate("base", MESH)
    ranked = autotune.rank([autotune.LayoutScore(cand, **score)])
    assert ranked[0].step_model_s >= score["comm_model_s"]


def test_skipped_cells_carry_the_reference_reason():
    art = dryrun.trace_cell("qwen3-32b", "long_500k", False, device="cpu")
    assert art["status"] == "skipped"
    assert "sub-quadratic" in art["reason"]


def test_cli_writes_and_resumes(tmp_path, capsys):
    argv = ["--arch", "whisper-small", "--shape", "long_500k", "--mesh",
            "single", "--out", str(tmp_path), "--device", "cpu"]
    assert dryrun.main(argv) == 0
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "skipped" in out and "cached=1" in out


DRYRUN_DIR = os.path.join(ROOT, "artifacts", "dryrun_torch")
_arts = [json.load(open(f)) for f in
         sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json")))]


@pytest.mark.skipif(not _arts, reason="no artifacts/dryrun_torch; run "
                    "`python -m repro_torch.launch.dryrun` first")
@pytest.mark.parametrize("check", [_check_priced, _check_flops])
def test_dryrun_torch_artifacts(check):
    for a in _arts:
        if a.get("status") == "ok":
            check(a)


# -- no rank runs another's work ----------------------------------------------

#: Cut configs whose heads, SSM heads or vocab do not divide the model axis
#: of 4, as hymba's 25 heads, whisper's 12, mamba2's 24 SSM heads and the
#: vocabs of 32001, 51865 and 50280 do not divide 16 (``None``: the
#: reference's microbatches; 64: slices of 4 rows, 2 a data rank, fewer
#: than the model axis).
SPLIT_CASES = [
    ("hymba-1.5b", dict(d_model=80, n_heads=5, n_kv_heads=1,
                        vocab_size=258), None),
    ("mamba2-130m", dict(d_model=80, vocab_size=258), None),
    ("whisper-small", dict(n_heads=6, n_kv_heads=6, vocab_size=258), 64),
    ("llama3.2-3b", dict(n_heads=6, n_kv_heads=2), 64),
]


@pytest.mark.parametrize("arch,cut,mb", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_no_rank_runs_another_ranks_work(arch, cut, mb):
    # a train cell's FLOPs a rank on the (2, 4) mesh, times its 8 ranks,
    # against the same cell on one rank: 3.7-4.0 (every model rank running
    # the replicated heads, scans, projections and logits whole) before the
    # attention and SSD scans dealt their (row, head) items out over the
    # model axis and the SSM's input projection and the logits ran on the
    # sequence-sharded residual.  What is left above
    # 1 is the plain attention backward's causal blocks, whose rows grow as
    # a rank's rows and heads shrink (``flash_attention.backward_rows``),
    # so more of each block lies above the diagonal
    one = _trace(arch, "train_4k", mesh_shape=(1, 1), cut=cut,
                 microbatch_override=mb)
    eight = _trace(arch, "train_4k", cut=cut, microbatch_override=mb)
    ratio = eight["cost"]["flops_per_device"] * 8 \
        / one["cost"]["flops_per_device"]
    assert 1.0 <= ratio < 1.35, ratio


def test_a_slice_keeps_a_row_for_each_data_rank():
    vl = configs.get_config("qwen2-vl-72b")
    # the reference's 16 slices of 16 rows on 16 data ranks; 8 of 32 rows
    # on 512 ranks' 32
    assert dryrun.microbatches_for(vl, 256, 16) == 16
    assert dryrun.microbatches_for(vl, 256, 32) == 8
    assert dryrun.microbatches_for(configs.get_config("whisper-small"),
                                   256, 32) == 2
    assert dryrun.microbatches_for(configs.get_config("tinyllama-1.1b"),
                                   256, 32) == 1


def test_flops_of_a_single_product_are_its_closed_form():
    # no layers: a prefill is the embedding, the final norm and the last
    # position's logits, one product of each data rank's B / 2 rows by
    # its vocab shard of V / 4: 2 * (B / 2) * d * (V / 4) FLOPs a rank
    cfg = configs.get_smoke_config("llama3.2-3b")
    art = _trace("llama3.2-3b", "prefill_32k", cut={"n_layers": 0})
    B = configs.SHAPES["prefill_32k"].global_batch
    assert art["cost"]["flops_per_device"] == \
        2 * (B // MESH[0]) * cfg.d_model * (cfg.vocab_size // MESH[1])


def test_the_recorder_refuses_a_torch_whose_propagation_it_misses(
        monkeypatch):
    from repro_torch.launch.mesh import fake_world, make_mesh
    with fake_world(8):
        mesh = make_mesh(MESH, ("data", "model"), device_type="cpu")
        groups, _ = dryrun.mesh_groups(mesh)
        dryrun.check_recorder(mesh, groups)
        monkeypatch.setattr(dryrun, "_PROPAGATION_FILES", ())
        with pytest.raises(RuntimeError, match="propagation"):
            dryrun.check_recorder(mesh, groups)


def test_settings_the_port_does_not_take_are_refused():
    from repro_torch.parallel.context import ShardingContext
    with pytest.raises(ValueError, match="blockwise"):
        dryrun.trace_cell("qwen3-32b", "decode_32k", False, q_chunk=512,
                          device="cpu")
    with pytest.raises(ValueError, match="blockwise"):
        ShardingContext(mesh=None, dp_axes=("data",), q_chunk=512)
    with pytest.raises(ValueError, match="unrolled"):
        ShardingContext(mesh=None, dp_axes=("data",), unroll_loops=True)


def test_kv_heads_repeated_for_the_model_axis_split_by_heads():
    # 8 query heads over 2 kv heads on a model axis of 4: each kv head is
    # repeated for its two ranks and the heads split; with 2 rows a data
    # rank (32 sequences over 16) the work must not go out as items
    # instead, which would gather the query heads too.  The all-gathers: Megatron's
    # of the residual (2 B S d bytes, B = 2 rows), and k's and v's a
    # layer, whose column-parallel product splits a kv head's columns
    cut = {"n_heads": 8, "n_kv_heads": 2}
    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), **cut)
    art = _trace("llama3.2-3b", "prefill_32k", mesh_shape=(16, 4), cut=cut)
    rp = row_parallel_ops_per_layer(cfg, 4)
    S, hd = configs.SHAPES["prefill_32k"].seq_len, cfg.head_dim
    x_bytes, kv_bytes = 2 * 2 * S * cfg.d_model, 2 * 2 * S * 2 * hd
    assert _ops(art, "all-gather", "model", x_bytes) == \
        rp * cfg.n_layers + 1
    assert _ops(art, "all-gather", "model", kv_bytes) == 2 * cfg.n_layers
    assert _ops(art, "all-gather", "model") == \
        (rp + 2) * cfg.n_layers + 1
