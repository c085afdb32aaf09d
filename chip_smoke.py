"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. build the five CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), print their register and spill
   lines and the card;
2. hold K1 (segment reduce), K2 (queue walk), K3 (block-ELL SpMV), K4
   (flash attention) and K5 (SSD intra-chunk step) to their plain PyTorch
   versions on the card, on ragged shapes; K1 also on sorted runs, random
   ids and one hot segment below its shared-memory capacity and on sorted,
   random and short-run ids above it, each on the path the wrapper picks
   and forced onto each path that applies; K2 also on a region of 10,000
   arrivals (five of its 2,048-word tiles) and on runs of empty regions;
   K4 also at hymba-1.5b's and
   llama3.2-3b's full attention shapes in bf16 (timed beside SDPA), with
   every bf16 case counted on its tensor-core kernel; K5 also on ragged q
   and at hymba-1.5b's and mamba2-130m's full prefill shapes, every case
   counted on its tensor-core (split-TF32) path; the Mamba2 mixer's
   prologue and epilogue kernels (``kernels/ssm_mixer.py``) at the
   benchmark's hymba-1.5b ``prefill-long`` and granite-4.0-h-small
   ``prefill-long16k`` step shapes (16,384 tokens), each held to its plain
   version in float32 and timed: wrapper, launch alone, the plain torch-op
   chain on bf16 inputs, the byte bound;
3. the small slice: ``best_strategy_many`` over the AMG hierarchy of
   ``elasticity_like_3d(16)`` on ``blue_waters_machine((4, 4, 2))``, on
   cuda and on cpu — identical winners, totals allclose; then one V-cycle
   on that hierarchy on cuda and on cpu, held together;
4. the full-width slice: ``elasticity_like_3d(40)`` (192,000 dof), its AMG
   hierarchy, each level partitioned over ``min(8192, rows // 2)`` ranks of
   ``blue_waters_machine((8, 8, 4))`` (8,192 ranks), swept by
   ``best_strategy_many`` on cuda with K1's and K2's counts set to 0 just
   before; every kernel input of that run is captured and each kernel's
   output there is held to its plain version, and the path each K1 call
   took is logged;
5. the full-width V-cycle on the same hierarchy: ``DeviceHierarchy.build``
   timed, every operator held to its plain version at each lane count K3
   takes (1-32), a ``cols`` past the block columns refused before any
   launch, one V(2,2) cycle on cuda with K3's count set to 0 just before
   (every SpMV is one K3 launch: 85 on the 6-level hierarchy) and its
   inputs captured, the same recursion again on device vectors under
   ``torch.cuda.set_sync_debug_mode("error")`` (no SpMV waits for the
   device), held to the same cycle on cpu, then 10 cycles with the
   relative residual computed on the host in float64;
6. the paper's measurements: Figs. 2-9 and Table 1 as
   ``benchmarks/bench_paper.py`` computes them (ping-pong sweeps of every
   Blue Waters locality against node-aware and flat ``message_time``,
   ``fit_alpha_beta`` and ``fit_RN``, the HighVolumePingPong and
   ``fit_gamma``, the Gemini line and ``fit_delta``) on cuda and on cpu —
   fitted values within 1e-4, queue steps bit-equal; then Figs. 10-11 at
   full width: the SpMV and SpGEMM (``A_l P_{l+1}``) traffic of every
   level of the phase-4 hierarchy with random arrivals, priced by one
   ``simulate_many`` and one ``model_ladder_many`` call per operation on
   cuda with K1's and K2's counts set to 0 just before and every K1/K2
   input captured and held to its plain version, the whole run held to
   the same run on cpu (steps bit-equal, totals within 1e-4); each level's
   measured time and five ladder rungs and the three derived rows;
   then Figs. 10-11 at the reference benchmark's own setup
   (``elasticity_like_3d(14)`` on ``blue_waters_machine((4, 4, 2))``, at
   most 1,024 ranks a level) on cuda and cpu, its six ``fig10_11_*`` rows
   held to the reference's (``FIG10_11_REFERENCE``) within 1e-4;
   ``simulate`` and ``phase_cost_phase`` of level 0's SpMV against the
   stacked row; one per-phase ``simulate`` and one batched
   ``pingpong_sweep`` timed; the run's launches on a line of their own;
7. the LLM workload registry: ``repro_torch.workloads.sweep()`` on cuda,
   the 21 (machine, scenario, phase) rows of the shipped registry (MoE
   all-to-alls of qwen3-moe-30b-a3b and deepseek-moe-16b, llama3.2-3b's TP
   rings and pipeline p2p, 64 ranks each, on lassen, frontier and
   blue_waters) through one ``best_strategy_many`` call with K1's and K2's
   counts set to 0 just before and every K1/K2 input captured and held to
   its plain version; the rows held to ``sweep(device="cpu")`` (winners
   equal, costs within 1e-4) and the 42 winners to the reference's table
   (``REGISTRY_WINNERS``); the winner table, the wall split into
   derivation, host rewrites and pricing, the device-busy share of a
   profiled rerun and the launches;
8. delta re-pricing (``repro_torch.comm.delta.DeltaStack`` under
   ``repro_torch.sparse.optimize_partition``), with K1's and K2's counts set
   to 0 before each search, every K1/K2 input captured and held to its
   plain version, and no fresh arena built during a search:
   ``benchmarks/bench_delta.py``'s search (``elasticity_like_3d(12)``, 512
   ranks of ``blue_waters_machine((4, 2, 2))``, 64 moves) on cuda and cpu,
   held to each other and to the reference's recorded costs and accept
   decisions (``DELTA_REFERENCE``), also by replaying the reference's
   candidates through the port's delta path; a full-width search on level
   0 of phase 4's hierarchy (8,192 ranks, 64 moves) timed against a rebuild
   of the same candidates (the ratio printed); ``verify=True`` applies and
   one ``simulate_many`` with random arrivals on its final arena, held to a
   fresh ``PhaseStack``;
9. the strategy service (``repro_torch.serve.StrategyService``) on cuda:
   the six level patterns of phase 4 cold (K1's and K2's counts set to 0
   just before, every K1/K2 input captured and held to its plain version,
   the verdicts held to phase 4's), warm (no launch, bit-equal), after
   ``restore(snapshot())`` on a fresh service, and ``reprice`` of level 0
   to phase 8's full-width search result (held to ``best_strategy_many``
   of the mutated phase); fault drills (``kernel.segment_reduce:raise``
   answered with error results, the breaker open and the next batch shed
   with ``BackendUnavailable`` and no K1 launch, the half-open probe
   closing it; ``Overloaded`` and ``DeadlineExceeded``); 4 threads
   querying the registry's 21 rows at once, held to the serial run; the
   wall split, the warm and restore walls, reprice against a cold query
   and the device-busy share of a profiled cold query;
10. the execution layer (``repro_torch.exec``) on cuda, each step with
   K1's and K2's counts set to 0 just before and every K1/K2 input captured
   and held to its plain version: (a) ``tests/test_exec.py``'s cases (the
   four 8-rank host presets x their strategies x both colorings, 40
   messages from seed 11) lowered, run as virtual ranks on the card and
   held to ``run_reference`` bit for bit, each digest (K1) within rtol
   1e-4 of the float64 bincount; (b) ``benchmarks/bench_exec.py``'s setup
   (``lassen_8``, 96 messages from seed 42): a table fitted from sweeps
   recorded on the card, held to the cpu fit, the measured-vs-predicted
   table, the pairwise agreement (printed), the launch overhead and greedy
   ``standard`` against ``per_message`` (at least 1.0); (c) the calibrated
   agreement of ``bench_exec_agreement`` (``best_strategy_many`` with
   random arrivals, K2): agreement and crossover 1.0; (d) Figs. 10-11's
   reference setup, levels 0-3 x the three node-aware strategies, held as
   in (a); (e) level 0 of phase 4's hierarchy (8,192 ranks, 165,930
   messages) x the three strategies: plan, executor build and median run
   timed, buffers and peak memory, the delivered matrix held to the
   semantic oracle on the card and the digest to the bincount;
11. the post-kernel check (``REPRO_STACK_VERIFY``): phase 4's full-width
   sweep again unchecked, then under ``finite`` and ``parity``, with K1's
   and K2's counts set to 0 just before each and every K1/K2 input
   captured and held to its plain version — winners equal, K2's inputs and
   steps bit-equal to the unchecked run's, the three walls and parity's
   plain K2 on the CPU timed; the chaos drill on phase 9's service
   (``*:nan`` with ``finite``, ``*:corrupt`` with ``parity``): every level
   an error or shed, the breaker open, no cache holding a rejected output,
   phase 9's verdicts again after the disarm; a K1 output poisoned with
   ``nan`` comes back all NaN with the check off and raises with it on;
12. collective pricing: one training step's collectives of
   qwen3-moe-30b-a3b on the reference's 2 x 16 x 16 production mesh (512
   chips) as post-SPMD HLO text (``collective_step_hlo``: FSDP all-gather,
   gradient reduce-scatter, tensor-parallel all-reduce and the expert
   all-to-alls inside a 48-trip ``while``; the gradient all-reduce over
   ``pod``, a 512-chip all-to-all and a ``collective-permute`` ring
   outside), parsed, decomposed and priced by ``price_step`` on cuda with
   K1's count set to 0 just before and every K1 input captured and held to
   its plain version, and on cpu — every ``CollectiveCost`` field and the
   step totals within 1e-4; the parse, decompose and pricing walls, the
   device-busy share, and per op kind the model time against the naive
   ``bytes / link_bw`` time;
13. the model, small: hymba-1.5b's smoke config and hymba-1.5b at full
   width cut to 2 layers, the smoke configs of tinyllama-1.1b,
   starcoder2-3b (gelu, layernorm), qwen3-32b (qk-norm), deepseek-moe-16b
   and qwen3-moe-30b-a3b (MoE), whisper-small (encoder and cross-attention
   on frame embeddings) and qwen2-vl-72b (patch embeddings, M-RoPE),
   qwen3-moe-30b-a3b at full width cut to 2 layers and llama3.2-3b's smoke
   config with the int8 KV cache, float32 weights, one 256-position
   prompt, ``prefill`` (one K4 launch a self-attention) then 8 greedy
   ``decode_step`` calls on cuda and on cpu — logits within 1e-4 relative
   L2, the same tokens;
14. the model, full width: hymba-1.5b (32 layers, d_model 1600) in bf16 with
   random weights from ``init_params(seed=0)``, 4 seeded prompts of 2048
   tokens through ``make_prefill_step`` (cache of 2080 positions) with K4's,
   K5's and the mixer's prologue and epilogue counts set to 0 just before
   (32 launches each, one a layer, K4's and K5's all on the tensor cores,
   and none during decode) and every K4
   and K5 input captured, then 32 greedy
   ``make_serve_step`` decode steps; prefill and decode times, peak device
   memory and the device busy share of a profiled prefill; then
   ``ServeEngine`` at full width (4 slots, 6 seeded requests of 2-7 prompt
   tokens, 8 new tokens each); the model is freed before phase 15;
15. the rest of ``nn/``, each model freed before the next, each prefill
   run with K4's count set to 0 just before and every K4 input captured,
   held to its plain version and timed beside SDPA: deepseek-moe-16b as
   published (28 layers, 64 experts top-6 and 2 shared, bf16 random
   weights; 16.4 B parameters) on 4 x 2048 tokens (28 K4 launches), the
   assignments dropped for capacity and the aux loss a layer, 32 decode
   steps beside their bytes bound, the device busy share of a profiled
   prefill, one MoE layer split by CUDA events into routing, dispatch,
   expert products, combine and shared experts and held on 512 tokens to
   itself on the cpu in float32 (routing equal), then ``ServeEngine``;
   whisper-small as published on 4 x 1500 frame embeddings and 4 x 64
   tokens (24 K4 launches, 12 non-causal at S 1500) and 32 decode steps
   through cross-attention, the cached encoder output unchanged;
   qwen2-vl-72b at full width cut to 4 layers on 2 x 2048 patch embeddings
   (K4 at rep 8), ``forward_logits`` with image-grid positions and 8
   decode steps; llama3.2-3b with the int8 KV cache on 4 x 2048 tokens and
   32 decode steps beside the bf16 cache's (half the k/v bytes, logits
   within the reference's 0.08);
16. training: (a) K4's and K5's autograd Functions (the launch forward;
   K4's backward kernels for bf16, the torch-op backwards otherwise, each
   bf16 K4 backward counted) held on the card to ``torch.autograd`` of their
   plain versions, on ragged shapes in float32 and bf16 and at hymba-1.5b's
   training shapes (K4 bf16 ``[2, 4096, 25, 64]`` with 5 kv heads), each
   gradient's worst error over its largest entry printed; (b) every smoke
   config and hymba-1.5b at full width cut to 2 layers, float32, 2 x 256
   ``SyntheticTokens`` tokens: ``lm_loss`` and every gradient leaf on cuda
   held to cpu, K4, K5 and the mixer's two kernels launched in the
   forward and again in each checkpointed layer's recompute (the mixer's
   backward the plain pieces' torch ops), and a ``make_train_step`` with
   ``microbatches=2`` held to one with 1 (configs without experts); (c)
   tinyllama-1.1b's smoke config through ``Trainer`` under
   ``torch.use_deterministic_algorithms(True)``: 6 steps straight equal 3 +
   crash + 3 resumed from the checkpoint, bit for bit; (d) hymba-1.5b as
   published (1,640,144,000 parameters, bf16 weights, float32 AdamW
   moments, ``remat``) on one fixed batch of 2 x 4096 tokens: a warm-up
   step, 8 timed steps with K4's, K5's and the mixer's counts set to 0
   just before (2 x 32 launches each a step, forward and recompute), the
   loss finite and
   falling, step wall, training tokens/s, model-flop share, peak device
   memory, one step split into forward, backward and optimizer, every K4
   and K5 input of one step held to its plain version, K4's forward launch
   beside its backward and SDPA's forward and backward, K4's backward
   kernels' row (wrapper, launch alone, plain, SDPA's backward, bound) at
   hymba's shape and at deepseek-moe-16b's D 128 with one query head a kv
   head, 32 backward calls a step counted, and the
   device busy share of one profiled step; each model freed before the
   next;
17. the dry run and the layout: (a) the reference's three §Perf cells
   (qwen3-moe-30b-a3b and qwen2-vl-72b x train_4k, qwen3-32b x decode_32k)
   on the 16 x 16 pod, qwen3-moe-30b-a3b x train_4k on the 2 x 16 x 16
   pod, and hymba-1.5b and whisper-small x train_4k on the 16 x 16 pod
   (heads and vocab that do not divide the model axis), at full width as
   published, each traced on a fake world of 256 or
   512 ranks (``repro_torch.launch.dryrun``: DTensor layouts from
   ``repro_torch.parallel``, the step run on ``meta`` tensors, every
   collective recorded), its collectives priced by one K1 launch on the
   card and again on the cpu (within rtol 1e-4 / atol 1e-6), the trace
   seconds, collectives by kind, argument bytes and FLOPs a rank (against
   the model estimate, within the reference's bounds for train cells)
   printed; (b) on a real one-rank NCCL world, hymba-1.5b at full width
   prefilled on 4 x 2048 tokens plainly and with its parameters laid out
   on a 1 x 1 mesh under a ``ShardingContext``: logits and cache bit-equal,
   32 launches each of K4, K5 and the mixer's prologue and epilogue in
   each; (c) deepseek-moe-16b's smoke config
   checkpointed and restored with ``shardings`` onto that mesh, every leaf
   bit-equal on the placements asked for;
18. the programs across ranks: the ``torch.distributed`` programs on
   worlds of ranks as threads of this process (``launch.mesh.run_ranks``:
   every rank computes on the one card, the threaded group's collectives
   are copies on it, and a time is the world's work serialised on the
   card, not a network's): (a) ``moe_ffn_ep`` for qwen3-moe-30b-a3b's MoE
   layer at full width (bf16 random weights) on 8 ranks, capacity factor
   8 on 1 x 2048 tokens held to ``moe_ffn`` on one device and 1.25 on 4 x
   2048 tokens (drops) to ``moe_ffn_ep`` on a one-rank NCCL world, both
   within relative L2 2^-8, with the drops, a call's wall and the peak
   memory; (d) the executor across 8 ranks, ``tests/test_exec.py``'s
   cases (4 presets x their strategies x both colorings): every delivered
   matrix bit-equal to ``run_reference`` and to the virtual ranks, each
   rank's digest one K1 launch within rtol 1e-4, ``time_schedule(mesh=)``
   beside the virtual ranks'; (b) ``gpipe`` over hymba-1.5b's 32 layers
   in 4 stages on 4 ranks, 4 microbatches of [1, 2048] in bf16, held to
   the layers in order, K4's and K5's counts set to 0 just before (224
   launches each); (c) ``dp_grads_compressed`` on hymba-1.5b's
   ``lm_loss``, one [1, 2048] row a rank on 4 ranks (2 where 4 ranks'
   float32 state would pass 72 GB): every entry within half a
   quantisation step of the ranks' uncompressed mean, the one shot
   within relative L2 0.07 of it and the 4-step error-feedback average
   within 0.02 and below the one shot, and that mean within 0.04 of the
   gradient of the mean loss on the whole batch on one device; (e) the
   same programs on a one-rank NCCL world (the MoE layer, one 32-layer
   stage, one row's compression) and the one-rank schedules of every
   strategy through ``execute(mesh=)``;
19. one ``{"kernels": [...]}`` JSON line: launches on the full-width runs
   (K1's and K2's rows add ``registry``, ``delta``, ``service``, ``exec``
   and ``verify``: their launches on phase 7's sweep, on phase 8, on phase
   9's cold query and reprice, on phase 10 and on phase 11's two checked
   sweeps, and K1's ``collectives``, ``dryrun`` and ``ranks``, on phases
   12, 17 and 18,
   with their calls' times and bound summed as below), worst error
   against the plain version, and CUDA-event times of the
   wrapper, the launch alone, the plain version and the one-call PyTorch
   yardstick, each summed over every call the full-width run made, beside
   the least time the card could take for the same calls; K1's row adds
   its launches by path and each call's path, K3's its lanes per operator
   and its bound over every padded slot (``bound_padded_ms``); K4's row adds
   its ``path`` ("wgmma"), its TFLOP/s launch alone, ``vs_library``
   (launch alone over SDPA) and ``rest_of_nn`` (its launches and summed
   figures on each model of phase 15), K5's its ``path`` ("mma.sync
   3xTF32"), and both their ``tc_launches``, ``train`` (their launches
   and summed figures on phase 16's hymba training, with their torch-op
   backwards' times) and ``ranks`` (their launches in phase 18's
   ``gpipe``, on thread ranks and on NCCL);
20. the card's name and power limit as ``nvidia-smi`` reports them, then,
   last, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32 (TF32 is switched off), so the
plain versions are exact references up to the order of their sums.  Exits
non-zero, printing no result, when no CUDA device is available or the
port's sources are not beside the script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
INT32_LANES_PER_SM = 64            # Hopper SM: 64 INT32 lanes
SMS = 132
RTOL, ATOL = 1e-4, 1e-6
FULL = {"nx": 40, "torus": (8, 8, 4), "max_ranks": 8192}
SMALL = {"nx": 16, "torus": (4, 4, 2)}
KERNEL_ROWS = {
    "segment_reduce": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/comm_stack.py:410"),
    "queue_walk": ("src/repro_torch/kernels/csrc/queue_walk.cu",
                   "src/repro/kernels/comm_stack.py:647"),
    "spmv_block_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                       "src/repro/kernels/spmv_ell.py:27"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd.cu",
                        "src/repro/kernels/ssd.py:25"),
}
# The reference's winners of the shipped LLM workload registry, (machine,
# scenario, phase) -> (model winner, simulator winner): the JAX package's
# ``repro.workloads.sweep()`` (its golden test pins the same table).
REGISTRY_WINNERS = {
    ("lassen", "qwen3-moe-a2a", "dispatch"):
        ("host_staged", "host_staged"),
    ("lassen", "qwen3-moe-a2a", "combine"):
        ("host_staged", "host_staged"),
    ("lassen", "deepseek-moe-a2a", "dispatch"):
        ("host_staged", "host_staged"),
    ("lassen", "deepseek-moe-a2a", "combine"):
        ("host_staged", "host_staged"),
    ("lassen", "llama3-tp", "reduce_scatter"):
        ("three_step", "three_step"),
    ("lassen", "llama3-tp", "all_gather"):
        ("three_step", "three_step"),
    ("lassen", "llama3-pipeline", "p2p"):
        ("three_step", "three_step"),
    ("frontier", "qwen3-moe-a2a", "dispatch"):
        ("standard", "standard"),
    ("frontier", "qwen3-moe-a2a", "combine"):
        ("three_step", "three_step"),
    ("frontier", "deepseek-moe-a2a", "dispatch"):
        ("standard", "standard"),
    ("frontier", "deepseek-moe-a2a", "combine"):
        ("three_step", "three_step"),
    ("frontier", "llama3-tp", "reduce_scatter"):
        ("standard", "standard"),
    ("frontier", "llama3-tp", "all_gather"):
        ("standard", "standard"),
    ("frontier", "llama3-pipeline", "p2p"):
        ("three_step", "three_step"),
    ("blue_waters", "qwen3-moe-a2a", "dispatch"):
        ("standard", "standard"),
    ("blue_waters", "qwen3-moe-a2a", "combine"):
        ("three_step", "three_step"),
    ("blue_waters", "deepseek-moe-a2a", "dispatch"):
        ("standard", "standard"),
    ("blue_waters", "deepseek-moe-a2a", "combine"):
        ("three_step", "three_step"),
    ("blue_waters", "llama3-tp", "reduce_scatter"):
        ("standard", "standard"),
    ("blue_waters", "llama3-tp", "all_gather"):
        ("standard", "standard"),
    ("blue_waters", "llama3-pipeline", "p2p"):
        ("standard", "standard"),
}
# Figs. 10-11 at the reference benchmark's own setup
# (benchmarks/bench_paper.py, bench_amg_spmv_spgemm) and the JAX package's
# six derived rows there (``python -m benchmarks.run``; the SpGEMM rows are
# its ``fig10_11_spgemm_AP_*``).
FIG10_11_SETUP = {"nx": 14, "torus": (4, 4, 2), "max_ranks": 1024}
FIG10_11_REFERENCE = {
    "spmv": {"underprediction": 0.10180537092653945,
             "plus_queue_relerr": 0.110817854207341,
             "queue_contention_share": 0.1018053709265394},
    "spgemm": {"underprediction": 0.2182493935133182,
               "plus_queue_relerr": 0.1551730708057454,
               "queue_contention_share": 0.21824939351331818},
}
# The delta re-pricing search of benchmarks/bench_delta.py and the JAX
# package's record of it (``repro.sparse.optimize_partition`` with these
# arguments): its initial modeled cost, then per move (boundary, shift,
# candidate cost or None where the proposal was infeasible, accepted).
DELTA_BENCH = {"nx": 12, "torus": (4, 2, 2), "n_procs": 512, "moves": 64,
               "seed": 0, "level": "contention"}
DELTA_REFERENCE_INITIAL = 0.0001511815433307433
DELTA_REFERENCE = [
    (435, 1, 0.0001511815433307433, False),
    (262, -1, 0.0001511815433307433, False),
    (158, -1, 0.00015122136555296552, False),
    (39, -1, 0.00015119292110852108, False),
    (90, 1, 0.0001511815433307433, False),
    (332, 1, 0.00015168200259000258, False),
    (258, 1, 0.0001511815433307433, False),
    (497, 1, 0.00015120429888629885, False),
    (324, 1, 0.0001511815433307433, False),
    (287, 1, 0.00015259689842009842, False),
    (142, 1, 0.00015114172110852108, True),
    (343, -1, 0.00015114172110852108, False),
    (202, 1, 0.00015110758777518775, True),
    (284, -1, 0.00015115263019943018, False),
    (391, 1, 0.00015107345444185442, True),
    (433, -1, 0.00015107345444185442, False),
    (46, 1, 0.00015107345444185442, False),
    (12, 1, 0.0001515189211085211, False),
    (42, -1, 0.00015109620999740998, False),
    (246, -1, 0.00015103932110852112, True),
    (207, -1, 0.00015101656555296554, True),
    (3, -1, 0.0001510279433307433, False),
    (5, 1, 0.00015101656555296554, False),
    (269, 1, 0.00015148478777518776, False),
    (132, 1, 0.00015101656555296554, False),
    (391, -1, 0.0001510506988862989, False),
    (236, 1, 0.0001510581278425278, False),
    (412, 1, 0.0001509824322196322, True),
    (194, 1, 0.00015240533975653976, False),
    (486, 1, 0.0001509824322196322, False),
    (430, 1, 0.00015094260999741, True),
    (360, -1, 0.00015090847666407664, True),
    (448, -1, 0.00015100016317016313, False),
    (296, 1, 0.00015095398777518776, False),
    (433, 1, 0.00015090847666407664, False),
    (192, -1, 0.00015086106925666927, True),
    (217, -1, 0.00015086106925666927, False),
    (368, 1, 0.00015413189826469825, False),
    (38, 1, 0.00015086106925666927, False),
    (272, -1, 0.00015415407946127945, False),
    (344, 1, 0.0001509136641284641, False),
    (131, -1, 0.00015132929147889147, False),
    (368, 1, 0.00015413189826469825, False),
    (258, -1, 0.00015082124703444703, True),
    (389, -1, 0.00015087384190624187, False),
    (168, 1, 0.00015082124703444703, False),
    (135, -1, 0.00015078711370111367, True),
    (365, 1, 0.0001508269359233359, False),
    (25, -1, 0.00015078711370111367, False),
    (193, 1, 0.00015074729147889146, True),
    (205, 1, 0.00015070746925666925, True),
    (162, -1, 0.00015066764703444702, True),
    (405, 1, 0.00015066764703444702, False),
    (41, -1, 0.00015064489147889148, True),
    (344, -1, 0.00015111357865837862, False),
    (294, -1, 0.0001506221359233359, True),
    (440, -1, 0.0001511188025900026, False),
    (458, 1, 0.0001511188025900026, False),
    (361, -1, 0.0001506221359233359, False),
    (392, -1, 0.00015067473079513076, False),
    (292, -1, 0.0001506221359233359, False),
    (510, -1, 0.00015061075814555813, True),
    (484, -1, 0.00015061075814555813, False),
    (319, 1, 0.0001505709359233359, True),
]
# K3 against its plain version: both sum the same float32 products of a row,
# in another order (no atomics, so the card's result does not change from
# run to run); each sum is off by far less than 1e-5 of the row's sum of
# magnitudes.  bfloat16 outputs may round one ulp (2^-8) apart on top.
K3_RTOL = 1e-5
BF16_ULP = 2.0 ** -8
# The V-cycle on cuda against cpu: 85 such SpMVs and the Jacobi updates in
# float32; relative L2 gap allowed, the same bound the CPU tests hold the
# float32 cycle to against the float64 reference (measured there: ~1.5e-7).
VCYCLE_RTOL = 1e-5
# peak rates of one H100 SXM (data sheet, dense): bf16 and TF32 on the
# tensor cores, float32 outside them (float32 inputs keep float32 products:
# TF32 is off for torch; K5 splits each float32 product into three TF32 ones)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# K4 and K5 against their plain versions: the same float32 products summed
# in another order, held to the reference's own kernel-test bounds
# (tests/test_kernels.py: flash 2e-5, SSD 2e-4); a bfloat16 output may in
# addition round one ulp apart, at most 2^-7 of its magnitude.  K4's
# bfloat16 kernel rounds the softmax weights p to bf16 before P V (as a
# TPU's matrix unit does at default precision), which moves a row by at most
# 2^-9 max_j |v_j|: held to 2^-8 of the max over the keys of its (batch, kv
# head) on top (tests/test_torch_attention.py checks the bound on an
# emulation of that arithmetic).
K4_TOL = 2e-5
K5_TOL = 2e-4
BF16_REL_ULP = 2.0 ** -7
BF16_P_TOL = 2.0 ** -8
# the model on cuda against cpu, float32 weights: relative L2 of every
# logits row (prefill and each decode step)
MODEL_RTOL = 1e-4
# dense ids whose smoke configs the small-model phase adds: llama2-style,
# gelu MLP with layernorm, qk-norm
DENSE_SMOKE = ("tinyllama-1.1b", "starcoder2-3b", "qwen3-32b")
# ids of the other families whose smoke configs it adds: MoE (with leading
# dense layers and shared experts), encoder-decoder, patch frontend
FAMILY_SMOKE = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "whisper-small",
                "qwen2-vl-72b")
HYMBA = {"arch": "hymba-1.5b", "batch": 4, "prompt": 2048, "max_seq": 2080,
         "decode": 32, "small_prompt": 256, "small_decode": 8,
         "engine": {"slots": 4, "requests": 6, "max_new": 8, "max_seq": 64}}


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sync_time(fn):
    """(result, wall seconds) of ``fn()`` ending in a device sync."""
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


# -- phase 2: kernel parity ------------------------------------------------

def k1_err(ks, values, ids, n_seg, path=None) -> float:
    """K1 against its plain version on one input, through the wrapper or,
    with ``path``, the launch alone on that path; returns the worst abs
    error and the worst error relative to the bound.  Sums: within ATOL +
    RTOL x the segment's sum of magnitudes of the float64 sum (the kernel
    adds in another order; for non-negative values — every input of the
    main path — this is allclose at rtol 1e-4 / atol 1e-6; the float32
    plain version's own atomics drift past it on one hot segment of 10^6
    messages).  Maxima: equal to the plain version's, since a maximum does
    not depend on order."""
    sums, maxs = (ks.segment_reduce(values, ids, n_seg) if path is None else
                  ks._segment_reduce_cuda(values, ids, n_seg, path))
    _, want_m = ks.segment_reduce_plain(values, ids, n_seg)
    if n_seg == 0:
        return 0.0, 0.0
    want_s = ks.segment_reduce_plain(values.double(), ids, n_seg)[0]
    scale, _ = ks.segment_reduce_plain(values.double().abs(), ids, n_seg)
    err = (sums - want_s).abs()
    if bool((err > ATOL + RTOL * scale).any()):
        raise AssertionError(f"segment_reduce sums off by up to "
                             f"{float(err.max())} (n={values.numel()}, "
                             f"n_seg={n_seg})")
    torch.testing.assert_close(maxs, want_m, rtol=0, atol=0)
    rel = float((err / (ATOL + RTOL * scale)).max())
    return float(torch.maximum(err.max().float(),
                               (maxs - want_m).abs().max())), rel


def k1_inputs(rng, dev):
    """(label, values, ids, n_seg) of K1's parity phase: ragged sizes, then
    the shapes its redesign is for, each below and above the shared-memory
    capacity ``ks.K1_BIN_CAP`` (4,096 segments)."""
    def t(vals, ids):
        return (torch.from_numpy(np.asarray(vals, np.float32)).to(dev),
                torch.from_numpy(np.asarray(ids, np.int32)).to(dev))
    for n, n_seg in ((0, 5), (1, 1), (1, 7), (513, 2000), (1_000_000, 3)):
        yield (f"n {n}, {n_seg} random ids",
               *t(rng.standard_normal(n) * 1e3, rng.integers(0, n_seg, n)),
               n_seg)
    phase = np.repeat(np.arange(46), rng.integers(30_000, 55_000, 46))
    yield "46 sorted runs", *t(rng.exponential(1e3, phase.size), phase), 46
    hot = np.full(1_500_000, 7)
    hot[rng.integers(0, hot.size, 1000)] = rng.integers(0, 50, 1000)
    yield "one hot segment", *t(rng.exponential(10.0, hot.size), hot), 50
    yield "random ids, 300 segments", *t(rng.standard_normal(1_000_003),
                                         rng.integers(0, 300, 1_000_003)), 300
    ids = np.sort(rng.integers(0, 400_000, 2_000_000))
    yield "sorted ids above capacity", *t(rng.exponential(1.0, ids.size),
                                          ids), 400_000
    yield "random ids above capacity", *t(
        rng.standard_normal(1_000_000) * 1e3,
        rng.integers(0, 300_000, 1_000_000)), 300_000
    keys = np.repeat(np.sort(rng.integers(0, 36_000, 1_500_000)),
                     rng.integers(1, 5, 1_500_000))
    yield "short runs above capacity", *t(rng.exponential(1.0, keys.size),
                                          keys), 36_000


def k2_check(ks, posted, arrival, bounds) -> int:
    """K2 against its plain version on one input: bit-equal or raise;
    returns the worst abs difference in steps (0 for an empty walk)."""
    got = ks.queue_walk(posted, arrival, bounds)
    want = ks.queue_walk_plain(posted, arrival, bounds)
    if not torch.equal(got, want):
        bad = int(torch.nonzero(got != want)[0])
        raise AssertionError(f"queue_walk differs from its plain version at "
                             f"arrival {bad}: {int(got[bad])} vs "
                             f"{int(want[bad])}")
    return int((got - want).abs().max()) if got.numel() else 0


def kernel_parity(ks, dev) -> None:
    rng = np.random.default_rng(0)
    worst, rel, cases = 0.0, 0.0, 0
    for label, vals, ids, n_seg in k1_inputs(rng, dev):
        paths = ["global"] + (["smem"] if n_seg <= ks.K1_BIN_CAP else [])
        for path in [None, *paths]:
            e, r = k1_err(ks, vals, ids, n_seg, path)
            worst, rel, cases = max(worst, e), max(rel, r), cases + 1
        log(f"  K1 {label} (n {vals.numel()}, {n_seg} segments): wrapper "
            f"takes {ks.k1_path(n_seg)}; {' and '.join(paths)} path held "
            f"to the plain version")
    log(f"K1 parity: {cases} cases, max abs err {worst:.3g}, worst error "
        f"{rel:.3g} of the bound")
    k2_parity(ks, dev, rng)


def k2_layouts(rng):
    """Region sizes of K2's parity phase: ragged random sizes, then a
    region of 10,000 arrivals (five 2,048-word tiles of the kernel's
    window; the plain lock-step walk takes one round an arrival, so this
    is as long as the phase affords) and runs of empty regions between,
    around and after non-empty ones, one of them longer than a block."""
    for n_regions, max_count in ((1, 1), (3, 0), (40, 25), (2, 2000),
                                 (50_000, 64)):
        yield rng.integers(0, max_count + 1, n_regions)
    yield np.array([3, 10_000, 0, 7])
    runs = rng.integers(0, 40, 3000) * (rng.random(3000) < 0.3)
    yield np.concatenate([[0] * 5, runs[:1500], [0] * 1500, runs[1500:],
                          [0] * 9])


def k2_parity(ks, dev, rng) -> None:
    cases = 0
    for counts in k2_layouts(rng):
        bounds = np.concatenate([[0], np.cumsum(counts)])
        posted = [rng.permutation(c) for c in counts]
        arrival = [rng.permutation(c) for c in counts]
        k2_check(ks, *(torch.from_numpy(np.concatenate(a).astype(np.int64)
                                        if len(a) else np.zeros(0, np.int64)
                                        ).to(dev)
                       for a in (posted, arrival)),
                 torch.from_numpy(bounds.astype(np.int64)).to(dev))
        cases += 1
    log(f"K2 parity: {cases} region layouts (up to 10,000 arrivals a "
        f"region, runs of empty regions), bit-equal")


def k3_err(ell, blocks, cols, x, lanes=None) -> float:
    """K3 against its plain version on one input, through the wrapper or,
    with ``lanes``, the launch alone with that many threads a row; returns
    the worst abs error, or raises if a row is off by more than K3_RTOL of
    its sum of magnitudes (plus one bfloat16 rounding step of the
    output)."""
    got = (ell.spmv_block_ell(blocks, cols, x) if lanes is None else
           ell._spmv_block_ell_cuda(blocks, cols, x, lanes))
    want = ell.spmv_block_ell_plain(blocks, cols, x)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"spmv_block_ell gave {got.dtype} "
                             f"{tuple(got.shape)}, expected {want.dtype} "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not got.numel():
        return 0.0
    scale = ell.spmv_block_ell_plain(blocks.float().abs(), cols,
                                     x.float().abs())
    tol = K3_RTOL * scale
    if x.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * want.abs()
    err = (got - want).abs()
    if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
        bad = int(torch.argmax(err - tol))
        raise AssertionError(f"spmv_block_ell off at row {bad}: "
                             f"{float(got[bad])} vs {float(want[bad])} "
                             f"(blocks {tuple(blocks.shape)}, {x.dtype})")
    return float(err.max())


def k3_parity(dev) -> None:
    """K3 on ragged shapes: bs 3 (the scalar path), 4, 8 and 16; max_bpr 0
    and 1; a rectangular P and its P^T; rows past n; float32, bfloat16 and
    mixed; an x that is not 16-byte aligned."""
    from repro_torch.kernels import spmv_ell as ell
    from repro_torch.sparse.amg import build_hierarchy
    from repro_torch.sparse.csr import CSR, eye
    from repro_torch.sparse.problems import elasticity_like_3d, poisson_3d

    rng = np.random.default_rng(1)
    P = build_hierarchy(elasticity_like_3d(8))[1].P          # 1536 x 145
    mats = {"poisson_3d(7)": poisson_3d(7), "P": P, "P^T": P.transpose(),
            "eye(37)": eye(37),                               # max_bpr 1
            "zero 21x13": CSR(np.zeros(22, np.int64), np.zeros(0, np.int64),
                              np.zeros(0), (21, 13))}         # max_bpr 0
    worst, n = 0.0, 0
    for name, A in mats.items():
        for bs in (3, 4, 8, 16):
            blocks, cols, _ = ell.csr_to_block_ell(A, bs, dev)
            ncb = -(-A.n_cols // bs)
            x = torch.from_numpy(rng.standard_normal(ncb * bs + 1)
                                 .astype(np.float32)).to(dev)
            for xb, xx in ((blocks, x[:-1]), (blocks, x[1:]),
                           (blocks.bfloat16(), x[:-1].bfloat16()),
                           (blocks.bfloat16(), x[:-1])):
                worst = max(worst, k3_err(ell, xb, cols, xx))
                n += 1
    torch.cuda.synchronize()
    log(f"K3 parity: {n} cases ({', '.join(mats)}; bs 3, 4, 8, 16; float32, "
        f"unaligned x, bfloat16, mixed), max abs err {worst:.3g}")


# -- phases 3 and 4: the slice ------------------------------------------------

def amg_patterns(nx: int, machine, max_ranks: int):
    from repro_torch.sparse.amg import build_hierarchy
    from repro_torch.sparse.partition import RowPartition, spmv_comm_pattern
    from repro_torch.sparse.problems import elasticity_like_3d

    A = elasticity_like_3d(nx)
    levels = build_hierarchy(A)
    pats = [spmv_comm_pattern(
        lvl.A, RowPartition.balanced(lvl.A.n_rows,
                                     min(max_ranks, lvl.A.n_rows // 2)))
        for lvl in levels]
    return A, levels, pats


def check_verdicts(verdicts, strategies) -> None:
    for v in verdicts:
        for table in (v.model, v.sim):
            vals = np.asarray(list(table.values()))
            if not (np.isfinite(vals).all() and (vals > 0).all()):
                raise AssertionError(f"non-finite or non-positive totals: "
                                     f"{table}")
        if v.model_winner not in strategies or v.sim_winner not in strategies:
            raise AssertionError("winner outside the strategy set")


def small_slice() -> None:
    from repro_torch.comm.strategies import STRATEGIES, best_strategy_many
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine(SMALL["torus"])
    _, levels, pats = amg_patterns(SMALL["nx"], m, m.n_procs)
    gpu, t_gpu = sync_time(lambda: best_strategy_many(pats, m))
    t = time.perf_counter()
    cpu = best_strategy_many(pats, m, device="cpu")
    t_cpu = time.perf_counter() - t
    check_verdicts(gpu, STRATEGIES)
    for lvl, (g, c) in enumerate(zip(gpu, cpu)):
        if (g.model_winner, g.sim_winner) != (c.model_winner, c.sim_winner):
            raise AssertionError(
                f"small slice level {lvl}: cuda picks {g.model_winner}/"
                f"{g.sim_winner}, cpu {c.model_winner}/{c.sim_winner}")
        for s in c.model:
            np.testing.assert_allclose(g.model[s], c.model[s], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(g.sim[s], c.sim[s], rtol=RTOL,
                                       atol=ATOL)
    log(f"small slice: elasticity_like_3d({SMALL['nx']}), {len(levels)} "
        f"levels, {m.n_procs} ranks; winners (model/sim) "
        f"{[(v.model_winner, v.sim_winner) for v in gpu]} equal on cuda "
        f"({t_gpu:.2f} s) and cpu ({t_cpu:.2f} s), totals allclose")
    return levels


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def small_vcycle(levels) -> None:
    """One V-cycle on the small hierarchy on cuda and on cpu, held
    together at VCYCLE_RTOL (relative L2)."""
    from repro_torch.sparse.amg import DeviceHierarchy, vcycle

    h = DeviceHierarchy.build(levels)
    b = np.random.default_rng(0).standard_normal(levels[0].A.n_rows)
    x_gpu, t_gpu = sync_time(lambda: vcycle(h, b))
    x_cpu = vcycle(h.to("cpu"), b)
    rel = rel_l2(x_gpu, x_cpu)
    if not rel <= VCYCLE_RTOL or not bool(torch.isfinite(x_gpu).all()):
        raise AssertionError(f"small V-cycle: cuda vs cpu relative L2 {rel}")
    log(f"small V-cycle: elasticity_like_3d({SMALL['nx']}), levels "
        f"{[lvl.A.n_rows for lvl in levels]}; cuda ({t_gpu * 1e3:.2f} ms) vs "
        f"cpu relative L2 {rel:.3g} (limit {VCYCLE_RTOL})")


def counted_kernels(ks, fn):
    """Run ``fn()`` with K1's and K2's counts set to 0 just before and read
    just after, every K1/K2 input captured and every ``PhaseStack.build``
    counted.  Returns (result, wall seconds, launches, captured inputs,
    arenas built)."""
    from repro_torch.comm.stack import PhaseStack

    captured = {name: [] for name in ("segment_reduce", "queue_walk")}
    real = {name: getattr(ks, name) for name in captured}
    real_build = PhaseStack.__dict__["build"]
    builds = []

    def spy(name):
        def call(*args):
            captured[name].append(args)
            return real[name](*args)
        return call

    def counted_build(cls, *a, **kw):
        builds.append(1)
        return real_build.__func__(cls, *a, **kw)

    for name in real:
        setattr(ks, name, spy(name))
    PhaseStack.build = classmethod(counted_build)
    try:
        ks.reset_launches()
        out, wall = sync_time(fn)
        launches = dict(ks.LAUNCHES)
    finally:
        for name, orig in real.items():
            setattr(ks, name, orig)
        PhaseStack.build = real_build
    return out, wall, launches, captured, len(builds)


def counted_sweep(ks, fn):
    """Run the strategy sweep ``fn()`` through :func:`counted_kernels`,
    with ``candidate_set`` (the host rewrites) and ``price_candidates`` (the
    device passes) timed.  Returns (result, wall seconds, launches,
    captured inputs, {"rewrite", "pricing"} seconds, {"arena", "phases"}
    sizes of the candidate set)."""
    from repro_torch.comm import strategies

    real_cands, real_price = strategies.candidate_set, \
        strategies.price_candidates
    split, sizes = {}, {}

    def timed_cands(*a, **kw):
        out, split["rewrite"] = sync_time(lambda: real_cands(*a, **kw))
        sizes["arena"], sizes["phases"] = out.n_msgs, len(out.phases)
        return out

    def timed_price(*a, **kw):
        out, split["pricing"] = sync_time(lambda: real_price(*a, **kw))
        return out

    strategies.candidate_set = timed_cands
    strategies.price_candidates = timed_price
    try:
        out, wall, launches, captured, _ = counted_kernels(ks, fn)
    finally:
        strategies.candidate_set = real_cands
        strategies.price_candidates = real_price
    return out, wall, launches, captured, split, sizes


def full_slice(ks):
    """The full-width run, with launches counted and kernel inputs
    captured; returns (launch counts, captured inputs, the AMG levels,
    their patterns, the sweep's verdicts)."""
    from repro_torch.comm import strategies
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine(FULL["torus"])
    t = time.perf_counter()
    A, levels, pats = amg_patterns(FULL["nx"], m, FULL["max_ranks"])
    t_setup = time.perf_counter() - t
    log(f"full slice: elasticity_like_3d({FULL['nx']}): {A.n_rows} dof, "
        f"{A.nnz} nnz, {len(levels)} AMG levels "
        f"{[lvl.A.n_rows for lvl in levels]}, ranks "
        f"{[p.n_procs for p in pats]} on blue_waters_machine("
        f"{FULL['torus']}) ({m.n_procs} ranks); operator + hierarchy + "
        f"patterns {t_setup:.2f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    verdicts, wall, launches, captured, split, sizes = counted_sweep(
        ks, lambda: strategies.best_strategy_many(pats, m))
    peak = torch.cuda.max_memory_allocated()
    check_verdicts(verdicts, strategies.STRATEGIES)
    log(f"full slice arena: {sizes['arena']} messages in "
        f"{sizes['phases']} candidate phases")
    for lvl, (v, p) in enumerate(zip(verdicts, pats)):
        log(f"  level {lvl}: {p.n_procs} ranks, {p.n_msgs} msgs; model "
            f"picks {v.model_winner}, simulator picks {v.sim_winner}; model "
            + ", ".join(f"{s}={v.model[s]:.6g}" for s in v.model)
            + "; sim " + ", ".join(f"{s}={v.sim[s]:.6g}" for s in v.sim))
    bind = wall - split["rewrite"] - split["pricing"]
    log(f"full slice best_strategy_many wall {wall:.3f} s: bind {bind:.3f} "
        f"s + rewrite {split['rewrite']:.3f} s (host) + pricing "
        f"{split['pricing']:.3f} s (device passes with host order "
        f"assembly); max_memory_allocated {peak} bytes")
    log(f"full slice launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the full-width "
                                 "run")
    device_share(lambda: strategies.best_strategy_many(pats, m))
    return launches, captured, levels, pats, verdicts


def full_vcycle(levels):
    """The full-width V-cycle with K3's count set to 0 just before and every
    K3 input captured; returns (launches, captured calls, operator label of
    every captured call, host CSR of every label, K3's device ms over a
    profiled cycle)."""
    from repro_torch.kernels import spmv_ell as ell
    from repro_torch.sparse.amg import DeviceHierarchy, vcycle

    A = levels[0].A
    h, t_build = sync_time(lambda: DeviceHierarchy.build(levels, bs=8))
    tensors = [t for lv in h.levels for op in (lv.A, lv.P, lv.PT) if op
               for t in op] + [lv.dinv for lv in h.levels]
    label, host = {}, {}
    for k, (lv, hl) in enumerate(zip(h.levels, levels)):
        label[lv.A[0].data_ptr()] = f"L{k} A"
        host[f"L{k} A"] = hl.A
        if lv.P is not None:
            label[lv.P[0].data_ptr()] = f"L{k} P"
            label[lv.PT[0].data_ptr()] = f"L{k} P^T"
            host[f"L{k} P"] = hl.P
            host[f"L{k} P^T"] = hl.P.transpose()
    max_bpr = [tuple(op[0].shape[1] for op in (lv.A, lv.P, lv.PT) if op)
               for lv in h.levels]
    log(f"full V-cycle: DeviceHierarchy.build {t_build:.3f} s (host "
        f"block-ELL conversion + copies), {len(h.levels)} levels, "
        f"{sum(t.numel() * t.element_size() for t in tensors)} bytes on the "
        f"card; max_bpr per level (A, P, P^T): {max_bpr}")

    k3_lanes_parity(ell, h, label)
    b = np.random.default_rng(0).standard_normal(A.n_rows)
    vcycle(h, b)                                      # warm-up, not counted
    captured = []
    real = ell.spmv_block_ell

    def spy(*args):
        captured.append(args)
        return real(*args)

    ell.spmv_block_ell = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        ell.reset_launches()
        x_gpu, wall = sync_time(lambda: vcycle(h, b))
        launches = ell.LAUNCHES["spmv_block_ell"]
    finally:
        ell.spmv_block_ell = real
    peak = torch.cuda.max_memory_allocated()
    expected = 7 * (len(levels) - 1) + 50
    log(f"full V-cycle launches: {{'spmv_block_ell': {launches}}} (expected "
        f"{expected}: 7 per level above the coarsest, 50 on it)")
    if launches != expected:
        raise AssertionError(f"spmv_block_ell launched {launches} times on "
                             f"the full-width V-cycle, expected {expected}")
    no_sync_cycle(h, b, x_gpu)
    x_cpu, t_cpu = sync_time(lambda: vcycle(h.to("cpu"), b))
    rel = rel_l2(x_gpu, x_cpu)
    if not rel <= VCYCLE_RTOL or not bool(torch.isfinite(x_gpu).all()):
        raise AssertionError(f"full V-cycle: cuda vs cpu relative L2 {rel}")
    walls = [sync_time(lambda: vcycle(h, b))[1] for _ in range(5)]
    log(f"full V-cycle: one cycle on cuda {wall * 1e3:.3f} ms wall (counted "
        f"run), 5 more {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; "
        f"max_memory_allocated {peak} bytes; cpu plain cycle {t_cpu:.3f} s, "
        f"cuda vs cpu relative L2 {rel:.3g} (limit {VCYCLE_RTOL})")
    # K3's own device time over a whole cycle: the CUDA-event times of
    # k3_row include the host's launch cost, which the small calls wait on
    k3_device = [(us, n) for us, n, key in device_share(lambda: vcycle(h, b))
                 if "ell_rows" in key]
    device_ms = sum(us for us, _ in k3_device) / 1e3 if k3_device else None
    log(f"full V-cycle: K3 device time under the profiler "
        f"{device_ms} ms over {sum(n for _, n in k3_device)} launches")

    x, res = None, []
    for _ in range(10):
        x = vcycle(h, b, x)
        r = b - A.spmv(x.double().cpu().numpy())
        res.append(float(np.linalg.norm(r) / np.linalg.norm(b)))
    log("full V-cycle: relative residual over 10 cycles (host float64 "
        "CSR.spmv): " + ", ".join(f"{r:.3e}" for r in res))
    falling = all(nxt < cur / 2 for cur, nxt in zip(res, res[1:])
                  if cur > 1e-5)
    if not (res[-1] < 1e-3 and falling):
        raise AssertionError(f"full V-cycle residuals do not fall: {res}")
    return launches, captured, [label[c[0].data_ptr()] for c in captured], \
        host, device_ms


def k3_lanes_parity(ell, h, label) -> None:
    """Every operator of the hierarchy at every lane count K3 takes, each
    held to the plain version (``k3_err`` with the launch forced); then a
    ``cols`` with an id past the block columns must raise before any
    launch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, n = 0.0, 0
    ops = [op for lv in h.levels for op in (lv.A, lv.P, lv.PT) if op]
    for blocks, cols in ops:
        x = torch.randn(int(cols.max()) * blocks.shape[2] + blocks.shape[2],
                        generator=gen, device="cuda")
        for lanes in (1, 2, 4, 8, 16, 32):
            worst = max(worst, k3_err(ell, blocks, cols, x, lanes))
            n += 1
    torch.cuda.synchronize()
    picked = []
    for blocks, _ in ops:
        nbr, max_bpr, bs, _ = blocks.shape
        picked.append(f"{label[blocks.data_ptr()]} "
                      f"{ell.lanes_for(nbr * bs, bs, max_bpr)}")
    log(f"K3 lanes parity: {len(ops)} operators of the full hierarchy x "
        f"lanes 1-32 ({n} launches), max abs err {worst:.3g}; lanes picked: "
        + ", ".join(picked))
    blocks, cols = h.levels[0].A
    bad = cols.clone()
    bad[-1, 0] = blocks.shape[0]                  # one past the last column
    before = ell.LAUNCHES["spmv_block_ell"]
    try:
        ell.spmv_block_ell(blocks, bad, h.levels[0].dinv)
    except ValueError as e:
        if ell.LAUNCHES["spmv_block_ell"] != before:
            raise AssertionError("K3 launched on out-of-range cols") from e
        log(f"K3 refuses out-of-range cols before launching: {e}")
    else:
        raise AssertionError("K3 took a block-column id past the columns")


def no_sync_cycle(h, b, want) -> None:
    """One full-width cycle's recursion on device vectors under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for
    the device raises, so no SpMV of the cycle syncs; the result must equal
    the counted cycle's."""
    from repro_torch.sparse.amg import _vcycle

    lv = h.levels[0]
    bp = torch.zeros(lv.dinv.numel(), device="cuda")
    bp[:lv.n] = torch.from_numpy(b.astype(np.float32)).cuda()
    xp = torch.zeros_like(bp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _vcycle(h, bp, xp, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rel = rel_l2(got[:lv.n], want)
    if not rel <= VCYCLE_RTOL:
        raise AssertionError(f"cycle under sync debug mode: relative L2 "
                             f"{rel} from the counted cycle")
    log(f"full V-cycle recursion under set_sync_debug_mode('error'): no "
        f"sync, relative L2 {rel:.3g} from the counted cycle")


def device_share(fn) -> list:
    """Run ``fn`` again under ``torch.profiler`` and print the device-busy
    share of its wall time (sum of device self time over the wall time of
    the profiled run) and the device time by kernel; returns the
    ``(device us, count, kernel name)`` rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    # device-side events only (kernels, copies): a CPU op's row repeats
    # the device time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("profiled rerun: the profiler saw no device time (not measured)")
        return rows
    log(f"profiled rerun: wall {wall:.3f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.2f} % of wall, idle {100 - 100 * busy / wall:.2f}"
        f" %); device time by kernel:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return rows


# -- phase 6: the paper's measurements ------------------------------------------

def paper_fits(device) -> dict:
    """Figs. 2-9 and Table 1 as ``benchmarks/bench_paper.py`` computes them,
    through the port's harnesses and fits on ``device``: the fitted values,
    the derived rows, every queue step of the queue and contention tests,
    and the wall of each harness call."""
    from repro_torch.core import fitting
    from repro_torch.core.models import message_time
    from repro_torch.core.params import PROTOCOL_NAMES
    from repro_torch.core.topology import contention_ell
    from repro_torch.net import pingpong
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine((2, 1, 1))
    gt = m.params
    fits, derived, steps, walls = {}, {}, [], {}

    def call(label, fn):
        out, walls[label] = sync_time(fn)
        return out

    # Figs. 2-3: ping-pong sweeps against node-aware and flat message_time
    sizes = np.unique(np.round(np.logspace(0, 6, 40)).astype(int))
    errs_na, errs_flat = [], []
    for li, kind in enumerate(gt.locality_names):
        meas = call(f"pingpong_sweep {kind}", lambda: pingpong.pingpong_sweep(
            m, kind, sizes, reps=2, noise=0.0, device=device))
        loc = np.full(sizes.shape, li)
        for errs, node_aware in ((errs_na, True), (errs_flat, False)):
            pred = message_time(gt, sizes, loc, node_aware=node_aware,
                                device=device).double().cpu().numpy()
            errs.append(np.abs(pred - meas) / meas)
    derived["fig2_flat_model_relerr"] = float(np.mean(np.concatenate(
        errs_flat)))
    derived["fig3_node_aware_relerr"] = float(np.mean(np.concatenate(
        errs_na)))
    # Table 1: (alpha, R_b) per locality and protocol, then R_N
    sizes = np.unique(np.round(np.logspace(0, 6, 48)).astype(int))
    worst = 0.0
    for li, kind in enumerate(gt.locality_names):
        meas = call(f"table1 pingpong_sweep {kind}",
                    lambda: pingpong.pingpong_sweep(m, kind, sizes, reps=2,
                                                    noise=0.0, device=device))
        fit = fitting.fit_alpha_beta(sizes, meas, gt)
        for pi, proto in enumerate(PROTOCOL_NAMES):
            a, rb = fit[proto]
            fits[f"alpha {kind} {proto}"], fits[f"Rb {kind} {proto}"] = a, rb
            worst = max(worst, abs(a - gt.alpha[li, pi]) / gt.alpha[li, pi],
                        abs(rb - gt.Rb[li, pi]) / gt.Rb[li, pi])
    ks_, ts = call("ppn_sweep", lambda: pingpong.ppn_sweep(m, 1e6,
                                                           device=device))
    fits["RN"] = fitting.fit_RN(ks_, ts, 1e6, gt.alpha[2, 2], gt.Rb[2, 2])
    derived["table1_fit_worst_param_relerr"] = float(max(
        worst, abs(fits["RN"] - 6.6e9) / 6.6e9))
    # Figs. 4-5: HighVolumePingPong, reversed against same order; gamma
    ns = np.array([100, 300, 1000, 3000])
    meas, base = [], []
    for n in ns:
        s = (1 << 22) // n
        for order, into in (("reversed", meas), ("same", base)):
            t, r1, r2 = call(f"high_volume_pingpong n={n} {order}",
                             lambda: pingpong.high_volume_pingpong(
                                 m, [(0, 32)], int(n), s, order=order,
                                 device=device))
            into.append(t)
            steps += [r1.per_proc_queue_steps, r2.per_proc_queue_steps]
    fits["gamma"] = fitting.fit_gamma(ns, np.array(meas), np.array(base))
    derived["fig5_gamma_fit_ratio"] = fits["gamma"] / gt.gamma
    # Figs. 7-9: the Gemini line; delta
    m4 = blue_waters_machine((4, 1, 1))
    ells, meas, base = [], [], []
    for n, s in [(1, 1e6), (4, 2.5e5), (16, 62500), (4, 1e6)]:
        tot, r1, r2 = call(f"contention_line_test n={n} size={s:g}",
                           lambda: pingpong.contention_line_test(
                               m4, n, s, device=device))
        base.append(r1.transport + r1.queue + r2.transport + r2.queue)
        meas.append(tot)
        steps += [r1.per_proc_queue_steps, r2.per_proc_queue_steps]
        ells.append(2 * contention_ell(4, 1, 2 * n * s * 32 / (32 * 4), 32)
                    / 2)
    fits["delta"] = fitting.fit_delta(np.array(ells), np.array(meas),
                                      np.array(base))
    derived["fig9_delta_fit_ratio"] = fits["delta"] / m4.params.delta
    return dict(fits=fits, derived=derived,
                steps=[s.cpu() for s in steps], walls=walls)


def amg_tagged(levels, op: str, machine, max_ranks: int = FULL["max_ranks"]):
    """(level, bound phase) of one operation over the hierarchy, as
    ``benchmarks/bench_paper._amg_phases`` makes them: each level over
    ``min(max_ranks, rows // 2)`` ranks, empty patterns skipped."""
    from repro_torch.sparse.partition import (RowPartition,
                                              spgemm_comm_pattern,
                                              spmv_comm_pattern)
    out = []
    for li, lvl in enumerate(levels):
        part = RowPartition.balanced(
            lvl.A.n_rows, min(max_ranks, max(lvl.A.n_rows // 2, 2)))
        if op == "spmv":
            cp = spmv_comm_pattern(lvl.A, part)
        elif li + 1 < len(levels):
            cp = spgemm_comm_pattern(lvl.A, levels[li + 1].P, part)
        else:
            break
        if cp.n_msgs:
            out.append((li, cp.bind(machine)))
    return out


def price_fig10_11(phases, arrivals, device) -> dict:
    """One ``simulate_many`` and one ``model_ladder_many`` call over an
    operation's phases on ``device``, each timed."""
    from repro_torch.core.models import MODEL_LEVELS, model_ladder_many
    from repro_torch.net.simulator import simulate_many

    sims, t_sim = sync_time(lambda: simulate_many(
        phases, arrival_orders=arrivals, device=device))
    ladders, t_lad = sync_time(lambda: model_ladder_many(phases,
                                                         device=device))
    meas = np.array([r.time for r in sims])
    mod = {lvl: np.array([lad[lvl].total for lad in ladders])
           for lvl in MODEL_LEVELS}
    return dict(sims=sims, measured=meas, ladder=mod, t_sim=t_sim,
                t_ladder=t_lad,
                steps=[r.per_proc_queue_steps.cpu() for r in sims],
                underprediction=float(np.max((meas - mod["node_aware"])
                                             / meas)),
                plus_queue_relerr=float(np.mean(np.abs(mod["queue"] - meas)
                                                / meas)),
                queue_contention_share=float(np.max(1.0 - mod["node_aware"]
                                                    / meas)))


def same_steps(got, want, what: str) -> None:
    if len(got) != len(want) or not all(torch.equal(g, w)
                                        for g, w in zip(got, want)):
        raise AssertionError(f"{what}: queue steps differ between cuda and "
                             "cpu")


def reference_setup_fig10_11(card=None) -> None:
    """Figs. 10-11 at the reference benchmark's own setup
    (``benchmarks/bench_paper.py``: ``elasticity_like_3d(14)``, its AMG
    hierarchy, each level over at most 1,024 ranks of
    ``blue_waters_machine((4, 4, 2))``, random arrivals from seed 0) on
    ``card`` and on cpu: steps bit-equal, and the six ``fig10_11_*`` rows
    held to the reference's (``FIG10_11_REFERENCE``) within rtol 1e-4; each
    level's measured time and five rungs logged."""
    from repro_torch.core.models import MODEL_LEVELS
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.sparse import build_hierarchy, elasticity_like_3d

    cfg = FIG10_11_SETUP
    levels = build_hierarchy(elasticity_like_3d(cfg["nx"]), theta=0.25)
    m = blue_waters_machine(cfg["torus"])
    for op in ("spmv", "spgemm"):
        tagged = amg_tagged(levels, op, m, max_ranks=cfg["max_ranks"])
        phases = [ph for _, ph in tagged]
        arrivals = [ph.random_arrival_order(np.random.default_rng(0))
                    for ph in phases]
        g = price_fig10_11(phases, arrivals, card)
        c = price_fig10_11(phases, arrivals, "cpu")
        same_steps(g["steps"], c["steps"], f"Figs. 10-11 {op} at "
                   f"{cfg['max_ranks']} ranks")
        got = {k: g[k] for k in FIG10_11_REFERENCE[op]}
        np.testing.assert_allclose(
            list(got.values()), list(FIG10_11_REFERENCE[op].values()),
            rtol=RTOL, err_msg=f"Figs. 10-11 {op} at the reference's setup")
        log(f"paper Fig. {10 if op == 'spmv' else 11} ({op}) at the "
            f"reference's setup: elasticity_like_3d({cfg['nx']}), "
            f"blue_waters_machine({cfg['torus']}), at most "
            f"{cfg['max_ranks']} ranks a level: {len(phases)} phases, "
            f"{sum(p.n_msgs for p in phases)} messages; simulate_many "
            f"{g['t_sim']:.3f} s, model_ladder_many {g['t_ladder']:.3f} s; "
            "steps bit-equal to cpu")
        for (li, ph), meas, *rungs in zip(
                tagged, g["measured"], *(g["ladder"][k]
                                         for k in MODEL_LEVELS)):
            log(f"  level {li}: {ph.n_procs} ranks, {ph.n_msgs} msgs, max "
                f"{ph.max_msgs_per_proc()} a rank; measured {meas:.6g} s; "
                + ", ".join(f"{k} {v:.6g}" for k, v in zip(MODEL_LEVELS,
                                                           rungs))
                + f"; +queue / measured {rungs[3] / meas:.4f}")
        log("  " + ", ".join(
            f"fig10_11_{op}_{k} {v!r} (reference "
            f"{FIG10_11_REFERENCE[op][k]!r})" for k, v in got.items()))


def paper_measurements(ks, levels, card=None) -> dict:
    """The paper's Sections 3-5 on the card: Figs. 2-9 and Table 1 on cuda
    and cpu, fits equal; Figs. 10-11 at full width with K1's and K2's
    counts set to 0 just before and every K1/K2 input captured, each held
    to its plain version, the whole run held to the same run on cpu; the
    per-phase entries against the stacked rows; one per-phase call and one
    batched sweep timed.  ``card`` is the device under test (``None`` =
    CUDA).  Returns the launch counts of the Figs. 10-11 run."""
    from repro_torch.core.models import MODEL_LEVELS, phase_cost_phase
    from repro_torch.net import pingpong
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.net.simulator import simulate

    ks.reset_launches()
    gpu, t_gpu = sync_time(lambda: paper_fits(card))
    fit_launches = dict(ks.LAUNCHES)
    cpu, t_cpu = sync_time(lambda: paper_fits("cpu"))
    for k, want in cpu["fits"].items():
        np.testing.assert_allclose(gpu["fits"][k], want, rtol=RTOL,
                                   err_msg=f"fit {k}: cuda vs cpu")
    same_steps(gpu["steps"], cpu["steps"], "Figs. 4-9")
    if not all(n > 0 for n in (fit_launches["segment_reduce"],
                               fit_launches["queue_walk"])):
        raise AssertionError(f"Figs. 2-9 did not reach K1 and K2: "
                             f"{fit_launches}")
    log(f"paper Figs. 2-9 and Table 1: cuda {t_gpu:.3f} s, cpu {t_cpu:.3f} "
        f"s; {len(cpu['fits'])} fitted values within rtol {RTOL}, "
        f"{len(cpu['steps'])} queue-step rows bit-equal; launches "
        f"{fit_launches}")
    for k, v in gpu["derived"].items():
        log(f"  {k} {v!r} (cpu {cpu['derived'][k]!r})")
    log("  fits: " + ", ".join(f"{k} {v:.6g}" for k, v in gpu["fits"].items()))
    log("  walls on cuda (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in gpu["walls"].items()))

    m = blue_waters_machine(FULL["torus"])
    captured = {name: [] for name in ("segment_reduce", "queue_walk")}
    runs = {}
    for op in ("spmv", "spgemm"):
        (tagged, t_bind) = sync_time(lambda: amg_tagged(levels, op, m))
        phases = [ph for _, ph in tagged]
        arrivals, t_arr = sync_time(lambda: [
            ph.random_arrival_order(np.random.default_rng(0))
            for ph in phases])
        g, _, launches, cap, _ = counted_kernels(
            ks, lambda: price_fig10_11(phases, arrivals, card))
        for name in captured:
            captured[name] += cap[name]
        c = price_fig10_11(phases, arrivals, "cpu")
        same_steps(g["steps"], c["steps"], f"Figs. 10-11 {op}")
        for k in ("measured", *MODEL_LEVELS):
            w = c["measured"] if k == "measured" else c["ladder"][k]
            v = g["measured"] if k == "measured" else g["ladder"][k]
            np.testing.assert_allclose(v, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"Figs. 10-11 {op} {k}")
        for k in ("underprediction", "plus_queue_relerr",
                  "queue_contention_share"):
            np.testing.assert_allclose(g[k], c[k], rtol=RTOL,
                                       err_msg=f"Figs. 10-11 {op} {k}")
        if not (launches["segment_reduce"] and launches["queue_walk"]):
            raise AssertionError(f"Figs. 10-11 {op} did not reach K1 and "
                                 f"K2: {launches}")
        if not all(np.isfinite(g["measured"])) or min(g["measured"]) <= 0:
            raise AssertionError(f"Figs. 10-11 {op}: bad measured times")
        runs[op] = dict(tagged=tagged, arrivals=arrivals, gpu=g,
                        launches=launches)
        log(f"paper Fig. {10 if op == 'spmv' else 11} ({op}) at full width: "
            f"{len(phases)} phases, {sum(p.n_msgs for p in phases)} messages"
            f"; bind {t_bind:.3f} s, arrivals {t_arr:.3f} s (host); "
            f"simulate_many cuda {g['t_sim']:.3f} s (cpu {c['t_sim']:.3f} s)"
            f", model_ladder_many cuda {g['t_ladder']:.3f} s (cpu "
            f"{c['t_ladder']:.3f} s); launches {launches}; steps bit-equal, "
            f"totals within rtol {RTOL} of cpu")
        for (li, ph), meas, *rungs in zip(
                tagged, g["measured"], *(g["ladder"][k]
                                         for k in MODEL_LEVELS)):
            log(f"  level {li}: {ph.n_procs} ranks, {ph.n_msgs} msgs, max "
                f"{ph.max_msgs_per_proc()} a rank; measured {meas:.6g} s; "
                + ", ".join(f"{k} {v:.6g}" for k, v in zip(MODEL_LEVELS,
                                                           rungs)))
        log(f"  fig10_11_{op}_node_aware_underprediction "
            f"{g['underprediction']!r}, fig10_11_{op}_plus_queue_relerr "
            f"{g['plus_queue_relerr']!r}, fig10_11_{op}_queue_contention_"
            f"share {g['queue_contention_share']!r}")
        if op == "spmv":      # the device's share of one operation's pricing
            device_share(lambda: price_fig10_11(phases, arrivals, card))

    # every K1 and K2 call of the full-width run against its plain version
    k1 = [k1_err(ks, *c) for c in captured["segment_reduce"]]
    k2 = [k2_check(ks, *c) for c in captured["queue_walk"]]
    log(f"paper Figs. 10-11 kernel calls: K1 {len(k1)} held to its plain "
        f"version (max abs err {max(e for e, _ in k1):.3g}, worst "
        f"{max(r for _, r in k1):.3g} of the bound), K2 {len(k2)} bit-equal "
        f"({sum(c[0].numel() for c in captured['queue_walk'])} arrivals)")

    reference_setup_fig10_11(card)

    # the per-phase entries against row 0 of the stacked results
    spmv = runs["spmv"]
    ph, arr, row = spmv["tagged"][0][1], spmv["arrivals"][0], \
        spmv["gpu"]["sims"][0]
    one = simulate(ph, arrival_order=arr, device=card)
    if not torch.equal(one.per_proc_queue_steps, row.per_proc_queue_steps):
        raise AssertionError("simulate(level 0 SpMV) steps differ from the "
                             "stacked row")
    for f in ("time", "transport", "queue", "contention", "max_link_bytes"):
        np.testing.assert_allclose(getattr(one, f), getattr(row, f),
                                   rtol=RTOL, err_msg=f"simulate {f}")
    cost = phase_cost_phase(ph, device=card)
    np.testing.assert_allclose(cost.total,
                               spmv["gpu"]["ladder"]["contention"][0],
                               rtol=RTOL, err_msg="phase_cost_phase")
    log(f"paper per-phase: simulate(level 0 SpMV) time {one.time:.6g} s "
        f"equals the stacked row's {row.time:.6g} s (steps bit-equal), "
        f"phase_cost_phase {cost.total:.6g} s equals "
        f"{spmv['gpu']['ladder']['contention'][0]:.6g} s")

    # one per-phase call alone, and a sweep batched against one call a ping
    bw = blue_waters_machine((2, 1, 1))
    ping = pingpong._ping(bw, 0, 32, 4096.0)
    ping_ms = cuda_ms(lambda: simulate(ping, device=card), 20)
    ping_dev = kernel_device_ms(lambda: simulate(ping, device=card), "", 20)
    big_ms = cuda_ms(lambda: simulate(ph, arrival_order=arr, device=card), 2)
    big_dev = kernel_device_ms(
        lambda: simulate(ph, arrival_order=arr, device=card), "", 2)
    sizes = np.unique(np.round(np.logspace(0, 6, 40)).astype(int))
    batched, t_batched = sync_time(lambda: pingpong.pingpong_sweep(
        bw, "inter_node", sizes, reps=2, noise=0.0, device=card))
    a, b = pingpong._pair_for(bw, "inter_node")

    def one_call_a_ping():
        return [np.mean([0.5 * (
            simulate(pingpong._ping(bw, a, b, s), device=card).time
            + simulate(pingpong._ping(bw, b, a, s), device=card).time)
            for _ in range(2)]) for s in map(float, sizes)]

    looped, t_looped = sync_time(one_call_a_ping)
    np.testing.assert_allclose(batched, looped, rtol=RTOL)
    log(f"paper timing: simulate of one ping {ping_ms:.4f} ms wrapper "
        f"(CUDA events), {ping_dev} ms device (profiler); simulate of level "
        f"0's SpMV with random arrivals {big_ms:.3f} ms wrapper, {big_dev} "
        f"ms device; pingpong_sweep of {2 * 2 * sizes.size} pings batched "
        f"{t_batched:.4f} s against {t_looped:.4f} s one simulate call a "
        f"ping (equal times)")
    return {op: r["launches"] for op, r in runs.items()}


# -- phase 7: the LLM workload registry ------------------------------------

def registry_sweep(ks, clock_hz, card=None) -> dict:
    """``repro_torch.workloads.sweep()`` on cuda: the 21 (machine,
    scenario, phase) rows of the shipped registry through one
    ``best_strategy_many`` call, with K1's and K2's counts set to 0 just
    before and every K1/K2 input captured, each held to its plain version;
    the rows held to ``sweep(device="cpu")`` (winners equal, costs within
    rtol 1e-4) and the winners to the reference's table
    (``REGISTRY_WINNERS``); the wall split into derivation and binding,
    rewrites (``candidate_set``, host) and pricing (device passes), and
    the device-busy share of a profiled rerun; K1's and K2's calls timed
    as the kernels line times the full slice's, summed over the sweep.
    ``card`` is the device under test (``None`` = CUDA).  Returns, per
    kernel, its launches on the sweep and those sums."""
    from repro_torch.workloads import sweep, winner_table

    sync_time(lambda: sweep(device=card))            # warm-up
    rows, wall, launches, captured, split, sizes = counted_sweep(
        ks, lambda: sweep(device=card))
    cpu, t_cpu = sync_time(lambda: sweep(device="cpu"))

    if len(rows) != len(REGISTRY_WINNERS) or len(cpu) != len(rows):
        raise AssertionError(f"registry sweep gave {len(rows)} rows on cuda "
                             f"and {len(cpu)} on cpu, expected "
                             f"{len(REGISTRY_WINNERS)}")
    for g, c in zip(rows, cpu):
        key = (g.machine, g.scenario, g.phase)
        if key != (c.machine, c.scenario, c.phase) or (
                g.n_msgs, g.total_bytes) != (c.n_msgs, c.total_bytes):
            raise AssertionError(f"registry row {key}: cuda and cpu rows "
                                 f"differ: {g} vs {c}")
        if (g.model_winner, g.sim_winner) != (c.model_winner, c.sim_winner):
            raise AssertionError(f"registry row {key}: cuda picks "
                                 f"{g.model_winner}/{g.sim_winner}, cpu "
                                 f"{c.model_winner}/{c.sim_winner}")
        if (g.model_winner, g.sim_winner) != REGISTRY_WINNERS.get(key):
            raise AssertionError(f"registry row {key}: winners "
                                 f"{g.model_winner}/{g.sim_winner}, the "
                                 f"reference's {REGISTRY_WINNERS.get(key)}")
        np.testing.assert_allclose([g.model, g.sim], [c.model, c.sim],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"registry row {key}")
        if not (0 < g.model < 1 and 0 < g.sim < 1 and g.n_msgs > 0
                and not g.degraded):
            raise AssertionError(f"registry row {key}: bad costs {g}")
    if not (launches["segment_reduce"] and launches["queue_walk"]):
        raise AssertionError(f"the registry sweep did not reach K1 and K2: "
                             f"{launches}")
    log(winner_table(rows))
    derive = wall - split["rewrite"] - split["pricing"]
    log(f"registry sweep: {len(rows)} rows, {sizes['arena']} messages in "
        f"{sizes['phases']} candidate phases; wall {wall:.3f} s on cuda: "
        f"derive, validate and bind {derive:.3f} s + rewrite "
        f"{split['rewrite']:.3f} s (host, candidate_set) + pricing "
        f"{split['pricing']:.3f} s (device passes with host order "
        f"assembly); cpu {t_cpu:.3f} s; 42 winners equal on cuda, cpu and "
        f"the reference's table, costs within rtol {RTOL} of cpu")
    prof = device_share(lambda: sweep(device=card))
    return kernel_sums(ks, "registry sweep", launches, captured, clock_hz,
                       prof)


# -- phase 8: delta re-pricing ------------------------------------------------

def replay_moves(A, machine, moves, n_procs, level, device):
    """Walk recorded candidates (``(starts, cost, accepted)`` per move, in
    order) through the port's delta path on ``device``, following the
    recorded accept decisions.  Returns per move the port's cost (NaN where
    the move was never priced) and whether the port's own search would
    accept it, then the final ``DeltaStack``, its ``SpmvPatternState`` and
    the initial message count."""
    from repro_torch.comm.delta import DeltaStack
    from repro_torch.core.models import phase_cost_many
    from repro_torch.sparse import (RowPartition, SpmvPatternState,
                                    spmv_comm_pattern_delta)

    state = SpmvPatternState.build(A, RowPartition.balanced(A.n_rows,
                                                            n_procs))
    n_msgs = state.src.size
    delta = DeltaStack.from_phases([state.pattern.bind(machine)],
                                   device=device)
    cost = phase_cost_many(delta, level=level)[0].total
    out = []
    for starts, want, accepted in moves:
        if want is None or np.isnan(want):
            out.append((float("nan"), False))
            continue
        rm, add, cand_state = spmv_comm_pattern_delta(state, starts)
        cand = delta.apply(rm, {0: add})
        c = phase_cost_many(cand, level=level)[0].total
        out.append((c, c < cost))
        if accepted:
            state, delta, cost = cand_state, cand, c
    return out, delta, state, n_msgs


def reference_moves(n_rows: int):
    """``DELTA_REFERENCE`` as ``(boundary, shift, starts, cost, accepted)``:
    each candidate partition rebuilt from the balanced one through the
    recorded accept decisions (the proposals are the seed's alone)."""
    from repro_torch.sparse import RowPartition

    starts = RowPartition.balanced(n_rows, DELTA_BENCH["n_procs"]).starts
    out = []
    for b, d, cost, accepted in DELTA_REFERENCE:
        cand = starts.copy()
        cand[b] += d
        out.append((b, d, cand, cost, accepted))
        if accepted:
            starts = cand
    return out


def search_fork(moves, want, initial: float, what: str) -> int:
    """Hold a search's moves (``Move`` objects) to ``want`` (``(boundary,
    shift, starts, cost, accepted)`` tuples, ``initial`` their initial
    cost): the same proposals, and the same candidates, accept decisions
    and costs (rtol 1e-4) up to the first move decided otherwise, which must
    be a near-tie (``want``'s cost within rtol 1e-4 of its current cost).
    Returns that move's index (the number of moves when none forks)."""
    if len(moves) != len(want):
        raise AssertionError(f"{what}: {len(moves)} moves, expected "
                             f"{len(want)}")
    fork, current = len(want), initial
    for i, (mv, (b, d, starts, cost, accepted)) in enumerate(zip(moves,
                                                                want)):
        if (mv.boundary, mv.shift) != (b, d):
            raise AssertionError(f"{what}: move {i} proposes "
                                 f"{(mv.boundary, mv.shift)}, expected "
                                 f"{(b, d)}")
        if fork < len(want):
            continue
        if not np.array_equal(mv.starts, starts):
            raise AssertionError(f"{what}: move {i} has another candidate")
        if cost is None or np.isnan(cost):
            if not np.isnan(mv.cost):
                raise AssertionError(f"{what}: move {i} was priced")
            continue
        np.testing.assert_allclose(mv.cost, cost, rtol=RTOL,
                                   err_msg=f"{what}: move {i}")
        if mv.accepted != accepted:
            if abs(cost - current) > RTOL * current:
                raise AssertionError(
                    f"{what}: move {i} accepted={mv.accepted} against "
                    f"{accepted} with a margin of "
                    f"{(cost - current) / current:.3g}")
            fork = i
            log(f"  {what}: forks at move {i}, a near-tie (relative "
                f"margin {(cost - current) / current:.3g})")
        elif accepted:
            current = cost
    return fork


def delta_repricing(ks, levels, clock_hz, card=None):
    """Delta re-pricing on the card (``card``, ``None`` = CUDA), with K1's
    and K2's counts set to 0 before each search and every K1/K2 input
    captured and held to its plain version:

    (a) ``benchmarks/bench_delta.py``'s search, uncut, on the card and on
        cpu, held to each other and to the reference's 64 recorded costs
        and accept decisions (``DELTA_REFERENCE``), also by replaying the
        reference's candidates through the port's delta path;
    (b) a full-width search on level 0 of phase 4's hierarchy (8,192 ranks
        of ``blue_waters_machine((8, 8, 4))``, 64 moves), timed against a
        rebuild of the same candidates on the card (fresh pattern, bind,
        ``phase_cost_many``);
    (c) a few ``verify=True`` applies on the full-width search's final
        arena and one ``simulate_many`` with random arrivals on it, held to
        a fresh ``PhaseStack``.

    No fresh arena may be built during a search.  Returns, per kernel, its
    launches on the phase and its calls' summed times and bound, and (b)'s
    final pattern."""
    from repro_torch.comm.stack import PhaseStack
    from repro_torch.core.models import phase_cost_many
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.net.simulator import simulate_many
    from repro_torch.sparse import (RowPartition, elasticity_like_3d,
                                    optimize_partition, spmv_comm_pattern,
                                    spmv_comm_pattern_delta)

    launches = {"segment_reduce": 0, "queue_walk": 0}
    captured = {"segment_reduce": [], "queue_walk": []}

    def counted(fn, what, arenas=0):
        out, wall, n, cap, builds = counted_kernels(ks, fn)
        if builds != arenas:
            raise AssertionError(f"{what} built {builds} PhaseStacks, "
                                 f"expected {arenas}")
        for k in launches:
            launches[k] += n[k]
            captured[k] += cap[k]
        return out, wall, n

    # (a) the reference benchmark's search
    cfg = DELTA_BENCH
    A = elasticity_like_3d(cfg["nx"])
    m = blue_waters_machine(cfg["torus"])
    kw = {k: cfg[k] for k in ("n_procs", "moves", "seed", "level")}
    want = reference_moves(A.n_rows)
    sync_time(lambda: optimize_partition(A, m, device=card, **kw))  # warm-up
    gpu, t_gpu, n_gpu = counted(
        lambda: optimize_partition(A, m, device=card, **kw),
        "the bench_delta search")
    cpu, t_cpu = sync_time(lambda: optimize_partition(A, m, device="cpu",
                                                      **kw))
    if not n_gpu["segment_reduce"]:
        raise AssertionError("the bench_delta search did not reach K1")
    np.testing.assert_allclose([gpu.initial_cost, cpu.initial_cost],
                               DELTA_REFERENCE_INITIAL, rtol=RTOL)
    forks = {"cuda": search_fork(gpu.moves, want, DELTA_REFERENCE_INITIAL,
                                 "cuda search vs the reference"),
             "cpu": search_fork(cpu.moves, want, DELTA_REFERENCE_INITIAL,
                                "cpu search vs the reference")}
    as_want = [(mv.boundary, mv.shift, mv.starts, mv.cost, mv.accepted)
               for mv in cpu.moves]
    forks["cuda vs cpu"] = search_fork(gpu.moves, as_want, cpu.initial_cost,
                                       "cuda search vs cpu")
    # the reference's candidates through the port's delta path
    recorded = [(st, c, acc) for _, _, st, c, acc in want]
    replays = {}
    for dev in (card, "cpu"):
        got, final, _, _ = replay_moves(A, m, recorded, kw["n_procs"],
                                        kw["level"], dev)
        if final._fresh_cache is not None:
            raise AssertionError("the replay built a fresh arena")
        replays["cpu" if dev == "cpu" else "cuda"] = got
    compared = 0
    current = DELTA_REFERENCE_INITIAL
    for i, (_, _, _, cost, accepted) in enumerate(want):
        for dev, got in replays.items():
            np.testing.assert_allclose(got[i][0], cost, rtol=RTOL,
                                       err_msg=f"replay on {dev}, move {i}")
            if abs(cost - current) > RTOL * current and \
                    got[i][1] != accepted:
                raise AssertionError(f"replay on {dev}, move {i}: accept "
                                     f"{got[i][1]} against {accepted}")
        compared += abs(cost - current) > RTOL * current
        if accepted:
            current = cost
    log(f"delta bench_delta setup: elasticity_like_3d({cfg['nx']}) "
        f"({A.n_rows} rows) over {kw['n_procs']} ranks of "
        f"blue_waters_machine({cfg['torus']}), {kw['moves']} moves: cuda "
        f"{t_gpu:.3f} s ({gpu.n_accepted} accepted, cost "
        f"{gpu.initial_cost:.9g} -> {gpu.cost:.9g}), cpu {t_cpu:.3f} s "
        f"({cpu.n_accepted} accepted); the reference "
        f"{sum(w[4] for w in want)} accepted, -> {want[-1][3]!r}; searches "
        f"fork at move {forks} (64 = never); the reference's 64 candidates "
        f"replayed on cuda and cpu within rtol {RTOL} of its costs, accept "
        f"decisions equal on the {compared} with a margin above {RTOL}; "
        f"launches {n_gpu}; no fresh arena built")

    # (b) full width: level 0 of the phase-4 hierarchy
    A0 = levels[0].A
    mf = blue_waters_machine(FULL["torus"])
    kwf = dict(n_procs=min(FULL["max_ranks"], A0.n_rows // 2), moves=64,
               seed=0, level="contention")
    full, t_full, n_full = counted(
        lambda: optimize_partition(A0, mf, device=card, **kwf),
        "the full-width search")
    if not n_full["segment_reduce"]:
        raise AssertionError("the full-width search did not reach K1")
    priced = [mv for mv in full.moves if not np.isnan(mv.cost)]

    def rebuild():
        return [phase_cost_many(
            [spmv_comm_pattern(A0, RowPartition(mv.starts)).bind(mf)],
            level=kwf["level"], device=card)[0].total for mv in priced]

    rebuilt, t_rebuild = sync_time(rebuild)
    np.testing.assert_allclose(rebuilt, [mv.cost for mv in priced],
                               rtol=RTOL, err_msg="full-width rebuild")
    # the same candidates through the delta path again, to the final arena
    recorded = [(mv.starts, mv.cost, mv.accepted) for mv in full.moves]
    (got, final, state, n0), t_replay = sync_time(lambda: replay_moves(
        A0, mf, recorded, kwf["n_procs"], kwf["level"], card))
    np.testing.assert_allclose([c for c, _ in got if not np.isnan(c)],
                               [mv.cost for mv in priced], rtol=RTOL,
                               err_msg="full-width replay")
    log(f"delta full width: level 0 of the phase-4 hierarchy, {A0.n_rows} "
        f"rows over {kwf['n_procs']} ranks of blue_waters_machine("
        f"{FULL['torus']}): {n0} messages at the start, "
        f"{full.pattern.n_msgs} at the end; {len(priced)} candidates "
        f"priced, {full.n_accepted} accepted, cost {full.initial_cost:.9g}"
        f" -> {full.cost:.9g} ({100 * full.improvement:.4f} %); launches "
        f"{n_full}")
    log(f"delta full width timing: delta search {t_full:.3f} s "
        f"({1e3 * t_full / len(priced):.2f} ms a candidate, setup "
        f"included); the replay of its candidates through the delta path "
        f"{t_replay:.3f} s; rebuild of the same candidates on cuda "
        f"{t_rebuild:.3f} s ({1e3 * t_rebuild / len(priced):.2f} ms a "
        f"candidate); rebuild / delta {t_rebuild / t_full:.2f}x")

    # (c) verify=True applies and the simulator on the final arena
    rng = np.random.default_rng(1)
    starts, checked = state.starts, 0
    while checked < 3:
        b = int(rng.integers(1, kwf["n_procs"]))
        ns = starts.copy()
        ns[b] += int(rng.choice((-1, 1))) * max(
            1, A0.n_rows // (8 * kwf["n_procs"]))
        if not starts[b - 1] < ns[b] < starts[b + 1]:
            continue
        rm, add, _ = spmv_comm_pattern_delta(state, ns)
        final.apply(rm, {0: add}, verify=True)       # check() inside
        checked += 1
    arrivals = [final.phases[0].random_arrival_order(
        np.random.default_rng(0))]
    # the queue walk binds its one-phase PhaseStack (CommPhase.queue_steps)
    sims, t_sim, n_sim = counted(
        lambda: simulate_many(final, arrival_orders=arrivals),
        "simulate_many on the delta arena", arenas=1)
    fresh = simulate_many(PhaseStack.build(final.phases, device=card),
                          arrival_orders=arrivals)
    same_steps([r.per_proc_queue_steps for r in sims],
               [r.per_proc_queue_steps for r in fresh], "delta simulate")
    for f in ("time", "transport", "queue", "contention", "max_link_bytes",
              "total_net_bytes"):
        np.testing.assert_allclose([getattr(r, f) for r in sims],
                                   [getattr(r, f) for r in fresh], rtol=RTOL,
                                   atol=ATOL, err_msg=f"delta simulate {f}")
    if final._fresh_cache is not None or not n_sim["queue_walk"]:
        raise AssertionError(f"the delta simulate built a fresh arena or "
                             f"missed K2: {n_sim}")
    log(f"delta verify: {checked} applies with verify=True on the final "
        f"arena held to a fresh cuda PhaseStack (rtol {RTOL}, steps exact); "
        f"simulate_many with random arrivals {t_sim:.3f} s, time "
        f"{sims[0].time:.9g} s against the fresh stack's {fresh[0].time:.9g}"
        f" s, steps bit-equal; launches {n_sim}")

    prof = {"segment_reduce": device_share(
                lambda: optimize_partition(A0, mf, device=card, **kwf)),
            "queue_walk": device_share(
                lambda: simulate_many(final, arrival_orders=arrivals))}
    # K1 from a rerun of the full-width search, K2 of the simulate
    return kernel_sums(ks, "delta", launches, captured, clock_hz,
                       prof), full.pattern


# -- phase 9: the strategy service ------------------------------------------

def _timed_calls(targets):
    """Wrap each ``(module or class, name)`` function so its calls add
    their wall seconds to the returned dict (under ``name``); returns
    (seconds, undo)."""
    spent = {name: 0.0 for _, name in targets}
    # the attribute as stored (a classmethod stays one when put back)
    real = [(mod, name, vars(mod)[name]) for mod, name in targets]

    def wrap(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    for mod, name, _ in real:
        setattr(mod, name, wrap(name, getattr(mod, name)))

    def undo():
        for mod, name, fn in real:
            setattr(mod, name, fn)
    return spent, undo


def _same_verdict(got, want, what: str, exact: bool = False) -> None:
    if (got.model_winner, got.sim_winner) != (want.model_winner,
                                              want.sim_winner):
        raise AssertionError(f"{what}: winners {got.model_winner}/"
                             f"{got.sim_winner} against {want.model_winner}/"
                             f"{want.sim_winner}")
    if exact:
        if (got.model, got.sim) != (want.model, want.sim):
            raise AssertionError(f"{what}: totals not bit-equal")
        return
    for s in want.model:
        np.testing.assert_allclose([got.model[s], got.sim[s]],
                                   [want.model[s], want.sim[s]], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: {s}")


def strategy_service(ks, pats, want, drifted, clock_hz, card=None) -> dict:
    """``repro_torch.serve.StrategyService`` on the card (``card``, ``None``
    = CUDA):

    (a) the six level patterns of phase 4's hierarchy on
        ``blue_waters_machine((8, 8, 4))``, cold, with K1's and K2's counts
        set to 0 just before and every K1/K2 input captured and held to its
        plain version; held to phase 4's verdicts ``want`` (winners equal,
        totals within rtol 1e-4); the wall split into validation,
        fingerprints and the sweep;
    (b) the same query warm: no launch, the cold numbers bit for bit;
    (c) a fresh service after ``restore(snapshot())``: all six from cache;
    (d) ``reprice`` of level 0's pattern to phase 8's full-width search
        result ``drifted``: ok, not degraded, within 1e-4 of
        ``best_strategy_many`` of the mutated phase on the card, its K1
        launches counted, timed against a cold query of ``drifted``;
    (e) fault drills: ``kernel.segment_reduce:raise`` armed on a fresh
        uncached batch (one result a pattern, none raises), the breaker
        open after ``breaker_threshold`` failures and the next batch shed
        with ``BackendUnavailable`` and no K1 launch, then disarmed, the
        half-open probe after ``breaker_reset`` closing the breaker with
        the clean answer; admission ``capacity=1`` (``Overloaded``) and
        ``timeout=0.0`` (``DeadlineExceeded``);
    (f) 4 threads, each with its own services, querying the registry's 21
        rows at once, every verdict held to the serial run;
    then the device-busy share of a profiled cold query.  Returns, per
    kernel, its launches on (a) and (d) and their calls' summed times and
    bound."""
    import threading

    from repro_torch.comm import delta, faults, guard, strategies
    from repro_torch.comm.health import BackendUnavailable, reset_health
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.serve import (AdmissionQueue, DeadlineExceeded,
                                   Overloaded, StrategyService)
    from repro_torch.workloads import (DEFAULT_SCENARIOS, default_machines,
                                       scenario_patterns)

    m = blue_waters_machine(FULL["torus"])
    launches = {"segment_reduce": 0, "queue_walk": 0}
    captured = {"segment_reduce": [], "queue_walk": []}

    def counted(fn, what):
        out, wall, n, cap, _ = counted_kernels(ks, fn)
        for k in launches:
            launches[k] += n[k]
            captured[k] += cap[k]
        return out, wall, n

    def all_ok(results, what, cached=False):
        for i, r in enumerate(results):
            if not r.ok or r.degraded or r.cached != cached:
                raise AssertionError(f"{what}[{i}]: ok {r.ok}, degraded "
                                     f"{r.degraded}, cached {r.cached}, "
                                     f"error {r.error!r}")

    # (a) cold
    svc = StrategyService(m, device=card)
    spent, undo = _timed_calls([(guard, "validate_phase"),
                                (delta, "pattern_fingerprint"),
                                (strategies, "best_strategy_many")])
    try:
        cold, t_cold, n_cold = counted(lambda: svc.query_many(pats),
                                       "cold query")
    finally:
        undo()
    all_ok(cold, "cold query")
    for lvl, (r, v) in enumerate(zip(cold, want)):
        _same_verdict(r.verdict, v, f"service level {lvl} vs phase 4")
    if not (n_cold["segment_reduce"] and n_cold["queue_walk"]):
        raise AssertionError(f"the cold query missed K1 or K2: {n_cold}")
    log(f"service cold: {len(pats)} level patterns "
        f"({sum(p.n_msgs for p in pats)} messages, ranks "
        f"{[p.n_procs for p in pats]}) on {svc.device}: wall {t_cold:.3f} s "
        f"= validate {spent['validate_phase']:.4f} s + fingerprint "
        f"{spent['pattern_fingerprint']:.4f} s + sweep "
        f"{spent['best_strategy_many']:.3f} s + the rest "
        f"{t_cold - sum(spent.values()):.4f} s; winners equal phase 4's, "
        f"totals within rtol {RTOL}; launches {n_cold}")

    # (b) warm
    warm, t_warm, n_warm = counted(lambda: svc.query_many(pats), "warm")
    all_ok(warm, "warm query", cached=True)
    for lvl, (w, c) in enumerate(zip(warm, cold)):
        _same_verdict(w.verdict, c.verdict, f"warm level {lvl}", exact=True)
    if any(n_warm.values()):
        raise AssertionError(f"the warm query launched kernels: {n_warm}")
    log(f"service warm: wall {1e3 * t_warm:.4f} ms "
        f"({1e6 * t_warm / len(pats):.2f} us a pattern), cold / warm "
        f"{t_cold / t_warm:.1f}x; the cold numbers bit for bit; launches "
        f"{n_warm}")

    # (c) restore
    snap = svc.snapshot()
    fresh = StrategyService(m, device=card)
    n_rest, t_rest = sync_time(lambda: fresh.restore(snap))
    restored, t_rq, n_rq = counted(lambda: fresh.query_many(pats),
                                   "restored query")
    all_ok(restored, "restored query", cached=True)
    for lvl, (w, c) in enumerate(zip(restored, cold)):
        _same_verdict(w.verdict, c.verdict, f"restored level {lvl}",
                      exact=True)
    if n_rest != len(pats) or any(n_rq.values()):
        raise AssertionError(f"restore landed {n_rest} entries, query "
                             f"launched {n_rq}")
    log(f"service restore: {n_rest} entries ({len(json.dumps(snap))} bytes "
        f"of snapshot) in {1e3 * t_rest:.3f} ms, then all {len(pats)} from "
        f"cache in "
        f"{1e3 * t_rq:.4f} ms, bit-equal, launches {n_rq}")

    # (d) reprice against phase 8's full-width search result
    arena = delta.DeltaStack.from_phases([pats[0].bind(m)], device=card)
    removed, added = delta.message_delta(arena.phases[0], drifted)
    frac = (removed.size + added[0].size) / drifted.n_msgs
    if frac > svc.drift_threshold:
        raise AssertionError(f"the full-width drift {frac:.4f} is past the "
                             "threshold: reprice would rebuild")
    mutated = arena.apply(removed, {0: added}).phases[0]
    parts = [(delta.DeltaStack, "from_phases"), (delta, "message_delta"),
             (delta.DeltaStack, "apply"), (delta, "pattern_fingerprint"),
             (strategies, "best_strategy_many")]
    spent, undo = _timed_calls(parts)
    try:
        rep, t_rep, n_rep = counted(lambda: svc.reprice(pats[0], drifted),
                                    "reprice")
        split_rep = dict(spent)
        spent.update({k: 0.0 for k in spent})
        again, t_again = sync_time(lambda: svc.reprice(pats[0], drifted))
    finally:
        undo()
    if not rep.ok or rep.degraded or rep.cached:
        raise AssertionError(f"reprice: ok {rep.ok}, degraded "
                             f"{rep.degraded}, cached {rep.cached}, error "
                             f"{rep.error!r}")
    ref_v = strategies.best_strategy_many([mutated], m, device=card)[0]
    _same_verdict(rep.verdict, ref_v, "reprice vs the mutated phase")
    if not again.cached:
        raise AssertionError("a second reprice of the same drift missed")
    cold_new, t_new = sync_time(
        lambda: StrategyService(m, device=card).query(drifted))
    log(f"service reprice: level 0 ({pats[0].n_msgs} messages) to the "
        f"full-width search's result ({drifted.n_msgs}): {removed.size} "
        f"removed, {added[0].size} added (drift {frac:.5f}); reprice "
        f"{t_rep:.3f} s (DeltaStack build, apply, a cold sweep of the "
        f"mutated phase), again {1e3 * t_again:.3f} ms (cache hit), a cold "
        f"query of the new pattern {t_new:.3f} s; winners "
        f"{rep.verdict.model_winner}/{rep.verdict.sim_winner}, within "
        f"rtol {RTOL} of best_strategy_many of the mutated phase; "
        f"launches {n_rep}")
    for what, part, wall in (("reprice", split_rep, t_rep),
                             ("repeat", spent, t_again)):
        log(f"service {what} split: " + ", ".join(
            f"{k} {1e3 * v:.2f} ms" for k, v in part.items())
            + f", the rest {1e3 * (wall - sum(part.values())):.2f} ms")

    # (e) fault drills on a fresh uncached batch: the registry's patterns
    # on its blue_waters machine
    bw = default_machines()["blue_waters"]
    batch = [p for sc in DEFAULT_SCENARIOS for _, p in scenario_patterns(sc)]
    clean = StrategyService(bw, device=card).query_many(batch)
    all_ok(clean, "clean drill batch")
    reset_health()      # the device's breaker is made anew, by the drill's
    drill = StrategyService(bw, device=card, breaker_threshold=3,
                            breaker_reset=0.5)
    outcomes = []
    with faults.inject("kernel.segment_reduce", "raise") as spec:
        for k in range(drill.breaker_threshold):
            res = drill.query_many(batch)
            if len(res) != len(batch) or any(r.ok for r in res):
                raise AssertionError(f"drill batch {k}: {res}")
            outcomes.append(sorted({type(r.error).__name__ for r in res}))
        state = drill._breaker().state
        before = ks.LAUNCHES["segment_reduce"]
        shed = drill.query_many(batch)
        if state != "open" or ks.LAUNCHES["segment_reduce"] != before or \
                not all(isinstance(r.error, BackendUnavailable)
                        for r in shed):
            raise AssertionError(f"breaker {state}, K1 launches "
                                 f"{ks.LAUNCHES['segment_reduce'] - before}"
                                 f" while open, shed {shed}")
    time.sleep(drill.breaker_reset + 0.1)
    healed = drill.query_many(batch)
    all_ok(healed, "the half-open probe")
    if drill._breaker().state != "closed":
        raise AssertionError("the probe did not close the breaker")
    for i, (h, c) in enumerate(zip(healed, clean)):
        _same_verdict(h.verdict, c.verdict, f"healed pattern {i}")
    q = AdmissionQueue(capacity=1)
    busy = StrategyService(bw, device=card, admission=q)
    q.acquire(1)
    try:
        over = busy.query_many(batch)
    finally:
        q.release(1)
    late = StrategyService(bw, device=card, timeout=0.0).query_many(batch)
    if not (all(isinstance(r.error, Overloaded) for r in over)
            and all(isinstance(r.error, DeadlineExceeded) for r in late)):
        raise AssertionError(f"admission drill: {over} / {late}")
    log(f"service fault drills ({len(batch)} registry patterns on "
        f"blue_waters): kernel.segment_reduce:raise fired {spec.fired} "
        f"times, batches answered with {outcomes} and none raised; breaker "
        f"open after {drill.breaker_threshold} failures, the next batch "
        f"shed with BackendUnavailable and no K1 launch; disarmed, the "
        f"probe after {drill.breaker_reset} s closed it with the clean "
        f"answer; capacity 1 -> Overloaded, timeout 0.0 -> "
        f"DeadlineExceeded")

    # (f) 4 threads, each with its own services, the 21 registry rows
    machines = default_machines()
    names = [(sc.name, ph) for sc in DEFAULT_SCENARIOS
             for ph, _ in scenario_patterns(sc)]

    def rows():
        out = {}
        for mname, mach in machines.items():
            for (sc, ph), r in zip(names, StrategyService(
                    mach, device=card).query_many(batch)):
                out[(mname, sc, ph)] = r
        return out

    serial, t_serial = sync_time(rows)
    errors, per_thread = [], [None] * 4
    barrier = threading.Barrier(4)

    def work(i):
        try:
            barrier.wait(timeout=60)
            per_thread[i] = rows()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    t_threads = time.perf_counter() - t
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"threaded queries failed: {errors}")
    for key, r in serial.items():
        all_ok([r], f"serial row {key}")
        if (r.verdict.model_winner, r.verdict.sim_winner) != \
                REGISTRY_WINNERS[key]:
            raise AssertionError(f"service row {key} against the "
                                 f"reference's {REGISTRY_WINNERS[key]}")
        for i, got in enumerate(per_thread):
            all_ok([got[key]], f"thread {i} row {key}")
            _same_verdict(got[key].verdict, r.verdict,
                          f"thread {i} row {key}")
    log(f"service threads: 4 threads x {len(serial)} registry rows at once "
        f"in {t_threads:.3f} s (serial {t_serial:.3f} s), every verdict held "
        f"to the serial run and the 42 winners to the reference's")

    prof = device_share(
        lambda: StrategyService(m, device=card).query_many(pats))
    return kernel_sums(ks, "service (cold query and reprice)", launches,
                       captured, clock_hz, prof)


# -- phase 10: the execution layer --------------------------------------------

# ``benchmarks/bench_exec.py``'s setup: 96 messages from seed 42, sizes
# 256-8192, on ``lassen_8``; its crossover counts
EXEC_BENCH = {"n": 96, "seed": 42, "sizes": (256, 8192)}
EXEC_COUNTS = (8, 32, 128, 512, 2048)


def exec_messages(n: int, seed: int, sizes, n_procs: int):
    """``n`` seeded messages over ``n_procs`` ranks, none to itself, as
    ``tests/test_exec.py`` and ``benchmarks/bench_exec.py`` draw them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_procs, n)
    dst = (src + rng.integers(1, n_procs, n)) % n_procs
    return src, dst, rng.integers(*sizes, n).astype(float)


def digest_ok(digest, sched, what: str) -> float:
    """Hold a digest to the float64 ``np.bincount(unit_dst, payload)``
    within rtol 1e-4; returns its worst relative error."""
    want = np.bincount(sched.unit_dst, weights=sched.payload.astype(float),
                       minlength=sched.n_procs)
    got = digest.double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               err_msg=f"{what}: digest")
    return float(np.max(np.abs(got - want) / np.maximum(want, 1.0),
                        initial=0.0))


def executed_ok(sched, card, what: str) -> float:
    """Run ``sched`` on ``card`` through ``execute``; the delivered matrix
    equal to ``run_reference`` (and to ``reference_delivered``), the digest
    within 1e-4.  Returns the digest's worst relative error."""
    from repro_torch.exec import execute, reference_delivered, run_reference

    got, digest = execute(sched, device=card)
    want = run_reference(sched)
    if not (torch.equal(got.cpu(), torch.from_numpy(want))
            and np.array_equal(want, reference_delivered(sched))):
        raise AssertionError(f"{what}: delivered differs from run_reference")
    return digest_ok(digest, sched, what)


def crossover_agreement(card) -> tuple:
    """``bench_exec_agreement``'s loop on ``card``: a table fitted from the
    sweeps recorded on ``lassen_machine((2, 2, 2))`` and
    ``frontier_machine((2, 2, 1))``, ``best_strategy_many`` over
    ``GPU_STRATEGIES`` on the crossover patterns (``EXEC_COUNTS``) with it.
    Returns (agreement, crossover, lassen's verdicts, every verdict)."""
    from repro_torch.comm.phase import CommPhase
    from repro_torch.comm.strategies import GPU_STRATEGIES, best_strategy_many
    from repro_torch.exec import calibrate, record_sweeps
    from repro_torch.net.machine import frontier_machine, lassen_machine

    verdicts = {}
    for mk, dims in ((lassen_machine, (2, 2, 2)),
                     (frontier_machine, (2, 2, 1))):
        m = mk(dims)
        fitted = calibrate(record_sweeps(m, device=card), m.params).params
        phases = [CommPhase.build(m, *exec_messages(n, 42, (256, 8192),
                                                    m.n_procs),
                                  n_procs=m.n_procs) for n in EXEC_COUNTS]
        verdicts[m.name] = best_strategy_many(
            phases, strategies=GPU_STRATEGIES, seed=0, params=fitted,
            device=card)
    every = [v for vs in verdicts.values() for v in vs]
    lassen = verdicts["lassen"]
    winners = [v.sim_winner for v in lassen]
    staged = [i for i, w in enumerate(winners) if w == "host_staged"]
    crossed = (winners[0] == "device_direct" and staged
               and winners[-1] == "host_staged")
    cases = [0, staged[0], len(winners) - 1] if crossed else []
    crossover = float(bool(crossed) and all(lassen[i].agree for i in cases))
    return float(np.mean([v.agree for v in every])), crossover, verdicts


def execution_layer(ks, pats, clock_hz, card=None) -> dict:
    """``repro_torch.exec`` on the card (``card``, ``None`` = CUDA), each
    step with K1's and K2's counts set to 0 just before and every K1/K2
    input captured and held to its plain version:

    (a) ``tests/test_exec.py``'s cases: the four host presets x every
        strategy of each, 40 messages from seed 11, both colorings, each
        executed on the card: delivered equal to ``run_reference`` and
        ``reference_delivered``, the digest within rtol 1e-4 of the float64
        bincount;
    (b) ``bench_exec.py``'s setup: a table fitted from the sweeps recorded
        on the card (held to the cpu fit within rel 1e-4), the
        measured-vs-predicted table per strategy (median of 5 runs after 2,
        the predicted cost, rounds), the pairwise agreement (printed, not
        gated), ``launch_overhead``, and greedy ``standard`` against
        ``per_message`` (at least 1.0, the reference's ``perf_smoke``
        gate);
    (c) the calibrated agreement (``bench_exec_agreement``): agreement and
        crossover 1.0, the reference's values;
    (d) Figs. 10-11 at the reference benchmark's setup, levels 0-3 x the
        three node-aware strategies, executed and held as in (a);
    (e) full width: level 0 of phase 4's hierarchy (``pats[0]`` on
        ``blue_waters_machine((8, 8, 4))``) x the three strategies: the
        host plan and executor build timed, the median run (reps 5, warmup
        2), the buffers and peak device memory; the delivered matrix held
        to the semantic oracle on the card (one nonzero a unit, the
        payload at its destination) and the digest to the bincount.
    Returns, per kernel, its launches on the phase and its calls' summed
    times and bound."""
    from repro_torch.comm.phase import CommPhase
    from repro_torch.comm.strategies import STRATEGIES, strategies_for
    from repro_torch.exec import (COLORINGS, build_executor, build_schedule,
                                  calibrate, delivered_digest, host_machines,
                                  lassen_8, launch_overhead,
                                  pairwise_agreement, predicted_costs,
                                  record_sweeps, time_schedule)
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.sparse import build_hierarchy, elasticity_like_3d

    launches = {"segment_reduce": 0, "queue_walk": 0}
    captured = {"segment_reduce": [], "queue_walk": []}

    def counted(fn):
        out, wall, n, cap, _ = counted_kernels(ks, fn)
        for k in launches:
            launches[k] += n[k]
            captured[k] += cap[k]
        return out, wall, n

    # (a) the reference's test cases
    def test_cases():
        worst, cases = 0.0, 0
        for name, m in host_machines().items():
            ph = CommPhase.build(m, *exec_messages(40, 11, (1, 6000), 8),
                                 n_procs=8)
            for strat in strategies_for(m):
                for coloring in COLORINGS:
                    sched = build_schedule(ph, strat, coloring=coloring)
                    worst = max(worst, executed_ok(
                        sched, card, f"{name}/{strat}/{coloring}"))
                    cases += 1
        return worst, cases

    (worst, cases), t_a, n_a = counted(test_cases)
    if n_a["segment_reduce"] != cases:
        raise AssertionError(f"{cases} digests, {n_a} launches")
    log(f"exec (a) test_exec's cases: {cases} schedules (4 host presets x "
        f"their strategies x {COLORINGS}) executed on the card in "
        f"{t_a:.3f} s, every delivered matrix equal to run_reference, "
        f"digests within rtol {RTOL} of the bincount (worst {worst:.3g}); "
        f"launches {n_a}")

    # (b) bench_exec's setup
    m8 = lassen_8()
    ph = CommPhase.build(m8, *exec_messages(
        EXEC_BENCH["n"], EXEC_BENCH["seed"], EXEC_BENCH["sizes"], 8),
        n_procs=8)

    def bench():
        fit = calibrate(record_sweeps(m8, device=card), m8.params)
        predicted = predicted_costs(ph, params=fit.params, device=card)
        measured, rounds = {}, {}
        for strat in strategies_for(m8):
            sched = build_schedule(ph, strat)
            executed_ok(sched, card, f"bench_exec {strat}")
            measured[strat] = time_schedule(sched, device=card, reps=5,
                                            warmup=2).median_s
            rounds[strat] = sched.n_rounds
        overhead = launch_overhead(ph, device=card, reps=5, warmup=2)
        colored = build_schedule(ph, "standard")
        naive = build_schedule(ph, "standard", coloring="per_message")
        for s in (colored, naive):
            executed_ok(s, card, f"bench_exec standard/{s.coloring}")
        t_col = time_schedule(colored, device=card, reps=5, warmup=2)
        t_naive = time_schedule(naive, device=card, reps=5, warmup=2)
        return (fit, predicted, measured, rounds, overhead, colored, naive,
                t_col.median_s, t_naive.median_s)

    (fit, predicted, measured, rounds, overhead, colored, naive, t_col,
     t_naive), t_b, n_b = counted(bench)
    cpu_fit = calibrate(record_sweeps(m8, device="cpu"), m8.params)
    for f in ("alpha", "Rb", "RN"):
        np.testing.assert_allclose(getattr(fit.params, f),
                                   getattr(cpu_fit.params, f), rtol=RTOL,
                                   err_msg=f"fitted {f} against the cpu fit")
    if fit.n_rails != cpu_fit.n_rails:
        raise AssertionError(f"rails {fit.n_rails} against the cpu fit's "
                             f"{cpu_fit.n_rails}")
    cpu_pred = predicted_costs(ph, params=fit.params, device="cpu")
    np.testing.assert_allclose([predicted[s] for s in cpu_pred],
                               list(cpu_pred.values()), rtol=RTOL, atol=ATOL,
                               err_msg="predicted costs against cpu")
    ratio = t_naive / t_col
    log(f"exec (b) bench_exec's setup: lassen_8, {ph.n_msgs} messages "
        f"from seed {EXEC_BENCH['seed']}, sizes {EXEC_BENCH['sizes']}; fitted "
        f"table (rails {fit.n_rails}, classes {fit.fitted_classes}) within "
        f"rel {RTOL} of the cpu fit; step {t_b:.3f} s; launches {n_b}")
    log(f"  {'strategy':14s} {'median ms':>10s} {'predicted s':>13s} "
        f"{'rounds':>6s}")
    for s in measured:
        log(f"  {s:14s} {1e3 * measured[s]:10.4f} {predicted[s]:13.6g} "
            f"{rounds[s]:6d}")
    log(f"  pairwise agreement, measured against predicted (printed, not "
        f"gated): {pairwise_agreement(measured, predicted):.4f}; launch "
        f"overhead {1e3 * overhead:.4f} ms "
        f"({overhead / measured['standard']:.4f} of standard); greedy "
        f"standard {1e3 * t_col:.4f} ms ({colored.n_rounds} rounds) against per_message "
        f"{1e3 * t_naive:.4f} ms ({naive.n_rounds} rounds): "
        f"per_message / greedy {ratio:.4f}")
    if not ratio >= 1.0:
        raise AssertionError(f"per_message / greedy standard {ratio:.4f} "
                             "< 1.0")

    # (c) the calibrated agreement
    (agreement, crossover, verdicts), t_c, n_c = counted(
        lambda: crossover_agreement(card))
    for mname, vs in verdicts.items():
        for n, v in zip(EXEC_COUNTS, vs):
            margin = {t: abs(np.subtract(*table.values()))
                      / max(table.values())
                      for t, table in (("model", v.model), ("sim", v.sim))}
            log(f"  {mname} {n} messages: model {v.model_winner} (margin "
                f"{margin['model']:.4g}), simulator {v.sim_winner} (margin "
                f"{margin['sim']:.4g}), agree {v.agree}")
    log(f"exec (c) calibrated agreement {agreement} and crossover "
        f"{crossover} (the reference's: 1.0 and 1.0) in {t_c:.3f} s; "
        f"launches {n_c}")
    if (agreement, crossover) != (1.0, 1.0):
        raise AssertionError(f"calibrated agreement {agreement}, crossover "
                             f"{crossover}")
    if not n_c["queue_walk"]:
        raise AssertionError(f"the agreement sweep missed K2: {n_c}")

    # (d) Figs. 10-11 at the reference benchmark's setup
    cfg = FIG10_11_SETUP
    levels = build_hierarchy(elasticity_like_3d(cfg["nx"]), theta=0.25)
    tagged = [(li, p) for li, p in amg_tagged(
        levels, "spmv", blue_waters_machine(cfg["torus"]),
        max_ranks=cfg["max_ranks"]) if li < 4]

    def fig_levels():
        rows = []
        for li, p in tagged:
            for strat in STRATEGIES:
                sched = build_schedule(p, strat)
                err = executed_ok(sched, card, f"level {li} {strat}")
                rows.append((li, p.n_procs, p.n_msgs, strat, sched.n_units,
                             sched.n_rounds, err))
        return rows

    rows, t_d, n_d = counted(fig_levels)
    log(f"exec (d) Figs. 10-11 setup (elasticity_like_3d({cfg['nx']}), at "
        f"most {cfg['max_ranks']} ranks a level), levels 0-3 x "
        f"{STRATEGIES} in {t_d:.3f} s, delivered equal to run_reference, "
        f"digests within rtol {RTOL}; launches {n_d}")
    for li, P, n_msgs, strat, units, n_rounds, err in rows:
        log(f"  level {li}: {P} ranks, {n_msgs} msgs, {strat}: {units} "
            f"units, {n_rounds} rounds, digest rel err {err:.3g}")

    # (e) full width
    m = blue_waters_machine(FULL["torus"])
    full = pats[0].bind(m)
    scheds = {}

    def full_width():
        out = {}
        for strat in STRATEGIES:
            sched, t_plan = sync_time(lambda: build_schedule(full, strat))
            torch.cuda.reset_peak_memory_stats()
            run, t_build = sync_time(lambda: build_executor(sched,
                                                            device=card))
            got, t_run = sync_time(run)
            U = sched.n_units
            dst = torch.as_tensor(sched.unit_dst, device=got.device)
            placed = got[dst, torch.arange(U, device=got.device)]
            if int(torch.count_nonzero(got)) != U or not torch.equal(
                    placed.cpu(), torch.from_numpy(sched.payload)):
                raise AssertionError(f"full width {strat}: delivered is not "
                                     "the payload at each destination")
            err = digest_ok(delivered_digest(got, sched), sched,
                            f"full width {strat}")
            del got, placed
            meas = time_schedule(sched, device=card, reps=5, warmup=2)
            widths = [r.width for p in sched.phases for r in p.rounds]
            out[strat] = dict(plan_s=t_plan, build_s=t_build,
                              first_run_s=t_run, median_s=meas.median_s,
                              runs_s=meas.times_s, rounds=sched.n_rounds,
                              msgs=sched.n_msgs, units=U,
                              widest=max(widths, default=0),
                              buffers_gb=2 * 4 * sched.n_procs * (U + 1)
                              / 1e9,
                              peak_gb=torch.cuda.max_memory_allocated()
                              / 1e9, digest_rel_err=err)
            scheds[strat] = sched
        return out

    figs, t_e, n_e = counted(full_width)
    log(f"exec (e) full width: level 0 of phase 4's hierarchy "
        f"({full.n_procs} ranks, {full.n_msgs} messages) in {t_e:.3f} s; "
        f"every delivered matrix the payload at its destination (one "
        f"nonzero a unit), digests within rtol {RTOL}; launches {n_e}")
    for strat, f in figs.items():
        log(f"  {strat}: build_schedule {f['plan_s']:.3f} s (host), "
            f"executor build {f['build_s']:.4f} s, first run "
            f"{1e3 * f['first_run_s']:.3f} ms, median run "
            f"{1e3 * f['median_s']:.4f} ms (runs "
            + ", ".join(f"{1e3 * t:.4f}" for t in f["runs_s"])
            + f" ms); {f['rounds']} rounds, {f['msgs']} messages, "
            f"{f['units']} units, widest round {f['widest']} units; "
            f"buffers {f['buffers_gb']:.3f} GB, peak device memory "
            f"{f['peak_gb']:.3f} GB; digest rel err "
            f"{f['digest_rel_err']:.3g}")
    for what, n in (("(a)", n_a), ("(b)", n_b), ("(d)", n_d), ("(e)", n_e)):
        if not n["segment_reduce"]:
            raise AssertionError(f"exec {what} missed K1: {n}")

    std = scheds["standard"]
    run = build_executor(std, device=card)
    prof = {"segment_reduce": device_share(
                lambda: delivered_digest(run(), std)),
            "queue_walk": device_share(lambda: crossover_agreement(card))}
    # K1 from a rerun of the full-width standard run and its digest, K2 of
    # the agreement sweep
    return kernel_sums(ks, "exec", launches, captured, clock_hz, prof)


# -- phase 11: the post-kernel check --------------------------------------------

@contextlib.contextmanager
def chaos_env(plan: str = "", verify: str = ""):
    """``REPRO_FAULT_INJECT`` and ``REPRO_STACK_VERIFY`` set for the block
    (empty: unset), restored after it."""
    import os

    from repro_torch.comm import faults

    names = (faults.ENV_VAR, "REPRO_STACK_VERIFY")
    saved = {k: os.environ.pop(k, None) for k in names}
    for k, v in zip(names, (plan, verify)):
        if v:
            os.environ[k] = v
    faults._env_cache.clear()
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        faults._env_cache.clear()


def post_kernel_check(ks, pats, want, clock_hz, card=None) -> dict:
    """ROADMAP item 12 on the card (``card``, ``None`` = CUDA):

    (a) phase 4's full-width sweep (``pats`` on ``blue_waters_machine((8,
        8, 4))``) again unchecked, then under ``REPRO_STACK_VERIFY=finite``
        and ``=parity``, each with K1's and K2's counts set to 0 just before
        and every K1/K2 input and K2 output captured: the winners those of
        phase 4 (``want``), the totals within rtol 1e-4, K2's inputs and
        steps bit-equal to the unchecked run's; the three walls, the verify
        overhead and parity's plain K2 on the CPU timed alone;
    (b) the chaos drill on phase 9's service (the six levels, a fresh
        service, breaker threshold 2): ``*:nan`` with ``finite``, then
        ``*:corrupt`` with ``parity``, one query a level: every result an
        error (``BackendVerifyError``) or shed (``BackendUnavailable``),
        the breaker open, nothing in the verdict cache or the arena cache;
        disarmed, after the breaker's hold, the service answers ``want``;
    (c) one K1 call of the sweep poisoned with ``nan``: with the check off
        the NaNs come back, with ``finite`` it raises.
    Returns, per kernel, its launches on (a)'s two checked runs and their
    calls' summed times and bound."""
    from repro_torch.comm import faults, strategies
    from repro_torch.comm.health import BackendUnavailable, reset_health
    from repro_torch.kernels.comm_stack import BackendVerifyError
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.serve import StrategyService

    m = blue_waters_machine(FULL["torus"])
    launches = {"segment_reduce": 0, "queue_walk": 0}
    captured = {"segment_reduce": [], "queue_walk": []}
    runs = {}
    real_walk = ks.queue_walk
    for verify in ("", "finite", "parity"):
        steps = []

        def walk(*a):
            out = real_walk(*a)
            steps.append(out)
            return out

        ks.queue_walk = walk
        try:
            with chaos_env(verify=verify):
                got, wall, n, cap, _ = counted_kernels(
                    ks, lambda: strategies.best_strategy_many(pats, m,
                                                              device=card))
        finally:
            ks.queue_walk = real_walk
        for lvl, (g, w) in enumerate(zip(got, want)):
            _same_verdict(g, w, f"verify {verify or 'off'} level {lvl}")
        if not (n["segment_reduce"] and n["queue_walk"]):
            raise AssertionError(f"verify {verify!r} run missed K1 or K2: "
                                 f"{n}")
        runs[verify] = (wall, n, cap, steps)
        if verify:
            for k in launches:
                launches[k] += n[k]
                captured[k] += cap[k]
    base = runs[""]
    for verify in ("finite", "parity"):
        _, _, cap, steps = runs[verify]
        same = len(steps) == len(base[3]) and all(
            torch.equal(a, b) for a, b in zip(steps, base[3])) and all(
            torch.equal(x, y) for c, d in zip(cap["queue_walk"],
                                              base[2]["queue_walk"])
            for x, y in zip(c, d))
        if not same:
            raise AssertionError(f"verify {verify}: K2's inputs or steps "
                                 "differ from the unchecked run's")
    posted, arrival, bounds = (t.cpu() for t in base[2]["queue_walk"][0])
    _, t_plain = sync_time(lambda: ks.queue_walk_plain(posted, arrival,
                                                       bounds))
    walls = {k or "off": v[0] for k, v in runs.items()}
    log(f"verify (a) full-width sweep ({sum(p.n_msgs for p in pats)} "
        f"messages in the {len(pats)} levels, {posted.numel()} K2 arrivals "
        f"in the arena): walls off "
        f"{walls['off']:.3f} s, finite {walls['finite']:.3f} s (+"
        f"{100 * (walls['finite'] / walls['off'] - 1):.2f} %), parity "
        f"{walls['parity']:.3f} s (+"
        f"{100 * (walls['parity'] / walls['off'] - 1):.2f} %); parity's "
        f"plain K2 on the CPU alone {t_plain:.3f} s; winners equal phase "
        f"4's, K2's inputs and steps bit-equal to the unchecked run; "
        f"launches {runs['finite'][1]} / {runs['parity'][1]}")

    # (b) the chaos drill on a fresh service of the six levels
    drills = {}
    for plan, verify in (("*:nan", "finite"), ("*:corrupt", "parity")):
        reset_health()
        svc = StrategyService(m, device=card, breaker_threshold=2,
                              breaker_reset=0.5)
        with chaos_env(plan, verify):
            res, t_drill = sync_time(lambda: [svc.query(p) for p in pats])
            fired = faults.active_specs()[0].fired
        kinds = [type(r.error).__name__ for r in res]
        if not (all(r.verdict is None for r in res)
                and isinstance(res[0].error, BackendVerifyError)
                and all(isinstance(r.error, (BackendVerifyError,
                                             BackendUnavailable))
                        for r in res)
                and svc._breaker().state == "open"):
            raise AssertionError(f"drill {plan} {verify}: {kinds}, breaker "
                                 f"{svc._breaker().state}")
        if svc.cache.n_entries or svc._arenas:
            raise AssertionError(f"drill {plan}: a rejected output was "
                                 "cached")
        time.sleep(svc.breaker_reset + 0.1)
        healed, t_heal = sync_time(lambda: svc.query_many(pats))
        for lvl, (h, w) in enumerate(zip(healed, want)):
            if not h.ok or h.degraded or h.cached:
                raise AssertionError(f"drill {plan} healed level {lvl}: "
                                     f"{h}")
            _same_verdict(h.verdict, w, f"drill {plan} healed level {lvl}")
        drills[plan] = kinds
        log(f"verify (b) drill {plan} with {verify}: fired {fired} times, "
            f"{len(res)} levels answered {kinds} in {t_drill:.3f} s, breaker "
            f"open, both caches empty; disarmed, the probe after "
            f"{svc.breaker_reset} s answered phase 9's verdicts in "
            f"{t_heal:.3f} s")

    # (c) the check is what catches the damage
    values, ids, n_seg = captured["segment_reduce"][0]
    with chaos_env():
        with faults.inject("kernel.segment_reduce", "nan") as spec:
            sums, maxs = ks.segment_reduce(values, ids, n_seg)
    if not (bool(torch.isnan(sums).all()) and bool(torch.isnan(maxs).all())
            and spec.fired == 1):
        raise AssertionError("a poisoned K1 output did not come back with "
                             "NaNs with the check off")
    try:
        with chaos_env(verify="finite"):
            with faults.inject("kernel.segment_reduce", "nan"):
                ks.segment_reduce(values, ids, n_seg)
    except BackendVerifyError:
        pass
    else:
        raise AssertionError("finite let a poisoned K1 output through")
    reset_health()
    log(f"verify (c): K1 on {values.numel()} messages poisoned with nan "
        f"came back all NaN with the check off and raised "
        f"BackendVerifyError under finite")
    return kernel_sums(ks, "verify (finite and parity sweeps)", launches,
                       captured, clock_hz, None)


# -- phase 12: collective pricing -----------------------------------------------

# One training step's collectives of qwen3-moe-30b-a3b (48 layers, d_model
# 2048, 32 heads of 128 and 4 kv heads, 128 experts top-8 of width 768,
# ~30.5 B parameters) on the reference's 2 x 16 x 16 production mesh (axes
# pod, data, model; device = pod * 256 + data * 16 + model): 4 x 4096 tokens
# a data replica, expert parallelism over each pod's 256 chips with capacity
# factor 1.25.  Result shapes are per device, as XLA prints them.
COLLECTIVES = {"arch": "qwen3-moe-30b-a3b", "layers": 48, "mesh": (2, 16, 16),
               "pod": {"n_pods": 2, "rows": 16, "cols": 16}}


def collective_step_hlo() -> str:
    """The step's collectives as post-SPMD HLO text.  Inside the layers'
    ``while`` body (trip count 48): the FSDP all-gather of a layer's
    attention weights and the reduce-scatter of their float32 gradients over
    ``data`` (``[32,16]<=[2,16,16]T(0,2,1)``), the tensor-parallel
    all-reduce of the attention output over ``model`` (``[32,16]<=[512]``),
    and the expert dispatch and combine all-to-alls over each pod's 256
    chips (``[2,256]<=[512]``: 1,024 tokens x top-8 x 1.25 = 40 slots a
    peer).  Outside it: the gradient all-reduce over ``pod``
    (``[256,2]<=[2,256]T(1,0)``, a chip's 1/256 of the parameters in
    float32), one all-to-all over all 512 chips (the next batch's tokens)
    and a ``collective-permute`` ring over the 512 chips."""
    ring = ",".join(f"{{{i},{(i + 1) % 512}}}" for i in range(512))
    w = "(bf16[2048,256]{1,0}, bf16[2048,32]{1,0}, bf16[2048,32]{1,0}, " \
        "bf16[256,2048]{1,0})"
    g = "(f32[128,256]{1,0}, f32[128,32]{1,0}, f32[128,32]{1,0}, " \
        "f32[16,2048]{1,0})"
    state = "(s32[], bf16[4,4096,2048])"
    return f"""HloModule jit_train_step, num_partitions=512

%add (x: f32[], y: f32[]) -> f32[] {{
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %add.1 = f32[] add(%x, %y)
}}

%layer_body (p: {state}) -> {state} {{
  %p = {state} parameter(0)
  %h = bf16[4,4096,2048]{{2,1,0}} get-tuple-element(%p), index=1
  %wg = {w} all-gather(%h), channel_id=1, replica_groups=[32,16]<=[2,16,16]T(0,2,1), dimensions={{0}}, use_global_device_ids=true
  %attn = bf16[4,4096,2048]{{2,1,0}} all-reduce(%h), channel_id=2, replica_groups=[32,16]<=[512], use_global_device_ids=true, to_apply=%add
  %disp = bf16[256,40,2048]{{2,1,0}} all-to-all(%attn), channel_id=3, replica_groups=[2,256]<=[512], dimensions={{0}}
  %comb = bf16[256,40,2048]{{2,1,0}} all-to-all(%disp), channel_id=4, replica_groups=[2,256]<=[512], dimensions={{0}}
  %gs = {g} reduce-scatter(%wg), channel_id=5, replica_groups=[32,16]<=[2,16,16]T(0,2,1), dimensions={{0}}, use_global_device_ids=true, to_apply=%add
  %i = s32[] get-tuple-element(%p), index=0
  ROOT %t = {state} tuple(%i, %attn)
}}

%layer_cond (p: {state}) -> pred[] {{
  %p = {state} parameter(0)
  ROOT %c = pred[] constant(true)
}}

ENTRY %main (a: bf16[4,4096,2048], g: f32[29100,4096]) -> f32[29100,4096] {{
  %a = bf16[4,4096,2048]{{2,1,0}} parameter(0)
  %g = f32[29100,4096]{{1,0}} parameter(1)
  %s = {state} tuple(%a)
  %wh = {state} while(%s), condition=%layer_cond, body=%layer_body
  %gr = f32[29100,4096]{{1,0}} all-reduce(%g), channel_id=6, replica_groups=[256,2]<=[2,256]T(1,0), use_global_device_ids=true, to_apply=%add
  %tok = bf16[512,32,2048]{{2,1,0}} all-to-all(%a), channel_id=7, replica_groups=[1,512]<=[512], dimensions={{0}}
  %shift = bf16[1024,2048]{{1,0}} collective-permute(%a), channel_id=8, source_target_pairs={{{ring}}}
  ROOT %out = f32[29100,4096]{{1,0}} add(%gr, %gr)
}}
"""


def collective_pricing(ks, clock_hz, card=None) -> dict:
    """ROADMAP item 7 on the card (``card``, ``None`` = CUDA): the step of
    :func:`collective_step_hlo` parsed (trip count 48), decomposed into
    point-to-point messages on the 2 x 16 x 16 pod and priced by
    ``price_step`` with ``tpu_v5e()``'s table on the card, with K1's count
    set to 0 just before and every K1 input captured and held to its plain
    version, and on the cpu: every ``CollectiveCost`` field and the step
    totals within rtol 1e-4 / atol 1e-6.  Prints the parse, decompose and
    pricing walls, the device-busy share of a profiled pricing, and per op
    kind the model time against the naive ``bytes / link_bw`` time.
    Returns, per kernel, its launches on the pricing and their calls'
    summed times and bound."""
    from repro_torch.core import (PodGeometry, decompose_collective,
                                  parse_collectives, price_step, tpu_v5e)

    text = collective_step_hlo()
    ops, t_parse = sync_time(lambda: parse_collectives(
        text, default_trip_count=COLLECTIVES["layers"]))
    sets, t_dec = sync_time(lambda: [decompose_collective(op) for op in ops])
    kinds = [(op.kind, op.count, op.group_size) for op in ops]
    n_msgs = [ms.src.size for ms in sets]
    want = [("all-gather", 48, 16), ("all-reduce", 48, 16),
            ("all-to-all", 48, 256), ("all-to-all", 48, 256),
            ("reduce-scatter", 48, 16), ("all-reduce", 1, 2),
            ("all-to-all", 1, 512), ("collective-permute", 1, 2)]
    if kinds != want or n_msgs != [512, 512, 130560, 130560, 512, 512,
                                   261632, 512]:
        raise AssertionError(f"collective parse: {kinds}, {n_msgs}")
    geom, params = PodGeometry(**COLLECTIVES["pod"]), tpu_v5e()
    step, t_price, n, cap, _ = counted_kernels(
        ks, lambda: price_step(ops, geom, params, device=card))
    cpu = price_step(ops, geom, params, device="cpu")
    for a, b in zip(step.per_op, cpu.per_op):
        got, ref = dataclasses.asdict(a), dataclasses.asdict(b)
        if (got["kind"], got["count"]) != (ref["kind"], ref["count"]):
            raise AssertionError(f"collective op {got} against {ref}")
        np.testing.assert_allclose(
            [got[k] for k in ref if isinstance(ref[k], float)],
            [ref[k] for k in ref if isinstance(ref[k], float)],
            rtol=RTOL, atol=ATOL, err_msg=f"collective {a.kind}")
    totals = ("naive_time", "transport", "queue", "contention", "model_time",
              "total_wire_bytes", "total_msgs")
    np.testing.assert_allclose([getattr(step, k) for k in totals],
                               [getattr(cpu, k) for k in totals],
                               rtol=RTOL, atol=ATOL, err_msg="step totals")
    if n["segment_reduce"] == 0:
        raise AssertionError("price_step did not launch K1")
    log(f"collectives: {COLLECTIVES['arch']} step on the "
        f"{COLLECTIVES['mesh']} mesh, {len(ops)} ops, {sum(n_msgs)} "
        f"messages a pass ({sum(c * m for (_, c, _), m in zip(kinds, n_msgs))}"
        f" a step); parse {1e3 * t_parse:.2f} ms, decompose "
        f"{1e3 * t_dec:.2f} ms (host), price_step {1e3 * t_price:.2f} ms "
        f"(decompose again, host pricing inputs, one K1 call, one read); "
        f"held to the cpu within rtol {RTOL}; launches {n}")
    by_kind = {}
    for c in step.per_op:
        k = by_kind.setdefault(c.kind, [0.0, 0.0, 0])
        k[0] += c.model_time * c.count
        k[1] += c.naive_time * c.count
        k[2] += c.count
    for kind, (model, naive, count) in by_kind.items():
        log(f"  {kind:18s} x{count:<3d} model {1e3 * model:10.4f} ms, naive "
            f"bytes/link_bw {1e3 * naive:10.4f} ms, model / naive "
            f"{model / naive:8.3f}")
    log(f"  step: model {1e3 * step.model_time:.4f} ms (transport "
        f"{1e3 * step.transport:.4f}, queue {1e3 * step.queue:.4f}, "
        f"contention {1e3 * step.contention:.4f}), naive "
        f"{1e3 * step.naive_time:.4f} ms; busiest chip "
        f"{step.total_wire_bytes:.6g} bytes in {step.total_msgs:.6g} "
        f"messages")
    prof = device_share(lambda: price_step(ops, geom, params, device=card))
    return kernel_sums(ks, "collectives", n, cap, clock_hz, prof)


# -- the kernels line: K1, K2 and K3 figures ---------------------------------

def k2_chain_ops(ks, posted, arrival, bounds):
    """(ops of the longest region's serial chain, ops of all regions) of
    K2 on this input: each region builds span + 1 tree cells, then pays one
    step per prefix-chain and per removal-chain link of every arrival."""
    b, starts, counts, toff, span, _ = ks._queue_layout(posted, arrival,
                                                        bounds)
    region = torch.repeat_interleave(
        torch.arange(counts.numel(), device=b.device), counts,
        output_size=b.numel())
    p = b + 1
    sp = span[region]
    links = torch.zeros_like(p)
    i = p.clone()
    while bool((i > 0).any()):
        links += (i > 0).long()
        i -= i & -i
    i = p.clone()
    while bool((i <= sp).any()):
        links += (i <= sp).long()
        i += i & -i
    per_region = torch.where(counts > 0, span + 1, torch.zeros_like(span))
    per_region.index_add_(0, region, links)
    return int(per_region.max()), int(per_region.sum())


def k1_call_figures(ks, values, ids, n_seg) -> dict:
    """CUDA-event times of one K1 call: the wrapper as the main path calls
    it, the launch alone, the plain version and the one-call PyTorch
    yardstick, beside the bytes bound (8 B read per message, 8 B written
    per segment)."""
    idx = ids.long()
    s_out = torch.empty(n_seg, device=values.device)
    m_out = torch.empty(n_seg, device=values.device)

    def library():
        s_out.zero_().index_add_(0, idx, values)
        m_out.zero_().scatter_reduce_(0, idx, values, "amax",
                                      include_self=False)

    reps = 20
    return dict(
        ms=cuda_ms(lambda: ks.segment_reduce(values, ids, n_seg), reps),
        kernel_ms=cuda_ms(lambda: ks._segment_reduce_cuda(values, ids, n_seg),
                          reps),
        plain_ms=cuda_ms(lambda: ks.segment_reduce_plain(values, ids, n_seg),
                         reps),
        library_ms=cuda_ms(library, reps),
        bound_ms=(8 * values.numel() + 8 * n_seg) / HBM_BYTES_PER_S * 1e3)


def kernel_device_ms(fn, tag: str, reps: int):
    """Mean device ms a call of the kernels whose name holds ``tag``, over
    ``reps`` calls of ``fn`` under ``torch.profiler`` after a warm-up call;
    None where the profiler saw no device time (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and tag in e.key)
    return us / 1e3 / reps if us else None


def k2_call_figures(ks, posted, arrival, bounds, clock_hz) -> dict:
    """CUDA-event times of one K2 call (wrapper with its layout ops, the
    launch alone, the plain lock-step version) and the kernel's device time
    under the profiler, beside its bound: the larger of its bytes (4 B in
    and 8 B out per arrival, 16 B per region), its longest region's serial
    chain at one step per SM clock, and all regions' steps over every INT32
    lane of the card; and the region sizes (mean, p99, max) and the
    compares the kernel makes (c (c - 1) / 2 a region of c arrivals)."""
    N, R = posted.numel(), bounds.numel() - 1
    # the chain terms count the Fenwick walk (K2 up to PR 17: tree build and
    # prefix and removal chains) at one step per clock; the bound is kept as
    # it was so the row compares with earlier ones
    chain, total = k2_chain_ops(ks, posted, arrival, bounds)
    b, starts = ks._queue_layout(posted, arrival, bounds)[:2]
    t_bytes = (4 * N + 16 * R + 8 * N) / HBM_BYTES_PER_S
    t_chain = chain / clock_hz
    t_total = total / (INT32_LANES_PER_SM * SMS * clock_hz)
    counts = (bounds[1:] - bounds[:-1]).double()
    return dict(
        ms=cuda_ms(lambda: ks.queue_walk(posted, arrival, bounds), 10),
        kernel_ms=cuda_ms(lambda: ks._queue_walk_cuda(b, starts), 10),
        device_ms=kernel_device_ms(lambda: ks._queue_walk_cuda(b, starts),
                                   "count_earlier_smaller", 10),
        plain_ms=cuda_ms(lambda: ks.queue_walk_plain(posted, arrival, bounds),
                         2),
        bound_ms=max(t_bytes, t_chain, t_total) * 1e3,
        bound_by="bytes" if t_bytes >= max(t_chain, t_total) else
        "operations",
        arrivals=N, regions=R, longest=int(counts.max()) if R else 0,
        compares=float((counts * (counts - 1) / 2).sum()),
        mean_region=float(counts.mean()) if R else 0.0,
        p99_region=float(torch.quantile(counts, 0.99)) if R else 0.0,
        chain_steps=chain, all_steps=total)


def kernel_sums(ks, what: str, launches, captured, clock_hz,
                prof) -> dict:
    """Every K1 and K2 call a phase captured, held to its plain version
    and timed as the kernels line times the full slice's.  Returns, per
    kernel, its launches on the phase, its calls' summed times and bound,
    its device ms in the profiled rerun ``prof`` (``device_share``'s rows,
    or such rows per kernel; None where the profiler saw no device time)
    and its worst error against the plain version."""
    k1 = [k1_err(ks, *c) for c in captured["segment_reduce"]]
    k2 = [k2_check(ks, *c) for c in captured["queue_walk"]]
    log(f"{what} kernel calls: K1 {len(k1)} held to its plain version (max "
        f"abs err {max((e for e, _ in k1), default=0.0):.3g}, worst "
        f"{max((r for _, r in k1), default=0.0):.3g} of the bound), K2 "
        f"{len(k2)} bit-equal "
        f"({sum(c[0].numel() for c in captured['queue_walk'])} arrivals)")
    log(f"{what} launches: {launches}")
    figs = {"segment_reduce": [k1_call_figures(ks, *c)
                               for c in captured["segment_reduce"]],
            "queue_walk": [k2_call_figures(ks, *c, clock_hz)
                           for c in captured["queue_walk"]]}
    out = {}
    for name, tag in (("segment_reduce", "seg_"),
                      ("queue_walk", "count_earlier_smaller")):
        keys = ("ms", "kernel_ms", "plain_ms", "bound_ms") + (
            ("library_ms",) if name == "segment_reduce" else ())
        out[name] = {"launches": launches[name],
                     **{k: sum(f[k] for f in figs[name]) for k in keys}}
        rows = prof[name] if isinstance(prof, dict) else prof
        out[name]["device_ms"] = (sum(us for us, _, key in rows
                                      if tag in key) / 1e3 if rows else None)
        log(f"{what} {name}: {out[name]} (ms summed over its "
            f"{launches[name]} calls; device_ms from the profiled rerun)")
    out["segment_reduce"]["max_abs_err"] = max((e for e, _ in k1),
                                               default=0.0)
    out["queue_walk"]["max_abs_err"] = max(k2, default=0)
    return out


def kernel_rows(ks, launches, captured, clock_hz):
    """One row per kernel over every call the full-width run made: each
    call is held to the plain version, and the row's times and bound are
    sums over those calls (the slowest call is named beside them)."""
    rows = []
    calls = captured["segment_reduce"]
    errs = [k1_err(ks, *c) for c in calls]
    figs = [k1_call_figures(ks, *c) for c in calls]
    for (v, _, n_seg), f in zip(calls, figs):
        log(f"K1 full-width call n={v.numel()}, n_seg={n_seg}, path "
            f"{ks.k1_path(n_seg)}: wrapper "
            f"{f['ms']:.4f} ms, launch alone {f['kernel_ms']:.4f} ms, plain "
            f"{f['plain_ms']:.4f} ms, library {f['library_ms']:.4f} ms, "
            f"bound {f['bound_ms']:.5f} ms (bytes)")
    slow = max(range(len(calls)), key=lambda k: figs[k]["kernel_ms"])
    total = {k: sum(f[k] for f in figs) for k in
             ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"K1 over the full-width run's {len(calls)} calls: wrapper "
        f"{total['ms']:.4f} ms, launch alone {total['kernel_ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f}"
        f" ms, bound {total['bound_ms']:.5f} ms; worst relative error "
        f"{max(r for _, r in errs):.3g}")
    rows.append(dict(name="segment_reduce", route="cuda",
                     source=KERNEL_ROWS["segment_reduce"][0],
                     replaces=KERNEL_ROWS["segment_reduce"][1],
                     launches=launches["segment_reduce"],
                     paths={p: launches[f"segment_reduce_{p}"]
                            for p in ("smem", "global")},
                     call_paths=[ks.k1_path(c[2]) for c in calls],
                     max_abs_err=max(e for e, _ in errs), ms=total["ms"],
                     plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                     bound_by="bytes", library_ms=total["library_ms"],
                     kernel_ms=total["kernel_ms"], calls=len(calls),
                     slowest_call=dict(n=calls[slow][0].numel(),
                                       n_seg=calls[slow][2], **figs[slow])))
    calls = captured["queue_walk"]
    errs = [k2_check(ks, *c) for c in calls]
    figs = [k2_call_figures(ks, *c, clock_hz) for c in calls]
    for f in figs:
        log(f"K2 full-width call: {f['arrivals']} arrivals in {f['regions']} "
            f"regions (arrivals a region: mean {f['mean_region']:.4f}, p99 "
            f"{f['p99_region']:.4f}, max {f['longest']}; {f['compares']:.0f} "
            f"compares), Fenwick serial "
            f"chain {f['chain_steps']} steps, all regions {f['all_steps']} "
            f"steps; wrapper {f['ms']:.4f} ms, launch alone "
            f"{f['kernel_ms']:.4f} ms, device {f['device_ms']} ms "
            f"(profiler), plain {f['plain_ms']:.4f} ms, bound "
            f"{f['bound_ms']:.5f} ms ({f['bound_by']}); bit-equal")
    total = {k: sum(f[k] for f in figs) for k in
             ("ms", "kernel_ms", "plain_ms", "bound_ms")}
    dev = [f["device_ms"] for f in figs]
    slow = max(range(len(calls)), key=lambda k: figs[k]["kernel_ms"])
    rows.append(dict(name="queue_walk", route="cuda",
                     source=KERNEL_ROWS["queue_walk"][0],
                     replaces=KERNEL_ROWS["queue_walk"][1],
                     launches=launches["queue_walk"], max_abs_err=max(errs),
                     ms=total["ms"], plain_ms=total["plain_ms"],
                     bound_ms=total["bound_ms"],
                     bound_by=figs[slow]["bound_by"], library_ms=None,
                     kernel_ms=total["kernel_ms"],
                     device_ms=None if None in dev else sum(dev),
                     calls=len(calls),
                     slowest_call=figs[slow]))
    return rows


def k3_read_slots(ell, blocks, cols) -> int:
    """Slots K3 reads on this input: every slot, or, for a pair in
    ``csr_to_block_ell``'s layout (``padding_at_end``), slot 0 of each
    block row and every slot at a block column other than 0 (the rest is
    padding, where the kernel stops)."""
    nbr, max_bpr = cols.shape
    if not ell.padding_at_end(blocks, cols) or max_bpr == 0:
        return nbr * max_bpr
    return nbr + int((cols[:, 1:] != 0).sum())


def k3_call_figures(ell, blocks, cols, x, S) -> dict:
    """CUDA-event times of one K3 call (the wrapper as the V-cycle calls it,
    the launch alone, the plain version, and ``S @ x`` with ``S`` the same
    matrix as a float32 ``torch.sparse_csr_tensor``, the one-call PyTorch
    yardstick) beside its bytes bound: the blocks K3 must read (padding
    past a block row's last block excluded: ``k3_read_slots``), ids and x
    read once and y written once at 3.35 TB/s; ``bound_padded_ms`` counts
    every slot, as the kernel's first bound did."""
    nbr, max_bpr, bs, _ = blocks.shape
    xs = x[:S.shape[1]]
    rest = (cols.numel() * 4 + x.numel() * x.element_size()
            + nbr * bs * x.element_size())
    block_bytes = bs * bs * blocks.element_size()
    moved = k3_read_slots(ell, blocks, cols) * block_bytes + rest
    padded = nbr * max_bpr * block_bytes + rest
    reps = 20
    return dict(
        ms=cuda_ms(lambda: ell.spmv_block_ell(blocks, cols, x), reps),
        kernel_ms=cuda_ms(lambda: ell._spmv_block_ell_cuda(blocks, cols, x),
                          reps),
        plain_ms=cuda_ms(lambda: ell.spmv_block_ell_plain(blocks, cols, x),
                         reps),
        library_ms=cuda_ms(lambda: S @ xs, reps),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bytes=moved,
        bound_padded_ms=padded / HBM_BYTES_PER_S * 1e3,
        lanes=ell.lanes_for(nbr * bs, bs, max_bpr))


def k3_row(launches, captured, labels, host, device_ms) -> dict:
    """K3's row over every call of the full-width V-cycle: each call held to
    the plain version, times and bound summed, one line per operator, the
    slowest call named beside the sums, and the kernel's device time over
    the cycle as the profiler saw it (``device_ms``)."""
    from repro_torch.kernels import spmv_ell as ell

    dev = captured[0][0].device
    sparse = {name: torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr), torch.from_numpy(M.indices),
        torch.from_numpy(M.data.astype(np.float32)), size=M.shape,
        device=dev) for name, M in host.items()}
    errs = [k3_err(ell, *c) for c in captured]
    figs = [k3_call_figures(ell, *c, sparse[name])
            for c, name in zip(captured, labels)]
    keys = ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_padded_ms")
    for name in dict.fromkeys(labels):
        mine = [k for k, lab in enumerate(labels) if lab == name]
        blocks = captured[mine[0]][0]
        tot = {k: sum(figs[i][k] for i in mine) for k in keys}
        M = host[name]
        log(f"K3 {name}: {len(mine)} call(s), {M.shape[0]} x {M.shape[1]}, "
            f"{M.nnz} nnz, block-ELL {tuple(blocks.shape)} "
            f"({figs[mine[0]]['bytes']} bytes a call), lanes "
            f"{figs[mine[0]]['lanes']}; summed: wrapper "
            f"{tot['ms']:.4f} ms, launch alone {tot['kernel_ms']:.4f} ms "
            f"({sum(figs[i]['bytes'] for i in mine) / tot['kernel_ms'] / 1e6:.0f}"
            f" GB/s), plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms "
            f"(bytes; every slot {tot['bound_padded_ms']:.5f})")
    total = {k: sum(f[k] for f in figs) for k in keys}
    slow = max(range(len(figs)), key=lambda k: figs[k]["kernel_ms"])
    log(f"K3 over the full-width V-cycle's {len(figs)} calls: wrapper "
        f"{total['ms']:.4f} ms, launch alone {total['kernel_ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f}"
        f" ms, bound {total['bound_ms']:.5f} ms "
        f"({sum(f['bytes'] for f in figs)} bytes; every slot "
        f"{total['bound_padded_ms']:.5f} ms); device {device_ms} ms; "
        f"wrapper / launch alone {total['ms'] / total['kernel_ms']:.3f}; "
        f"slowest call "
        f"{labels[slow]}; max abs err {max(errs):.3g}")
    return dict(name="spmv_block_ell", route="cuda",
                source=KERNEL_ROWS["spmv_block_ell"][0],
                replaces=KERNEL_ROWS["spmv_block_ell"][1], launches=launches,
                max_abs_err=max(errs), ms=total["ms"],
                plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                bound_by="bytes", library_ms=total["library_ms"],
                kernel_ms=total["kernel_ms"], device_ms=device_ms,
                bound_padded_ms=total["bound_padded_ms"],
                lanes={lab: figs[labels.index(lab)]["lanes"]
                       for lab in dict.fromkeys(labels)},
                calls=len(figs),
                slowest_call=dict(op=labels[slow], **figs[slow]))


# -- phase 2 (continued): K4 and K5 parity --------------------------------------

def k4_err(fa, q, k, v, causal) -> float:
    """K4 against its plain version on one input; returns the worst abs
    error, or raises past K4_TOL + K4_TOL |want| (for bf16 outputs plus one
    bf16 ulp and BF16_P_TOL max_j |v_j| for the rounded p)."""
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention gave {got.dtype} "
                             f"{tuple(got.shape)}, expected {want.dtype} "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    tol = K4_TOL + K4_TOL * want.abs()
    if q.dtype == torch.bfloat16:
        rep = q.shape[2] // k.shape[2]
        vmax = v.float().abs().amax(dim=(1, 3)).repeat_interleave(rep, 1)
        tol = tol + BF16_REL_ULP * want.abs() \
            + BF16_P_TOL * vmax[:, None, :, None]
    err = (got - want).abs()
    if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention off by up to "
                             f"{float(err.max())} (q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, {q.dtype}, causal {causal})")
    return float(err.max())


def k5_err(ssd, dtx, Bm, Cm, cumA) -> float:
    """K5 against its plain version on one input (y and S_c); returns the
    worst abs error, or raises past K5_TOL."""
    got = ssd.ssd_intra_chunk(dtx, Bm, Cm, cumA)
    want = ssd.ssd_intra_chunk_plain(dtx, Bm, Cm, cumA)
    worst = 0.0
    for g, w, what in zip(got, want, ("y", "S_c")):
        if g.shape != w.shape:
            raise AssertionError(f"ssd_intra_chunk {what} has shape "
                                 f"{tuple(g.shape)}, expected "
                                 f"{tuple(w.shape)}")
        err = (g - w).abs()
        if bool((err > K5_TOL + K5_TOL * w.abs()).any()) \
                or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_intra_chunk {what} off by up to "
                                 f"{float(err.max())} (dtx "
                                 f"{tuple(dtx.shape)}, B {tuple(Bm.shape)})")
        worst = max(worst, float(err.max()))
    return worst


# K4 at full width beside the main path's shape: (label, B, S, H, KH, D)
K4_WIDE = (("hymba-1.5b", 4, 2048, 25, 5, 64),
           ("llama3.2-3b", 4, 2048, 24, 8, 128))
# K5 at the full prefill shapes of 4 x 2048 tokens in chunks of 128:
# (label, G1 = batch x chunks, heads, q, n, p)
K5_WIDE = (("hymba-1.5b", 64, 50, 128, 16, 64),
           ("mamba2-130m", 64, 24, 128, 128, 64))


def k5_inputs(gen, G1, h, q, n, p):
    """K5's inputs as ``nn.ssm.ssd_chunked`` passes them: dtx and cumA
    transposed views of [G1, q, h, x], B and C [G1, 1, q, n] expanded over
    the heads (stride 0), cumA a cumulative sum of decays in (-0.1, 0]."""
    dev = "cuda"
    dtx = torch.randn(G1, q, h, p, generator=gen, device=dev)
    Bm, Cm = (torch.randn(G1, 1, q, n, generator=gen, device=dev)
              .expand(G1, h, q, n) for _ in range(2))
    a = -0.1 * torch.rand(G1, q, h, generator=gen, device=dev)
    cumA = a.cumsum(1).permute(0, 2, 1)[..., None]
    return dtx.permute(0, 2, 1, 3), Bm, Cm, cumA


def k4_k5_parity(dev) -> None:
    """K4 on D 16/32/64/128, rep 1, 5 and 8, causal and full, S 1, 63, 200
    (not multiples of the 64-row tile) and 2048, float32 and bfloat16, then
    causal bf16 at hymba-1.5b's and llama3.2-3b's full attention shapes
    (timed beside SDPA and the bound); K5 on q 1/16/24/64/100/128 (ragged
    q is padded inside the kernel), n 8/16/128, p 16/64 with B and C
    expanded over 5 heads (stride 0) and dtx and cumA transposed views, on
    p 18 and a column-strided dtx (copied four bytes at a time), and at
    hymba-1.5b's and mamba2-130m's full prefill shapes, every launch on
    the tensor-core path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    gen = torch.Generator(device=dev).manual_seed(2)
    worst, n = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    fa.reset_launches()
    n_bf16 = 0
    for D in (16, 32, 64, 128):
        for rep in (1, 5, 8):
            for causal in (True, False):
                for S in (1, 63, 200, 2048):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v = (torch.randn(2, S, h, D, generator=gen,
                                               device=dev).to(dtype)
                                   for h in (2 * rep, 2, 2))
                        worst[dtype] = max(worst[dtype],
                                           k4_err(fa, q, k, v, causal))
                        n += 1
                        n_bf16 += dtype == torch.bfloat16
    wide = []
    for label, B, S, H, KH, D in K4_WIDE:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev)
                   .bfloat16() for h in (H, KH, KH))
        wide.append((label, q, k, v, k4_err(fa, q, k, v, True)))
        worst[torch.bfloat16] = max(worst[torch.bfloat16], wide[-1][-1])
        n += 1
        n_bf16 += 1
    torch.cuda.synchronize()
    if fa.LAUNCHES["flash_attention_tc"] != n_bf16:
        raise AssertionError(f"{fa.LAUNCHES['flash_attention_tc']} of "
                             f"{n_bf16} bf16 K4 cases ran on the tensor "
                             f"cores")
    log(f"K4 parity: {n} cases (D 16/32/64/128, rep 1/5/8, causal and full, "
        f"S 1/63/200/2048, float32 and bfloat16; 2 full-width bf16), max abs"
        f" err float32 {worst[torch.float32]:.3g}, bfloat16 "
        f"{worst[torch.bfloat16]:.3g}; {fa.LAUNCHES['flash_attention_tc']} "
        f"of {n_bf16} bf16 cases on the tensor-core path")
    for label, q, k, v, err in wide:
        f = k4_call_figures(fa, q, k, v, True)
        log(f"K4 at {label}'s attention shape (q {list(q.shape)}, k/v "
            f"{list(k.shape)}, bf16, causal): launch alone "
            f"{f['kernel_ms']:.4f} ms ({f['flops'] / f['kernel_ms'] / 1e9:.1f}"
            f" TFLOP/s), SDPA {f['library_ms']:.4f} ms, plain "
            f"{f['plain_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
            f"({f['bound_by']}); max abs err {err:.3g}")
    worst5, n = 0.0, 0
    ssd.reset_launches()
    for q in (1, 16, 24, 64, 100, 128):
        for nn in (8, 16, 128):
            for p in (16, 64):
                worst5 = max(worst5, k5_err(ssd, *k5_inputs(gen, 6, 5, q, nn,
                                                             p)))
                n += 1
    # dtx copied four bytes at a time: a head dim that is not a multiple of
    # 4, and columns that are not adjacent
    for q, nn, p, strided in ((100, 16, 18, False), (128, 16, 64, True)):
        dtx, *rest = k5_inputs(gen, 6, 5, q, nn, p)
        if strided:
            dtx = dtx.mT.contiguous().mT
        worst5 = max(worst5, k5_err(ssd, dtx, *rest))
        n += 1
    wide = {}
    for label, *shape in K5_WIDE:
        wide[label] = k5_err(ssd, *k5_inputs(gen, *shape))
        worst5 = max(worst5, wide[label])
        n += 1
    torch.cuda.synchronize()
    if ssd.LAUNCHES["ssd_intra_chunk_tc"] != n:
        raise AssertionError(f"{ssd.LAUNCHES['ssd_intra_chunk_tc']} of {n} "
                             f"K5 cases ran on the tensor cores")
    log(f"K5 parity: {n} cases (q 1/16/24/64/100/128, n 8/16/128, p 16/64; "
        f"B and C expanded over 5 heads, dtx and cumA transposed views; p 18 "
        f"and column-strided dtx; "
        f"full width " + ", ".join(f"{k} {v:.3g}" for k, v in wide.items())
        + f"), max abs err {worst5:.3g} (limit {K5_TOL} + {K5_TOL} |want|); "
        f"{ssd.LAUNCHES['ssd_intra_chunk_tc']} of {n} on the tensor-core "
        f"path")


# The mixer's prologue and epilogue against their plain versions run in
# float32 on the same (widened) inputs: one bf16 rounding at each bf16
# output and at the conv output behind dtx, B and C (2^-9 of the value),
# held to 2^-8 of it plus float32 round-off; cumA, float32 throughout, to
# 1e-5.
MIXER_REL = 2.0 ** -8
# The benchmark's prefill steps: (label, rows, positions, heads, head dim,
# state), 16,384 tokens in chunks of 128, conv kernel 4
MIXER_STEPS = (("hymba-1.5b prefill-long", 8, 2048, 50, 64, 16),
               ("granite-4.0-h-small prefill-long16k", 4, 4096, 128, 64,
                128))


def mixer_err(got, want, what: str, rel: float = MIXER_REL) -> float:
    """The worst abs error of ``got`` against ``want``; raises past ``rel
    |want| + 1e-5 (1 + max |want|)``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = rel * want.abs() + 1e-5 * (1 + want.abs().max())
    if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"ssm mixer {what} off by up to "
                             f"{float(err.max())}")
    return float(err.max())


def mixer_kernels(dev) -> dict:
    """The prologue and epilogue kernels at each of ``MIXER_STEPS``: held
    to their plain versions, then timed (CUDA events): the wrapper, the
    launch alone, the plain torch-op chain the mixer ran before them (the
    plain version on the bf16 inputs) and the byte bound at 3.35 TB/s
    (every input read once, every output written once)."""
    from repro_torch.kernels import ssm_mixer as fused

    gen = torch.Generator(device=dev).manual_seed(35)
    fused.reset_launches()
    out = {}
    for label, b, l, h, hd, n in MIXER_STEPS:
        di, q, K = h * hd, 128, 4
        bc, tokens = b * l // q, b * l

        def rnd(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device=dev)
        zx = rnd(b, l, 2 * di + 2 * n + h).bfloat16()
        w = rnd(K, di + 2 * n, scale=0.5).bfloat16()
        cb = rnd(di + 2 * n, scale=0.1).bfloat16()
        dt_bias = rnd(h)
        A_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        xbc, dt = zx[..., di:2 * di + 2 * n], zx[..., 2 * di + 2 * n:]
        pro_args = (xbc, dt, w, cb, dt_bias, A_log, n, q)
        pro = fused.prologue(*pro_args)
        want = fused.prologue_plain(xbc.float(), dt.float(), w.float(),
                                    cb.float(), dt_bias, A_log, n, q)
        errs = {what: mixer_err(g, wt, what, 1e-5 if what == "cumA"
                                else MIXER_REL)
                for g, wt, what in zip(pro, want,
                                       ("dtx", "Bm", "Cm", "cumA", "x"))}
        epi_args = (rnd(bc * h, q, hd), rnd(b, l // q, q, h, hd), pro[3],
                    pro[4], zx[..., :di], rnd(h), 1 + rnd(di, scale=0.1))
        got = fused.epilogue(*epi_args, 1e-5)
        wide = [t.float() if t.dtype == torch.bfloat16 else t
                for t in epi_args]
        errs["out"] = mixer_err(got, fused.epilogue_plain(*wide, 1e-5),
                                "out")
        reps = 20
        xbc_rows, dt_rows = fused._rows(xbc), fused._rows(dt)
        weights = fused._f32(w, cb, dt_bias, A_log)
        epi_out = torch.empty_like(got)
        pro_bytes = tokens * ((di + 2 * n + h) * 2 + di * 4 + di * 2
                              + 2 * n * 4 + h * 4)
        epi_bytes = tokens * (2 * di * 4 + h * 4 + 3 * di * 2)
        figs = dict(
            prologue=dict(
                ms=cuda_ms(lambda: fused.prologue(*pro_args), reps),
                kernel_ms=cuda_ms(lambda: fused._prologue_cuda(
                    xbc_rows, dt_rows, *weights, pro, K), reps),
                plain_ms=cuda_ms(lambda: fused.prologue_plain(*pro_args),
                                 reps),
                bytes=pro_bytes, bound_ms=pro_bytes / HBM_BYTES_PER_S * 1e3),
            epilogue=dict(
                ms=cuda_ms(lambda: fused.epilogue(*epi_args, 1e-5), reps),
                kernel_ms=cuda_ms(lambda: fused._epilogue_cuda(
                    *epi_args[:4], fused._rows(epi_args[4]), *epi_args[5:],
                    1e-5, epi_out), reps),
                plain_ms=cuda_ms(lambda: fused.epilogue_plain(
                    *epi_args, 1e-5), reps),
                bytes=epi_bytes, bound_ms=epi_bytes / HBM_BYTES_PER_S * 1e3))
        for name, f in figs.items():
            log(f"ssm_{name} at {label}'s step ({b} x {l} tokens, h {h}, p "
                f"{hd}, n {n}): wrapper {f['ms']:.4f} ms, launch alone "
                f"{f['kernel_ms']:.4f} ms "
                f"({f['bytes'] / f['kernel_ms'] / 1e6:.0f} GB/s), plain "
                f"torch-op chain {f['plain_ms']:.4f} ms, bound "
                f"{f['bound_ms']:.4f} ms (bytes: {f['bytes']})")
        log(f"ssm mixer kernels at {label}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        out[label] = dict(figs, max_abs_err=errs)
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    log(f"ssm mixer kernels: launches in this phase {launches}")
    return dict(source="src/repro_torch/kernels/csrc/ssm_mixer.cu",
                launches=launches, steps=out)


# -- phases 13 and 14: the model -------------------------------------------------

def prompt_inputs(cfg, B: int, S: int, seed: int) -> dict:
    """A seeded prompt of ``cfg``'s family as numpy arrays, keyed as
    ``prefill`` takes them: tokens, or patch embeddings [B, S, d] for a
    patch frontend (qwen2-vl); frame embeddings [B, encoder_seq, d] for an
    encoder (whisper)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch_embed":
        out = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_layers:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def greedy(model, cfg, inputs: dict, steps: int, device, max_seq: int):
    """``prefill`` of ``inputs`` (tensors keyed as ``prefill`` takes them)
    then ``steps`` greedy ``decode_step`` calls; returns (every logits row
    on the host, the greedy tokens)."""
    from repro_torch.nn import decode_step, prefill

    S = next(iter(inputs.values())).shape[1]
    logits, cache = prefill(model, cfg, max_seq=max_seq, device=device,
                            **inputs)
    rows, toks = [logits.double().cpu()], []
    for i in range(steps):
        tok = logits.argmax(-1)
        toks.append(tok.cpu())
        logits, cache = decode_step(model, cfg, cache, tok, S + i,
                                    device=device)
        rows.append(logits.double().cpu())
    toks.append(logits.argmax(-1).cpu())
    return rows, torch.stack(toks, 1)


def small_model() -> None:
    """hymba-1.5b's smoke config and its full width cut to 2 layers, the
    smoke configs of the dense ids whose blocks differ from llama3.2's
    (tinyllama-1.1b; starcoder2-3b: gelu MLP, layernorm; qwen3-32b:
    qk-norm) and of the other families (deepseek-moe-16b and
    qwen3-moe-30b-a3b: MoE; whisper-small: encoder and cross-attention on
    frame embeddings; qwen2-vl-72b: patch embeddings, M-RoPE),
    qwen3-moe-30b-a3b at full width cut to 2 layers and llama3.2-3b's smoke
    config with the int8 KV cache, float32 weights, on cuda and on cpu: K4
    launched once a self-attention on cuda, logits within MODEL_RTOL
    relative L2 of each other at every step, the same greedy tokens."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn import init_params, params_from_numpy, params_to_numpy

    S, steps = HYMBA["small_prompt"], HYMBA["small_decode"]
    for arch, label, cfg in (
            (HYMBA["arch"], "smoke config", get_smoke_config(HYMBA["arch"])),
            (HYMBA["arch"], "full width cut to 2 layers", dataclasses.replace(
                get_config(HYMBA["arch"]), n_layers=2)),
            *((a, "smoke config", get_smoke_config(a))
              for a in DENSE_SMOKE + FAMILY_SMOKE),
            ("qwen3-moe-30b-a3b", "full width cut to 2 layers",
             dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                 n_layers=2)),
            ("llama3.2-3b", "smoke config with kv_quant",
             dataclasses.replace(get_smoke_config("llama3.2-3b"),
                                 kv_quant=True))):
        gpu = init_params(cfg, seed=0).float()
        cpu = params_from_numpy(params_to_numpy(gpu), cfg, device="cpu",
                                dtype=torch.float32)
        inputs = {k: torch.from_numpy(v)
                  for k, v in prompt_inputs(cfg, 1, S, 0).items()}
        fa.reset_launches()
        (rows_g, toks_g), t_gpu = sync_time(lambda: greedy(
            gpu, cfg, {k: v.cuda() for k, v in inputs.items()}, steps, None,
            S + steps))
        k4 = fa.LAUNCHES["flash_attention"]
        if k4 != cfg.n_layers + cfg.encoder_layers:
            raise AssertionError(f"small model {arch} ({label}): K4 launched "
                                 f"{k4} times, expected "
                                 f"{cfg.n_layers + cfg.encoder_layers}")
        t = time.perf_counter()
        rows_c, toks_c = greedy(cpu, cfg, inputs, steps, "cpu", S + steps)
        t_cpu = time.perf_counter() - t
        rels = [rel_l2(g, c) for g, c in zip(rows_g, rows_c)]
        if not max(rels) <= MODEL_RTOL or not all(
                bool(torch.isfinite(r).all()) for r in rows_g):
            raise AssertionError(f"small model {arch} ({label}): cuda vs "
                                 f"cpu logits relative L2 {rels}")
        if not torch.equal(toks_g, toks_c):
            raise AssertionError(f"small model {arch} ({label}): greedy "
                                 f"tokens differ: cuda {toks_g.tolist()}, "
                                 f"cpu {toks_c.tolist()}")
        log(f"small model, {arch} {label} ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.family}, {cfg.mlp_type} MLP, "
            f"{cfg.norm_type}, qk_norm {cfg.qk_norm}, experts "
            f"{cfg.n_experts} top-{cfg.n_experts_active}, encoder "
            f"{cfg.encoder_layers}, m_rope {cfg.m_rope}, kv_quant "
            f"{cfg.kv_quant}), float32, 1 x {S}-position prompt "
            f"({'/'.join(inputs)}) + {steps} greedy steps, {k4} K4 launches:"
            f" cuda {t_gpu:.3f} s, cpu {t_cpu:.3f} s; "
            f"logits relative L2 worst {max(rels):.3g} (limit {MODEL_RTOL}),"
            f" tokens equal {toks_g[0].tolist()}")
        del gpu, cpu


def spy_ops(names):
    """Context: the entry points ``names`` of ``kernels.ops`` (K4's
    ``flash_attention``, K5's ``ssd_intra_chunk``) record every call's
    inputs, detached, as ``([args], kwargs)`` in the dict it yields, by
    name, while it is open."""
    from repro_torch.kernels import ops

    captured = {name: [] for name in names}
    real = {name: getattr(ops, name) for name in names}

    def spy(name):
        def call(*args, **kw):
            captured[name].append(([a.detach() for a in args], kw))
            return real[name](*args, **kw)
        return call

    @contextlib.contextmanager
    def ctx():
        for name in names:
            setattr(ops, name, spy(name))
        try:
            yield captured
        finally:
            for name, fn in real.items():
                setattr(ops, name, fn)
    return ctx()


def full_model():
    """hymba-1.5b at full width in bf16: prefill of 4 x 2048 tokens with K4
    and K5 counted and their inputs captured, 32 greedy decode steps, a
    profiled prefill and the serving engine.  Returns (launches, captured
    calls, device ms of K4 and K5 over the profiled prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.kernels import ssm_mixer as fused
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import init_params

    cfg = get_config(HYMBA["arch"])
    B, S, steps = HYMBA["batch"], HYMBA["prompt"], HYMBA["decode"]
    model, t_init = sync_time(lambda: init_params(cfg, seed=0))
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"full model: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim}, {cfg.ssm_heads} SSM heads (state {cfg.ssm_state}, "
        f"chunk {cfg.ssm_chunk}), vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for p in model.parameters())} parameters, {n_bytes}"
        f" bytes on the card (bf16 weights, float32 norms and SSM scalars), "
        f"init_params(seed=0) {t_init:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    batch = {"tokens": tokens}
    prefill_step = make_prefill_step(cfg, max_seq=HYMBA["max_seq"])
    serve_step = make_serve_step(cfg)

    t_warm = sync_time(lambda: prefill_step(model, batch))[1]
    torch.cuda.reset_peak_memory_stats()
    t_pre = sync_time(lambda: prefill_step(model, batch))[1]
    peak = torch.cuda.max_memory_allocated()

    with spy_ops(("flash_attention", "ssd_intra_chunk")) as captured:
        fa.reset_launches()
        ssd.reset_launches()
        fused.reset_launches()
        (logits, cache), t_counted = sync_time(
            lambda: prefill_step(model, batch))
        launches = {**fa.LAUNCHES, **ssd.LAUNCHES}
        mixer = dict(fused.LAUNCHES)
    mamba = sum(k in ("ssm", "hybrid") for k in cfg.layer_kinds)
    log(f"full model prefill launches: {launches} (expected "
        f"{cfg.n_layers} each, one a layer, K4's backward none); the "
        f"mixer's prologue and "
        f"epilogue {mixer} (expected {mamba} each, one a Mamba2 layer)")
    for name, n in launches.items():
        # K4's backward kernels run in training only
        want = 0 if name == "flash_attention_bwd" else cfg.n_layers
        if n != want:
            raise AssertionError(f"{name} launched {n} times in the "
                                 f"full-width prefill, expected {want}")
    if set(mixer.values()) != {mamba}:
        raise AssertionError(f"the mixer's kernels launched {mixer} times "
                             f"in the full-width prefill, expected {mamba} "
                             "each")
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite")
    for name, t in cache["layers"].items():
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"prefill cache {name} is not finite")
    log(f"full model prefill {B} x {S} tokens: {t_pre:.4f} s wall "
        f"({B * S / t_pre:.0f} tokens/s; warm-up {t_warm:.3f} s, counted "
        f"run {t_counted:.3f} s); max_memory_allocated {peak} bytes; cache "
        + ", ".join(f"{k} {tuple(t.shape)} {str(t.dtype)[6:]}"
                    for k, t in cache["layers"].items()))

    tok, walls, out = logits.argmax(-1), [], []
    for i in range(steps):
        (logits, cache), w = sync_time(
            lambda: serve_step(model, cache, tok, S + i))
        walls.append(w)
        tok = logits.argmax(-1)
        out.append(tok)
    if {**fa.LAUNCHES, **ssd.LAUNCHES} != launches:
        raise AssertionError(f"decode launched K4 or K5: {fa.LAUNCHES}, "
                             f"{ssd.LAUNCHES}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("decode logits are not finite")
    step_ms = 1e3 * sum(walls[1:]) / (steps - 1)
    log(f"full model decode: {steps} greedy steps from position {S}, "
        f"{step_ms:.3f} ms a step after the first ({walls[0] * 1e3:.3f} ms), "
        f"{B / step_ms * 1e3:.1f} tokens/s; no K4 or K5 launch; row 0's "
        f"tokens {torch.stack(out, 1)[0].tolist()}")

    rows = device_share(lambda: prefill_step(model, batch))
    # None where the profiler saw no device time
    dev_ms = {name: sum(us for us, _, key in rows if tag in key) / 1e3
              if rows else None
              for name, tag in (("flash_attention", "flash_fwd"),
                                ("ssd_intra_chunk", "ssd_intra"))}
    log(f"full model prefill: kernel device time under the profiler "
        f"{dev_ms} ms")
    del cache
    serve_engine(cfg, model, fa, ssd)
    del model
    torch.cuda.empty_cache()
    return launches, captured, dev_ms


def serve_engine(cfg, model, fa, ssd) -> None:
    """``ServeEngine`` at full width with ``launch/serve.py``'s defaults:
    every request finishes with its 8 tokens, and no kernel runs (the
    engine ingests prompts through decode, as the reference's does)."""
    from repro_torch.serve import Request, ServeEngine

    e = HYMBA["engine"]
    eng = ServeEngine(cfg, model, batch_slots=e["slots"],
                      max_seq=e["max_seq"])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=uid, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(2, 8))).tolist(),
        max_new_tokens=e["max_new"]) for uid in range(e["requests"])]
    for r in reqs:
        eng.submit(r)
    before = {**fa.LAUNCHES, **ssd.LAUNCHES}
    done, wall = sync_time(lambda: eng.run_until_done(max_ticks=2000))
    if len(done) != e["requests"] or any(
            len(r.output) != e["max_new"] for r in reqs):
        raise AssertionError(f"ServeEngine finished {len(done)} of "
                             f"{e['requests']} requests: "
                             f"{[(r.uid, len(r.output)) for r in reqs]}")
    if {**fa.LAUNCHES, **ssd.LAUNCHES} != before:
        raise AssertionError("ServeEngine launched K4 or K5")
    new = sum(len(r.output) for r in reqs)
    log(f"ServeEngine at full width: {e['slots']} slots, {len(reqs)} "
        f"requests of {[len(r.prompt) for r in reqs]} prompt tokens, "
        f"{new} new tokens in {wall:.3f} s ({new / wall:.1f} tokens/s)")
    for r in reqs:
        log(f"  req {r.uid}: prompt {r.prompt} -> {r.output}")


# -- phase 15: the rest of nn/ -------------------------------------------------

# the full-width runs of the other families: deepseek-moe-16b as published;
# whisper-small as published on 1,500 frame embeddings; qwen2-vl-72b at full
# width cut to 4 of its 80 layers (80 are 144 GB); llama3.2-3b with the
# int8 KV cache
REST = {
    "deepseek": {"arch": "deepseek-moe-16b", "batch": 4, "prompt": 2048,
                 "max_seq": 2080, "decode": 32, "layer_tokens": 512},
    "whisper": {"arch": "whisper-small", "batch": 4, "prompt": 64,
                "max_seq": 96, "decode": 32},
    "qwen2_vl": {"arch": "qwen2-vl-72b", "layers": 4, "batch": 2,
                 "prompt": 2048, "max_seq": 2056, "decode": 8},
    "kv_quant": {"arch": "llama3.2-3b", "batch": 4, "prompt": 2048,
                 "max_seq": 2080, "decode": 32},
}
# the reference's own bound on decode through the int8 cache against full
# precision (tests/test_nn_models.py::test_int8_kv_cache_decode_close): the
# largest logit gap over the largest logit
KV_QUANT_REL = 0.08


def k4_counted(fn):
    """``fn()`` with K4's counts set to 0 just before and the inputs of
    every K4 call captured: (result, wall s, launches, [(args, kwargs)])."""
    from repro_torch.kernels import flash_attention as fa

    with spy_ops(("flash_attention",)) as captured:
        fa.reset_launches()
        out, wall = sync_time(fn)
        launches = dict(fa.LAUNCHES)
    return out, wall, launches, captured["flash_attention"]


def k4_path(label: str, launches: dict, calls: list, want: int) -> dict:
    """K4's launches on one path (``want`` of them, all bf16 on the tensor
    cores), every call held to its plain version and timed: the summed
    figures of its calls."""
    from repro_torch.kernels import flash_attention as fa

    if launches["flash_attention"] != want or \
            launches["flash_attention_tc"] != want or len(calls) != want:
        raise AssertionError(f"{label}: K4 launched {launches} with "
                             f"{len(calls)} calls, expected {want}, all on "
                             f"the tensor cores")
    errs, figs = [], []
    for args, kw in calls:
        causal = kw.get("causal", True)
        errs.append(k4_err(fa, *args, causal))
        figs.append(k4_call_figures(fa, *args, causal))
    total = {k: sum(f[k] for f in figs) for k in
             ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
              "flops", "bytes")}
    shapes = sorted({(tuple(a[0].shape), tuple(a[1].shape),
                      kw.get("causal", True)) for a, kw in calls})
    n_full = sum(not kw.get("causal", True) for _, kw in calls)
    log(f"K4 on {label}: {len(calls)} calls ({n_full} non-causal; q, k, "
        f"causal: {shapes}), bf16: wrapper {total['ms']:.4f} ms, launch alone"
        f" {total['kernel_ms']:.4f} ms "
        f"({total['flops'] / total['kernel_ms'] / 1e9:.1f} TFLOP/s), SDPA "
        f"{total['library_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"bound {total['bound_ms']:.4f} ms ({figs[0]['bound_by']}); max abs "
        f"err {max(errs):.3g}")
    return dict(launches=launches["flash_attention"],
                tc_launches=launches["flash_attention_tc"],
                calls=len(calls), non_causal=n_full,
                inputs=[[list(q), list(k), c] for q, k, c in shapes],
                max_abs_err=max(errs), bound_by=figs[0]["bound_by"],
                **{k: total[k] for k in ("ms", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms")})


def model_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for g in cache.values()
               for t in g.values())


def check_finite(what: str, logits, cache=None) -> None:
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{what}: logits are not finite")
    for group in (cache or {}).values():
        for name, t in group.items():
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what}: cache {name} is not finite")


def decode_run(what: str, model, cfg, cache, tok, start: int, steps: int):
    """``steps`` greedy ``make_serve_step`` calls from ``tok`` at
    ``start``, no K4 launch among them: (last logits, ms a step after the
    first, the first step's ms, the tokens)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_serve_step

    serve_step = make_serve_step(cfg)
    before = dict(fa.LAUNCHES)
    walls, out = [], []
    for i in range(steps):
        (logits, cache), w = sync_time(
            lambda: serve_step(model, cache, tok, start + i))
        walls.append(w)
        tok = logits.argmax(-1)
        out.append(tok)
    if fa.LAUNCHES != before:
        raise AssertionError(f"{what}: decode launched K4")
    check_finite(f"{what} decode", logits)
    step_ms = 1e3 * sum(walls[1:]) / max(steps - 1, 1)
    return logits, step_ms, 1e3 * walls[0], torch.stack(out, 1)


def prefill_run(what: str, cfg, model, batch: dict, max_seq: int,
                want_k4: int, around=contextlib.nullcontext):
    """A warm-up prefill, one timed (peak memory read), one counted (K4's
    calls captured, inside the context ``around()``): (logits, cache, wall
    s, peak bytes, K4 figures' inputs (launches, calls), the step)."""
    from repro_torch.launch.steps import make_prefill_step

    prefill_step = make_prefill_step(cfg, max_seq=max_seq)
    t_warm = sync_time(lambda: prefill_step(model, batch))[1]
    torch.cuda.reset_peak_memory_stats()
    t_pre = sync_time(lambda: prefill_step(model, batch))[1]
    peak = torch.cuda.max_memory_allocated()
    with around():
        (logits, cache), t_counted, launches, calls = k4_counted(
            lambda: prefill_step(model, batch))
    if launches["flash_attention"] != want_k4:
        raise AssertionError(f"{what} prefill launched K4 {launches}, "
                             f"expected {want_k4}")
    check_finite(f"{what} prefill", logits, cache)
    B, S = next(iter(batch.values())).shape[:2]
    log(f"{what} prefill {B} x {S}: {t_pre:.4f} s wall ({B * S / t_pre:.0f}"
        f" positions/s; warm-up {t_warm:.3f} s, counted run "
        f"{t_counted:.3f} s); max_memory_allocated {peak} bytes; "
        f"{launches['flash_attention']} K4 launches; cache "
        + ", ".join(f"{g}/{k} {tuple(t.shape)} {str(t.dtype)[6:]}"
                    for g, d in cache.items() for k, t in d.items()))
    return logits, cache, t_pre, peak, (launches, calls), prefill_step


def moe_layer_split(cfg, lp, xf) -> None:
    """One MoE layer of ``lp`` on the tokens ``xf`` [T, d] split by CUDA
    events into routing (router product, softmax, top-k), dispatch (sort,
    counts, the buffer's gather), the expert products, the combine and the
    shared experts."""
    from repro_torch.nn import moe
    from repro_torch.nn.layers import mlp

    T = xf.shape[0]
    C = moe.capacity(T, cfg)
    p = lp["moe"]
    xg = xf[None]                    # one group of T tokens (D = 1)
    gates, idx, _, _ = moe.route(xg, p["router"], cfg)
    buf, plan = moe.dispatch(xg, idx, gates, C, cfg.n_experts)
    out = moe.experts(buf, p)
    shared = {k: p[f"shared_{k}"] for k in ("w1", "w3", "w2")}
    parts = {
        "route": lambda: moe.route(xg, p["router"], cfg),
        "dispatch": lambda: moe.dispatch(xg, idx, gates, C, cfg.n_experts),
        "experts": lambda: moe.experts(buf, p),
        "combine": lambda: moe.combine(out, plan, T),
        "shared": lambda: mlp(xf, shared, "swiglu"),
        "whole": lambda: moe.moe_ffn(xf[None], p, cfg),
    }
    ms = {k: cuda_ms(fn, 5) for k, fn in parts.items()}
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    flops = 3 * 2 * E * C * d * f
    wbytes = 3 * E * d * f * buf.element_size()
    log(f"deepseek MoE layer split (T {T}, E {E}, C {C}, bf16, CUDA events):"
        + ", ".join(f" {k} {v:.4f} ms" for k, v in ms.items())
        + f"; expert products {flops} flops over E x C slots "
        f"({flops / ms['experts'] / 1e9:.1f} TFLOP/s; bound "
        f"{max(flops / BF16_FLOPS, wbytes / HBM_BYTES_PER_S) * 1e3:.4f} ms),"
        f" of which the routed T K = {T * cfg.n_experts_active} assignments "
        f"fill {100 * T * cfg.n_experts_active / (E * C):.1f} %")


def moe_layer_on_cpu(cfg, lp, xf) -> None:
    """One full-width MoE layer on ``xf`` [T, d] in float32 on cuda and on
    cpu: routing equal, outputs within MODEL_RTOL relative L2, aux within
    1e-6."""
    from repro_torch.nn import moe

    p32 = {k: v.float() for k, v in lp["moe"].items()}
    x32 = xf.float()
    T = x32.shape[0]
    (y_g, aux_g), t_g = sync_time(lambda: moe.moe_ffn(x32[None], p32, cfg))
    pc = {k: v.cpu() for k, v in p32.items()}
    xc = x32.cpu()
    t = time.perf_counter()
    y_c, aux_c = moe.moe_ffn(xc[None], pc, cfg)
    t_c = time.perf_counter() - t
    _, idx_g, _, _ = moe.route(x32[None], p32["router"], cfg)
    _, idx_c, _, _ = moe.route(xc[None], pc["router"], cfg)
    if not torch.equal(idx_g.cpu(), idx_c):
        raise AssertionError(f"MoE layer routing differs on "
                             f"{int((idx_g.cpu() != idx_c).any(-1).sum())} "
                             f"of {T} tokens between cuda and cpu")
    rel = rel_l2(y_g.double().cpu(), y_c.double())
    if not rel <= MODEL_RTOL or abs(float(aux_g) - float(aux_c)) > 1e-6:
        raise AssertionError(f"MoE layer cuda vs cpu: relative L2 {rel}, "
                             f"aux {float(aux_g)} vs {float(aux_c)}")
    log(f"deepseek MoE layer at full width, {T} tokens, float32: routing "
        f"equal on cuda and cpu, output relative L2 {rel:.3g} (limit "
        f"{MODEL_RTOL}), aux {float(aux_g):.6f} / {float(aux_c):.6f}; cuda "
        f"{t_g:.3f} s, cpu {t_c:.3f} s")


def deepseek_full() -> dict:
    """deepseek-moe-16b as published (28 layers: one dense, 27 of 64
    routed experts top-6 and 2 shared), bf16 random weights: prefill of
    4 x 2048 tokens (28 K4 launches), the capacity drops and aux loss a
    layer, 32 greedy decode steps, a profiled prefill, one MoE layer split
    by parts and held to itself on the cpu, and ``ServeEngine``.  Returns
    K4's figures on the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.nn import init_params, moe

    r = REST["deepseek"]
    cfg = get_config(r["arch"])
    B, S = r["batch"], r["prompt"]
    model, t_init = sync_time(lambda: init_params(cfg, seed=0))
    n_moe = cfg.n_layers - cfg.first_dense_layers
    expert_bytes = sum(model_bytes(lp["moe"]) - lp["moe"]["router"].numel()
                       * lp["moe"]["router"].element_size()
                       for lp in model.layers)
    log(f"{cfg.name}: {cfg.n_layers} layers ({cfg.first_dense_layers} dense "
        f"of d_ff {cfg.d_ff}, {n_moe} MoE of {cfg.n_experts} experts top-"
        f"{cfg.n_experts_active} and {cfg.n_shared_experts} shared of "
        f"{cfg.moe_d_ff}), d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{model_bytes(model)} bytes on the card ({expert_bytes} of them "
        f"expert weights), init_params(seed=0) {t_init:.2f} s; capacity at "
        f"{B * S} tokens {moe.capacity(B * S, cfg)}")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    batch = {"tokens": tokens}
    # the routing of the counted run: each MoE layer's aux loss and kept
    # assignments, and the first MoE layer's input
    routed = []

    @contextlib.contextmanager
    def spied():
        real = (moe.route, moe.dispatch)

        def route(xf, router, c):
            # one group of the batch's tokens (D = 1): [1, T, d]
            out = real[0](xf, router, c)
            routed.append({"aux": moe.aux_loss(out[2], out[3],
                                               xf.shape[0] * xf.shape[1], c),
                           "x": None if routed else xf[0]})
            return out

        def dispatch(*args):
            buf, plan = real[1](*args)
            routed[-1]["kept"] = plan.keep.sum()
            return buf, plan

        moe.route, moe.dispatch = route, dispatch
        try:
            yield
        finally:
            moe.route, moe.dispatch = real

    logits, cache, t_pre, peak, k4_in, prefill_step = prefill_run(
        cfg.name, cfg, model, batch, r["max_seq"], cfg.n_layers, spied)
    if len(routed) != n_moe:
        raise AssertionError(f"{len(routed)} MoE layers routed, expected "
                             f"{n_moe}")
    TK = B * S * cfg.n_experts_active
    drops = [TK - int(x["kept"]) for x in routed]
    auxes = [float(x["aux"]) for x in routed]
    log(f"{cfg.name} prefill routing: {TK} assignments a layer; dropped for "
        f"capacity a layer {drops} (total {sum(drops)}, "
        f"{100 * sum(drops) / (TK * n_moe):.3f} %); aux a layer "
        + ", ".join(f"{a:.5f}" for a in auxes) + f"; summed {sum(auxes):.5f}")
    kv = sum(t.numel() * t.element_size() for g in cache.values()
             for k, t in g.items() if k in ("k", "v"))
    read = model_bytes(model) - model.embed.numel() * \
        model.embed.element_size() + kv
    logits, step_ms, first_ms, toks = decode_run(
        cfg.name, model, cfg, cache, logits.argmax(-1), S, r["decode"])
    log(f"{cfg.name} decode: {r['decode']} greedy steps from position {S}, "
        f"{step_ms:.3f} ms a step after the first ({first_ms:.3f} ms), "
        f"{B / step_ms * 1e3:.1f} tokens/s; bound {read} bytes a step (every"
        f" weight but the embedding, {expert_bytes} of them experts the "
        f"dense dispatch reads, and the k/v cache) = "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms; no K4 launch; row 0's "
        f"tokens {toks[0].tolist()}")
    del cache
    rows = device_share(lambda: prefill_step(model, batch))
    k4_dev = sum(us for us, _, key in rows if "flash_fwd" in key) / 1e3 \
        if rows else None
    log(f"{cfg.name} prefill: K4 device time under the profiler {k4_dev} ms")
    xf = routed[0]["x"]
    lp = model.layers[0]
    moe_layer_split(cfg, lp, xf)
    moe_layer_on_cpu(cfg, lp, xf[:r["layer_tokens"]])
    del routed, xf
    serve_engine(cfg, model, fa, ssd)
    figs = k4_path(f"{cfg.name}'s prefill", *k4_in, cfg.n_layers)
    figs.update(device_ms=k4_dev, prefill_s=t_pre, peak_bytes=peak,
                decode_ms=step_ms, dropped=sum(drops), aux=sum(auxes))
    del model, k4_in
    torch.cuda.empty_cache()
    return figs


def whisper_full() -> dict:
    """whisper-small as published (12 encoder and 12 decoder layers, bf16
    random weights) on 4 x 1500 frame embeddings and a 4 x 64-token
    prompt: 24 K4 launches (12 non-causal at S 1500, 12 causal), then 32
    greedy decode steps through cross-attention on the cached encoder
    output, which stays as it was."""
    from repro_torch.configs import get_config
    from repro_torch.nn import init_params

    r = REST["whisper"]
    cfg = get_config(r["arch"])
    B = r["batch"]
    model, t_init = sync_time(lambda: init_params(cfg, seed=0))
    log(f"{cfg.name}: {cfg.encoder_layers} encoder + {cfg.n_layers} decoder "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, {cfg.encoder_seq} frames; "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"init_params(seed=0) {t_init:.2f} s")
    inputs = prompt_inputs(cfg, B, r["prompt"], 0)
    batch = {"tokens": torch.from_numpy(inputs["tokens"]).cuda(),
             "frames": torch.from_numpy(inputs["enc_frames"]).cuda()}
    logits, cache, t_pre, peak, k4_in, _ = prefill_run(
        cfg.name, cfg, model, batch, r["max_seq"],
        cfg.n_layers + cfg.encoder_layers)
    full = [a for a, kw in k4_in[1] if not kw.get("causal", True)]
    if len(full) != cfg.encoder_layers or any(
            a[0].shape[1] != cfg.encoder_seq for a in full):
        raise AssertionError(f"whisper: {len(full)} non-causal K4 calls at "
                             f"{[tuple(a[0].shape) for a in full]}")
    enc = cache["layers"]["enc_out"].clone()
    logits, step_ms, first_ms, toks = decode_run(
        cfg.name, model, cfg, cache, logits.argmax(-1), r["prompt"],
        r["decode"])
    if not torch.equal(cache["layers"]["enc_out"], enc):
        raise AssertionError("whisper decode changed the cached encoder "
                             "output")
    log(f"{cfg.name} decode: {r['decode']} greedy steps through "
        f"cross-attention onto {cfg.encoder_seq} encoder positions, "
        f"{step_ms:.3f} ms a step after the first ({first_ms:.3f} ms); "
        f"enc_out unchanged; row 0's tokens {toks[0].tolist()}")
    figs = k4_path(f"{cfg.name}'s prefill", *k4_in,
                   cfg.n_layers + cfg.encoder_layers)
    figs.update(prefill_s=t_pre, peak_bytes=peak, decode_ms=step_ms)
    del model, cache, enc, k4_in
    torch.cuda.empty_cache()
    return figs


def qwen2_vl_cut() -> dict:
    """qwen2-vl-72b at full width cut to 4 of its 80 layers, bf16 random
    weights: prefill from 2 x 2048 patch embeddings through
    ``frontend_proj`` (4 K4 launches at rep 8), ``forward_logits`` with
    3-D positions of an image grid (t, h and w differ), held to its
    (t, t, t) run's last row against prefill's, and 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.nn import forward_logits, init_params

    r = REST["qwen2_vl"]
    cfg = dataclasses.replace(get_config(r["arch"]), n_layers=r["layers"])
    B, S = r["batch"], r["prompt"]
    model, t_init = sync_time(lambda: init_params(cfg, seed=0))
    log(f"{cfg.name} cut to {cfg.n_layers} layers: d_model {cfg.d_model}, "
        f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{model_bytes(model)} bytes, init_params(seed=0) {t_init:.2f} s")
    embeds = torch.from_numpy(prompt_inputs(cfg, B, S, 0)["embeds"]).cuda()
    logits, cache, t_pre, peak, k4_in, _ = prefill_run(
        cfg.name, cfg, model, {"embeds": embeds}, r["max_seq"], cfg.n_layers)
    i = torch.arange(S, device=embeds.device)
    grid = torch.stack([i // 1024, (i // 32) % 32, i % 32], -1)
    (full, _), t_fwd, launches, _ = k4_counted(lambda: forward_logits(
        model, cfg, embeds=embeds, positions=grid.expand(B, S, 3)))
    text, _ = forward_logits(model, cfg, embeds=embeds)
    check_finite(f"{cfg.name} forward_logits", full)
    last = rel_l2(text[:, -1].double().cpu(), logits.double().cpu())
    moved = rel_l2(full[:, -1].double().cpu(), text[:, -1].double().cpu())
    if launches["flash_attention"] != cfg.n_layers or not last <= 1e-2 \
            or not moved > 1e-2:
        raise AssertionError(f"{cfg.name} forward_logits: K4 {launches}, "
                             f"(t, t, t) last row vs prefill {last}, grid "
                             f"positions vs (t, t, t) {moved}")
    del full, text
    logits, step_ms, first_ms, toks = decode_run(
        cfg.name, model, cfg, cache, logits.argmax(-1), S, r["decode"])
    log(f"{cfg.name} forward_logits with image-grid positions (t, h, w "
        f"differ) {t_fwd:.3f} s, {launches['flash_attention']} K4 launches;"
        f" the (t, t, t) run's last row within {last:.3g} relative L2 of "
        f"prefill's (bf16), the grid's {moved:.3g} from it; decode "
        f"{r['decode']} steps {step_ms:.3f} ms a step after the first "
        f"({first_ms:.3f} ms)")
    figs = k4_path(f"{cfg.name}'s prefill (4 layers)", *k4_in, cfg.n_layers)
    figs.update(prefill_s=t_pre, peak_bytes=peak, decode_ms=step_ms)
    del model, cache, embeds, k4_in
    torch.cuda.empty_cache()
    return figs


def kv_quant_full() -> dict:
    """llama3.2-3b at full width with the int8 KV cache: prefill of
    4 x 2048 tokens (28 K4 launches), then 32 decode steps on the int8
    cache beside the same steps on the bf16 cache of the same model (both
    fed the bf16 run's greedy tokens): the cache half the bytes (the
    scales on top), every step's logits within KV_QUANT_REL of the bf16
    run's relative to their largest."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import init_params

    r = REST["kv_quant"]
    cfg_b = get_config(r["arch"])
    cfg = dataclasses.replace(cfg_b, kv_quant=True)
    B, S = r["batch"], r["prompt"]
    model = init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    logits, cache, t_pre, peak, k4_in, _ = prefill_run(
        f"{cfg.name} kv_quant", cfg, model, {"tokens": tokens},
        r["max_seq"], cfg.n_layers)
    logits_b, cache_b = make_prefill_step(cfg_b, max_seq=r["max_seq"])(
        model, {"tokens": tokens})
    qb, bb = cache_bytes(cache), cache_bytes(cache_b)
    kv_q = sum(cache["layers"][k].numel() for k in ("k", "v"))
    if 2 * kv_q != bb or qb != kv_q + 4 * sum(
            cache["layers"][k].numel() for k in ("k_scale", "v_scale")):
        raise AssertionError(f"int8 cache {qb} bytes against bf16 {bb}")
    step, step_b = make_serve_step(cfg), make_serve_step(cfg_b)
    rels, walls = [rel_max(logits, logits_b)], []
    tok = logits_b.argmax(-1)
    for i in range(r["decode"]):
        (logits, cache), w = sync_time(
            lambda: step(model, cache, tok, S + i))
        walls.append(w)
        logits_b, cache_b = step_b(model, cache_b, tok, S + i)
        rels.append(rel_max(logits, logits_b))
        tok = logits_b.argmax(-1)
    check_finite(f"{cfg.name} kv_quant decode", logits, cache)
    if not max(rels) < KV_QUANT_REL:
        raise AssertionError(f"int8 cache logits off the bf16 cache's by "
                             f"{rels}")
    step_ms = 1e3 * sum(walls[1:]) / (len(walls) - 1)
    log(f"{cfg.name} kv_quant: cache {qb} bytes against the bf16 cache's "
        f"{bb} ({qb / bb:.4f}; k/v exactly half, float32 scales on top); "
        f"prefill and {r['decode']} decode steps on the int8 cache, logits "
        f"within {max(rels):.4f} of the bf16 cache's (largest gap over "
        f"largest logit; limit {KV_QUANT_REL}); decode {step_ms:.3f} ms a "
        f"step after the first")
    figs = k4_path(f"{cfg.name} kv_quant's prefill", *k4_in, cfg.n_layers)
    figs.update(prefill_s=t_pre, peak_bytes=peak, decode_ms=step_ms,
                cache_ratio=qb / bb, worst_rel=max(rels))
    del model, cache, cache_b, k4_in
    torch.cuda.empty_cache()
    return figs


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| in float32, 0 where a equals b (both may be
    0: K5's cumA gradient at q 1)."""
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    return err / float(b.abs().max()) if err else 0.0


def rest_of_nn() -> dict:
    """Phase 15: the families of ``nn/`` beyond hymba at full width; K4's
    figures on each path, keyed by config."""
    return {"deepseek-moe-16b": deepseek_full(),
            "whisper-small": whisper_full(),
            "qwen2-vl-72b (4 layers)": qwen2_vl_cut(),
            "llama3.2-3b kv_quant": kv_quant_full()}


# -- phase 16: training ----------------------------------------------------------

# hymba-1.5b as published trains on 2 x 4096 tokens: train_4k's sequence
# length, its global batch of 256 cut to 2 for one card; a fixed batch
# repeated, one warm-up step, then 8 timed ones
TRAIN = {"arch": "hymba-1.5b", "batch": 2, "seq": 4096, "steps": 8,
         "opt": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 100},
         "cut_batch": 2, "cut_seq": 256,
         "resume": {"arch": "tinyllama-1.1b", "batch": 4, "seq": 64,
                    "steps": 6, "crash": 3}}
# K4's and K5's Functions (the launch forward; K4's backward kernels for
# bf16, the torch-op backwards otherwise) against torch.autograd of their
# plain versions on the same card: each gradient's largest error over its
# largest entry.  float32: the forwards agree to K4_TOL / K5_TOL and the
# backwards run the same float32 ops in another order.  bf16 (K4): the
# kernels round P and dS to bf16 before their products, both sides round
# each gradient to bf16 (2^-8 of an entry), and the backward's
# rowsum(dO * O) reads K4's bf16 output, whose P was rounded to bf16 (the
# forward's bound, BF16_P_TOL): 2^-6 of the largest gradient entry
# (tests/test_torch_attn_bwd.py holds the same bound on the card).
GRAD_F32_REL = 1e-4
GRAD_BF16_REL = 2.0 ** -6
# the training path on cuda against cpu, float32: the loss within rtol 1e-5
# and every gradient leaf within 1e-4 relative L2 plus 1e-6 (the CPU tests'
# bounds against the reference)
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6
# K4 at hymba-1.5b's training shape (B, S, H, KH, D) and K5 at it (batch x
# chunks, heads, q, n, p); K4 at deepseek-moe-16b's heads (16 of 128, one
# a kv head) over the same rows
TRAIN_K4 = (2, 4096, 25, 5, 64)
TRAIN_K4_D128 = (2, 4096, 16, 16, 128)
TRAIN_K5 = (64, 50, 128, 16, 64)


def function_grads(fn, args, grad_out):
    """Gradients of ``fn(*args)`` at ``args`` (leaves made from them) for
    the output gradients ``grad_out``; the output(s) too."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return outs, torch.autograd.grad(outs, leaves, grad_out)


def k4_grad_errs(fa, ops, q, k, v, causal, worst) -> float:
    """K4's Function against autograd of its plain version on one input:
    the forward to K4's own bound (``k4_err``), each gradient to
    GRAD_F32_REL / GRAD_BF16_REL of its largest entry; ``worst`` keeps the
    largest error of each gradient.  Returns the forward's error."""
    gen = torch.Generator(device=q.device).manual_seed(q.shape[1])
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    (got,), g = function_grads(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal),
        (q, k, v), (dout,))
    (_,), w = function_grads(
        lambda a, b, c: fa.flash_attention_plain(a, b, c, causal),
        (q, k, v), (dout,))
    with torch.no_grad():
        err = k4_err(fa, q, k, v, causal)
    bound = GRAD_BF16_REL if q.dtype == torch.bfloat16 else GRAD_F32_REL
    for name, a, b in zip(("dq", "dk", "dv"), g, w):
        e = rel_max(a, b)
        if a.dtype != q.dtype or a.shape != b.shape or not e <= bound \
                or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"K4 backward {name} off by {e} of its "
                                 f"largest entry (limit {bound}; q "
                                 f"{tuple(q.shape)}, {q.dtype}, causal "
                                 f"{causal})")
        key = (str(q.dtype)[6:], name)
        worst[key] = max(worst.get(key, 0.0), e)
    return err


def k5_grad_errs(ssd, ops, dtx, Bm, Cm, cumA, worst) -> None:
    """K5's Function against autograd of its plain version on one input,
    the inputs as ``nn.ssm`` passes them (B and C expanded over the heads
    with stride 0): each gradient to GRAD_F32_REL of its largest entry."""
    G = dtx.shape[0] * dtx.shape[1]
    q, p, n = dtx.shape[2], dtx.shape[3], Bm.shape[-1]
    gen = torch.Generator(device=dtx.device).manual_seed(q)
    gy = torch.randn(G, q, p, generator=gen, device=dtx.device)
    gs = torch.randn(G, n, p, generator=gen, device=dtx.device)
    # B and C as leaves [G1, 1, q, n], expanded inside
    base = (dtx, Bm[:, :1], Cm[:, :1], cumA)
    h = dtx.shape[1]

    def run(f):
        def call(d, b, c, a):
            return f(d, b.expand(-1, h, -1, -1), c.expand(-1, h, -1, -1), a)
        return function_grads(call, base, (gy, gs))[1]

    g, w = run(ops.ssd_intra_chunk), run(ssd.ssd_intra_chunk_plain)
    with torch.no_grad():
        k5_err(ssd, dtx, Bm, Cm, cumA)
    for name, a, b in zip(("d dtx", "dB", "dC", "d cumA"), g, w):
        e = rel_max(a, b)
        if a.shape != b.shape or not e <= GRAD_F32_REL \
                or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"K5 backward {name} off by {e} of its "
                                 f"largest entry (limit {GRAD_F32_REL}; "
                                 f"dtx {tuple(dtx.shape)})")
        worst[name] = max(worst.get(name, 0.0), e)


def backward_parity() -> None:
    """(a) K4's and K5's Functions on the card against ``torch.autograd``
    of their plain versions: K4 on ragged float32 and bf16 shapes (D 64
    and 128, rep 1 and 5, causal and full, S 63 and 200) and at
    hymba-1.5b's training shape in bf16 (``[2, 4096, 25, 64]``, 5 kv
    heads, causal); K5 on ragged q (1, 24, 100, 128) with B and C expanded
    over 5 heads and at hymba-1.5b's training shape (64 (batch, chunk)
    pairs, 50 heads, q 128, n 16, p 64)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd

    gen = torch.Generator(device="cuda").manual_seed(16)
    worst4, worst5, n4, n5 = {}, {}, 0, 0
    fa.reset_launches()
    ssd.reset_launches()
    for D in (64, 128):
        for rep in (1, 5):
            for causal in (True, False):
                for S in (63, 200):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v = (torch.randn(2, S, h, D, generator=gen,
                                               device="cuda").to(dtype)
                                   for h in (2 * rep, 2, 2))
                        k4_grad_errs(fa, ops, q, k, v, causal, worst4)
                        n4 += 1
    B, S, H, KH, D = TRAIN_K4
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
               .bfloat16() for h in (H, KH, KH))
    full4 = dict(worst4)
    worst_full4 = {}
    err = k4_grad_errs(fa, ops, q, k, v, True, worst_full4)
    n4 += 1
    del q, k, v
    for q_len in (1, 24, 100, 128):
        k5_grad_errs(ssd, ops, *k5_inputs(gen, 6, 5, q_len, 16, 64), worst5)
        n5 += 1
    worst_full5 = {}
    k5_grad_errs(ssd, ops, *k5_inputs(gen, *TRAIN_K5), worst_full5)
    n5 += 1
    torch.cuda.synchronize()
    # each Function launched its kernel once a case, the checks once more;
    # every bf16 case's backward ran on K4's backward kernels (16 ragged
    # cases and the training shape), no float32 one did
    launches = (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_intra_chunk"],
                fa.LAUNCHES["flash_attention_bwd"])
    if launches != (2 * n4, 2 * n5, n4 // 2 + 1):
        raise AssertionError(f"backward parity launched K4/K5/K4's backward "
                             f"{launches} times, expected "
                             f"{(2 * n4, 2 * n5, n4 // 2 + 1)}")
    torch.cuda.empty_cache()
    log(f"training (a) backward parity on the card: K4 {n4} cases (D 64/128, "
        f"rep 1/5, causal and full, S 63/200, float32 on the torch-op "
        f"backward and bf16 on the backward kernels, {launches[2]} calls; hymba's "
        f"training shape (B, S, H, KH, D) {TRAIN_K4} bf16 causal), worst gradient error"
        f" over its largest entry " + ", ".join(
            f"{t} {g} {e:.3g}" for (t, g), e in sorted(full4.items()))
        + f"; at the training shape " + ", ".join(
            f"{g} {e:.3g}" for (_, g), e in sorted(worst_full4.items()))
        + f" (forward max abs err {err:.3g}; limits float32 {GRAD_F32_REL},"
        f" bf16 {GRAD_BF16_REL}); K5 {n5} cases (q 1/24/100/128, n 16, p 64,"
        f" B and C expanded over 5 heads; hymba's training shape (batch x "
        f"chunks, heads, q, n, p) {TRAIN_K5}): " + ", ".join(
            f"{g} {e:.3g}" for g, e in sorted(worst5.items()))
        + "; at the training shape " + ", ".join(
            f"{g} {e:.3g}" for g, e in sorted(worst_full5.items()))
        + f" (limit {GRAD_F32_REL})")


def training_batch(cfg, batch: int, seq: int) -> dict:
    """``SyntheticTokens``' batch 0 for ``cfg``'s family (numpy)."""
    from repro_torch.data import SyntheticTokens

    return SyntheticTokens(cfg.vocab_size, batch=batch, seq_len=seq,
                           family=cfg.family, d_model=cfg.d_model,
                           encoder_seq=cfg.encoder_seq).batch_at(0)


def loss_and_grads(model, cfg, batch, device):
    """(loss, {name: gradient on the host}) of ``lm_loss``."""
    from repro_torch.nn import lm_loss

    loss, _ = lm_loss(model.trainable(), cfg, batch, device=device)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return float(loss.detach()), {n: (torch.zeros_like(p) if g is None else g)
                         .double().cpu() for (n, p), g in
                         zip(named.items(), grads)}


def expected_launches(cfg) -> tuple:
    """K4's and K5's launches in one ``lm_loss`` forward and backward with
    ``remat``: each checkpointed decoder layer launches in the forward and
    again in its recompute, a leading dense layer and an encoder layer
    once."""
    kinds = cfg.layer_kinds
    k4 = (2 * sum(k != "ssm" for k in kinds) + cfg.first_dense_layers
          + cfg.encoder_layers)
    k5 = 2 * sum(k in ("ssm", "hybrid") for k in kinds)
    return k4, k5


def cut_models() -> None:
    """(b) every smoke config and hymba-1.5b at full width cut to 2
    layers, float32, 2 x 256 tokens of ``SyntheticTokens``: ``lm_loss``
    and every gradient leaf on cuda held to cpu (K4 and K5 launched as
    ``expected_launches`` says on cuda), then one ``make_train_step`` with
    ``microbatches=2`` held to one with ``microbatches=1`` on cuda (not for
    MoE, whose capacity is per slice in the reference too)."""
    from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.kernels import ssm_mixer as fused
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn import init_params, params_from_numpy, params_to_numpy
    from repro_torch.train.optim import AdamWConfig, init_opt_state

    ocfg = AdamWConfig(warmup_steps=1, total_steps=10)
    for arch, label, cfg in (
            *((a, "smoke config", get_smoke_config(a)) for a in ALL_IDS),
            (TRAIN["arch"], "full width cut to 2 layers", dataclasses.replace(
                get_config(TRAIN["arch"]), n_layers=2))):
        tree = params_to_numpy(init_params(cfg, seed=0, device="cpu"))
        batch = training_batch(cfg, TRAIN["cut_batch"], TRAIN["cut_seq"])
        gpu = params_from_numpy(tree, cfg, dtype=torch.float32)
        cpu = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
        fa.reset_launches()
        ssd.reset_launches()
        fused.reset_launches()
        (l_g, g_g), t_gpu = sync_time(lambda: loss_and_grads(gpu, cfg, batch,
                                                             None))
        launches = (fa.LAUNCHES["flash_attention"],
                    ssd.LAUNCHES["ssd_intra_chunk"])
        if launches != expected_launches(cfg):
            raise AssertionError(f"training {arch} ({label}): K4/K5 launched"
                                 f" {launches}, expected "
                                 f"{expected_launches(cfg)}")
        # the mixer's kernels beside K5: forward and recompute
        if set(fused.LAUNCHES.values()) != {launches[1]}:
            raise AssertionError(f"training {arch} ({label}): the mixer's "
                                 f"kernels launched {fused.LAUNCHES}, "
                                 f"expected {launches[1]} each")
        t = time.perf_counter()
        l_c, g_c = loss_and_grads(cpu, cfg, batch, "cpu")
        t_cpu = time.perf_counter() - t
        if not abs(l_g - l_c) <= LOSS_RTOL * abs(l_c) or not np.isfinite(l_g):
            raise AssertionError(f"training {arch} ({label}): loss cuda "
                                 f"{l_g} vs cpu {l_c}")
        worst = 0.0
        for name, w in g_c.items():
            err = float(torch.linalg.norm(g_g[name] - w))
            scale = float(torch.linalg.norm(w))
            if not err <= LEAF_RTOL * scale + LEAF_ATOL:
                raise AssertionError(f"training {arch} ({label}): gradient "
                                     f"{name} cuda vs cpu |diff| {err}, "
                                     f"|want| {scale}")
            worst = max(worst, err / max(scale, LEAF_ATOL / LEAF_RTOL))
        line = (f"training (b) {arch} {label} ({cfg.n_layers} layers, d_model"
                f" {cfg.d_model}, {cfg.family}), float32, "
                f"{TRAIN['cut_batch']} x {TRAIN['cut_seq']} tokens: loss cuda "
                f"{l_g:.6f} cpu {l_c:.6f}, worst leaf relative L2 {worst:.3g}"
                f" (limit {LEAF_RTOL} + {LEAF_ATOL}); K4/K5 launches "
                f"{launches}; cuda {t_gpu:.3f} s, cpu {t_cpu:.3f} s")
        del cpu, g_c, g_g
        if not cfg.n_experts:
            models = [params_from_numpy(tree, cfg, dtype=torch.float32)
                      for _ in range(2)]
            outs = []
            for mb, model in zip((1, 2), models):
                step = make_train_step(cfg, ocfg, microbatches=mb)
                _, state, met = step(model, init_opt_state(model), batch)
                outs.append({k: float(v) for k, v in met.items()})
            lr = outs[0]["lr"]
            for k in ("loss", "grad_norm"):
                if not abs(outs[1][k] - outs[0][k]) <= 1e-4 * abs(outs[0][k]):
                    raise AssertionError(f"training {arch}: microbatches 2 "
                                         f"{k} {outs[1][k]} vs 1 "
                                         f"{outs[0][k]}")
            # at step 1 AdamW moves an element by lr times the sign of its
            # gradient, which a rounding flips for a near-zero gradient
            diff = max(float(((a - b).abs() - 1e-5 * b.abs()).max())
                       for a, b in zip(models[1].parameters(),
                                       models[0].parameters()))
            if not diff <= 2 * lr:
                raise AssertionError(f"training {arch}: microbatches 2 vs 1 "
                                     f"parameters apart by {diff} (limit "
                                     f"2 lr = {2 * lr})")
            line += (f"; train step microbatches 2 vs 1: loss "
                     f"{outs[1]['loss']:.6f} / {outs[0]['loss']:.6f}, grad "
                     f"norm {outs[1]['grad_norm']:.5g} / "
                     f"{outs[0]['grad_norm']:.5g}, parameters within 2 lr")
            del models
        log(line)
        del gpu
    torch.cuda.empty_cache()


def resume_bitwise() -> None:
    """(c) tinyllama-1.1b's smoke config through the port's ``Trainer`` on
    the card under ``torch.use_deterministic_algorithms(True)``: 6 steps
    straight, and 3 steps, a crash, then 3 resumed from the checkpoint;
    the parameters equal bit for bit."""
    import os
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer

    r = TRAIN["resume"]
    cfg = get_smoke_config(r["arch"])
    data = SyntheticTokens(cfg.vocab_size, batch=r["batch"],
                           seq_len=r["seq"])

    def train(steps, ckpt_dir):
        t = Trainer(cfg, TrainConfig(steps=steps, ckpt_every=r["crash"],
                                     ckpt_dir=ckpt_dir, log_every=1),
                    AdamWConfig(warmup_steps=2, total_steps=10))
        return t.run(data)

    # cuBLAS is deterministic on one stream; torch asks for this setting
    # before it lets a product run under deterministic algorithms
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            full, t_full = sync_time(lambda: train(r["steps"], f"{d}/a"))
            train(r["crash"], f"{d}/b")
            resumed, t_res = sync_time(lambda: train(r["steps"], f"{d}/b"))
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    diff = [n for (n, a), (_, b) in zip(full["params"].named_parameters(),
                                        resumed["params"].named_parameters())
            if not torch.equal(a, b)]
    if diff or [h["step"] for h in resumed["history"]] != list(
            range(r["crash"], r["steps"])):
        raise AssertionError(f"crash-resume on the card: parameters differ "
                             f"in {diff}; resumed steps "
                             f"{[h['step'] for h in resumed['history']]}")
    log(f"training (c) crash-resume on the card, deterministic algorithms: "
        f"{r['arch']} smoke config, {r['batch']} x {r['seq']} tokens, "
        f"{r['steps']} steps straight ({t_full:.3f} s) equal 3 + crash + 3 "
        f"resumed ({t_res:.3f} s) bit for bit in all "
        f"{sum(1 for _ in full['params'].parameters())} parameter leaves; "
        f"losses {[round(h['loss'], 6) for h in full['history']]}")


def train_split_ms(model, cfg, opt_state, batch, ocfg) -> dict:
    """One training step split by CUDA events: ``lm_loss``'s forward, the
    backward (``torch.autograd.grad``, the layers' recompute in it) and
    the AdamW update, in ms."""
    from repro_torch.nn import lm_loss
    from repro_torch.train.optim import adamw_update

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss, _ = lm_loss(model, cfg, batch)
    ev[1].record()
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    ev[2].record()
    adamw_update(model, grads, opt_state, ocfg)
    ev[3].record()
    torch.cuda.synchronize()
    return {k: ev[i].elapsed_time(ev[i + 1])
            for i, k in enumerate(("forward", "backward", "optimizer"))}


def k4_train_figures(fa, q, k, v) -> dict:
    """At one training call's shape: K4's forward launch, its backward
    (the kernels, for bf16), and SDPA's forward and forward + backward
    (with ``enable_gqa``), CUDA-event ms."""
    import torch.nn.functional as F

    gen = torch.Generator(device=q.device).manual_seed(0)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    out = fa._flash_attention_cuda(q, k, v, True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qt, kt, vt), dt)

    with torch.no_grad():
        fwd = cuda_ms(lambda: fa._flash_attention_cuda(q, k, v, True), 5)
        bwd = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, out, dout,
                                                          True), 3)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5)
    return {"k4_fwd_ms": fwd, "k4_bwd_ms": bwd, "sdpa_fwd_ms": sdpa,
            "sdpa_fwd_bwd_ms": cuda_ms(sdpa_fwd_bwd, 3)}


def k4_bwd_figures(fa, q, k, v, causal=True) -> dict:
    """One K4 backward at ``q``, ``k``, ``v``'s shape, CUDA-event ms: the
    wrapper (``flash_attention_backward``: the kernels for bf16), the
    launch alone (the C entry, its two kernels, on buffers allocated
    once), the plain version, and SDPA's backward with ``enable_gqa``
    (``autograd.grad`` on one retained graph), the library yardstick;
    beside the bound of ``bench/counts``' ``attention_bwd``: four
    products, twice the forward's flops, at 989 TFLOP/s against q, k, v,
    o and dO read and dq, dk, dv written once at 3.35 TB/s."""
    import torch.nn.functional as F

    B, S, H, D = q.shape
    KH = k.shape[2]
    gen = torch.Generator(device=q.device).manual_seed(1)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    out = fa._flash_attention_cuda(q, k, v, causal)
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2 * B * H * pairs * 4 * D
    moved = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
    Sp = -(-S // 64) * 64
    bufs = [torch.empty_like(t) for t in (q, k, v)] + [
        torch.empty(B, H, Sp, device=q.device),
        torch.empty(B, H, Sp, device=q.device)]
    fn = fa.kernel("flash_attention_bwd", "flash_attention_bwd",
                   fa._BWD_ARGTYPES)
    args = [t.data_ptr() for t in (q, k, v, out, dout, *bufs)] + [
        B, S, H, KH, D, int(causal), 1.0 / D ** 0.5]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)
    dt = dout.transpose(1, 2)
    with torch.no_grad():
        figs = dict(
            ms=cuda_ms(lambda: fa.flash_attention_backward(
                q, k, v, out, dout, causal), 5),
            kernel_ms=cuda_ms(lambda: fa.launch(fn, q.device, *args), 5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_backward_plain(
                q, k, v, out, dout, causal), 2))
    figs.update(
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dt, retain_graph=True), 5),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=[B, S, H, KH, D])
    return figs


def k5_train_figures(ssd, dtx, Bm, Cm, cumA) -> dict:
    """At one training call's shape: K5's forward launch and its torch-op
    backward, CUDA-event ms."""
    G1, h, q, p = dtx.shape
    n = Bm.shape[-1]
    gen = torch.Generator(device=dtx.device).manual_seed(0)
    gy = torch.randn(G1 * h, q, p, generator=gen, device=dtx.device)
    gs = torch.randn(G1 * h, n, p, generator=gen, device=dtx.device)
    with torch.no_grad():
        fwd = cuda_ms(lambda: ssd._ssd_intra_chunk_cuda(
            dtx, Bm, Cm, cumA, G1 * h, h, q, n, p), 5)
        bwd = cuda_ms(lambda: ssd.ssd_intra_chunk_backward(
            dtx, Bm, Cm, cumA, gy, gs), 3)
    return {"k5_fwd_ms": fwd, "k5_bwd_ms": bwd}


def hymba_training() -> dict:
    """(d) hymba-1.5b as published (32 layers, d_model 1600, 1,640,144,000
    parameters; 1,640,872,320 tensor elements) in bf16 with float32 AdamW moments, ``init_params(seed=0)``,
    ``make_train_step`` with ``remat``, on one fixed ``SyntheticTokens``
    batch of 2 x 4096 tokens: a warm-up step, then 8 timed steps with K4's
    and K5's counts set to 0 just before (each launched forward and in the
    recompute, 2 x 32 a step); one step split into forward, backward and
    optimizer; one step with every K4 and K5 input captured and held to
    the plain versions; K4 and K5 forward beside their backwards and SDPA;
    K4's backward kernels beside their plain version, SDPA's backward and
    their bound at hymba's shape and at ``TRAIN_K4_D128``; one profiled
    step.  Returns the ``train`` figures of K4's and
    K5's rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.kernels import ssm_mixer as fused
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn import init_params
    from repro_torch.train.optim import AdamWConfig, init_opt_state

    cfg = get_config(TRAIN["arch"])
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    model, t_init = sync_time(lambda: init_params(cfg, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    opt_state = init_opt_state(model)
    ocfg = AdamWConfig(**TRAIN["opt"])
    step_fn = make_train_step(cfg, ocfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             training_batch(cfg, B, S).items()}
    tokens = B * S
    _, t_warm = sync_time(lambda: step_fn(model, opt_state, batch))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ssd.reset_launches()
    fused.reset_launches()
    walls, mets = [], []
    for _ in range(steps):
        (_, opt_state, met), w = sync_time(
            lambda: step_fn(model, opt_state, batch))
        walls.append(w)
        mets.append(met)
    peak = torch.cuda.max_memory_allocated()
    launches = {**fa.LAUNCHES, **ssd.LAUNCHES, **fused.LAUNCHES}
    want = steps * 2 * cfg.n_layers
    if launches["flash_attention"] != want or launches[
            "ssd_intra_chunk"] != want or launches["flash_attention_tc"] \
            != want or launches["flash_attention_bwd"] != want // 2 \
            or launches["ssm_prologue"] != want \
            or launches["ssm_epilogue"] != want:
        raise AssertionError(f"hymba training launched {launches} in "
                             f"{steps} steps, expected {want} of K4 (all "
                             f"on the tensor cores), of K5 and of the "
                             f"mixer's prologue and epilogue, and "
                             f"{want // 2} of K4's backward")
    losses = [float(m["loss"]) for m in mets]
    norms = [float(m["grad_norm"]) for m in mets]
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"hymba training: losses {losses}, grad norms "
                             f"{norms}")
    med = float(np.median(walls))
    attn_flops = 6 * cfg.n_layers * cfg.n_heads * cfg.head_dim * S * tokens
    model_flops = 6 * n_params * tokens + attn_flops
    mfu = model_flops / med / BF16_FLOPS
    log(f"training (d) {cfg.name} as published: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_params()} parameters ({n_params} "
        f"with the norms and SSM scalars, the N of 6 N), bf16 weights with "
        f"float32 AdamW moments (lr {ocfg.lr}, warm-up {ocfg.warmup_steps}),"
        f" remat, init_params(seed=0) {t_init:.2f} s; {B} x {S} tokens a "
        f"step, warm-up step {t_warm:.3f} s; {steps} steps: wall median "
        f"{med:.4f} s (min {min(walls):.4f}, max {max(walls):.4f}), "
        f"{tokens / med:.0f} training tokens/s; model flops a step "
        f"{model_flops:.4g} (6 N tokens + causal attention "
        f"{attn_flops:.4g}), {100 * mfu:.2f} % of 989 TFLOP/s bf16; "
        f"max_memory_allocated {peak} bytes; K4/K5/mixer launches "
        f"{launches} ({want} each = {steps} steps x 2 x {cfg.n_layers}: "
        f"forward and recompute; K4's backward {want // 2}, one a layer); losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}")
    split = train_split_ms(model, cfg, opt_state, batch, ocfg)
    log(f"training (d) one step split by CUDA events: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items()))
    with spy_ops(("flash_attention", "ssd_intra_chunk")) as captured:
        fa.reset_launches()
        ssd.reset_launches()
        _, opt_state, _ = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        step_launches = {**fa.LAUNCHES, **ssd.LAUNCHES}
    out = {}
    for name, err_of, figs_of in (
            ("flash_attention",
             lambda a, kw: k4_err(fa, *a, kw.get("causal", True)),
             lambda a, kw: k4_call_figures(fa, *a, kw.get("causal", True))),
            ("ssd_intra_chunk", lambda a, kw: k5_err(ssd, *a),
             lambda a, kw: k5_call_figures(ssd, *a))):
        calls = captured[name]
        with torch.no_grad():
            errs = [err_of(a, kw) for a, kw in calls]
            figs = [figs_of(a, kw) for a, kw in calls]
        total = {k: sum(f[k] for f in figs) for k in figs[0]
                 if k not in ("bound_by",)}
        out[name] = dict(launches=launches[name], calls_a_step=len(calls),
                         step_launches=step_launches[name],
                         max_abs_err=max(errs), ms=total["ms"],
                         kernel_ms=total["kernel_ms"],
                         plain_ms=total["plain_ms"],
                         library_ms=total.get("library_ms"),
                         bound_ms=total["bound_ms"],
                         bound_by=figs[0]["bound_by"],
                         inputs=[list(t.shape) for t in calls[0][0]])
        log(f"training (d) {name}: {len(calls)} calls in one step (inputs "
            f"{out[name]['inputs']}), every one held to its plain version "
            f"(max abs err {max(errs):.3g}); summed wrapper {total['ms']:.3f}"
            f" ms, launch alone {total['kernel_ms']:.3f} ms, plain "
            f"{total['plain_ms']:.3f} ms, library "
            + (f"{total['library_ms']:.3f} ms" if "library_ms" in total
               else "none")
            + f", bound {total['bound_ms']:.3f} ms ({figs[0]['bound_by']})")
    a4, _ = captured["flash_attention"][0]
    a5, _ = captured["ssd_intra_chunk"][0]
    f4 = k4_train_figures(fa, *a4)
    f5 = k5_train_figures(ssd, *a5)
    b4 = [k4_bwd_figures(fa, *a4)]
    del captured
    gen = torch.Generator(device="cuda").manual_seed(33)
    B4, S4, H4, KH4, D4 = TRAIN_K4_D128
    b4.append(k4_bwd_figures(fa, *(
        torch.randn(B4, S4, h, D4, generator=gen, device="cuda").bfloat16()
        for h in (H4, KH4, KH4))))
    out["flash_attention"].update(f4, backward=b4)
    out["ssd_intra_chunk"].update(f5)
    for b in b4:
        log(f"training (d) K4's backward kernels at (B, S, H, KH, D) "
            f"{b['shape']} bf16 causal: wrapper {b['ms']:.3f} ms, launch "
            f"alone {b['kernel_ms']:.3f} ms, plain {b['plain_ms']:.3f} ms, "
            f"SDPA backward {b['library_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
    log(f"training (d) K4 at {list(a4[0].shape)} / {list(a4[1].shape)} bf16 "
        f"causal: forward launch {f4['k4_fwd_ms']:.3f} ms, backward kernels"
        f" {f4['k4_bwd_ms']:.3f} ms; SDPA forward {f4['sdpa_fwd_ms']:.3f} ms,"
        f" forward + backward {f4['sdpa_fwd_bwd_ms']:.3f} ms; K5 at "
        f"{list(a5[0].shape)}: forward launch {f5['k5_fwd_ms']:.3f} ms, "
        f"torch-op backward {f5['k5_bwd_ms']:.3f} ms")
    rows = device_share(lambda: step_fn(model, opt_state, batch))
    dev_ms = {name: sum(us for us, _, key in rows if tag in key) / 1e3
              if rows else None
              for name, tag in (("flash_attention", "flash_fwd"),
                                ("ssd_intra_chunk", "ssd_intra"))}
    for name in out:
        out[name].update(device_ms=dev_ms[name], step_median_s=med,
                         tokens_per_s=tokens / med, mfu=mfu,
                         peak_bytes=peak, split_ms=split)
    log(f"training (d) kernel device time in the profiled step {dev_ms} ms; "
        f"card {nvidia_smi('name,power.limit')}")
    del model, opt_state, batch
    torch.cuda.empty_cache()
    return out


def training() -> dict:
    """Phase 16: (a) backward parity, (b) cut models cuda against cpu,
    (c) crash-resume on the card, (d) hymba-1.5b training at full width;
    each model freed before the next.  Returns K4's and K5's ``train``
    figures."""
    backward_parity()
    cut_models()
    resume_bitwise()
    return hymba_training()


# -- phase 17: the dry run, the layout on the card, the elastic restore ----------

#: Phase 17's cells: the reference's three §Perf cells on the 16 x 16 pod
#: and the MoE cell on the 2 x 16 x 16 pod, then the train cells of hymba
#: and whisper, whose heads and vocab do not divide the model axis (the
#: layout deals their (row, head) items out over it instead), all traced
#: at full width as published.
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k", False),
                ("qwen2-vl-72b", "train_4k", False),
                ("qwen3-32b", "decode_32k", False),
                ("qwen3-moe-30b-a3b", "train_4k", True),
                ("hymba-1.5b", "train_4k", False),
                ("whisper-small", "train_4k", False))


def dryrun_cells(ks, clock_hz, card=None) -> dict:
    """Phase 17 (a): each of :data:`DRYRUN_CELLS` traced on a fake world
    of 256 or 512 ranks (``trace_collectives``), its collectives priced by
    ``price_step`` on the card (``card``, None = CUDA) with K1's count set
    to 0 just before and every K1 input captured and held to its plain
    version, and the same op list priced on the cpu: every
    ``CollectiveCost`` field and the step totals within rtol 1e-4 / atol
    1e-6.  Prints per cell the trace seconds, the count and per-rank bytes
    of each kind of collective, argument bytes per rank, FLOPs per rank
    against 6 (train) or 2 N_active tokens / ranks, and K1's launch and
    time.  A train cell must have collectives and FLOPs within the
    reference's bounds (0.3 for MoE, else 0.8, up to 6 times the model
    estimate).  Returns K1's ``dryrun`` figures."""
    from repro_torch.launch import dryrun

    launches = {"segment_reduce": 0, "queue_walk": 0}
    captured = {"segment_reduce": [], "queue_walk": []}
    traced, priced = 0.0, None
    for arch, shape, multi_pod in DRYRUN_CELLS:
        art, ops = dryrun.trace_collectives(arch, shape, multi_pod)
        traced += art["trace_s"]
        priced, t_price, n, cap, _ = counted_kernels(
            ks, lambda: dryrun.price_cell(art, ops, multi_pod, device=card))
        cpu = dryrun.price_cell(art, ops, multi_pod, device="cpu")
        if n["segment_reduce"] != 1:
            raise AssertionError(f"{arch} x {shape}: {n} launches pricing, "
                                 "want one K1")
        for key in launches:
            launches[key] += n[key]
            captured[key] += cap[key]
        got, ref = priced["comm_model"], cpu["comm_model"]
        for a, b in zip(got["ops"], ref["ops"]):
            if (a["kind"], a["count"]) != (b["kind"], b["count"]):
                raise AssertionError(f"dry-run op {a} against {b}")
            np.testing.assert_allclose(
                [a[k] for k in b if isinstance(b[k], float)],
                [b[k] for k in b if isinstance(b[k], float)],
                rtol=RTOL, atol=ATOL, err_msg=f"{arch} {a['kind']}")
        totals = ("naive_time", "transport", "queue", "contention",
                  "model_time", "total_wire_bytes", "total_msgs")
        np.testing.assert_allclose([got[k] for k in totals],
                                   [ref[k] for k in totals],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch} step totals")
        ranks = int(np.prod(art["mesh_shape"]))
        tokens = art["global_batch"] * (art["seq_len"] if art["kind"]
                                        != "decode" else 1)
        model = (6 if art["kind"] == "train" else 2) \
            * art["n_active_params"] * tokens / ranks
        flops = art["cost"]["flops_per_device"]
        log(f"dry run {arch} x {shape} x {art['mesh']} ({ranks} ranks, "
            f"{art['microbatches']} microbatches, one traced): trace "
            f"{art['trace_s']:.2f} s, pricing {1e3 * t_price:.2f} ms with "
            f"{n['segment_reduce']} K1 launch; argument bytes a rank "
            f"{art['memory']['argument_bytes']}; FLOPs a rank {flops:.6g} "
            f"= {flops / model:.4f} x the model estimate {model:.6g}; "
            f"bytes a rank (unfused) {art['cost']['bytes_per_device']:.6g}")
        for kind, c in sorted(art["collectives"].items()):
            log(f"  {kind:15s} {int(c['ops']):6d} ops, {c['bytes']:.6g} bytes "
                "a rank")
        if art["kind"] == "train":
            if not art["collectives"]:
                raise AssertionError(f"{arch} x {shape}: no collectives")
            lo = 0.3 if "moe" in arch else 0.8
            if not lo * model < flops < 6 * model:
                raise AssertionError(f"{arch} x {shape}: FLOPs a rank "
                                     f"{flops:.4g} outside ({lo}, 6) x "
                                     f"{model:.4g}")
    log(f"dry run: the {len(DRYRUN_CELLS)} cells traced in {traced:.2f} s")
    prof = device_share(lambda: dryrun.price_cell(art, ops, multi_pod,
                                                  device=card))
    out = kernel_sums(ks, "dry run", launches, captured, clock_hz, prof)
    out["segment_reduce"]["trace_s"] = traced
    return out


def layout_on_the_card() -> None:
    """Phase 17 (b) and (c), on a real world of one rank (NCCL) with a 1 x
    1 ``("data", "model")`` mesh on the card, opened after the fake worlds
    closed.  (b) hymba-1.5b at full width (bf16 random weights from
    ``init_params(seed=0)``), 4 seeded prompts of 2048 tokens through
    ``prefill`` without a layout, then its parameters laid out by
    ``param_pspecs`` and the same prefill under a ``ShardingContext``: the
    logits and every cache leaf bit-equal, K4 and K5 launched 32 times
    each in both (counts set to 0 just before each).  (c) deepseek-moe-
    16b's smoke config (leading dense layers, experts, FSDP layouts)
    written as a checkpoint and restored with ``shardings`` onto the mesh:
    every leaf bit-equal and every placement the one asked for."""
    import tempfile
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.kernels import ssm_mixer as fused
    from repro_torch.launch.mesh import make_mesh, one_rank_world
    from repro_torch.nn import model as M
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel import sharding

    cfg = configs.get_config(HYMBA["arch"])
    B, S, max_seq = HYMBA["batch"], HYMBA["prompt"], HYMBA["max_seq"]
    model = M.init_params(cfg, seed=0)
    tokens = torch.from_numpy(
        prompt_inputs(cfg, B, S, seed=17)["tokens"]).cuda()

    def counted(fn):
        fa.reset_launches()
        ssd.reset_launches()
        fused.reset_launches()
        out, wall = sync_time(fn)
        return out, wall, (fa.LAUNCHES["flash_attention"],
                           ssd.LAUNCHES["ssd_intra_chunk"],
                           fused.LAUNCHES["ssm_prologue"],
                           fused.LAUNCHES["ssm_epilogue"])

    (logits, cache), t_plain, n_plain = counted(
        lambda: M.prefill(model, cfg, tokens, max_seq=max_seq))
    with one_rank_world("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        plan = sharding.make_mesh_plan(mesh)
        specs = sharding.param_pspecs(cfg, plan)
        _, t_dist = sync_time(lambda: sharding.distribute_model(
            model, specs, mesh))
        tok = sharding.place(tokens, mesh, sharding.batch_pspecs(plan,
                                                                 tokens))
        ctx = pctx.ShardingContext(mesh=mesh, dp_axes=plan.dp_axes)

        def laid_out():
            with implicit_replication(), pctx.use(ctx):
                return M.prefill(model, cfg, tok, max_seq=max_seq)

        (l2, c2), t_layout, n_layout = counted(laid_out)
        want = (cfg.n_layers,) * 4
        if n_plain != want or n_layout != want:
            raise AssertionError(f"K4/K5/mixer launches {n_plain} plain, "
                                 f"{n_layout} under the layout; want {want}")
        if not torch.equal(l2.full_tensor(), logits):
            raise AssertionError("logits under the 1 x 1 layout differ")
        for g, leaves in cache.items():
            for k, v in leaves.items():
                if not torch.equal(c2[g][k].full_tensor(), v):
                    raise AssertionError(f"cache {g}/{k} under the layout "
                                         "differs")
        log(f"layout on the card: {cfg.name} prefill of {B} x {S} tokens "
            f"plain {t_plain:.3f} s, under the 1 x 1 layout {t_layout:.3f} s "
            f"(parameters laid out in {t_dist:.3f} s); logits and "
            f"{sum(len(v) for v in cache.values())} cache leaves bit-equal; "
            f"K4/K5/prologue/epilogue launches {n_plain} plain, {n_layout} "
            "laid out")
        del model, cache, c2, logits, l2
        torch.cuda.empty_cache()

        small = configs.get_smoke_config("deepseek-moe-16b")
        ref = M.init_params(small, seed=3)
        tree = M.params_to_numpy(ref)
        specs = sharding.param_pspecs(small, plan, fsdp=True)
        with tempfile.TemporaryDirectory() as d:
            _, t_save = sync_time(lambda: save_checkpoint(d, 5, {
                "params": tree}))
            back, t_load = sync_time(lambda: load_checkpoint(
                d, 5, {"params": tree}, shardings={
                    "params": sharding.checkpoint_shardings(small, specs,
                                                            mesh)}))
        n = 0
        for name, p in ref.named_parameters():
            path, i = M.leaf_path(name)
            leaf = back["params"]
            for k in path:
                leaf = leaf[k]
            got = leaf if i is None else leaf[i]
            spec = sharding.layer_spec(sharding.lookup(specs, path), name)
            if tuple(got.placements) != sharding.placements(spec, mesh):
                raise AssertionError(f"{name}: placements {got.placements}")
            if not torch.equal(got.full_tensor(), p.float()):
                raise AssertionError(f"{name}: restored values differ")
            n += 1
        log(f"elastic restore on the card: {small.name} smoke, {n} "
            f"parameters written ({t_save:.3f} s) and restored onto the "
            f"1 x 1 mesh ({t_load:.3f} s), each bit-equal on the placements "
            "its layout asks for")


def dry_run(ks, clock_hz) -> dict:
    """Phase 17: (a) the dry run's cells, then (b) and (c) on the card."""
    out = dryrun_cells(ks, clock_hz)
    layout_on_the_card()
    return out


# -- phase 18: the programs across ranks ---------------------------------------

#: (a)'s two runs of qwen3-moe-30b-a3b's MoE layer: (label, batch of 2048
#: tokens, capacity factor)
EP_RUNS = (("generous", 1, 8.0), ("config", 4, 1.25))
EP_RANKS = 8
#: the tokens' mean: it skews the random router's choices, as a trained
#: router's are skewed, so that the config's capacity factor drops
EP_SKEW = 0.25
#: relative L2 bound of a bf16 MoE layer against another order of the same
#: products
EP_RTOL = 2 ** -8
#: (b): hymba-1.5b's 32 layers in 4 stages, 4 microbatches of [1, 2048]
PIPE = {"stages": 4, "micro": 4, "seq": 2048}
#: (c): the ranks' float32 state may take this much of the card; ranks of
#: [1, 2048] tokens, error-feedback steps averaged
CMP = {"ranks": 4, "fallback_ranks": 2, "max_bytes": 72e9, "seq": 2048,
       "steps": 4}
#: (c)'s bound in quantisation steps: int8 rounding moves each rank's entry
#: by at most half a step, and so their mean; the uncompressed mean comes
#: from a second gradient pass, whose atomic adds (the embedding's
#: backward) may differ in the last bits
CMP_HALF_STEP = 0.5 + 1e-3
#: (c)'s relative L2 limits of the compressed mean gradient against the
#: ranks' uncompressed mean: the one shot (0.05224 on hymba-1.5b's tree
#: on the H100; one int8 scale a tensor of up to 1.6e8 entries cannot
#: meet the reference's 0.02, held on its 16 x 4 linear model) and the
#: average of 4 error-feedback steps (0.01307)
CMP_ONE_SHOT_REL = 0.07
CMP_AVERAGED_REL = 0.02
#: and of the ranks' uncompressed mean against the gradient of the mean
#: loss taken on the whole batch on one device (no rank, no shard): two
#: bf16 backwards of 32 layers in another order, 0.026 apart on the H100
CMP_WHOLE_REL = 0.04


def moe_layer(cfg, seed: int) -> dict:
    """One MoE layer of ``cfg`` in bf16, drawn on the card with
    ``init_params``' recipe (normal over the square root of the fan in)."""
    from repro_torch.nn.moe import moe_param_shapes

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: (torch.randn(sh, generator=gen, device="cuda")
                / sh[-2] ** 0.5).bfloat16()
            for k, sh in moe_param_shapes(cfg).items()}


def ep_drops(x, p, cfg) -> int:
    """Assignments past the ``ep_a2a`` capacity in one rank's buffer (every
    rank routes every token of ``x``)."""
    from repro_torch.nn.moe import top_k
    from repro_torch.workloads.moe import a2a_capacity

    xf = x.reshape(-1, x.shape[-1])
    idx = top_k(xf.float() @ p["router"].float(), cfg.n_experts_active)[2]
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    C = a2a_capacity(xf.shape[0], cfg)
    return int((counts - C).clamp(min=0).sum())


def timed_in_ranks(fn):
    """``fn()`` once to warm up, then once timed, inside a rank: (result,
    wall seconds of the timed call, ending in a device sync that waits for
    every rank's work on the shared card)."""
    fn()
    torch.cuda.synchronize()
    return sync_time(fn)


def ep_across_ranks() -> dict:
    """Phase 18 (a) and (e)'s MoE: ``moe_ffn_ep`` for qwen3-moe-30b-a3b's
    MoE layer at full width (d 2048, 128 experts top-8 of width 768, bf16
    random weights) on 8 thread ranks of ``cuda:0``, the experts split 16 a
    rank: with capacity factor 8 on [1, 2048, 2048] (no drop) held to
    ``nn.moe.moe_ffn`` on one device, and with the config's 1.25 on [4,
    2048, 2048] (drops: the tokens' mean ``EP_SKEW`` skews the routing)
    held to ``moe_ffn_ep`` on a one-rank NCCL world,
    every rank's output within relative L2 2^-8 (a rank's slots sit at
    its own place in each expert's product, so the ranks' outputs may
    differ in their last bits); then (e)
    the capacity-8 call on the NCCL world held to ``moe_ffn`` too.
    Prints the drops, the wall of one call across the world and its peak
    memory."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, one_rank_world, run_ranks
    from repro_torch.nn.moe import moe_ffn
    from repro_torch.parallel import moe_ffn_ep

    base = configs.get_config("qwen3-moe-30b-a3b")
    p = moe_layer(base, seed=21)
    gen = torch.Generator(device="cuda").manual_seed(22)
    runs = {}
    for label, B, cf in EP_RUNS:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        x = (torch.randn(B, 2048, cfg.d_model, generator=gen,
                         device="cuda") + EP_SKEW).bfloat16()

        def rank(r, x=x, cfg=cfg):
            mesh = make_mesh((EP_RANKS,), ("model",), "cuda")
            return timed_in_ranks(lambda: moe_ffn_ep(x, p, cfg, mesh))

        torch.cuda.reset_peak_memory_stats()
        outs, wall = sync_time(lambda: run_ranks(EP_RANKS, rank))
        peak = torch.cuda.max_memory_allocated()
        ys = [y for y, _ in outs]
        for y in ys:
            check_finite(f"moe_ffn_ep {label}", y)
        runs[label] = dict(cfg=cfg, x=x, ys=ys, drops=ep_drops(x, p, cfg),
                           call_s=max(t for _, t in outs), world_s=wall,
                           peak=peak)
    with one_rank_world("nccl"):
        nccl = {label: moe_ffn_ep(run["x"], p, run["cfg"])
                for label, run in runs.items()}
    dense, _ = moe_ffn(runs["generous"]["x"], p, runs["generous"]["cfg"])
    held = {"generous": (dense, "nn.moe.moe_ffn on one device"),
            "config": (nccl["config"], "moe_ffn_ep on a one-rank NCCL "
                       "world")}
    for label, run in runs.items():
        want, what = held[label]
        rel = max(rel_l2(y, want) for y in run["ys"])
        if (label == "generous") == bool(run["drops"]):
            cf = run["cfg"].capacity_factor
            raise AssertionError(f"capacity factor {cf} dropped "
                                 f"{run['drops']}")
        if not rel <= EP_RTOL:
            raise AssertionError(f"moe_ffn_ep {label}: relative L2 {rel} "
                                 f"against {what}")
        B = run["x"].shape[0]
        log(f"(a) moe_ffn_ep qwen3-moe-30b-a3b layer, {B} x 2048 tokens, "
            f"capacity factor {run['cfg'].capacity_factor} on {EP_RANKS} "
            f"thread ranks of one card: {run['drops']} assignments dropped "
            f"a rank; relative L2 {rel:.3g} against {what} (the worst "
            f"rank; limit 2^-8); "
            f"one call {run['call_s'] * 1e3:.2f} ms across the world (its "
            f"ranks' work serialised on the card; no network), the world's "
            f"run {run['world_s']:.3f} s; max_memory_allocated "
            f"{run['peak']} bytes")
    rel = rel_l2(nccl["generous"], dense)
    if not rel <= EP_RTOL:
        raise AssertionError(f"moe_ffn_ep on NCCL: relative L2 {rel}")
    log(f"(e) moe_ffn_ep on a one-rank NCCL world (128 experts on the rank):"
        f" capacity factor 8 relative L2 {rel:.3g} against moe_ffn on one "
        f"device; capacity factor 1.25 is (a)'s reference")


def exec_across_ranks(ks) -> dict:
    """Phase 18 (d): ``tests/test_exec.py``'s cases (the four 8-rank host
    presets x every strategy x both colorings, 40 messages from seed 11)
    executed with ``mesh=`` on 8 thread ranks, K1's count set to 0 just
    before: every rank's delivered matrix bit-equal to ``run_reference``
    and to the virtual-rank executor, its digest (one K1 launch a rank)
    within rtol 1e-4 of the float64 bincount; ``time_schedule(mesh=)``'s
    median (greedy coloring) beside the virtual-rank median.  Returns K1's
    launches."""
    from repro_torch.comm.phase import CommPhase
    from repro_torch.comm.strategies import strategies_for
    from repro_torch.exec import (COLORINGS, build_executor, build_schedule,
                                  execute, host_machines, run_reference,
                                  time_schedule)
    from repro_torch.launch.mesh import make_rank_mesh, run_ranks

    ks.reset_launches()
    n, worst, t0 = 0, 0.0, time.perf_counter()
    medians = {}
    for name, m in host_machines().items():
        ph = CommPhase.build(m, *exec_messages(40, 11, (1, 6000), 8),
                             n_procs=8)
        for strat in strategies_for(m):
            for coloring in COLORINGS:
                sched = build_schedule(ph, strat, coloring=coloring)
                want = torch.from_numpy(run_reference(sched)).cuda()
                if not torch.equal(build_executor(sched)(), want):
                    raise AssertionError(f"{name} {strat}: virtual ranks")
                timed = coloring == "greedy"

                def rank(r, sched=sched, timed=timed):
                    mesh = make_rank_mesh(8, "cuda")
                    got = execute(sched, mesh=mesh)
                    return got, (time_schedule(sched, mesh=mesh).median_s
                                 if timed else None)

                outs = run_ranks(8, rank)
                for (delivered, digest), _ in outs:
                    if not torch.equal(delivered, want):
                        raise AssertionError(f"{name} {strat} {coloring}: "
                                             "delivered across ranks")
                    worst = max(worst, digest_ok(digest, sched,
                                                 f"{name} {strat}"))
                if timed:
                    medians[name, strat] = (
                        max(t for _, t in outs),
                        time_schedule(sched).median_s, sched.n_rounds)
                n += 1
    launches = ks.LAUNCHES["segment_reduce"]
    if launches != 8 * n:
        raise AssertionError(f"{launches} K1 launches, want {8 * n}")
    log(f"(d) the executor across ranks: {n} schedules (4 presets x their "
        f"strategies x both colorings) on 8 thread ranks in "
        f"{time.perf_counter() - t0:.2f} s, every rank's delivered matrix "
        f"bit-equal to run_reference and to the virtual ranks, digests "
        f"within {worst:.3g} (limit 1e-4), {launches} K1 launches")
    for (name, strat), (ranks_s, virt_s, rounds) in medians.items():
        log(f"  {name:14s} {strat:13s} {rounds:2d} rounds: time_schedule "
            f"median across 8 thread ranks {ranks_s * 1e3:.3f} ms (slowest "
            f"rank), virtual ranks {virt_s * 1e3:.3f} ms")
    return {"launches": launches}


def pipe_stage(cfg, positions):
    """GPipe's ``stage_fn`` over a model's decoder layers."""
    from repro_torch.nn.blocks import block_forward

    def stage_fn(layers, x):
        for lp in layers:
            x = block_forward(x, lp, cfg, positions)[0]
        return x
    return stage_fn


def counted_k4_k5(fn):
    """``fn()`` with K4's and K5's counts set to 0 just before: (result,
    wall, (K4 launches, K5 launches))."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    fa.reset_launches()
    ssd.reset_launches()
    out, wall = sync_time(fn)
    return out, wall, (fa.LAUNCHES["flash_attention"],
                       ssd.LAUNCHES["ssd_intra_chunk"])


def pipe_across_ranks(model, cfg) -> dict:
    """Phase 18 (b): ``gpipe`` over hymba-1.5b's 32 layers in 4 stages of
    8 on 4 thread ranks, 4 microbatches of [1, 2048] embedded tokens in
    bf16, K4's and K5's counts set to 0 just before (every stage computes
    on each of the 7 ticks: 224 launches each, 128 useful), held to the
    32 layers run in order on one device (relative L2 2^-8; 0 expected:
    the same kernels on the same inputs).  Returns the launches and the
    microbatches and reference for (e)."""
    from repro_torch.launch.mesh import make_mesh, run_ranks
    from repro_torch.parallel import gpipe, stack_stages

    S, M, n = PIPE["seq"], PIPE["micro"], PIPE["stages"]
    tokens = torch.from_numpy(prompt_inputs(cfg, M, S, seed=23)["tokens"])
    positions = torch.arange(S, device="cuda")[None]
    stage_fn = pipe_stage(cfg, positions)
    with torch.no_grad():
        mbs = model.embed[tokens.cuda()][:, None]
        want, t_seq = sync_time(lambda: torch.stack(
            [stage_fn(model.layers, x) for x in mbs]))
    stages = stack_stages(model.layers, n)

    def rank(r):
        with torch.no_grad():
            return gpipe(stage_fn, stages, mbs,
                         make_mesh((n,), ("pod",), "cuda"), "pod")

    torch.cuda.reset_peak_memory_stats()
    outs, wall, launches = counted_k4_k5(lambda: run_ranks(n, rank))
    peak = torch.cuda.max_memory_allocated()
    ticks = M + n - 1
    expect = ticks * cfg.n_layers
    if launches != (expect, expect):
        raise AssertionError(f"gpipe: K4/K5 launches {launches}, want "
                             f"{expect} each")
    gap = max(float((y - want).abs().max()) for y in outs)
    rel = max(rel_l2(y, want) for y in outs)
    if not rel <= EP_RTOL:
        raise AssertionError(f"gpipe: relative L2 {rel} against the layers "
                             "in order")
    log(f"(b) gpipe hymba-1.5b, {cfg.n_layers} layers in {n} stages of "
        f"{cfg.n_layers // n} on {n} thread ranks, {M} microbatches of "
        f"[1, {S}] bf16: {ticks} ticks, K4/K5 launches {launches} ({M} x "
        f"{cfg.n_layers} = {M * cfg.n_layers} useful); largest absolute gap "
        f"to the layers in order {gap} (relative L2 {rel:.3g}); the "
        f"world's run {wall:.3f} s (the ranks' work serialised on the card),"
        f" the layers in order {t_seq:.3f} s; max_memory_allocated {peak} "
        "bytes")
    return {"launches": launches[0], "mbs": mbs, "want": want,
            "stage_fn": stage_fn}


def tree_rel(a: dict, b: dict) -> float:
    """Relative L2 of the tree ``a`` against ``b`` (float64 sums)."""
    num = sum(float((a[k].double() - b[k].double()).norm()) ** 2 for k in b)
    den = sum(float(b[k].double().norm()) ** 2 for k in b)
    return (num / den) ** 0.5


def whole_batch_grads(loss_fn, model, batch) -> dict:
    """{name: gradient} of ``loss_fn(model, batch)`` on the whole batch on
    one device, outside any world: the uncompressed mean gradient that
    (c) holds the compressed one to, by another path than the ranks'
    shards.  The parameters' ``requires_grad`` is left as it was."""
    named = dict(model.named_parameters())
    flags = [p.requires_grad for p in named.values()]
    model.trainable()
    try:
        grads = torch.autograd.grad(loss_fn(model, batch),
                                    list(named.values()), allow_unused=True)
    finally:
        for p, flag in zip(named.values(), flags):
            p.requires_grad_(flag)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named.items(), grads)}


def compression_rank(loss_fn, model, batch, n: int, steps: int, mesh=None,
                     whole=None):
    """One rank of (c): the one-shot compressed mean gradient held entry by
    entry to half a quantisation step of the uncompressed mean (the mean
    of the ranks' own gradients, reduced leaf by leaf), then ``steps - 1``
    more with error feedback.  Returns (worst gap in quantisation steps,
    the one shot's relative L2 against the uncompressed mean, and on rank
    0 with ``whole`` given the uncompressed mean's relative L2 against
    ``whole``, the whole batch's gradient, and the averaged one's against
    the uncompressed mean; else None for both)."""
    from repro_torch.parallel import dp_grads_compressed
    from repro_torch.parallel.collectives import (axis_group, axis_index,
                                                  pmax, psum)
    from repro_torch.parallel.compression import shard_grads

    group = axis_group(mesh, "data")
    first = axis_index(group) == 0 and whole is not None
    own = shard_grads(loss_fn, model, batch, mesh, "data")
    mean, errs = dp_grads_compressed(loss_fn, model, batch, mesh, "data")
    worst, u = 0.0, {}
    for k in list(own):
        g = own.pop(k).float()
        scale = float(pmax(g.abs().max(), group)) / 127.0
        uk = psum(g, group) / n
        worst = max(worst, float((mean[k] - uk).abs().max()) / scale
                    if scale else 0.0)
        u[k] = uk
    one_shot = tree_rel(mean, u)
    u_whole = tree_rel(u, whole) if first else None
    acc = mean if first else None
    if not first:
        u = None
    del mean
    for _ in range(steps - 1):      # every rank: each call reduces
        step, errs = dp_grads_compressed(loss_fn, model, batch, mesh, "data",
                                         errors=errs)
        if first:
            for k in acc:
                acc[k] += step[k]
        del step
    if not first:
        return worst, one_shot, None, None
    return worst, one_shot, u_whole, tree_rel(
        {k: v / steps for k, v in acc.items()}, u)


def compression_across_ranks(model, cfg) -> None:
    """Phase 18 (c): ``dp_grads_compressed`` on hymba-1.5b's ``lm_loss``
    (remat) at full width, one [1, 2048] token row a rank: 4 thread ranks,
    or 2 where 4 ranks' state (three float32 trees — mean, error in and
    out — and the bf16 gradients, a rank) would pass 72 GB.  Each entry of
    the one-shot mean within half a quantisation step of the uncompressed
    mean of the ranks' gradients (the bound int8 rounding gives); its
    relative L2 within ``CMP_ONE_SHOT_REL`` and the 4-step error-feedback
    average's within ``CMP_AVERAGED_REL`` and below the one shot's; the
    uncompressed mean within ``CMP_WHOLE_REL`` of the gradient of the
    mean loss on the whole batch on one device."""
    from repro_torch.launch.mesh import make_mesh, run_ranks
    from repro_torch.nn import lm_loss

    n_params = sum(p.numel() for p in model.parameters())
    state = 14 * n_params
    n = CMP["ranks"] if CMP["ranks"] * state + model_bytes(model) \
        <= CMP["max_bytes"] else CMP["fallback_ranks"]
    tokens = torch.from_numpy(prompt_inputs(cfg, n, CMP["seq"],
                                            seed=24)["tokens"]).cuda()

    def loss_fn(m, b):
        return lm_loss(m, cfg, b)[0]

    whole = whole_batch_grads(loss_fn, model, {"tokens": tokens})

    def rank(r):
        mesh = make_mesh((n,), ("data",), "cuda")
        return compression_rank(loss_fn, model, {"tokens": tokens}, n,
                                CMP["steps"], mesh, whole)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    outs, wall = sync_time(lambda: run_ranks(n, rank))
    peak = torch.cuda.max_memory_allocated()
    del whole
    worst = max(w for w, _, _, _ in outs)
    one_shot, u_whole, averaged = outs[0][1:]
    if not worst <= CMP_HALF_STEP:
        raise AssertionError(f"compressed mean off by {worst} quantisation "
                             "steps")
    if not one_shot <= CMP_ONE_SHOT_REL:
        raise AssertionError(f"one-shot compressed mean: relative L2 "
                             f"{one_shot} (limit {CMP_ONE_SHOT_REL})")
    if not averaged <= CMP_AVERAGED_REL or not averaged < one_shot:
        raise AssertionError(f"error feedback: {averaged} against the one "
                             f"shot {one_shot} (limit {CMP_AVERAGED_REL})")
    if not u_whole <= CMP_WHOLE_REL:
        raise AssertionError(f"the ranks' mean gradient: relative L2 "
                             f"{u_whole} against the whole batch's (limit "
                             f"{CMP_WHOLE_REL})")
    log(f"(c) dp_grads_compressed hymba-1.5b lm_loss, {n} thread ranks of "
        f"[1, {CMP['seq']}] tokens ({'4' if n == 4 else '2: 4 ranks would '
        f'hold {4 * state + model_bytes(model)} bytes'}; {n_params} "
        f"parameters): every entry within {worst:.4f} quantisation steps "
        f"of the uncompressed mean (limit 0.5); relative L2 one shot "
        f"{one_shot:.4g} (limit {CMP_ONE_SHOT_REL}; the reference's bound "
        f"on its 16 x 4 linear model 0.02), {CMP['steps']}-step "
        f"error-feedback average {averaged:.4g} (limit {CMP_AVERAGED_REL});"
        f" the uncompressed mean {u_whole:.4g} from the whole batch's "
        f"gradient on one device (limit {CMP_WHOLE_REL}); the world's run "
        f"{wall:.2f} s; max_memory_allocated {peak} bytes")


def nccl_one_rank(model, cfg, pipe) -> int:
    """Phase 18 (e) for (b) and (c) and a schedule, on a one-rank NCCL
    world: ``gpipe`` with one stage of 32 layers on the 4 microbatches
    (K4/K5 launched 4 x 32 times) held to the layers in order, the
    compressed mean gradient of one [1, 2048] row within half a step of
    its uncompressed mean, and the one-rank schedules of every strategy
    on ``lassen_8`` through ``execute(mesh=)`` equal to ``run_reference``.
    Returns K4's launches."""
    from repro_torch.comm.phase import CommPhase
    from repro_torch.comm.strategies import strategies_for
    from repro_torch.exec import build_schedule, execute, lassen_8
    from repro_torch.exec import run_reference
    from repro_torch.launch.mesh import make_rank_mesh, one_rank_world
    from repro_torch.nn import lm_loss
    from repro_torch.parallel import gpipe

    tokens = torch.from_numpy(prompt_inputs(cfg, 1, CMP["seq"],
                                            seed=24)["tokens"]).cuda()
    with one_rank_world("nccl"):
        with torch.no_grad():
            y, wall, launches = counted_k4_k5(lambda: gpipe(
                pipe["stage_fn"], [list(model.layers)], pipe["mbs"]))
        want = PIPE["micro"] * cfg.n_layers
        gap = float((y - pipe["want"]).abs().max())
        if launches != (want, want) or not rel_l2(y, pipe["want"]) \
                <= EP_RTOL:
            raise AssertionError(f"gpipe on NCCL: launches {launches}, gap "
                                 f"{gap}")
        worst, one_shot, _, _ = compression_rank(
            lambda m, b: lm_loss(m, cfg, b)[0], model, {"tokens": tokens},
            1, 1)
        if not worst <= CMP_HALF_STEP:
            raise AssertionError(f"compression on NCCL: {worst} steps")
        m = lassen_8()
        for strat in strategies_for(m):
            sched = build_schedule(CommPhase.build(
                m, [0, 0], [0, 0], [100.0, 200.0], n_procs=1), strat)
            got, _ = execute(sched, mesh=make_rank_mesh(1, "cuda"))
            if not torch.equal(got.cpu(), torch.from_numpy(
                    run_reference(sched))):
                raise AssertionError(f"one-rank {strat} on NCCL")
    log(f"(e) on a one-rank NCCL world: gpipe of one 32-layer stage, K4/K5 "
        f"launches {launches}, largest absolute gap {gap} to the layers in "
        f"order ({wall:.3f} s); compressed gradient of one row within "
        f"{worst:.4f} steps (relative L2 {one_shot:.4g}); the one-rank "
        f"schedules of {len(strategies_for(m))} strategies equal to "
        "run_reference")
    return launches[0]


def across_ranks(ks) -> dict:
    """Phase 18: the expert all-to-all, GPipe, the compressed all-reduce
    and the executor across ranks, as ``torch.distributed`` programs on
    worlds of ranks as threads of this process (``launch.mesh.run_ranks``:
    every rank computes on the one card and the threaded group's
    collectives are copies on it), and on a one-rank NCCL world.  Returns
    the launches for the kernels line."""
    from repro_torch import configs
    from repro_torch.nn import init_params

    t0 = time.perf_counter()
    ep_across_ranks()
    torch.cuda.empty_cache()
    k1 = exec_across_ranks(ks)
    cfg = configs.get_config("hymba-1.5b")
    model = init_params(cfg, seed=0)
    pipe = pipe_across_ranks(model, cfg)
    compression_across_ranks(model, cfg)
    nccl = nccl_one_rank(model, cfg, pipe)
    k4_k5 = {"launches": pipe["launches"], "nccl_launches": nccl}
    del model, pipe
    torch.cuda.empty_cache()
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return {"segment_reduce": k1, "flash_attention": k4_k5,
            "ssd_intra_chunk": dict(k4_k5)}


# -- the kernels line: K4 and K5 figures -------------------------------------

def k4_call_figures(fa, q, k, v, causal) -> dict:
    """CUDA-event times of one K4 call (the wrapper, the launch alone, the
    plain version and ``scaled_dot_product_attention`` with
    ``enable_gqa``, the one-call PyTorch yardstick) beside its bound: the
    larger of its flops (the causal triangle, 4D a pair) at the peak rate
    of its dtype and its bytes (q, k, v read once, the output written
    once) at 3.35 TB/s."""
    import torch.nn.functional as F

    B, S, H, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = B * H * pairs * 4 * D
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / (BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS)
    t_bytes = moved / HBM_BYTES_PER_S
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    reps = 3
    return dict(
        ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal), reps),
        kernel_ms=cuda_ms(lambda: fa._flash_attention_cuda(q, k, v, causal),
                          reps),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                         reps),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, bytes=moved)


def k5_call_figures(ssd, dtx, Bm, Cm, cumA) -> dict:
    """CUDA-event times of one K5 call (the wrapper, the launch alone, the
    plain version; no single PyTorch call computes it) beside its bound:
    the larger of its bytes (dtx, cumA, y and S_c once a program, B and C
    once a (batch, chunk), float32) at 3.35 TB/s and the tensor-core flops
    of its products at the card's TF32 rate, three TF32 products for each
    float32 one (the lower triangle of C B^T once a (batch, chunk), then a
    head's scores times dtx and S_c).  ``bound_f32_ms`` is the bound of
    the CUDA-core kernel K5 replaced, kept to compare with: every float32
    flop (C B^T per head, the decay, both products) at the float32 rate."""
    G1, h, q, p = dtx.shape
    n = Bm.shape[-1]
    G = G1 * h
    moved = 4 * (2 * G * q * p + G * q + 2 * G1 * q * n + G * n * p)
    tri = q * (q + 1) // 2
    flops = G * (tri * (2 * n + 1 + 2 * p) + q * n + 2 * q * n * p)
    tc_flops = 3 * (G1 * tri * 2 * n + G * (tri * 2 * p + 2 * q * n * p))
    t_ops, t_bytes = tc_flops / TF32_FLOPS, moved / HBM_BYTES_PER_S
    heads = (G, h, q, n, p)
    reps = 5
    return dict(
        ms=cuda_ms(lambda: ssd.ssd_intra_chunk(dtx, Bm, Cm, cumA), reps),
        kernel_ms=cuda_ms(lambda: ssd._ssd_intra_chunk_cuda(
            dtx, Bm, Cm, cumA, *heads), reps),
        plain_ms=cuda_ms(lambda: ssd.ssd_intra_chunk_plain(dtx, Bm, Cm, cumA),
                         reps),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_f32_ms=max(flops / F32_FLOPS, t_bytes) * 1e3,
        flops=flops, tc_flops=tc_flops, bytes=moved)


def model_kernel_rows(launches, captured, dev_ms) -> list:
    """The K4 and K5 rows over the 32 calls of the full-width prefill: each
    call held to its plain version, times and bounds summed, and the
    kernel's device time over a profiled prefill (``dev_ms``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    rows = []
    for name, err_of, figs_of in (
            ("flash_attention",
             lambda a, kw: k4_err(fa, *a, kw.get("causal", True)),
             lambda a, kw: k4_call_figures(fa, *a, kw.get("causal", True))),
            ("ssd_intra_chunk", lambda a, kw: k5_err(ssd, *a),
             lambda a, kw: k5_call_figures(ssd, *a))):
        calls = captured[name]
        errs = [err_of(a, kw) for a, kw in calls]
        figs = [figs_of(a, kw) for a, kw in calls]
        keys = [k for k in ("ms", "kernel_ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_f32_ms", "flops", "tc_flops",
                            "bytes") if k in figs[0]]
        total = {k: sum(f[k] for f in figs) for k in keys}
        shapes = [tuple(t.shape) for t in calls[0][0]]
        log(f"{name} over the full-width prefill's {len(calls)} calls "
            f"(inputs {shapes}, {calls[0][0][0].dtype}): wrapper "
            f"{total['ms']:.4f} ms, launch alone {total['kernel_ms']:.4f} ms "
            f"({total['flops'] / total['kernel_ms'] / 1e9:.2f} TFLOP/s, "
            f"{total['bytes'] / total['kernel_ms'] / 1e6:.0f} GB/s), device "
            f"{dev_ms[name]} ms (profiled prefill), plain "
            f"{total['plain_ms']:.4f} ms, library "
            + (f"{total['library_ms']:.4f} ms" if "library_ms" in total
               else "none")
            + f", bound {total['bound_ms']:.4f} ms ({figs[0]['bound_by']}: "
            f"{total['flops']} flops, {total['bytes']} bytes"
            + (f"; {total['tc_flops']} split-TF32 flops; as float32 on the "
               f"CUDA cores {total['bound_f32_ms']:.4f} ms"
               if "tc_flops" in total else "")
            + f"); max abs err {max(errs):.3g}")
        rows.append(dict(name=name, route="cuda", source=KERNEL_ROWS[name][0],
                         replaces=KERNEL_ROWS[name][1],
                         launches=launches[name], max_abs_err=max(errs),
                         ms=total["ms"], plain_ms=total["plain_ms"],
                         bound_ms=total["bound_ms"],
                         bound_by=figs[0]["bound_by"],
                         library_ms=total.get("library_ms"),
                         kernel_ms=total["kernel_ms"],
                         device_ms=dev_ms[name], calls=len(calls),
                         flops=total["flops"], bytes=total["bytes"],
                         inputs=[list(s) for s in shapes],
                         **{k: total[k] for k in ("bound_f32_ms", "tc_flops")
                            if k in total}))
    k4, k5 = rows
    k4.update(path="wgmma",
              tflops=k4["flops"] / k4["kernel_ms"] / 1e9,
              vs_library=k4["kernel_ms"] / k4["library_ms"],
              tc_launches=launches["flash_attention_tc"])
    k5.update(path="mma.sync 3xTF32",
              tflops=k5["tc_flops"] / k5["kernel_ms"] / 1e9,
              tc_launches=launches["ssd_intra_chunk_tc"])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import comm_stack as ks

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {nvidia_smi('name,power.limit')}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t = time.perf_counter()
    build_logs = ks.build_kernels()
    log(f"build: {sorted(build_logs)} compiled in "
        f"{time.perf_counter() - t:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                log(f"  {name}: {line.split(chr(39))[1]}")
            elif ("registers" in line or "spill" in line or "warning" in line
                  or "wgmma" in line):
                log(f"    {line.strip()}")

    kernel_parity(ks, dev)
    k3_parity(dev)
    k4_k5_parity(dev)
    mixer = mixer_kernels(dev)
    small_vcycle(small_slice())
    launches, captured, levels, pats, verdicts = full_slice(ks)
    k3_run = full_vcycle(levels)
    paper_launches = paper_measurements(ks, levels)
    registry = registry_sweep(ks, clock_mhz * 1e6)
    delta, drifted = delta_repricing(ks, levels, clock_mhz * 1e6)
    service = strategy_service(ks, pats, verdicts, drifted, clock_mhz * 1e6)
    execution = execution_layer(ks, pats, clock_mhz * 1e6)
    verify = post_kernel_check(ks, pats, verdicts, clock_mhz * 1e6)
    collectives = collective_pricing(ks, clock_mhz * 1e6)
    small_model()
    model_run = full_model()
    model_rows = model_kernel_rows(*model_run)
    del model_run                   # hymba's captured K4/K5 inputs
    torch.cuda.empty_cache()
    model_rows[0]["rest_of_nn"] = rest_of_nn()
    trained = training()
    dry = dry_run(ks, clock_mhz * 1e6)
    ranks = across_ranks(ks)
    for row in model_rows:          # K4 and K5: their launches and summed
        row["train"] = trained[row["name"]]   # figures training hymba,
        row["ranks"] = ranks[row["name"]]     # their launches in gpipe
    rows = kernel_rows(ks, launches, captured, clock_mhz * 1e6)
    for row in rows:        # K1 and K2: their calls on the registry sweep,
        row["registry"] = registry[row["name"]]   # on delta re-pricing, on
        row["delta"] = delta[row["name"]]         # the strategy service, on
        row["service"] = service[row["name"]]     # the execution layer and
        row["exec"] = execution[row["name"]]      # under the post-kernel
        row["verify"] = verify[row["name"]]       # check; K1's on the
    rows[0]["collectives"] = collectives["segment_reduce"]  # collectives
    rows[0]["dryrun"] = dry["segment_reduce"]      # and on the dry run
    rows[0]["ranks"] = ranks["segment_reduce"]     # and across ranks
    rows.append(k3_row(*k3_run))
    rows.extend(model_rows)
    log(f"paper measurements launches (Figs. 10-11 at full width): "
        f"{paper_launches}")
    log("registry sweep launches: " + ", ".join(
        f"{k} {v['launches']}" for k, v in registry.items()))
    log("delta re-pricing launches: " + ", ".join(
        f"{k} {v['launches']}" for k, v in delta.items()))
    log("strategy service launches: " + ", ".join(
        f"{k} {v['launches']}" for k, v in service.items()))
    log("execution layer launches: " + ", ".join(
        f"{k} {v['launches']}" for k, v in execution.items()))
    log("post-kernel check launches: " + ", ".join(
        f"{k} {v['launches']}" for k, v in verify.items()))
    log(f"collective pricing launches: segment_reduce "
        f"{collectives['segment_reduce']['launches']}")
    log(f"dry run launches: segment_reduce "
        f"{dry['segment_reduce']['launches']}")
    log(f"across ranks launches: segment_reduce "
        f"{ranks['segment_reduce']['launches']}, flash_attention and "
        f"ssd_intra_chunk {ranks['flash_attention']['launches']} each on 4 "
        f"thread ranks and {ranks['flash_attention']['nccl_launches']} on "
        "NCCL")
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"port_only_kernels": mixer}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
