"""Scenario registry: config × workload × machine, priced in one arena.

A :class:`Scenario` names one traffic shape the in-repo LLM stack emits —
an MoE expert-parallel all-to-all (:mod:`repro_torch.workloads.moe`), a
TP ring collective pair (:mod:`repro_torch.workloads.tp`) or a pipeline
stage-boundary exchange (:mod:`repro_torch.workloads.pipe`) — for one
architecture from :mod:`repro_torch.configs` at one rank count.
:data:`DEFAULT_SCENARIOS` enumerates the shipped set over the production
configs; :func:`default_machines` supplies the machine presets (two GPU
machines plus the paper's CPU baseline, all sized to the same 64 ranks);
:func:`sweep` prices every scenario phase on every machine through **one**
:func:`repro_torch.comm.strategies.best_strategy_many` call (one arena per
machine, on the device) and returns rows :func:`winner_table` renders.

The whole registry is deterministic: scenarios carry their own seeds, the
sweep threads one arrival seed, and equal inputs give identical winners —
the reference's winner table, pinned by its golden test.

Port note: a copy of ``repro.workloads.registry``.  The scenarios derive on
the host (numpy, bit-equal to the reference's patterns); :func:`sweep`
takes ``device=None`` (CUDA; raises without a CUDA device, ``"cpu"`` runs
the plain kernel versions) and prices through K1 (segment reduce) and K2
(queue walk).  Its totals are float32 aggregates, allclose to the
reference's float64 ones.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.net.machine import (blue_waters_machine,
                                     frontier_machine, lassen_machine)

from .moe import moe_a2a_pattern
from .pipe import pipeline_p2p_pattern
from .tp import tp_collective_patterns

WORKLOADS = ("moe_a2a", "tp_collective", "pipeline_p2p")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registry entry: ``workload`` traffic of config ``arch`` on
    ``n_ranks`` ranks.

    ``name`` labels the sweep rows; ``tokens_per_rank`` sizes the activation
    payloads (per rank for MoE, total per TP group for collectives,
    per microbatch for pipelines); ``seed`` feeds the routing histogram
    (MoE only — TP and pipeline shapes are deterministic); ``n_stages`` /
    ``n_microbatches`` shape the ``pipeline_p2p`` schedule and are ignored
    elsewhere.
    """

    name: str
    arch: str
    workload: str               # one of WORKLOADS
    n_ranks: int
    tokens_per_rank: int
    seed: int = 0
    n_stages: int = 8
    n_microbatches: int = 8

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}; "
                             f"expected one of {WORKLOADS}")


def scenario_patterns(sc: Scenario):
    """Derive ``sc``'s labelled, unbound phase list.

    Returns ``[(label, CommPattern), ...]`` in schedule order: MoE gives
    the dispatch + combine exchanges, TP the reduce-scatter + all-gather
    rings, pipeline a single p2p phase.  Deterministic per the workload
    modules' RNG contracts.
    """
    cfg = get_config(sc.arch)
    if sc.workload == "moe_a2a":
        return moe_a2a_pattern(cfg, sc.n_ranks, sc.tokens_per_rank,
                               seed=sc.seed).phases()
    if sc.workload == "tp_collective":
        return tp_collective_patterns(cfg, sc.n_ranks,
                                      sc.tokens_per_rank).phases()
    mb_tokens = sc.tokens_per_rank
    return [("p2p", pipeline_p2p_pattern(cfg, sc.n_stages,
                                         sc.n_microbatches, mb_tokens,
                                         n_procs=sc.n_ranks))]


#: The shipped scenario set: the three production parallelism styles over
#: the MoE and dense configs, all at 64 ranks so every machine preset in
#: :func:`default_machines` hosts every scenario.
DEFAULT_SCENARIOS = (
    Scenario(name="qwen3-moe-a2a", arch="qwen3-moe-30b-a3b",
             workload="moe_a2a", n_ranks=64, tokens_per_rank=256),
    Scenario(name="deepseek-moe-a2a", arch="deepseek-moe-16b",
             workload="moe_a2a", n_ranks=64, tokens_per_rank=256),
    Scenario(name="llama3-tp", arch="llama3.2-3b",
             workload="tp_collective", n_ranks=64, tokens_per_rank=2048),
    Scenario(name="llama3-pipeline", arch="llama3.2-3b",
             workload="pipeline_p2p", n_ranks=64, tokens_per_rank=512,
             n_stages=8, n_microbatches=8),
)


def default_machines():
    """The sweep's machine presets, every one hosting 64 ranks.

    ``lassen`` (fat V100-class nodes, 2×2×2 node torus) and ``frontier``
    (8-GCD nodes, 2×2×2) are the GPU machines; ``blue_waters`` (Gemini
    torus, 2×1×1 — 2 Geminis × 2 nodes × 16 ppn) is the paper's CPU
    baseline.
    """
    return {
        "lassen": lassen_machine((2, 2, 2)),
        "frontier": frontier_machine((2, 2, 2)),
        "blue_waters": blue_waters_machine((2, 1, 1)),
    }


@dataclasses.dataclass(frozen=True)
class SweepRow:
    """One (machine, scenario, phase) verdict of :func:`sweep`.

    ``model_winner`` is the model ladder's predicted strategy,
    ``sim_winner`` the simulator's ground truth, ``agree`` their match;
    ``model`` / ``sim`` are the winning costs in seconds; ``n_msgs`` /
    ``total_bytes`` describe the derived phase itself.  ``degraded`` is
    the reference's flag for rows priced under a backend fallback; the
    port never prices under a fallback (a failed device call raises), so
    it is always ``False``, kept so rows compare field for field.
    """

    machine: str
    scenario: str
    phase: str
    n_msgs: int
    total_bytes: float
    model_winner: str
    sim_winner: str
    agree: bool
    model: float
    sim: float
    degraded: bool = False


def sweep(scenarios=DEFAULT_SCENARIOS, machines=None,
          level: str = "contention", seed: int = 0,
          validate: bool = True, device=None) -> list[SweepRow]:
    """Price every scenario phase on every machine in ONE arena call.

    Each scenario in ``scenarios`` is derived once (seeded per the workload
    RNG contracts), validated through the typed guard layer
    (``validate=True``, the default — a NaN-sized or out-of-range derived
    pattern raises a precise :class:`repro_torch.comm.guard.PatternError`
    before any pricing), bound to each machine in ``machines`` (default
    :func:`default_machines`), and the whole cross product goes through a
    single :func:`repro_torch.comm.strategies.best_strategy_many` call on
    ``device`` (``None`` = CUDA) — the mixed-machine candidate set stacks
    per machine group inside — at model ladder ``level`` with one arrival
    ``seed``.  Returns one :class:`SweepRow` per (machine, scenario, phase),
    machines in dict order, scenarios in input order.
    """
    from repro_torch.comm.strategies import best_strategy_many
    from repro_torch.device import resolve_device

    device = resolve_device(device)

    if machines is None:
        machines = default_machines()
    derived = [(sc, scenario_patterns(sc)) for sc in scenarios]
    if validate:
        from repro_torch.comm.guard import validate_phase
        for sc, phases in derived:
            for label, pat in phases:
                validate_phase(pat, where=f"{sc.name}/{label}")
    keys, bound = [], []
    for mname, machine in machines.items():
        for sc, phases in derived:
            for label, pat in phases:
                keys.append((mname, sc.name, label, pat))
                bound.append(pat.bind(machine))
    verdicts = best_strategy_many(bound, seed=seed, level=level,
                                  device=device)
    return [SweepRow(machine=mname, scenario=sname, phase=label,
                     n_msgs=pat.n_msgs, total_bytes=pat.total_bytes,
                     model_winner=v.model_winner, sim_winner=v.sim_winner,
                     agree=v.agree, model=v.model[v.model_winner],
                     sim=v.sim[v.sim_winner])
            for (mname, sname, label, pat), v in zip(keys, verdicts)]


def winner_table(rows) -> str:
    """Render :func:`sweep` ``rows`` with
    :func:`repro_torch.core.report.format_table`."""
    from repro_torch.core.report import format_table
    cols = ["machine", "scenario", "phase", "n_msgs", "total_bytes",
            "model_winner", "sim_winner", "agree", "model", "sim"]
    return format_table([dataclasses.asdict(r) for r in rows], columns=cols,
                        title="LLM workload winner table")
