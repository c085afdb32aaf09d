"""MoE expert-parallel all-to-all traffic as irregular point-to-point phases.

The optimized MoE path in this repo (:mod:`repro_torch.parallel.ep_a2a`)
moves tokens between ranks with two ``all_to_all_single`` exchanges:
**dispatch**
ships every routed token from its origin rank to the rank owning its expert,
and **combine** returns the expert outputs along the exact reverse routes.
Which rank owes how many tokens to which rank is decided by the *router* —
a data-dependent top-K choice — so the exchange is exactly the kind of
irregular point-to-point phase the paper's node-aware + queue-search model
prices: per-pair sizes follow the token-routing histogram, not a regular
collective schedule.

This module derives those phases without running the model: a routing-count
histogram ``counts[rank, expert]`` is lowered to ``(src, dst, size)``
triples (:func:`pattern_from_counts`) that mirror the ``ep_a2a`` schedule —
per-(rank, expert) capacity clipping included — with the histogram itself
coming either from a seeded numpy **router forward pass** (the same
logits → softmax → top-K math as :func:`repro_torch.nn.moe.moe_ffn`,
reproduced in numpy so the derivation needs no device) or from a seeded
synthetic **top-K multinomial** with a skewed expert-popularity prior.

RNG contract (pinned by the property tests): every function takes an
integer ``seed`` and creates its own ``np.random.default_rng(seed)`` —
the same seed always yields bit-identical histograms and patterns across
calls, processes and platforms; no global numpy state is read or written.

Port note: a copy of ``repro.workloads.moe``, host numpy throughout (the
float32 router product and the stable argsort as written there), so every
histogram and pattern is bit-equal to the reference's.  The slots
:func:`repro_torch.parallel.ep_a2a.moe_ffn_ep` sends each peer are the
token counts :func:`pattern_from_counts` derives from its routing
histogram and capacity (``tests/test_torch_multirank.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.nn.config import ArchConfig
from repro_torch.sparse.partition import CommPattern

#: Bytes per activation element crossing the wire (bf16, matching the
#: production stack's activation dtype).
ACT_BYTES = 2


@dataclasses.dataclass(frozen=True)
class MoeA2APattern:
    """Both exchanges of one MoE layer's expert-parallel all-to-all.

    ``dispatch`` carries routed tokens origin-rank → expert-rank; ``combine``
    is its exact mirror (same pair volumes, direction reversed) — expert
    outputs travel back along the routes the tokens arrived on, which is the
    flow-conservation identity the property tests certify.  ``counts`` is
    the raw routing histogram ``[n_ranks, n_experts]``; ``sent`` is the same
    histogram after per-(rank, expert) capacity clipping (what actually
    rides the wire); ``capacity`` is the per-expert slot count of the
    ``ep_a2a`` buffer; ``token_bytes`` the wire size of one token's
    activation vector.
    """

    dispatch: CommPattern
    combine: CommPattern
    counts: np.ndarray          # [n_ranks, n_experts] routed assignments
    sent: np.ndarray            # [n_ranks, n_experts] after capacity clip
    capacity: int
    token_bytes: int

    @property
    def n_ranks(self) -> int:
        return self.dispatch.n_procs

    @property
    def dropped_tokens(self) -> int:
        """Assignments lost to capacity clipping (over-capacity drops)."""
        return int((self.counts - self.sent).sum())

    def phases(self) -> list[tuple[str, CommPattern]]:
        """The two exchanges in schedule order, labelled."""
        return [("dispatch", self.dispatch), ("combine", self.combine)]


def a2a_capacity(tokens_per_rank: int, cfg: ArchConfig) -> int:
    """Per-expert capacity of the ``ep_a2a`` dispatch buffer.

    The same formula :func:`repro_torch.parallel.ep_a2a.moe_ffn_ep`
    computes inline from ``tokens_per_rank`` (its per-rank token count
    ``T``) and ``cfg`` (``n_experts_active``, ``capacity_factor``,
    ``n_experts``); kept in sync by the buffer shape checked in
    ``tests/test_torch_multirank.py``.
    """
    return max(8, int(tokens_per_rank * cfg.n_experts_active
                      * cfg.capacity_factor // cfg.n_experts) + 1)


def synthetic_routing_counts(n_ranks: int, tokens_per_rank: int,
                             n_experts: int, top_k: int, seed: int = 0,
                             concentration: float = 0.3) -> np.ndarray:
    """Seeded synthetic routing histogram: top-K multinomial token routing.

    Each of the ``n_ranks * tokens_per_rank`` tokens picks ``top_k``
    *distinct* experts out of ``n_experts`` with probability proportional to
    a shared expert-popularity vector drawn from a symmetric Dirichlet with
    parameter ``concentration`` (< 1 skews popular experts — the hot-expert
    imbalance real routers exhibit).  Sampling-without-replacement is the
    Gumbel-top-K trick, fully vectorized.  Returns integer counts
    ``[n_ranks, n_experts]``.  ``seed`` follows the module RNG contract:
    same seed, bit-identical histogram.
    """
    if top_k > n_experts:
        raise ValueError(f"top_k ({top_k}) cannot exceed n_experts "
                         f"({n_experts})")
    rng = np.random.default_rng(seed)
    popularity = rng.dirichlet(np.full(n_experts, concentration))
    # Gumbel top-K over log-popularity == K draws without replacement
    n_tokens = n_ranks * tokens_per_rank
    keys = np.log(popularity)[None, :] + rng.gumbel(size=(n_tokens, n_experts))
    experts = np.argpartition(-keys, top_k - 1, axis=1)[:, :top_k]
    rank_of_token = np.repeat(np.arange(n_ranks, dtype=np.int64),
                              tokens_per_rank)
    flat = rank_of_token[:, None] * n_experts + experts
    return np.bincount(flat.ravel(), minlength=n_ranks * n_experts) \
             .reshape(n_ranks, n_experts)


def router_routing_counts(cfg: ArchConfig, n_ranks: int, tokens_per_rank: int,
                          seed: int = 0) -> np.ndarray:
    """Routing histogram from an actual seeded router forward pass (numpy).

    Runs the router math of :func:`repro_torch.nn.moe.moe_ffn` — token
    activations × router weight matrix → float32 logits → softmax → top-K —
    on seeded Gaussian activations and a seeded Gaussian router
    ``[cfg.d_model, cfg.n_experts]`` (scaled ``1/sqrt(d)``), entirely in
    numpy so the derivation needs no device.  Top-K uses a stable
    descending argsort, which matches the model's lowest-index
    tie-breaking on identical logits.  Returns counts ``[n_ranks,
    n_experts]``; ``tokens_per_rank`` tokens are routed per rank, ``seed``
    per the module RNG contract.
    """
    rng = np.random.default_rng(seed)
    d, E, K = cfg.d_model, cfg.n_experts, cfg.n_experts_active
    if not (E and K):
        raise ValueError(f"{cfg.name!r} is not a MoE config "
                         f"(n_experts={E}, n_experts_active={K})")
    n_tokens = n_ranks * tokens_per_rank
    x = rng.standard_normal((n_tokens, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    logits = x @ router
    # softmax is monotone per row, kept for fidelity with the moe_ffn path
    z = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = z / z.sum(axis=1, keepdims=True)
    experts = np.argsort(-probs, axis=1, kind="stable")[:, :K]
    rank_of_token = np.repeat(np.arange(n_ranks, dtype=np.int64),
                              tokens_per_rank)
    flat = rank_of_token[:, None] * E + experts
    return np.bincount(flat.ravel(), minlength=n_ranks * E).reshape(n_ranks, E)


def pattern_from_counts(counts, d_model: int, capacity: int,
                        act_bytes: int = ACT_BYTES) -> MoeA2APattern:
    """Lower a routing histogram to the two-exchange ``ep_a2a`` message set.

    ``counts[r, e]`` tokens routed by rank ``r`` to expert ``e`` are clipped
    at ``capacity`` slots per (rank, expert) — the ``[E, C]`` dispatch
    buffer of :func:`repro_torch.parallel.ep_a2a.moe_ffn_ep` drops
    over-capacity tokens per *source* rank — then summed over each
    destination rank's contiguous expert shard (expert ``e`` lives on rank
    ``e // (E // M)``, the experts split on their leading dim).  Dispatch
    message sizes are ``tokens * d_model * act_bytes``; self-pairs (tokens
    staying on their origin rank) are local buffer traffic, not
    communication, and are dropped.  The combine exchange reuses the same
    pair volumes with src/dst swapped.  Deterministic: no randomness, so
    equal ``counts`` (plus equal ``d_model`` / ``capacity`` / ``act_bytes``)
    give bit-identical patterns.
    """
    counts = np.asarray(counts, dtype=np.int64)
    if counts.ndim != 2:
        raise ValueError(f"counts must be [n_ranks, n_experts], "
                         f"got shape {counts.shape}")
    M, E = counts.shape
    if E % M:
        raise ValueError(f"n_experts ({E}) must divide evenly over "
                         f"n_ranks ({M}), as in ep_a2a")
    sent = np.minimum(counts, int(capacity))
    # tokens per (src rank, dst rank): sum each destination's expert shard
    pair_tokens = sent.reshape(M, M, E // M).sum(axis=2)
    np.fill_diagonal(pair_tokens, 0)            # local dispatch: no message
    src, dst = np.nonzero(pair_tokens)
    size = pair_tokens[src, dst].astype(np.float64) * d_model * act_bytes
    dispatch = CommPattern(src=src.astype(np.int64), dst=dst.astype(np.int64),
                           size=size, n_procs=M).validate(
                               where="pattern_from_counts(dispatch)")
    # combine mirrors dispatch exactly: outputs retrace the token routes
    order = np.lexsort((src, dst))              # canonical (src, dst) order
    combine = CommPattern(src=dst[order].astype(np.int64),
                          dst=src[order].astype(np.int64),
                          size=size[order].copy(), n_procs=M).validate(
                              where="pattern_from_counts(combine)")
    return MoeA2APattern(dispatch=dispatch, combine=combine, counts=counts,
                         sent=sent, capacity=int(capacity),
                         token_bytes=int(d_model) * int(act_bytes))


def moe_a2a_pattern(cfg: ArchConfig, n_ranks: int, tokens_per_rank: int,
                    seed: int = 0, source: str = "synthetic",
                    act_bytes: int = ACT_BYTES) -> MoeA2APattern:
    """One MoE layer's expert-parallel all-to-all for ``cfg`` on ``n_ranks``.

    ``source`` picks the routing histogram: ``"router"`` runs the seeded
    numpy router forward pass (:func:`router_routing_counts`),
    ``"synthetic"`` the top-K multinomial fallback
    (:func:`synthetic_routing_counts`).  ``tokens_per_rank`` tokens are
    routed per rank and lowered through :func:`pattern_from_counts` with the
    ``ep_a2a`` capacity for that token count (:func:`a2a_capacity`);
    ``act_bytes`` scales the per-token wire size.  ``seed`` per the module
    RNG contract: same seed (and same arguments) → bit-identical pattern.
    """
    if source == "router":
        counts = router_routing_counts(cfg, n_ranks, tokens_per_rank,
                                       seed=seed)
    elif source == "synthetic":
        counts = synthetic_routing_counts(n_ranks, tokens_per_rank,
                                          cfg.n_experts,
                                          cfg.n_experts_active, seed=seed)
    else:
        raise ValueError(f"unknown source {source!r}; expected 'router' "
                         "or 'synthetic'")
    return pattern_from_counts(counts, cfg.d_model,
                               a2a_capacity(tokens_per_rank, cfg),
                               act_bytes=act_bytes)
