"""Parse compiled (post-SPMD) HLO text into a table of collective operations.

``compiled.as_text()`` shapes are per-device.  We extract every
all-reduce / all-gather / reduce-scatter / all-to-all / collective-permute
(sync or async ``-start`` form), its payload bytes, and its replica groups —
including the iota form ``[G,S]<=[dims]T(perm)`` — so the decomposition in
:mod:`repro_torch.core.decompose` can recover *which physical devices* talk
and apply the node-aware model.

Collectives inside ``while`` bodies (e.g. a scan over layers) execute once per
iteration; callers pass ``loop_trip_counts`` mapping body-computation names
(or a default) to trip counts, typically the layer count.

Port note: a copy of ``repro.core.hlo`` (numpy and regex, host only); the
parse is field for field the reference's.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "token": 0,
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute", "ragged-all-to-all")

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?P<type>\(?[\w\[\],{}\s/]*?\)?)\s*"
    r"(?P<kind>" + "|".join(COLLECTIVE_KINDS) + r")"
    r"(?P<async>-start)?\(")
_IOTA_GROUPS_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?")
_EXPLICIT_GROUPS_RE = re.compile(r"replica_groups=\{(\{[0-9,{}\s]*\})\}")
_PAIRS_RE = re.compile(r"source_target_pairs=\{([0-9,{}\s]*)\}")


def shape_bytes(type_str: str) -> float:
    """Total bytes of an HLO result type (handles tuples)."""
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1.0
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def parse_iota_groups(g: int, s: int, dims: list[int],
                      perm: list[int] | None) -> np.ndarray:
    n = int(np.prod(dims))
    ids = np.arange(n).reshape(dims)
    if perm:
        ids = ids.transpose(perm)
    return ids.reshape(g, s)


@dataclasses.dataclass
class CollectiveOp:
    kind: str                   # e.g. "all-reduce"
    result_bytes: float         # per-device result payload (bytes)
    groups: np.ndarray | None   # [n_groups, group_size] device ids, or None
    source_target_pairs: list[tuple[int, int]] | None
    count: int                  # static occurrences x loop trip count
    line: str                   # HLO line (for debugging / attribution)

    @property
    def group_size(self) -> int:
        if self.groups is not None:
            return int(self.groups.shape[1])
        if self.source_target_pairs:
            return 2
        return 1


def _computation_spans(text: str) -> dict[str, tuple[int, int]]:
    """Map computation name -> (start, end) character span in the HLO text."""
    spans: dict[str, tuple[int, int]] = {}
    for m in re.finditer(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$",
                         text, re.MULTILINE):
        name = m.group(1)
        # find matching closing brace at column 0
        end = text.find("\n}", m.end())
        spans[name] = (m.end(), end if end != -1 else len(text))
    return spans


def _loop_computations(text: str, spans: dict[str, tuple[int, int]]) -> set[str]:
    """Names of computations reachable from any ``while`` body."""
    bodies: set[str] = set()
    for m in re.finditer(r"\bwhile\(", text):
        line_end = text.find("\n", m.start())
        line = text[m.start():line_end if line_end != -1 else len(text)]
        bm = re.search(r"body=%?([\w.\-]+)", line)
        if bm:
            bodies.add(bm.group(1))
    # transitive closure over %name references inside each computation span
    marked = set(bodies)
    frontier = list(bodies)
    while frontier:
        comp = frontier.pop()
        if comp not in spans:
            continue
        s0, s1 = spans[comp]
        for ref in re.findall(r"%([\w.\-]+)", text[s0:s1]):
            if ref in spans and ref not in marked:
                marked.add(ref)
                frontier.append(ref)
    return marked


def parse_collectives(text: str,
                      default_trip_count: int = 1) -> list[CollectiveOp]:
    """Extract all collectives; ops inside while bodies get the trip multiplier.

    ``default_trip_count`` applies to every op found inside any while-body
    computation (our models scan over layers, so the trip count is the layer
    count; fwd and bwd scans both use it).
    """
    spans = _computation_spans(text)
    looped = _loop_computations(text, spans)
    body_ranges = [spans[b] for b in looped if b in spans]

    ops: list[CollectiveOp] = []
    for m in _OP_RE.finditer(text):
        line_start = text.rfind("\n", 0, m.start()) + 1
        line_end = text.find("\n", m.start())
        line = text[line_start:line_end if line_end != -1 else len(text)]
        if line.lstrip().startswith("//"):
            continue
        kind = m.group("kind")
        type_str = m.group("type")
        rb = shape_bytes(type_str)

        groups = None
        gm = _IOTA_GROUPS_RE.search(line)
        if gm:
            g, s = int(gm.group(1)), int(gm.group(2))
            dims = [int(x) for x in gm.group(3).split(",")]
            perm = [int(x) for x in gm.group(4).split(",")] if gm.group(4) else None
            groups = parse_iota_groups(g, s, dims, perm)
        else:
            em = _EXPLICIT_GROUPS_RE.search(line)
            if em:
                rows = re.findall(r"\{([0-9,\s]*)\}", em.group(1))
                parsed = [[int(x) for x in r.split(",") if x.strip()] for r in rows]
                if parsed and all(len(r) == len(parsed[0]) for r in parsed):
                    groups = np.asarray(parsed)

        pairs = None
        pm = _PAIRS_RE.search(line)
        if pm:
            pairs = [tuple(int(x) for x in p.split(","))
                     for p in re.findall(r"\{([0-9,\s]+)\}", pm.group(0))]

        count = 1
        for (s0, s1) in body_ranges:
            if s0 <= m.start() < s1:
                count = default_trip_count
                break
        ops.append(CollectiveOp(kind=kind, result_bytes=rb, groups=groups,
                                source_target_pairs=pairs, count=count,
                                line=line.strip()[:400]))
    return ops


def collective_summary(ops: list[CollectiveOp]) -> dict[str, dict[str, float]]:
    """Aggregate ops by kind: occurrence count and total per-device bytes."""
    out: dict[str, dict[str, float]] = {}
    for op in ops:
        d = out.setdefault(op.kind, {"ops": 0.0, "bytes": 0.0})
        d["ops"] += op.count
        d["bytes"] += op.result_bytes * op.count
    return out
