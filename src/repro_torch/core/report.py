"""Model-vs-measured reporting (the paper's Figs. 1-11 as tables).

Port note: host Python over the host floats of
:class:`~repro_torch.core.models.CostBreakdown`, string-equal to the
reference's tables.
"""
from __future__ import annotations

from .models import CostBreakdown, MODEL_LEVELS


def accuracy_row(measured: float, ladder: dict[str, CostBreakdown]) -> dict:
    """One phase: measured time + every model level's prediction and rel-error."""
    row: dict[str, float] = {"measured": measured}
    for lvl in MODEL_LEVELS:
        if lvl in ladder:
            t = ladder[lvl].total
            row[lvl] = t
            row[f"{lvl}_relerr"] = abs(t - measured) / measured if measured else 0.0
    return row


def format_table(rows: list[dict], columns: list[str] | None = None,
                 title: str = "") -> str:
    if not rows:
        return f"{title}\n(empty)"
    columns = columns or list(rows[0].keys())
    widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows)) for c in columns}
    lines = []
    if title:
        lines.append(title)
    lines.append("  ".join(c.rjust(widths[c]) for c in columns))
    for r in rows:
        lines.append("  ".join(_fmt(r.get(c)).rjust(widths[c]) for c in columns))
    return "\n".join(lines)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e4 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4f}"
    return str(v)
