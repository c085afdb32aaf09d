"""Typed input validation for communication patterns (the ``PatternError``
hierarchy).

A NaN-sized message silently poisons every float aggregate downstream, a
negative rank indexes the wrong bin, and an arena whose packed keys exceed
``int32`` cannot ship to the device.  This module rejects all of them
*before* they reach the kernels, with precise, typed errors:

* :class:`PatternError` — base class, a ``ValueError`` (so callers that
  catch ``ValueError`` keep working);
* :class:`MessageSizeError` — NaN / infinite / negative message sizes;
* :class:`RankError` — negative or out-of-range endpoint ranks, bad
  process counts;
* :class:`ArenaOverflowError` — ranks beyond the ``int32`` index range of
  the arena's device columns.

Entry points: :func:`validate_messages` (one message set) and
:func:`validate_phase` (a built phase or pattern, duck-typed).  Wired into
:meth:`repro_torch.comm.phase.CommPhase.build` (``validate=True``) and the
array-level entry points that take ``validate=`` —
:func:`repro_torch.core.models.phase_cost` and
:func:`repro_torch.net.simulator.simulate_phase`.

Port note: host numpy, O(messages), a few vectorized reductions; the
checks, their order and their messages are the reference's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PatternError", "MessageSizeError", "RankError",
           "ArenaOverflowError", "validate_messages", "validate_phase",
           "INT32_MAX"]

#: The arena's index ceiling: ranks beyond this cannot ship as int32
#: device columns.
INT32_MAX = np.iinfo(np.int32).max


class PatternError(ValueError):
    """Base class for typed communication-pattern validation errors."""


class MessageSizeError(PatternError):
    """A message size is NaN, infinite, or negative."""


class RankError(PatternError):
    """An endpoint rank is negative, non-integral, or out of range."""


class ArenaOverflowError(PatternError):
    """Ranks exceed the int32 range of the arena's device columns."""


def _first_bad(mask: np.ndarray) -> int:
    """Index of the first True element (callers guarantee one exists)."""
    return int(np.argmax(mask))


def validate_messages(src, dst, size, n_procs: int | None = None, *,
                      where: str = "pattern") -> None:
    """Validate one message set ``(src, dst, size)``; raise a typed error.

    Checks, in order (first violation raises, naming the offending index
    and value):

    * ``src`` / ``dst`` / ``size`` are one-dimensional and equal-length
      (:class:`PatternError`);
    * endpoint ranks are integral, non-negative, and — when ``n_procs`` is
      given — below it (:class:`RankError`);
    * ``n_procs``, when given, is a positive integer (:class:`RankError`);
    * sizes are finite and non-negative: NaN, ``inf`` and negative byte
      counts all raise (:class:`MessageSizeError`);
    * ranks fit the arena's int32 device columns
      (:class:`ArenaOverflowError`).

    ``where`` labels the message set in error text (e.g. a scenario name).
    An empty message set is valid.  O(messages), fully vectorized.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    size = np.asarray(size)
    if src.ndim != 1 or dst.ndim != 1 or size.ndim != 1:
        raise PatternError(
            f"{where}: src/dst/size must be one-dimensional arrays, got "
            f"shapes {src.shape}/{dst.shape}/{size.shape}")
    if not (src.shape == dst.shape == size.shape):
        raise PatternError(
            f"{where}: src/dst/size lengths differ "
            f"({src.size}/{dst.size}/{size.size})")
    if n_procs is not None:
        n_procs = int(n_procs)
        if n_procs < 1:
            raise RankError(f"{where}: n_procs must be >= 1, got {n_procs}")
    for name, ranks in (("src", src), ("dst", dst)):
        if ranks.size == 0:
            continue
        if not np.issubdtype(ranks.dtype, np.integer):
            f = np.asarray(ranks, dtype=np.float64)
            if not np.isfinite(f).all() or (f != np.trunc(f)).any():
                bad = _first_bad(~np.isfinite(f) | (f != np.trunc(f)))
                raise RankError(
                    f"{where}: {name}[{bad}] = {ranks[bad]!r} is not an "
                    "integral rank")
            ranks = f.astype(np.int64)
        lo, hi = int(ranks.min()), int(ranks.max())
        if lo < 0:
            bad = _first_bad(ranks < 0)
            raise RankError(
                f"{where}: {name}[{bad}] = {ranks[bad]} is negative")
        if n_procs is not None and hi >= n_procs:
            bad = _first_bad(ranks >= n_procs)
            raise RankError(
                f"{where}: {name}[{bad}] = {ranks[bad]} is out of range for "
                f"n_procs = {n_procs}")
        if hi > INT32_MAX:
            raise ArenaOverflowError(
                f"{where}: {name} reaches {hi}, beyond the int32 range of "
                f"the arena's device columns (max {INT32_MAX})")
    if size.size:
        sz = np.asarray(size, dtype=np.float64)
        bad_mask = ~np.isfinite(sz)
        if bad_mask.any():
            bad = _first_bad(bad_mask)
            raise MessageSizeError(
                f"{where}: size[{bad}] = {sz[bad]} is not finite")
        if (sz < 0).any():
            bad = _first_bad(sz < 0)
            raise MessageSizeError(
                f"{where}: size[{bad}] = {sz[bad]} is negative")


def validate_phase(phase, *, where: str | None = None) -> None:
    """Validate a built pattern/phase (anything with ``src`` / ``dst`` /
    ``size`` and optionally ``n_procs`` — a
    :class:`repro_torch.sparse.partition.CommPattern` or a bound
    :class:`repro_torch.comm.phase.CommPhase`).

    ``where`` labels the object in error text (default: its class name).
    Delegates to :func:`validate_messages`.
    """
    if where is None:
        where = type(phase).__name__
    validate_messages(phase.src, phase.dst, phase.size,
                      n_procs=getattr(phase, "n_procs", None), where=where)
