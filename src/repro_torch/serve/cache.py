"""ArenaCache: the crash-consistent pattern-fingerprint → verdict cache.

Counterpart of ``repro.serve.cache`` (a copy: stdlib only; the same entry
and snapshot bytes for the same body).
:class:`repro_torch.serve.StrategyService` keys priced strategy verdicts
by content-hash fingerprints of the query patterns
(:func:`repro_torch.comm.delta.pattern_fingerprint`).  This module stores
those entries so a warm service answers a repeated traffic shape without
re-running the sweep, across three tiers:

* **memory** — an LRU-bounded dict, always on;
* **disk** — optional write-through persistence (``path`` directory), one
  file per entry, written atomically (tempfile + ``os.replace``) so a crash
  mid-write leaves either the old entry or no entry, never a torn one;
* **snapshot** — :meth:`ArenaCache.snapshot` / :meth:`ArenaCache.restore`
  serialize the whole memory tier to one JSON-safe dict for warm restarts.

Every on-disk entry (and every snapshot) is versioned and checksummed::

    {"version": 1, "checksum": sha256(canonical-body-json), "body": {...}}

Corruption, partial writes, version skew, or unparseable files detected at
load **degrade to a miss** — the caller rebuilds, a failure event lands in
the :class:`repro_torch.comm.health.BackendHealth` ledger (backend
``'cache'``), and nothing ever raises out of :meth:`ArenaCache.get`.  A
failed disk tier degrades to the memory tier: that is storage, not the
device, so it is no fallback off the card.  Reads and writes pass through
the ``serve.cache_read`` / ``serve.cache_write`` fault sites, so chaos runs
can corrupt or fail any I/O deterministically.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import tempfile
import threading

__all__ = ["ArenaCache", "CACHE_VERSION"]

#: On-disk / snapshot format version; entries from any other version are
#: rejected at load (degrading to a rebuild, never an error).
CACHE_VERSION = 1


def _canonical(body) -> str:
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def _wrap(body) -> str:
    canon = _canonical(body)
    checksum = hashlib.sha256(canon.encode()).hexdigest()
    return json.dumps({"version": CACHE_VERSION, "checksum": checksum,
                       "body": body}, sort_keys=True)


def _unwrap(text: str):
    """Parse + validate one wrapped entry; raises ValueError on anything
    short of a clean, current-version, checksum-true entry."""
    obj = json.loads(text)
    if not isinstance(obj, dict):
        raise ValueError("cache entry is not an object")
    if obj.get("version") != CACHE_VERSION:
        raise ValueError(f"cache version skew: entry v{obj.get('version')!r}"
                         f", this build reads v{CACHE_VERSION}")
    body = obj.get("body")
    canon = _canonical(body)
    if hashlib.sha256(canon.encode()).hexdigest() != obj.get("checksum"):
        raise ValueError("cache entry checksum mismatch (corrupt or torn)")
    return body


class ArenaCache:
    """A crash-consistent key → JSON-body cache with LRU memory and
    optional atomic disk persistence.

    Parameters
    ----------
    path : directory for write-through disk persistence (created on first
        write), or None for a memory-only cache.  Each entry lives in its
        own checksummed file, named by the SHA-256 of its key.
    max_entries : memory-tier LRU bound (>= 1).  Disk entries are not
        evicted — a key aged out of memory reloads from disk on the next
        :meth:`get`.

    The contract: :meth:`get` / :meth:`put` / :meth:`snapshot` /
    :meth:`restore` **never raise** on I/O or data problems — every failure
    degrades to a miss / skipped write plus a health-ledger event under
    backend ``'cache'``.  Thread-safe.
    """

    def __init__(self, path: str | None = None, *, max_entries: int = 1024):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.path = path
        self.max_entries = int(max_entries)
        self._mem: collections.OrderedDict[str, object] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._rejected = 0
        self._write_errors = 0

    # -- stats ----------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        """Entries currently in the memory tier."""
        with self._lock:
            return len(self._mem)

    def stats(self) -> dict:
        """Counters: ``hits`` / ``misses`` (per :meth:`get`), ``rejected``
        (entries refused at load: corruption, version skew, parse failure)
        and ``write_errors`` (disk writes that failed and were skipped)."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "rejected": self._rejected,
                    "write_errors": self._write_errors,
                    "entries": len(self._mem)}

    # -- internals ------------------------------------------------------------
    def _file(self, key: str) -> str:
        return os.path.join(self.path,
                            hashlib.sha256(key.encode()).hexdigest() + ".json")

    def _event(self, site: str, error: Exception) -> None:
        from repro_torch.comm.health import get_health
        get_health().record_failure("cache", site, error)

    def _remember(self, key: str, body) -> None:
        # caller holds no lock
        with self._lock:
            self._mem[key] = body
            self._mem.move_to_end(key)
            while len(self._mem) > self.max_entries:
                self._mem.popitem(last=False)

    # -- the cache contract ---------------------------------------------------
    def get(self, key: str):
        """The entry body stored under ``key``, or None on a miss.

        Memory first; on a memory miss with a disk tier, the entry file is
        read through the ``serve.cache_read`` fault site and validated
        (version + checksum) — any defect degrades to None with a health
        event, never an exception.
        """
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                self._hits += 1
                return self._mem[key]
        if self.path is not None:
            from repro_torch.comm import faults
            fname = self._file(key)
            try:
                faults.fail_point("serve.cache_read")
                if os.path.exists(fname):
                    with open(fname, encoding="utf-8") as f:
                        text = f.read()
                    text = faults.poison("serve.cache_read", text)
                    body = _unwrap(text)
                    self._remember(key, body)
                    with self._lock:
                        self._hits += 1
                    return body
            except Exception as e:  # noqa: BLE001 - degrade, never raise
                with self._lock:
                    self._rejected += 1
                self._event("serve.cache_read", e)
        with self._lock:
            self._misses += 1
        return None

    def put(self, key: str, body) -> None:
        """Store ``body`` (a JSON-serializable dict) under ``key``.

        Always lands in the memory tier; with a disk tier the entry is
        written through the ``serve.cache_write`` fault site as a
        checksummed file via tempfile + atomic rename, so a crash mid-write
        can never leave a torn entry.  A failed write is skipped with a
        health event (the memory tier still serves the entry).
        """
        self._remember(key, body)
        if self.path is None:
            return
        from repro_torch.comm import faults
        try:
            faults.fail_point("serve.cache_write")
            text = faults.poison("serve.cache_write", _wrap(body))
            os.makedirs(self.path, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write(text)
                os.replace(tmp, self._file(key))
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise
        except Exception as e:  # noqa: BLE001 - degrade, never raise
            with self._lock:
                self._write_errors += 1
            self._event("serve.cache_write", e)

    # -- warm restarts --------------------------------------------------------
    def snapshot(self) -> dict:
        """The whole memory tier as one versioned, checksummed, JSON-safe
        dict — hand it to :meth:`restore` on a fresh cache for a warm
        restart."""
        with self._lock:
            entries = dict(self._mem)
        body = {"entries": entries}
        canon = _canonical(body)
        return {"version": CACHE_VERSION,
                "checksum": hashlib.sha256(canon.encode()).hexdigest(),
                "body": json.loads(canon)}

    def restore(self, snapshot: dict) -> int:
        """Load a :meth:`snapshot` into the memory tier; returns how many
        entries landed.

        Version skew, checksum mismatch, or a malformed ``snapshot`` object
        degrades to restoring nothing (0) with a health event — a warm
        restart from a stale or damaged snapshot starts cold, it does not
        crash.
        """
        try:
            body = _unwrap(_canonical(snapshot) if isinstance(snapshot, dict)
                           else snapshot)
            entries = body["entries"]
            if not isinstance(entries, dict):
                raise ValueError("snapshot entries is not a dict")
        except Exception as e:  # noqa: BLE001 - degrade, never raise
            with self._lock:
                self._rejected += 1
            self._event("serve.cache_read", e)
            return 0
        for key, entry in entries.items():
            self._remember(key, entry)
        return len(entries)

    def clear(self) -> None:
        """Drop the memory tier (disk files are left in place)."""
        with self._lock:
            self._mem.clear()
