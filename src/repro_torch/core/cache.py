"""Reuse caches for UDF results (§4.3, UC2) — id-keyed, content-keyed, layered.

Three classes, one probe/put surface:

``ReuseCache``
    Keyed by (udf_name, row_id) — row ids are stable source identifiers
    (e.g. video frame id x object index), so results cached by one query
    are reused by later queries over overlapping ranges (the paper's
    exploratory-analysis pattern). Optionally spills to disk (npz) to
    mirror the paper's on-disk KV store. Hardened:

    * the ``path`` is normalized to the ``.npz`` extension once at
      construction (``np.savez`` appends it on write, so an extension-less
      path used to read back cold);
    * ``flush`` groups rows by (dtype, shape) so heterogeneous values
      (e.g. a detector returning variable-length boxes) round-trip instead
      of crashing ``np.stack``;
    * ``flush`` writes to a temp file and ``os.replace``s it — a crash
      mid-write never corrupts the previous snapshot — and ``_load``
      tolerates a corrupt/empty file by starting cold with a warning;
    * ``probe`` vectorizes membership over a sorted id index and
      ``hit_rate`` takes a values-free path (``hit_mask``) — both sit on
      the REUSE-AWARE routing hot path.

``ContentHashCache``
    Keyed by (udf_name, digest of the row PAYLOAD), so repeated or
    overlapping queries hit even when their row ids differ — the same
    frame re-ingested under a new scan id still skips the kernel launch.
    Knobs: ``ttl_s`` (entries older than the TTL read as misses and are
    evicted lazily; ``None`` = never expire) and explicit
    ``invalidate(udf=None)`` (drop one UDF's entries, or everything —
    the hook for upstream data changes the digest cannot see, e.g. a
    model-weight update that changes what the UDF would return).

``LayeredReuseCache``
    The cross-query composition: an id layer (fast, disk-spillable) over a
    content layer (id-agnostic, TTL-bounded). Probes check ids first and
    fall through to content digests for the misses; content hits are
    promoted into the id layer under the probing query's row ids so the
    next probe for the same ids is a pure index lookup. This is what the
    REUSE-AWARE policy reads: ``hit_rate(udf, row_ids, data=...)`` feeds
    the paper's ``(1 - hit_rate) x cost`` routing estimate with real
    cross-run hits.

Digests cover only the UDF's input columns (callers pass the
column-restricted batch data), include dtype/shape, and use 64-bit
blake2b — one hash per row at Hydro's ~10-row routing-batch granularity.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np


def row_digests(data: Dict[str, np.ndarray]) -> np.ndarray:
    """(rows,) int64 content digests over the given columns.

    Column name, dtype, and trailing shape are folded into each row's
    digest so reinterpretations of the same bytes cannot collide."""
    cols = sorted(data)
    arrs = [np.ascontiguousarray(np.asarray(data[c])) for c in cols]
    rows = len(arrs[0]) if arrs else 0
    out = np.empty(rows, np.int64)
    for i in range(rows):
        h = hashlib.blake2b(digest_size=8)
        for c, a in zip(cols, arrs):
            r = a[i]
            h.update(repr((c, a.dtype.str, r.shape)).encode())
            h.update(r.tobytes())
        out[i] = int.from_bytes(h.digest(), "little", signed=True)
    return out


class ReuseCache:
    """Id-keyed result cache; see module docstring for the layer picture."""

    def __init__(self, path: Optional[str] = None):
        self._data: Dict[str, Dict[int, np.ndarray]] = {}
        # per-udf sorted id arrays for vectorized probes; rebuilt lazily
        # after a put invalidates them
        self._index: Dict[str, np.ndarray] = {}
        self._lock = threading.RLock()
        # np.savez appends ".npz" when the target lacks it, so an
        # un-normalized path would WRITE cache.npz but READ (and miss) the
        # literal path — the next process would silently start cold.
        if path and not path.endswith(".npz"):
            path += ".npz"
        self.path = path
        if path and os.path.exists(path):
            self._load()

    # ----------------------------- core ----------------------------- #
    def _sorted_ids(self, udf: str) -> np.ndarray:
        idx = self._index.get(udf)
        if idx is None:
            table = self._data.get(udf, {})
            idx = np.fromiter(table.keys(), np.int64, count=len(table))
            idx.sort()
            self._index[udf] = idx
        return idx

    def _hit_mask_locked(self, udf: str, ids: np.ndarray) -> np.ndarray:
        keys = self._sorted_ids(udf)
        if keys.size == 0 or ids.size == 0:
            return np.zeros(ids.size, bool)
        pos = np.searchsorted(keys, ids)
        pos = np.minimum(pos, keys.size - 1)
        return keys[pos] == ids

    @staticmethod
    def _as_ids(row_ids: np.ndarray) -> np.ndarray:
        return np.asarray(row_ids).astype(np.int64, copy=False).ravel()

    def hit_mask(self, udf: str, row_ids: np.ndarray) -> np.ndarray:
        """Vectorized per-row hit mask WITHOUT materializing values."""
        with self._lock:
            return self._hit_mask_locked(udf, self._as_ids(row_ids))

    def probe(self, udf: str, row_ids: np.ndarray) -> Tuple[np.ndarray, list]:
        """(hit_mask (rows,), values list aligned to rows; None on miss)."""
        with self._lock:
            ids = self._as_ids(row_ids)
            hits = self._hit_mask_locked(udf, ids)
            table = self._data.get(udf, {})
            vals: List[Optional[np.ndarray]] = [
                table[r] if h else None
                for r, h in zip(ids.tolist(), hits.tolist())
            ]
            return hits, vals

    def hit_rate(self, udf: str, row_ids: np.ndarray, data=None) -> float:
        """Values-free: one vectorized membership test, nothing fetched.

        ``data`` is accepted (and ignored) so callers can pass batch
        payloads uniformly; the content-aware layers actually use it."""
        hits = self.hit_mask(udf, row_ids)
        return float(hits.mean()) if hits.size else 0.0

    def put(self, udf: str, row_ids: np.ndarray, values) -> None:
        with self._lock:
            table = self._data.setdefault(udf, {})
            for rid, v in zip(self._as_ids(row_ids).tolist(), values):
                table[rid] = np.asarray(v)
            self._index.pop(udf, None)

    # batch-aware aliases: the worker calls these uniformly; the id-keyed
    # base ignores the payload, the layered cache digests it
    def probe_batch(self, udf: str, row_ids: np.ndarray,
                    data=None) -> Tuple[np.ndarray, list]:
        return self.probe(udf, row_ids)

    def put_batch(self, udf: str, row_ids: np.ndarray, data, values) -> None:
        self.put(udf, row_ids, values)

    def invalidate(self, udf: Optional[str] = None) -> None:
        with self._lock:
            if udf is None:
                self._data.clear()
                self._index.clear()
            else:
                self._data.pop(udf, None)
                self._index.pop(udf, None)

    def __contains__(self, udf: str) -> bool:
        with self._lock:
            return udf in self._data and bool(self._data[udf])

    def size(self, udf: str) -> int:
        with self._lock:
            return len(self._data.get(udf, {}))

    # ----------------------------- disk ----------------------------- #
    def flush(self) -> None:
        """Atomic snapshot: rows grouped by (dtype, shape) so ragged values
        round-trip; temp file + ``os.replace`` so a crash mid-write leaves
        the previous snapshot intact."""
        if not self.path:
            return
        with self._lock:
            blob = {}
            for udf, table in self._data.items():
                if not table:
                    continue
                groups: Dict[tuple, List[int]] = {}
                for rid, v in table.items():
                    groups.setdefault((v.dtype.str, v.shape), []).append(rid)
                for gi, key in enumerate(sorted(groups)):
                    ids = np.array(sorted(groups[key]), dtype=np.int64)
                    vals = np.stack([table[int(i)] for i in ids])
                    blob[f"{udf}__g{gi}__ids"] = ids
                    blob[f"{udf}__g{gi}__vals"] = vals
            tmp = self.path + ".tmp.npz"  # ends in .npz: savez won't rename
            try:
                np.savez(tmp, **blob)
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)

    def _load(self) -> None:
        try:
            with np.load(self.path, allow_pickle=False) as data:
                for key in data.files:
                    if not key.endswith("__ids"):
                        continue
                    base = key[: -len("__ids")]
                    # grouped layout "udf__g<N>"; legacy files are "udf"
                    udf, sep, g = base.rpartition("__g")
                    if not (sep and g.isdigit()):
                        udf = base
                    ids = data[key]
                    vals = data[base + "__vals"]
                    table = self._data.setdefault(udf, {})
                    for i, v in zip(ids, vals):
                        table[int(i)] = v
        except Exception as e:
            # a corrupt/truncated snapshot (e.g. a crash before flush went
            # atomic) must not take the process down at construction —
            # starting cold only costs recomputation
            self._data.clear()
            warnings.warn(
                f"ReuseCache: could not load {self.path!r} ({e!r}); "
                "starting cold"
            )
        self._index.clear()


class ContentHashCache:
    """Content-digest-keyed result cache with TTL + explicit invalidation.

    Knobs: ``ttl_s`` — seconds an entry stays probeable (``None`` = no
    expiry); entries past the TTL read as misses and are evicted lazily on
    probe. ``clock`` is injectable for deterministic tests. Memory-only:
    cross-process persistence belongs to the id layer (``ReuseCache``)
    after promotion."""

    def __init__(self, ttl_s: Optional[float] = None, *,
                 clock=time.monotonic):
        self.ttl_s = ttl_s
        self.clock = clock
        self._data: Dict[str, Dict[int, Tuple[np.ndarray, float]]] = {}
        self._lock = threading.RLock()

    def _fresh(self, stamped: Tuple[np.ndarray, float], now: float) -> bool:
        return self.ttl_s is None or (now - stamped[1]) <= self.ttl_s

    def probe_digests(self, udf: str,
                      digests: np.ndarray) -> Tuple[np.ndarray, list]:
        with self._lock:
            table = self._data.get(udf, {})
            now = self.clock()
            hits = np.zeros(len(digests), bool)
            vals: List[Optional[np.ndarray]] = [None] * len(digests)
            for i, d in enumerate(np.asarray(digests).tolist()):
                stamped = table.get(d)
                if stamped is None:
                    continue
                if not self._fresh(stamped, now):
                    del table[d]  # lazy TTL eviction
                    continue
                hits[i] = True
                vals[i] = stamped[0]
            return hits, vals

    def hit_mask_digests(self, udf: str, digests: np.ndarray) -> np.ndarray:
        with self._lock:
            table = self._data.get(udf, {})
            now = self.clock()
            return np.fromiter(
                (d in table and self._fresh(table[d], now)
                 for d in np.asarray(digests).tolist()),
                bool, count=len(digests),
            )

    def put_digests(self, udf: str, digests: np.ndarray, values) -> None:
        with self._lock:
            table = self._data.setdefault(udf, {})
            now = self.clock()
            for d, v in zip(np.asarray(digests).tolist(), values):
                table[d] = (np.asarray(v), now)

    # batch-payload convenience surface (mirrors ReuseCache)
    def probe_batch(self, udf: str, row_ids: np.ndarray,
                    data=None) -> Tuple[np.ndarray, list]:
        if not data:
            return np.zeros(len(np.asarray(row_ids)), bool), [None] * len(
                np.asarray(row_ids))
        return self.probe_digests(udf, row_digests(data))

    def put_batch(self, udf: str, row_ids: np.ndarray, data, values) -> None:
        if data:
            self.put_digests(udf, row_digests(data), values)

    def hit_rate(self, udf: str, row_ids: np.ndarray, data=None) -> float:
        if not data:
            return 0.0
        mask = self.hit_mask_digests(udf, row_digests(data))
        return float(mask.mean()) if mask.size else 0.0

    def invalidate(self, udf: Optional[str] = None) -> None:
        """Explicit invalidation: one UDF's entries, or everything."""
        with self._lock:
            if udf is None:
                self._data.clear()
            else:
                self._data.pop(udf, None)

    def size(self, udf: str) -> int:
        with self._lock:
            return len(self._data.get(udf, {}))

    def __contains__(self, udf: str) -> bool:
        with self._lock:
            return udf in self._data and bool(self._data[udf])


class LayeredReuseCache:
    """Id layer over content layer; the cross-query reuse surface.

    ``path`` spills the id layer to disk (same npz store as ``ReuseCache``);
    ``ttl_s``/``clock`` configure the content layer. Pre-built layers can
    be passed instead (``ids=``/``content=``) to share either across
    executors."""

    def __init__(self, path: Optional[str] = None, *,
                 ids: Optional[ReuseCache] = None,
                 content: Optional[ContentHashCache] = None,
                 ttl_s: Optional[float] = None, clock=time.monotonic):
        self.ids = ids if ids is not None else ReuseCache(path)
        self.content = (content if content is not None
                        else ContentHashCache(ttl_s=ttl_s, clock=clock))

    # --------------------------- probing --------------------------- #
    def probe_batch(self, udf: str, row_ids: np.ndarray,
                    data=None) -> Tuple[np.ndarray, list]:
        hits, vals = self.ids.probe(udf, row_ids)
        if data and not hits.all():
            digs = row_digests(data)
            miss = np.nonzero(~hits)[0]
            chits, cvals = self.content.probe_digests(udf, digs[miss])
            promoted_ids, promoted_vals = [], []
            row_arr = np.asarray(row_ids).ravel()
            for j, i in enumerate(miss.tolist()):
                if chits[j]:
                    hits[i] = True
                    vals[i] = cvals[j]
                    promoted_ids.append(int(row_arr[i]))
                    promoted_vals.append(cvals[j])
            if promoted_ids:
                # promotion: the NEXT probe for these ids is a pure
                # sorted-index lookup in the id layer
                self.ids.put(udf, np.asarray(promoted_ids), promoted_vals)
        return hits, vals

    def probe(self, udf: str, row_ids: np.ndarray) -> Tuple[np.ndarray, list]:
        return self.ids.probe(udf, row_ids)

    def hit_mask(self, udf: str, row_ids: np.ndarray) -> np.ndarray:
        return self.ids.hit_mask(udf, row_ids)

    def hit_rate(self, udf: str, row_ids: np.ndarray, data=None) -> float:
        """Values-free across BOTH layers — the ReuseAware routing input."""
        mask = self.ids.hit_mask(udf, row_ids)
        if data and not mask.all():
            digs = row_digests(data)
            miss = np.nonzero(~mask)[0]
            cmask = self.content.hit_mask_digests(udf, digs[miss])
            mask = mask.copy()
            mask[miss[cmask]] = True
        return float(mask.mean()) if mask.size else 0.0

    # --------------------------- writing --------------------------- #
    def put(self, udf: str, row_ids: np.ndarray, values) -> None:
        self.ids.put(udf, row_ids, values)

    def put_batch(self, udf: str, row_ids: np.ndarray, data, values) -> None:
        self.ids.put(udf, row_ids, values)
        if data:
            self.content.put_digests(udf, row_digests(data), values)

    def invalidate(self, udf: Optional[str] = None) -> None:
        self.ids.invalidate(udf)
        self.content.invalidate(udf)

    # --------------------------- inspection ------------------------ #
    def size(self, udf: str) -> int:
        return self.ids.size(udf)

    def __contains__(self, udf: str) -> bool:
        return udf in self.ids or udf in self.content

    @property
    def path(self) -> Optional[str]:
        return self.ids.path

    def flush(self) -> None:
        self.ids.flush()
