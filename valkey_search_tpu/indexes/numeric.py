"""Numeric index: doc → double column with device range predicates.

Reference: src/indexes/numeric.{h,cc} over an order-statistic B+-tree
(src/utils/numeric_btree.h:21-25) giving O(log n) range *counts* for the
planner and range fetchers (half-open bounds + negation via two ranges +
untracked extras, numeric.h:77-121).

Device design: the authoritative store is a dense fp32 column over doc ids
(NaN = absent) mirrored to the device; a range predicate is just
``valid & (lo {<,<=} v) & (v {<,<=} hi)`` computed on-device and fused into
the distance kernel — no tree needed on the query path. Planner counts use
a lazily rebuilt sorted array + searchsorted (O(log n) queries, O(n log n)
amortized rebuild), replacing the B+-tree's order statistics.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Set

import jax
import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.base import EntriesFetcher, IndexBase, RecordResult
from valkey_search_tpu.runtime import config
from valkey_search_tpu.utils.interning import KeyInterner


@jax.jit
def _scatter_vals(col, idx, vals):
    return col.at[idx].set(vals)


def _parse_number(value) -> Optional[float]:
    # overlong numeric strings are invalid data (reference
    # max-numeric-field-length, ft_create_parser.cc:66, default 128)
    if isinstance(value, (str, bytes, bytearray)) and len(value) > int(
        config.get("search.max-numeric-field-length")
    ):
        return None
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    if math.isnan(v):
        return None
    return v


class NumericIndex(IndexBase):
    kind = "NUMERIC"
    mutation_weight = 1.0

    def __init__(self, interner: Optional[KeyInterner] = None):
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        self._values: Dict[int, float] = {}  # doc → value
        self._tracked: Dict[str, int] = {}
        self._untracked: Set[str] = set()
        self._sorted: Optional[np.ndarray] = None  # cached sorted values
        self._sorted_docs: Optional[np.ndarray] = None
        self._column = np.full(2048, np.nan, np.float32)
        self._dirty: set = set()
        self._device: Optional[dict] = None
        self._lock = threading.RLock()
        self.epoch = 0

    def memory_bytes(self) -> int:
        with self._lock:
            b = self._column.nbytes + 72 * (
                len(self._values) + len(self._tracked) + len(self._untracked)
            )
            if self._sorted is not None:
                b += self._sorted.nbytes
            if self._sorted_docs is not None:
                b += self._sorted_docs.nbytes
            return b

    # -- mutation ------------------------------------------------------------
    def add_record(self, key: str, value) -> RecordResult:
        v = _parse_number(value)
        with self._lock:
            existed = key in self._tracked
            if v is None:
                # unparsable numeric → kInvalidData: the schema drops the
                # key from EVERY index (Redisearch compat,
                # index_schema.cc:729; 'bad numbers' oracle dataset)
                if existed:
                    self._remove_locked(key)
                self._untracked.add(key)
                return RecordResult.INVALID_DATA
            doc = self.interner.intern(key)
            self._untracked.discard(key)
            self._tracked[key] = doc
            self._values[doc] = v
            self._set_col(doc, v)
            self._sorted = None
            self.epoch += 1
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def modify_record(self, key: str, value) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        with self._lock:
            self._untracked.discard(key)
            if key not in self._tracked:
                return RecordResult.SKIPPED
            self._remove_locked(key)
            return RecordResult.REMOVED

    def _remove_locked(self, key: str) -> None:
        doc = self._tracked.pop(key)
        self._values.pop(doc, None)
        self._set_col(doc, float("nan"))
        if self._owns_interner:
            self.interner.release(key)
        self._sorted = None
        self.epoch += 1

    def _set_col(self, doc: int, v: float) -> None:
        if doc >= self._column.shape[0]:
            new_cap = max(2048, 1 << int(np.ceil(np.log2(doc + 1))))
            col = np.full(new_cap, np.nan, np.float32)
            col[: self._column.shape[0]] = self._column
            self._column = col
            self._device = None
        self._column[doc] = np.float32(v)
        self._dirty.add(doc)

    # -- planner estimates (order-statistic replacement) ---------------------
    def _ensure_sorted(self):
        if self._sorted is None:
            docs = np.fromiter(self._values.keys(), np.int64, len(self._values))
            vals = np.fromiter(self._values.values(), np.float64, len(self._values))
            order = np.argsort(vals, kind="stable")
            self._sorted = vals[order]
            self._sorted_docs = docs[order]

    def range_count(
        self, lo: float, hi: float, lo_open: bool = False, hi_open: bool = False
    ) -> int:
        """O(log n) count of docs with value in the range (planner sizing;
        reference numeric_btree.h:21-25)."""
        with self._lock:
            if not self._values:
                return 0
            self._ensure_sorted()
            left = np.searchsorted(self._sorted, lo, "right" if lo_open else "left")
            right = np.searchsorted(self._sorted, hi, "left" if hi_open else "right")
            return max(0, int(right - left))

    def range_fetch(
        self, lo: float, hi: float, lo_open: bool = False, hi_open: bool = False
    ) -> EntriesFetcher:
        with self._lock:
            if not self._values:
                return EntriesFetcher((), size=0)
            self._ensure_sorted()
            left = np.searchsorted(self._sorted, lo, "right" if lo_open else "left")
            right = np.searchsorted(self._sorted, hi, "left" if hi_open else "right")
            ids = self._sorted_docs[left:right]
            return EntriesFetcher(ids.tolist(), size=len(ids))

    def range_docs_array(
        self, lo: float, hi: float, lo_open: bool = False,
        hi_open: bool = False
    ) -> np.ndarray:
        """Sorted-unique doc ids in range as an ndarray (one doc has one
        value, so the value-ordered slice is already unique) — the
        boolean-combinator fast path (predicate.py ids_and/ids_or)."""
        with self._lock:
            if not self._values:
                return np.empty(0, np.int64)
            self._ensure_sorted()
            left = np.searchsorted(self._sorted, lo, "right" if lo_open else "left")
            right = np.searchsorted(self._sorted, hi, "left" if hi_open else "right")
            return np.sort(self._sorted_docs[left:right].astype(np.int64))

    # -- device predicate ----------------------------------------------------
    def _ensure_col_cap(self, cap: int) -> None:
        if cap > self._column.shape[0]:
            new_cap = max(2048, 1 << int(np.ceil(np.log2(cap))))
            col = np.full(new_cap, np.nan, np.float32)
            col[: self._column.shape[0]] = self._column
            self._column = col
            self._device = None

    def device_column(self, cap: int) -> jnp.ndarray:
        """fp32 [cap] column (NaN = absent), device-resident and incrementally
        synced — range predicates evaluate on-device with zero host work."""
        with self._lock:
            self._ensure_col_cap(cap)
            col = self._column
            if self._device is None or self._device["cap"] != col.shape[0]:
                self._device = {"col": jnp.asarray(col), "cap": col.shape[0]}
                self._dirty.clear()
            elif self._dirty:
                idx = np.fromiter(self._dirty, np.int32, len(self._dirty))
                self._device = {
                    "col": _scatter_vals(
                        self._device["col"], idx, jnp.asarray(col[idx])
                    ),
                    "cap": col.shape[0],
                }
                self._dirty.clear()
            dev = self._device["col"]
            return dev if dev.shape[0] == cap else dev[:cap]

    def device_mask(
        self,
        lo: float,
        hi: float,
        cap: int,
        lo_open: bool = False,
        hi_open: bool = False,
    ) -> jnp.ndarray:
        col = self.device_column(cap)
        lo_ok = (col > lo) if lo_open else (col >= lo)
        hi_ok = (col < hi) if hi_open else (col <= hi)
        return lo_ok & hi_ok & ~jnp.isnan(col)

    # -- IndexBase -----------------------------------------------------------
    def tracked_keys(self) -> Set[str]:
        with self._lock:
            return set(self._tracked)

    def tracks(self, key: str) -> bool:
        with self._lock:
            return key in self._tracked

    def untracked_keys(self) -> Set[str]:
        with self._lock:
            return set(self._untracked)

    def count(self) -> int:
        with self._lock:
            return len(self._tracked)

    def value_of(self, key: str) -> Optional[float]:
        with self._lock:
            doc = self._tracked.get(key)
            return self._values.get(doc) if doc is not None else None

    def all_docs(self) -> Set[int]:
        with self._lock:
            return set(self._tracked.values())
