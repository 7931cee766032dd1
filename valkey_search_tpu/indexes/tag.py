"""Tag index: normalized tag values → doc-id postings, device bitmask predicates.

Reference: src/indexes/tag.{h,cc} — a rax radix tree mapping each normalized
tag to a size-adaptive bag of interned key pointers (tag.h:33-43), with
configurable separator and case sensitivity, searched by
``Tag::Search``/``ParseSearchTags`` (tag.h:142-148).

Device design: the authoritative structure is a host hash map tag →
doc-id set (sorted key list for prefix walks); the query path materializes a *device
bool bitmask over doc ids* for each queried tag disjunction — cached per
tag value and invalidated on mutation — so the predicate can be fused
straight into the vector distance kernels (the planner's inline-filter
path) or intersected on-device for the pre-filter path.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set

import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.base import EntriesFetcher, IndexBase, RecordResult
from valkey_search_tpu.runtime import config
from valkey_search_tpu.utils.interning import KeyInterner


def parse_tags(raw: str, separator: str, case_sensitive: bool) -> List[str]:
    """Split a tag field value; mirrors reference tag parsing: split on the
    separator, trim surrounding whitespace, casefold unless case-sensitive,
    drop empties."""
    out = []
    max_len = int(config.get("search.max-tag-field-len"))
    for part in raw.split(separator):
        t = part.strip()
        if not t:
            continue
        if len(t) > max_len:
            continue
        out.append(t if case_sensitive else t.casefold())
    return out


class TagIndex(IndexBase):
    kind = "TAG"
    mutation_weight = 1.0

    def __init__(
        self,
        interner: Optional[KeyInterner] = None,
        separator: str = ",",
        case_sensitive: bool = False,
    ):
        if len(separator) != 1:
            raise ValueError("tag separator must be a single character")
        self.separator = separator
        self.case_sensitive = case_sensitive
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        self._postings: Dict[str, Set[int]] = {}
        self._doc_tags: Dict[int, Set[str]] = {}
        self._tracked: Dict[str, int] = {}
        self._untracked: Set[str] = set()  # keys seen with empty/invalid tags
        # raw-value column for the columnar GROUPBY fast path
        # (server/ft_aggregate.py): per-doc interned id of the UNPARSED
        # field value — GROUPBY groups by the raw document string (the
        # reference loads field content per row, ft_aggregate.cc
        # CreateRecordsFromNeighbors), not by the normalized tag set.
        self._doc_val = np.full(64, -1, np.int32)
        self._vals: List[str] = []
        self._val_ids: Dict[str, int] = {}
        # untracked keys (empty/invalid tag parse) still carry a raw field
        # value the generic GROUPBY would group under; they have no stable
        # doc id owned by this index, so they live in a key-keyed side map
        # and value_counts() resolves them via the interner (rare path)
        self._untracked_raw: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._mask_cache: Dict[str, jnp.ndarray] = {}
        self._mask_cache_cap = 0
        self._sorted_cache: Optional[List[str]] = None
        self.epoch = 0

    def memory_bytes(self) -> int:
        with self._lock:
            b = 0
            for tag, docs in self._postings.items():
                b += 64 + len(tag) + 32 * len(docs)
            for _doc, tags in self._doc_tags.items():
                b += 64 + 48 * len(tags)
            b += 72 * (len(self._tracked) + len(self._untracked))
            b += self._doc_val.nbytes
            b += sum(120 + len(v) for v in self._vals)
            b += sum(96 + len(k) + len(v)
                     for k, v in self._untracked_raw.items())
            return b

    # -- mutation ------------------------------------------------------------
    def add_record(self, key: str, value: str) -> RecordResult:
        # hash values arrive as raw bytes over the wire; tags are text
        # (the reference reads hash fields as byte strings and parses them
        # as UTF-8 tag lists, tag.cc ParseSearchTags)
        if isinstance(value, (bytes, bytearray)):
            # raw column value: surrogateescape matches what the generic
            # GROUPBY's content fetch would coerce to (_coerce in
            # server/ft_aggregate.py); tag PARSING keeps strict utf-8
            raw = bytes(value).decode(errors="surrogateescape")
            try:
                value = bytes(value).decode("utf-8")
            except UnicodeDecodeError:
                value = ""
        else:
            raw = str(value)
        tags = parse_tags(str(value), self.separator, self.case_sensitive)
        with self._lock:
            existed = key in self._tracked
            if not tags:
                # untracked-keys extras: key exists but has no indexable tags
                # (reference negate/untracked handling, tag.h Search negate)
                if existed:
                    self._remove_locked(key)
                self._untracked.add(key)
                self._untracked_raw[key] = raw
                return RecordResult.SKIPPED
            doc = self.interner.intern(key)
            if existed:
                self._clear_doc(doc)
            self._untracked.discard(key)
            self._untracked_raw.pop(key, None)
            self._tracked[key] = doc
            self._doc_tags[doc] = set(tags)
            self._set_raw(doc, raw)
            for t in tags:
                if t not in self._postings:
                    self._postings[t] = set()
                    self._sorted_cache = None
                self._postings[t].add(doc)
                self._mask_cache.pop(t, None)
            self.epoch += 1
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def modify_record(self, key: str, value: str) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        with self._lock:
            self._untracked.discard(key)
            self._untracked_raw.pop(key, None)
            if key not in self._tracked:
                return RecordResult.SKIPPED
            self._remove_locked(key)
            return RecordResult.REMOVED

    def _remove_locked(self, key: str) -> None:
        doc = self._tracked.pop(key)
        self._clear_doc(doc)
        if doc < len(self._doc_val):
            self._doc_val[doc] = -1
        if self._owns_interner:
            self.interner.release(key)
        self.epoch += 1

    def _set_raw(self, doc: int, raw: str) -> None:
        """Record the raw field value for ``doc`` in the columnar store."""
        vid = self._val_ids.get(raw)
        if vid is None:
            vid = len(self._vals)
            self._vals.append(raw)
            self._val_ids[raw] = vid
        if doc >= len(self._doc_val):
            grow = max(64, len(self._doc_val), doc + 1 - len(self._doc_val))
            self._doc_val = np.concatenate(
                [self._doc_val, np.full(grow, -1, np.int32)]
            )
        self._doc_val[doc] = vid

    def value_counts(self, docs: np.ndarray):
        """Columnar GROUPBY+COUNT over the raw-value column: for the doc-id
        array of a match set (ascending), return ``[(raw_value_or_None,
        count)]`` in first-occurrence order — exactly the groups and order
        the generic per-row pipeline would produce (rows iterate in
        ascending doc order for non-vector queries). Docs outside the
        column (never seen by this index) group under None, matching the
        generic path's to_string(None). Returns None when untracked keys
        with raw values exist (their doc ids are not owned here, so the
        caller must fall back to the per-row path). Zero keyspace access —
        the index's own column is the data (reference
        analog is the aggregation mix in the FTS benchmark configs)."""
        with self._lock:
            if self._untracked_raw:
                return None
            col = self._doc_val
            v = np.full(docs.shape, -1, np.int32)
            inb = docs < len(col)
            v[inb] = col[docs[inb]]
            vals, first, counts = np.unique(
                v, return_index=True, return_counts=True
            )
            order = np.argsort(first, kind="stable")
            out = []
            for j in order:
                vid = int(vals[j])
                out.append((
                    self._vals[vid] if vid >= 0 else None, int(counts[j])
                ))
            return out

    def _clear_doc(self, doc: int) -> None:
        for t in self._doc_tags.pop(doc, ()):
            s = self._postings.get(t)
            if s is not None:
                s.discard(doc)
                if not s:
                    del self._postings[t]
                    self._sorted_cache = None
                self._mask_cache.pop(t, None)

    # -- query side ----------------------------------------------------------
    def normalize_query_tag(self, tag: str) -> str:
        t = tag.strip()
        return t if self.case_sensitive else t.casefold()

    def _match_tags(self, pattern: str) -> List[str]:
        """Resolve one query tag pattern to stored tag values.

        A trailing ``*`` performs prefix matching over the sorted tag space
        (the reference walks the rax subtree, radix_tree.h WordIterator);
        otherwise exact. Caller holds the lock."""
        p = self.normalize_query_tag(pattern)
        if p.endswith("*") and len(p) > 1:
            prefix = p[:-1]
            tags = self._sorted_tags()
            import bisect

            lo = bisect.bisect_left(tags, prefix)
            # walk until the prefix no longer holds — a sentinel upper
            # bound like prefix+'￿' sorts BELOW supplementary-plane
            # continuations (e.g. emoji) and would drop them (r2 review)
            out = []
            for t in tags[lo:]:
                if not t.startswith(prefix):
                    break
                out.append(t)
            return out
        return [p] if p in self._postings else []

    def _sorted_tags(self) -> List[str]:
        if self._sorted_cache is None:
            self._sorted_cache = sorted(self._postings)
        return self._sorted_cache

    def posting(self, tag: str) -> Set[int]:
        with self._lock:
            return set(self._postings.get(self.normalize_query_tag(tag), ()))

    def search(self, tags: Iterable[str]) -> EntriesFetcher:
        """OR over tag patterns (reference Tag::Search {a|b*} semantics)."""
        with self._lock:
            acc: Set[int] = set()
            for pat in tags:
                for t in self._match_tags(pat):
                    acc |= self._postings.get(t, set())
            return EntriesFetcher(acc, size=len(acc))

    def docs_array(self, tags: Iterable[str]) -> np.ndarray:
        """Sorted-unique doc ids for a tag union as an ndarray, memoized
        per index epoch — the boolean-combinator fast path (predicate.py
        ids_and/ids_or keep big tag∩text conjunctions vectorized)."""
        key = "\x00".join(sorted(tags))
        with self._lock:
            cache = getattr(self, "_docs_cache", None)
            if cache is None:
                cache = self._docs_cache = {}
            hit = cache.get(key)
            if hit is not None and hit[0] == self.epoch:
                return hit[1]
            acc: Set[int] = set()
            for pat in tags:
                for t in self._match_tags(pat):
                    acc |= self._postings.get(t, set())
            arr = np.fromiter(acc, np.int64, len(acc))
            arr.sort()
            if len(cache) >= 256:
                cache.clear()  # epoch-keyed: droppable
            cache[key] = (self.epoch, arr)
            return arr

    def estimate(self, tags: Iterable[str]) -> int:
        """Upper-bound qualified count for the planner (rax posting sizes /
        prefix subtree counts, reference radix_tree.h:14-56)."""
        with self._lock:
            return sum(
                len(self._postings.get(t, ()))
                for pat in tags
                for t in self._match_tags(pat)
            )

    def device_mask(self, tags: Iterable[str], cap: int) -> jnp.ndarray:
        """Device bool [cap]: True where the doc carries any queried tag."""
        with self._lock:
            if self._mask_cache_cap != cap:
                self._mask_cache.clear()
                self._mask_cache_cap = cap
            acc = None
            for pat in tags:
                for tn in self._match_tags(pat):
                    m = self._mask_cache.get(tn)
                    if m is None:
                        host = np.zeros(cap, bool)
                        ids = [d for d in self._postings.get(tn, ()) if d < cap]
                        if ids:
                            host[np.fromiter(ids, np.int64, len(ids))] = True
                        m = jnp.asarray(host)
                        self._mask_cache[tn] = m
                    acc = m if acc is None else (acc | m)
            if acc is None:
                acc = jnp.zeros(cap, bool)
            return acc

    def doc_matches(self, doc: int, patterns: Iterable[str]) -> bool:
        """Host-side re-verification of one doc (content resolution drops
        keys whose current value no longer matches, response_generator.cc)."""
        with self._lock:
            tags = self._doc_tags.get(doc)
            if not tags:
                return False
            for pat in patterns:
                p = self.normalize_query_tag(pat)
                if p.endswith("*") and len(p) > 1:
                    if any(t.startswith(p[:-1]) for t in tags):
                        return True
                elif p in tags:
                    return True
            return False

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

    def unique_tags(self) -> int:
        with self._lock:
            return len(self._postings)

    def all_docs(self) -> Set[int]:
        with self._lock:
            return set(self._tracked.values())
