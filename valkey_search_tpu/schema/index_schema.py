"""IndexSchema: one index — attribute map, shared doc-id space, ingest routing.

Reference: src/index_schema.{h,cc} — an index schema owns an attribute map
(alias → identifier → IndexBase, index_schema.h:86), subscribes to keyspace
events, and routes each document mutation to the per-attribute indexes
(ProcessAttributeMutation, index_schema.cc:747). Invalid attribute data
removes the key from all indexes (Redisearch compat, index_schema.cc:729).

Device design: all attribute indexes share one KeyInterner so predicates and
vector rows align on a single doc-id space; `docs_valid` and per-attribute
masks are device bool arrays over that space. The synchronous
`upsert`/`delete` below is the write path the mutation queue
(schema.ingestion) drives; queries run against published device snapshots.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.base import IndexBase, RecordResult
from valkey_search_tpu.indexes.flat import FlatVectorIndex
from valkey_search_tpu.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu.indexes.numeric import NumericIndex
from valkey_search_tpu.indexes.tag import TagIndex
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS
from valkey_search_tpu.utils.interning import KeyInterner


@dataclasses.dataclass
class Attribute:
    """alias → stored-field identifier → index instance
    (reference index_schema.h attribute map)."""

    alias: str
    identifier: str
    index: IndexBase

    @property
    def kind(self) -> str:
        return getattr(self.index, "kind", type(self.index).__name__)


class IndexSchema:
    """One search index over a key prefix set."""

    def __init__(
        self,
        name: str,
        prefixes: Sequence[str] = ("",),
        on: str = "HASH",
        db: int = 0,
    ):
        if on not in ("HASH", "JSON"):
            raise ValueError("ON must be HASH or JSON")
        from valkey_search_tpu.schema.attribute_data_type import data_type_for

        self.name = name
        self.prefixes = tuple(prefixes) or ("",)
        self.on = on
        self.data_type = data_type_for(on)
        self.db = db
        self.interner = KeyInterner()
        self.attributes: Dict[str, Attribute] = {}  # by alias
        self._by_identifier: Dict[str, List[Attribute]] = {}
        self._documents: Dict[str, Dict[str, object]] = {}  # key → raw fields
        self._lock = threading.RLock()
        self.created_at = time.time()
        self.version = 0  # bumped per definition change (metadata fingerprint)
        self.mutation_epoch = 0  # bumped per applied mutation (consistency check)
        self.backfill_in_progress = False
        self.backfill_scanned = 0

    # -- definition ----------------------------------------------------------
    def add_tag_attribute(
        self,
        alias: str,
        identifier: Optional[str] = None,
        separator: str = ",",
        case_sensitive: bool = False,
    ) -> Attribute:
        idx = TagIndex(
            interner=self.interner,
            separator=separator,
            case_sensitive=case_sensitive,
        )
        return self._add(alias, identifier, idx)

    def add_numeric_attribute(
        self, alias: str, identifier: Optional[str] = None
    ) -> Attribute:
        return self._add(alias, identifier, NumericIndex(interner=self.interner))

    def add_text_attribute(
        self,
        alias: str,
        identifier: Optional[str] = None,
        no_stem: bool = False,
        with_suffix_trie: bool = True,
        weight: float = 1.0,
    ) -> Attribute:
        from valkey_search_tpu.text.text_index import TextFieldIndex, TextEngine

        if getattr(self, "text_engine", None) is None:
            self.text_engine = TextEngine(
                self, options=getattr(self, "text_options", None)
            )
        idx = TextFieldIndex(
            engine=self.text_engine,
            alias=alias,
            no_stem=no_stem,
            with_suffix_trie=with_suffix_trie,
            weight=weight,
        )
        return self._add(alias, identifier, idx)

    def add_vector_attribute(
        self,
        alias: str,
        identifier: Optional[str] = None,
        algorithm: str = "HNSW",
        dim: int = 0,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_runtime: Optional[int] = None,
        initial_cap: int = 0,
    ) -> Attribute:
        if dim <= 0:
            raise ValueError("vector DIM must be positive")
        if algorithm.upper() == "HNSW":
            idx: IndexBase = HnswVectorIndex(
                dim=dim,
                metric=metric,
                m=m,
                ef_construction=ef_construction,
                ef_runtime=ef_runtime,
                interner=self.interner,
            )
        elif algorithm.upper() == "FLAT":
            idx = FlatVectorIndex(dim=dim, metric=metric, interner=self.interner)
        else:
            raise ValueError(f"unknown vector algorithm {algorithm!r}")
        return self._add(alias, identifier, idx)

    def _add(self, alias: str, identifier: Optional[str], idx: IndexBase) -> Attribute:
        with self._lock:
            if alias in self.attributes:
                raise ValueError(f"duplicate attribute alias {alias!r}")
            if len(self.attributes) >= int(config.get("search.max-attributes")):
                raise ValueError("too many attributes")
            attr = Attribute(alias, identifier or alias, idx)
            self.attributes[alias] = attr
            self._by_identifier.setdefault(attr.identifier, []).append(attr)
            self.version += 1
            return attr

    def attribute(self, alias: str) -> Attribute:
        a = self.attributes.get(alias)
        if a is None:
            raise KeyError(f"unknown attribute @{alias}")
        return a

    def vector_attributes(self) -> List[Attribute]:
        return [a for a in self.attributes.values() if a.kind in ("HNSW", "FLAT")]

    def text_attributes(self) -> List[Attribute]:
        return [a for a in self.attributes.values() if a.kind == "TEXT"]

    # -- key routing ---------------------------------------------------------
    def matches_key(self, key: str) -> bool:
        return any(key.startswith(p) for p in self.prefixes)

    # -- write path ----------------------------------------------------------
    def upsert(self, key: str, fields: Dict[str, object]) -> Dict[str, RecordResult]:
        """Index (or re-index) a document's attribute values.

        ``fields`` holds the raw stored fields (hash fields / JSON paths).
        Attributes whose identifier is absent from ``fields`` are removed for
        this key (the reference fetches a full snapshot of mutated attributes,
        index_schema.cc:591). INVALID_DATA in any attribute removes the key
        from all indexes (index_schema.cc:729).
        """
        results: Dict[str, RecordResult] = {}
        with self._lock:
            self._documents[key] = dict(fields)
            invalid = False
            for attr in self.attributes.values():
                val = self.data_type.fetch(fields, attr.identifier)
                if val is None:
                    r = attr.index.remove_record(key)
                else:
                    r = attr.index.add_record(key, val)
                    if r is RecordResult.INVALID_DATA:
                        invalid = True
                results[attr.alias] = r
            if invalid:
                # Redisearch compat: invalid data in any attribute removes the
                # key from the *index* (the raw document still exists in the
                # keyspace store) — index_schema.cc:729.
                for attr in self.attributes.values():
                    attr.index.remove_record(key)
                self.interner.release(key)
                STATS.incr("documents_dropped_invalid")
                # per-schema gauge (reference stats_.document_drop_... on
                # the IndexSchema; FT.INFO hash_indexing_failures reports
                # THIS index's failures, not a process-wide counter)
                self.indexing_failures = \
                    getattr(self, "indexing_failures", 0) + 1
            else:
                self._maybe_release(key)
            self.mutation_epoch += 1
            return results

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = self._documents.pop(key, None) is not None
            for attr in self.attributes.values():
                attr.index.remove_record(key)
            self.interner.release(key)
            self.mutation_epoch += 1
            return existed

    def _maybe_release(self, key: str) -> None:
        """Free the doc id if no attribute tracks the key anymore."""
        if key not in self._documents:
            return
        for attr in self.attributes.values():
            if attr.index.tracks(key):
                return
        # document exists but indexes nothing → keep raw fields, release id
        self.interner.release(key)

    # -- read helpers --------------------------------------------------------
    def document(self, key: str) -> Optional[Dict[str, object]]:
        with self._lock:
            doc = self._documents.get(key)
            return dict(doc) if doc is not None else None

    def num_docs(self) -> int:
        """Documents in the *index* (≥1 indexed attribute), not raw keyspace
        size — FT.SEARCH '*' and Negate both range over this set."""
        return self.interner.count

    def doc_capacity(self) -> int:
        """Doc-id-space capacity all predicate masks are sized to."""
        cap = max(self.interner.capacity, 1)
        for a in self.vector_attributes():
            if isinstance(a.index, FlatVectorIndex):
                cap = max(cap, a.index.store.capacity)
        return cap

    def docs_valid_mask(self, cap: int) -> jnp.ndarray:
        """Device bool [cap]: allocated doc ids (for Negate / match-all).
        Cached per (interner.epoch, cap) so repeated queries reuse the
        device-resident mask instead of rebuilding + re-uploading."""
        with self._lock:
            cache = getattr(self, "_valid_mask_cache", None)
            key = (self.interner.epoch, cap)
            if cache is not None and cache[0] == key:
                return cache[1]
            mask = jnp.asarray(self.interner.valid_ids_np(cap))
            self._valid_mask_cache = (key, mask)
            return mask

    def doc_keys(self, docs: Sequence[int]) -> List[Optional[str]]:
        return [self.interner.key_of(int(d)) for d in docs]

    def memory_pools(self) -> Dict[str, int]:
        """Per-subsystem resident bytes (reference text_index.h:50-55
        MemoryPools + malloc-interposition accounting): vector stores +
        graphs, tag/numeric structures, text dictionary/postings/trees,
        and the key interner."""
        pools = {"vector": 0, "tag": 0, "numeric": 0, "text": 0,
                 "interner": 0}
        with self._lock:
            for a in self.attributes.values():
                if a.kind in ("HNSW", "FLAT"):
                    pools["vector"] += a.index.memory_bytes()
                elif a.kind == "TAG":
                    pools["tag"] += a.index.memory_bytes()
                elif a.kind == "NUMERIC":
                    pools["numeric"] += a.index.memory_bytes()
            eng = getattr(self, "text_engine", None)
            if eng is not None:
                pools["text"] = eng.bytes_used()
            pools["interner"] = self.interner.memory_bytes()
        return pools

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "name": self.name,
                "on": self.on,
                "prefixes": list(self.prefixes),
                "num_docs": self.interner.count,
                "num_attributes": len(self.attributes),
                "doc_capacity": self.doc_capacity(),
                "mutation_epoch": self.mutation_epoch,
                "backfill_in_progress": self.backfill_in_progress,
                "attributes": {
                    alias: {"type": a.kind, "identifier": a.identifier,
                            "tracked": a.index.count(),
                            "memory": getattr(
                                a.index, "memory_bytes", lambda: 0)()}
                    for alias, a in self.attributes.items()
                },
            }
