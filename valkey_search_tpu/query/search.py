"""Search executor: parsed query → device kernels → neighbors.

Reference: src/query/search.{h,cc} — ``Search`` (search.cc:844) runs under
the reader lock, choosing DoSearchVector (:692 — inline filter functor vs
exact-over-prefiltered-set) or DoSearchNonVector (:607 — fetcher scan with
dedup), then trims via the LIMIT buffer multiplier (:744).

Device mapping: the reader lock becomes the published device snapshot; the
inline filter functor becomes a doc-space bitmask fused into the beam
kernel; the prefiltered exact path becomes a masked blocked-matmul scan;
the non-vector fetcher scan becomes one device mask reduced to ids on host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from valkey_search_tpu.indexes.flat import FlatVectorIndex
from valkey_search_tpu.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu.query import parser as qparser
from valkey_search_tpu.query import planner
from valkey_search_tpu.query import predicate as P
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS, timed


class QueryError(ValueError):
    pass


@dataclasses.dataclass
class SearchParameters:
    """Parsed FT.SEARCH request (reference query::SearchParameters,
    search.h:193-320)."""

    index_name: str
    query: str
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    limit_offset: int = 0
    limit_num: int = 10
    no_content: bool = False
    return_fields: Optional[List[Tuple[str, str]]] = None  # (field, as_name)
    timeout_ms: Optional[int] = None
    sortby: Optional[str] = None
    sortby_desc: bool = False
    withsortkeys: bool = False
    ef_runtime: Optional[int] = None
    local_only: bool = False
    # columnar consumers (FT.AGGREGATE's index-columnar GROUPBY) want the
    # raw doc-id ndarray, not materialized Neighbor rows — building tens
    # of thousands of row objects is the non-vector path's top cost
    docs_only: bool = False


class Neighbor:
    """Result row (key, distance, doc). Hand-rolled __slots__ class: a
    result window constructs tens of thousands of these per query, and
    the generated dataclass __init__ was the top cost of a 10k-row
    aggregate's profile."""

    __slots__ = ("key", "distance", "doc")

    def __init__(self, key, distance=None, doc=-1):
        self.key = key
        self.distance = distance  # None for non-vector queries
        self.doc = doc

    def __repr__(self):
        return f"Neighbor({self.key!r}, {self.distance}, {self.doc})"


@dataclasses.dataclass
class SearchResponse:
    total: int
    neighbors: List[Neighbor]
    score_field: Optional[str] = None  # e.g. "__vec_score"
    partial: bool = False
    predicate: Optional[P.Predicate] = None
    knn: Optional[qparser.KnnClause] = None
    # schema.mutation_epoch at snapshot time: content resolution skips
    # per-row re-verification when the epoch is unchanged (reference
    # PerformKeyContentionCheck compares per-key sequence numbers,
    # index_schema.cc:1917 — an unchanged epoch proves no key changed)
    epoch: int = -1
    # docs_only result: ascending doc-id ndarray instead of neighbors
    # (materialize_neighbors() converts on fallback)
    doc_array: Optional["np.ndarray"] = None


def execute_search(schema, sp: SearchParameters, token=None) -> SearchResponse:
    """Run one search against a schema's published snapshots."""
    from valkey_search_tpu.utils import cancel

    t0 = time.perf_counter()
    # Snapshot the epoch BEFORE reading any index state: a mutation that
    # applies mid-query (e.g. while the KNN program compiles) must make
    # this response fail the content-resolution epoch fast-path, or a
    # stale result computed from the pre-mutation postings would ship
    # unverified (the reference's per-neighbor sequence numbers are
    # likewise captured at snapshot time, index_schema.cc:1917).
    epoch0 = getattr(schema, "mutation_epoch", -1)
    if token is None:
        token = cancel.from_timeout_ms(sp.timeout_ms)
    token.check()
    pred, knn = qparser.parse_query(sp.query, sp.params)
    ctx = P.EvalContext(schema)
    if knn is not None:
        # no post-kernel check: once the device kernel has produced the
        # result, discarding it on deadline wastes the work (first-compile
        # can exceed any reasonable query timeout); the token gates work
        # about to start, matching the reference's loop-entry checks.
        resp = _search_vector(schema, ctx, pred, knn, sp)
    else:
        resp = _search_non_vector(schema, ctx, pred, sp, token)
    resp.predicate = pred
    resp.knn = knn
    resp.epoch = epoch0
    STATS.sampler("query_execution", 1).observe_usec(
        (time.perf_counter() - t0) * 1e6
    )
    return resp


def _search_vector(schema, ctx, pred, knn, sp) -> SearchResponse:
    attr = schema.attribute(knn.field)
    index = attr.index
    if not isinstance(index, (HnswVectorIndex, FlatVectorIndex)):
        raise QueryError(f"@{knn.field} is not a VECTOR attribute")
    qvec = np.frombuffer(knn.vector, dtype="<f4")
    if qvec.shape[0] != index.dim:
        raise QueryError(
            f"query vector has {qvec.shape[0]} dims, @{knn.field} expects "
            f"{index.dim}"
        )
    ef = sp.ef_runtime or knn.ef_runtime
    score_field = knn.score_as or f"__{knn.field}_score"
    match_all = isinstance(pred, P.MatchAll)

    if match_all:
        # Unfiltered KNN goes through the query batcher: concurrent reader
        # threads coalesce into one device launch (P1 batched execution,
        # query/batcher.py).
        from valkey_search_tpu.query import batcher

        use_ef = ef if isinstance(index, HnswVectorIndex) else None
        d_row, doc_row = batcher.submit(index, qvec, knn.k, use_ef).result()
        d, docs = d_row[None], doc_row[None]
        STATS.incr("vector_searches_unfiltered")
    else:
        qualified = pred.estimate(ctx)
        mask = pred.device_mask(ctx)
        if planner.use_prefiltering(qualified, index):
            # exact scoring over the qualified set (search.cc:456)
            if isinstance(index, HnswVectorIndex):
                d, docs = index.exact_search_batch(qvec[None], knn.k, mask)
            else:
                d, docs = index.search_batch(qvec[None], knn.k, filter_mask=mask)
            STATS.incr("vector_searches_prefiltered")
        else:
            d, docs = index.search_batch(qvec[None], knn.k, ef=ef, filter_mask=mask)
            STATS.incr("vector_searches_inline_filtered")

    neighbors = []
    for dist, doc in zip(d[0], docs[0]):
        if doc < 0 or not np.isfinite(dist):
            continue
        key = schema.interner.key_of(int(doc))
        if key is not None:
            neighbors.append(Neighbor(key, float(dist), int(doc)))
    return SearchResponse(
        total=len(neighbors), neighbors=neighbors, score_field=score_field
    )


def _search_non_vector(schema, ctx, pred, sp, token=None) -> SearchResponse:
    """Fetcher-scan path (search.cc:607): host-set predicate resolution,
    capped by search.max-non-vector-search-results-fetched. Non-vector
    queries never touch the device — host posting sets are the fetchers;
    device masks exist to fuse predicates into the vector kernels."""
    cap_results = int(config.get("search.max-non-vector-search-results-fetched"))
    if sp.sortby is None:
        # LIMIT-aware cap (reference trims to LIMIT x buffer-multiplier
        # before the main-thread content fetch, search.cc:744-779);
        # SORTBY needs the full window since sort keys come from content
        mult = max(1, int(config.get("search.search-result-buffer-multiplier")))
        cap_results = min(cap_results, (sp.limit_offset + sp.limit_num) * mult)
    ids = pred.host_ids(ctx)
    if isinstance(ids, np.ndarray):
        arr = ids.astype(np.int64, copy=False)
    else:
        arr = np.fromiter(ids, np.int64, len(ids)) \
            if not isinstance(ids, (list, tuple)) else np.asarray(ids, np.int64)
    total = int(arr.size)
    # smallest cap_results ids in ascending order WITHOUT sorting the full
    # match set: np.partition is O(n) vs sorted()'s O(n log n) — hot terms
    # match most of the corpus while LIMIT wants a handful
    if cap_results < total:
        arr = np.partition(arr, cap_results - 1)[:cap_results]
    arr = np.sort(arr)
    if token is not None:
        token.check()  # cancel checkpoint (search.cc:672)
    STATS.incr("non_vector_searches")
    if sp.docs_only:
        return SearchResponse(total=total, neighbors=[], doc_array=arr)
    docs = arr.tolist()
    keys = schema.interner.keys_of(docs)
    # positional construction: kwargs add ~40% per-object overhead and a
    # hot-term window builds thousands of rows
    neighbors = [
        Neighbor(key, None, doc)
        for key, doc in zip(keys, docs) if key is not None
    ]
    return SearchResponse(total=total, neighbors=neighbors)


def materialize_neighbors(schema, resp: SearchResponse) -> None:
    """Fallback for a docs_only response whose consumer could not stay
    columnar: build the Neighbor rows the normal path would have."""
    if resp.doc_array is None:
        return
    docs = resp.doc_array.tolist()
    keys = schema.interner.keys_of(docs)
    resp.neighbors = [
        Neighbor(key, None, doc)
        for key, doc in zip(keys, docs) if key is not None
    ]
    resp.doc_array = None
