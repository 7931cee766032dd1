"""Shared vector-index logic: value parsing, normalization, host store, device sync.

Models reference src/indexes/vector_base.{h,cc}: binary fp32 blob parsing,
cosine normalization with magnitude tracking (NormalizeEmbedding,
vector_base.h:46), key↔id mapping (here delegated to the schema-shared
KeyInterner), prefiltered exact scoring (AddPrefilteredKey, :170 — here a
masked device scan), and reply construction (CreateReply, :177).

Device design: the host keeps the authoritative copy in pinned numpy arrays;
the device holds a mirror refreshed either by scatter-update (few dirty
rows, donated in-place) or full re-upload (bulk change). Queries always run
against the device mirror; the host arrays are the checkpoint source.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.base import IndexBase, RecordResult
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS
from valkey_search_tpu.utils.interning import KeyInterner

VectorLike = Union[bytes, bytearray, memoryview, np.ndarray, Sequence[float]]


def parse_vector(value: VectorLike, dim: int) -> np.ndarray:
    """Decode a vector attribute value into fp32 [dim].

    The reference stores vectors as raw little-endian fp32 blobs in hash
    fields (vector_base.cc record parsing); numpy arrays/sequences are also
    accepted for the Python API.
    """
    if isinstance(value, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(value, dtype="<f4")
    else:
        arr = np.asarray(value, dtype=np.float32)
    arr = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if arr.shape[0] != dim:
        raise ValueError(f"vector has {arr.shape[0]} dims, index expects {dim}")
    if not np.all(np.isfinite(arr)):
        raise ValueError("vector contains non-finite values")
    return arr


def _round_capacity(needed: int, block: int, growth: str = "block") -> int:
    """Round capacity up.

    growth="block": small corpora to 2048-multiples, large to block-multiples
    (flat_topk requires cap % block_rows == 0 once cap > block_rows — the
    reference grows hnsw/flat capacity by a fixed block too, ResizeIfFull,
    vector_hnsw.h:76).
    growth="pow2": geometric doubling — used for HNSW device graphs where
    every capacity change recompiles the search program, so growth events
    must be O(log N).
    """
    if growth == "pow2":
        cap = 2048
        while cap < needed:
            cap *= 2
        return cap
    if needed <= block:
        return max(2048, -(-needed // 2048) * 2048)
    return -(-needed // block) * block


@jax.jit
def _scatter_rows(dst, idx, rows):
    return dst.at[idx].set(rows)


class HostVectorStore:
    """Host-authoritative vector arrays + lazily-synced device mirror."""

    def __init__(self, dim: int, metric: str, block: int, growth: str = "block"):
        self.dim = dim
        self.metric = metric
        self.block = block
        self.growth = growth
        cap = _round_capacity(1, block, growth)
        self.vectors = np.zeros((cap, dim), np.float32)
        self.norms_sq = np.zeros((cap,), np.float32)
        self.magnitudes = np.zeros((cap,), np.float32)  # cosine denormalization
        self.present = np.zeros((cap,), bool)
        self._dirty: set = set()
        self._device: Optional[dict] = None
        self._lock = threading.RLock()
        self.epoch = 0  # bumped on every publish; consistency fingerprint
        self.mutations = 0  # lifetime row writes/clears (IVF drift gauge)
        # rows written since the last IVF mirror build: the mirror's
        # delta overlay scans exactly these (exact read-your-writes on
        # the throttled sub-linear path)
        self.ivf_written_since: set = set()

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    def memory_bytes(self) -> int:
        return (self.vectors.nbytes + self.norms_sq.nbytes
                + self.magnitudes.nbytes + self.present.nbytes
                + 32 * len(self._dirty))

    def ensure_capacity(self, needed: int) -> None:
        with self._lock:
            if needed <= self.capacity:
                return
            new_cap = _round_capacity(needed, self.block, self.growth)
            grow = new_cap - self.capacity
            self.vectors = np.concatenate(
                [self.vectors, np.zeros((grow, self.dim), np.float32)]
            )
            self.norms_sq = np.concatenate([self.norms_sq, np.zeros(grow, np.float32)])
            self.magnitudes = np.concatenate(
                [self.magnitudes, np.zeros(grow, np.float32)]
            )
            self.present = np.concatenate([self.present, np.zeros(grow, bool)])
            self._device = None  # shape changed → full re-upload

    def set_row(self, doc: int, vec: np.ndarray) -> None:
        """Store a vector (already normalized for cosine) at row ``doc``."""
        with self._lock:
            self.ensure_capacity(doc + 1)
            if self.metric == "cosine":
                mag = float(np.sqrt(np.dot(vec, vec)))
                self.magnitudes[doc] = mag
                if mag > 0:
                    vec = vec / mag
            self.vectors[doc] = vec
            self.norms_sq[doc] = float(np.dot(vec, vec))
            self.present[doc] = True
            self._dirty.add(doc)
            self.mutations += 1
            self.ivf_written_since.add(doc)

    def clear_row(self, doc: int) -> None:
        with self._lock:
            if doc < self.capacity:
                self.present[doc] = False
                self.vectors[doc] = 0
                self.norms_sq[doc] = 0
                self.magnitudes[doc] = 0
                self._dirty.add(doc)
                self.mutations += 1
                self.ivf_written_since.add(doc)

    def device_snapshot(self) -> dict:
        """Publish the current state to the device; returns the mirror dict.

        The epoch-snapshot analog of the reference's time-sliced MRMW mutex
        read phase (vmsdk/src/time_sliced_mrmw_mutex.h:42-136): queries run
        on an immutable device snapshot; host mutations accumulate in
        ``_dirty`` and publish as either a scatter or a full upload.
        """
        with self._lock:
            dt = str(config.get("search.corpus-dtype"))
            # int8 mode serves the coarse stage from the int8 mirror and
            # rescores from fp32 — the bf16 mirror would be dead memory
            # (2.5GB at 10Mx128), so it is only built for bfloat16 mode
            lp = dt == "bfloat16"
            i8 = dt == "int8"
            if self._device is None:
                self._device = {
                    "vectors": jnp.asarray(self.vectors),
                    "norms_sq": jnp.asarray(self.norms_sq),
                    "invalid": jnp.asarray(~self.present),
                }
                if lp:
                    # bf16 mirror for the coarse scan (half the memory
                    # traffic; exact fp32 rescore uses "vectors") — cast
                    # ON DEVICE: one memory pass instead of a host convert +
                    # second transfer
                    self._device["vectors_lp"] = self._device[
                        "vectors"
                    ].astype(jnp.bfloat16)
                if i8:
                    # int8 mirror: int8 tensor cores + integer epilogue
                    # (ops/pallas_scan int8 section); global symmetric
                    # scale from the published rows' absmax
                    v = self._device["vectors"]
                    scale = jnp.maximum(
                        jnp.max(jnp.abs(v)) / 127.0, 1e-30
                    ).astype(jnp.float32)
                    self._device["vectors_i8"] = jnp.clip(
                        jnp.round(v / scale), -127, 127
                    ).astype(jnp.int8)
                    self._device["i8_scale"] = scale
                self._dirty.clear()
                self.epoch += 1
                STATS.incr("vector_store_full_uploads")
                return self._device
            if (lp and "vectors_lp" not in self._device) or (
                i8 and "vectors_i8" not in self._device
            ):
                # corpus-dtype config changed since last publish
                self._device = None
                return self.device_snapshot()
            if self._dirty:
                if len(self._dirty) > max(1024, self.capacity // 5):
                    self._device = None
                    return self.device_snapshot()
                idx = np.fromiter(self._dirty, np.int32, len(self._dirty))
                dev = self._device
                self._device = {
                    "vectors": _scatter_rows(
                        dev["vectors"], idx, jnp.asarray(self.vectors[idx])
                    ),
                    "norms_sq": _scatter_rows(
                        dev["norms_sq"], idx, jnp.asarray(self.norms_sq[idx])
                    ),
                    "invalid": _scatter_rows(
                        dev["invalid"], idx, jnp.asarray(~self.present[idx])
                    ),
                }
                if "vectors_lp" in dev:
                    self._device["vectors_lp"] = _scatter_rows(
                        dev["vectors_lp"], idx,
                        jnp.asarray(self.vectors[idx]).astype(jnp.bfloat16),
                    )
                if "vectors_i8" in dev:
                    scale = float(dev["i8_scale"])
                    new_abs = float(np.abs(self.vectors[idx]).max()) \
                        if len(idx) else 0.0
                    if new_abs > scale * 127.0 * 1.001:
                        # incoming rows exceed the published quantization
                        # range: re-publish with a fresh global scale
                        self._device = None
                        return self.device_snapshot()
                    rows = np.clip(
                        np.round(self.vectors[idx] / scale), -127, 127
                    ).astype(np.int8)
                    self._device["vectors_i8"] = _scatter_rows(
                        dev["vectors_i8"], idx, jnp.asarray(rows)
                    )
                    self._device["i8_scale"] = dev["i8_scale"]
                self._dirty.clear()
                self.epoch += 1
                STATS.incr("vector_store_scatter_uploads")
            return self._device


class VectorIndexBase(IndexBase):
    def memory_bytes(self) -> int:
        b = self.store.memory_bytes() + 72 * len(getattr(self, '_tracked', ()))
        nd = getattr(self, '_node_doc', None)
        if nd is not None and hasattr(nd, 'nbytes'):
            b += nd.nbytes
        builder = getattr(self, 'builder', None)
        if builder is not None:
            b += builder.memory_bytes()  # native graph (hnsw_bytes)
        return b

    """Common add/remove/modify plumbing for flat and HNSW vector indexes."""

    mutation_weight = 10.0  # vectors dominate ingest cost (index_base.h weight)

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        interner: Optional[KeyInterner] = None,
        block_size: Optional[int] = None,
        growth: str = "block",
    ):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"bad metric {metric!r}")
        self.dim = dim
        self.metric = metric
        # With a schema-shared interner the *schema* owns doc-id lifetime
        # (a doc id is released when the document leaves every attribute
        # index); a standalone index owns it itself.
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        block = block_size or config.get("search.flat-block-size")
        self.store = HostVectorStore(dim, metric, block, growth)
        self._tracked: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._ivf = None  # drift-throttled IVF mirror (ops/ivf.py)
        self._ivf_epoch = -1
        self._ivf_muts = -1  # store.mutations at build time
        self._ivf_building = threading.Lock()

    # -- IVF mirror (large-corpus sub-linear path) --------------------------
    def ivf_mirror(self):
        """IVF index over the present rows, or None below
        search.ivf-threshold.

        Rebuild policy: a build is k-means + reorder + quantize over the
        whole corpus — seconds to minutes at the sizes where this path
        engages — so it must neither run per epoch bump nor hold the
        index lock. The mirror rebuilds only when mutation DRIFT since
        the last build is material (>5% of rows or >16k writes); in
        between, a slightly-stale mirror serves: deletions ride the
        caller's dense ~invalid mask, modified rows rescore against the
        CURRENT fp32 snapshot, and rows added since the build (a bounded
        fraction) are temporarily invisible to this path — the standard
        refresh-cadence contract of IVF serving systems. Row data is
        copied under the lock; the build itself runs unlocked (one
        builder at a time; concurrent searches keep the stale mirror)."""
        thresh = int(config.get("search.ivf-threshold"))
        n = self.count()
        if thresh == 0 or n < thresh:
            return None
        from valkey_search_tpu.ops import ivf as ivf_ops

        with self._lock:
            self.store.device_snapshot()  # settle epoch for memo key
            epoch = self.store.epoch
            muts = self.store.mutations
            if self._ivf is not None:
                if self._ivf_epoch == epoch:
                    return self._ivf
                drift = muts - self._ivf_muts
                if drift <= max(16384, n // 20):
                    return self._ivf
        if not self._ivf_building.acquire(blocking=False):
            # another thread is building: serve the stale mirror if any
            # (first-ever build: block until it lands so results exist)
            if self._ivf is not None:
                return self._ivf
            with self._ivf_building:
                return self._ivf
        try:
            with self._lock:
                st = self.store
                docs = np.nonzero(st.present)[0]
                epoch = st.epoch
                muts = st.mutations
                # device-resident build when the published mirror is
                # CURRENT (no pending dirty rows): the corpus then never
                # re-crosses the host↔device link — on a link-bound
                # deployment the transfer, not compute, bounds the build
                dev = st._device
                dev_fresh = (
                    dev is not None and "vectors" in dev and not st._dirty
                )
                if dev_fresh:
                    present = st.present.copy()
                else:
                    vecs = st.vectors[docs].copy()
                # the new mirror absorbs everything up to this copy;
                # writes landing during the (unlocked) build re-enter
                # the delta set and overlay the finished mirror
                st.ivf_written_since = set()
            if dev_fresh:
                new = ivf_ops.build_ivf_device(
                    dev["vectors"],
                    present=present,
                    block_rows=int(config.get("search.ivf-block-rows")),
                    n_clusters=int(config.get("search.ivf-clusters")),
                )
            else:
                new = ivf_ops.build_ivf(
                    vecs,
                    docs.astype(np.int64),
                    block_rows=int(config.get("search.ivf-block-rows")),
                    n_clusters=int(config.get("search.ivf-clusters")),
                )
            with self._lock:
                self._ivf = new
                self._ivf_epoch = epoch
                self._ivf_muts = muts
            STATS.incr("ivf_mirror_builds")
            return new
        finally:
            self._ivf_building.release()

    def ivf_delta_ids(self, pad_pow2: bool = True) -> np.ndarray:
        """Rows written since the last mirror build, -1-padded to a power
        of two so the overlay kernel's compiled shapes stay few."""
        with self.store._lock:
            if not self.store.ivf_written_since:
                return np.empty(0, np.int64)
            ids = np.fromiter(
                self.store.ivf_written_since, np.int64,
                len(self.store.ivf_written_since),
            )
        if not pad_pow2:
            return ids
        p = 1
        while p < len(ids):
            p *= 2
        out = np.full(p, -1, np.int64)
        out[: len(ids)] = ids
        return out

    # -- IndexBase ----------------------------------------------------------
    def add_record(self, key: str, value: VectorLike) -> RecordResult:
        try:
            vec = parse_vector(value, self.dim)
        except ValueError:
            STATS.incr("vector_invalid_records")
            return RecordResult.INVALID_DATA
        with self._lock:
            existed = key in self._tracked
            doc = self.interner.intern(key)
            self._tracked[key] = doc
            self.store.set_row(doc, vec)
            self._on_row_written(doc, vec, existed)
            STATS.incr("vector_records_modified" if existed else "vector_records_added")
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def modify_record(self, key: str, value: VectorLike) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        with self._lock:
            doc = self._tracked.pop(key, None)
            if doc is None:
                return RecordResult.SKIPPED
            self.store.clear_row(doc)
            self._on_row_removed(doc)
            if self._owns_interner:
                self.interner.release(key)
            STATS.incr("vector_records_removed")
            return RecordResult.REMOVED

    def tracked_keys(self):
        with self._lock:
            return set(self._tracked)

    def tracks(self, key: str) -> bool:
        with self._lock:
            return key in self._tracked

    def count(self) -> int:
        with self._lock:
            return len(self._tracked)

    def doc_of(self, key: str) -> Optional[int]:
        with self._lock:
            return self._tracked.get(key)

    def bulk_load(self, keys: Sequence[str], vectors: np.ndarray) -> int:
        """Vectorized batch ingest (backfill fast path; the reference's
        backfill feeds records one at a time through the writer pool,
        index_schema.cc:1044 — here the whole batch lands with numpy writes
        and one device publish)."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.shape[1] != self.dim:
            raise ValueError("bulk_load dim mismatch")
        with self._lock:
            doc_list = self.interner.intern_many(keys)
            docs = np.asarray(doc_list, np.int64)
            self.store.ensure_capacity(int(docs.max()) + 1)
            st = self.store
            vecs = vectors
            if self.metric == "cosine":
                mags = np.linalg.norm(vectors, axis=1)
                st.magnitudes[docs] = mags
                vecs = vectors / np.maximum(mags, 1e-30)[:, None]
            st.vectors[docs] = vecs
            # einsum: no [n, d] squared temp (it is 5 GB at 10M x 128)
            st.norms_sq[docs] = np.einsum("ij,ij->i", vecs, vecs)
            st.present[docs] = True
            st.mutations += len(docs)
            st.ivf_written_since.update(doc_list)
            st._device = None  # full re-upload on next publish
            self._tracked.update(zip(keys, doc_list))
            STATS.incr("vector_records_added", len(keys))
            return len(keys)

    # -- reply construction (reference vector_base.h:177 CreateReply) -------
    def neighbors_to_keys(
        self, dists: np.ndarray, ids: np.ndarray
    ) -> List[Tuple[str, float]]:
        """One query's (dists [k], ids [k]) → [(key, distance)], dropping pads."""
        out: List[Tuple[str, float]] = []
        for d, i in zip(np.asarray(dists), np.asarray(ids)):
            if i < 0 or not np.isfinite(d):
                continue
            key = self.interner.key_of(int(i))
            if key is not None:
                out.append((key, float(d)))
        return out

    # -- subclass hooks ------------------------------------------------------
    def _on_row_written(self, doc: int, vec: np.ndarray, existed: bool) -> None:
        pass

    def _on_row_removed(self, doc: int) -> None:
        pass
