"""Streaming exact k-NN: blocked corpus scan with a running top-k.

Device replacement for the reference's brute-force index
(third_party/hnswlib/bruteforce.h:213 — a per-query linear SIMD scan).
Here a batch of queries is scored against corpus blocks with one matmul
per block, and per-block top-k results are merged into a running top-k via
``lax.top_k`` — so device-memory traffic is one streaming pass over the
corpus per *batch* (amortized across B queries) and the [B, N] score
matrix is never materialized whole.

Distances are "smaller is better" throughout (hnswlib convention); invalid
rows (unallocated capacity, deleted, filtered-out) score +inf.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from valkey_search_tpu.ops import distance as dist_ops
from valkey_search_tpu.ops import pallas_scan as ps

# Plain Python scalars, NOT jnp arrays: a module-level jnp constant is
# committed to the import-time default device and poisons lowering for any
# other backend (embedding an accelerator-resident constant into a CPU
# program forces a cross-client transfer during MLIR lowering).
INF = float("inf")
INVALID_ID = -1


def merge_topk(
    dists_a: jnp.ndarray,
    ids_a: jnp.ndarray,
    dists_b: jnp.ndarray,
    ids_b: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge two top-k sets [B, ka] + [B, kb] → best k, ascending by distance.

    Also the cross-shard merge primitive: the reference merges per-shard
    results in a k-bounded max-heap on the coordinator
    (src/query/fanout.cc:69-222 SearchPartitionResultsTracker); here shards'
    top-k rows are concatenated (post all-gather) and re-selected.
    """
    d = jnp.concatenate([dists_a, dists_b], axis=-1)
    i = jnp.concatenate([ids_a, ids_b], axis=-1)
    neg_top, pos = jax.lax.top_k(-d, k)
    return -neg_top, jnp.take_along_axis(i, pos, axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "block_rows", "precision"),
)
def _rescore_exact(
    queries: jnp.ndarray,      # [B, d] fp32
    corpus: jnp.ndarray,       # [cap, d] fp32
    cand_ids: jnp.ndarray,     # [B, C] int32 (-1 padded)
    cand_valid_d: jnp.ndarray, # [B, C] coarse distances (inf = invalid)
    k: int,
    metric: str = "l2",
    block_rows: int = 0,       # unused; keeps signature uniform
    precision: str = "highest",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact re-ranking of coarse candidates: gather fp32 rows, one
    einsum, top-k (the second stage of the bf16-coarse / fp32-rescore
    retrieval)."""
    cand = jnp.take(corpus, jnp.maximum(cand_ids, 0), axis=0)  # [B, C, d]
    d = dist_ops.batched_candidate_scores(
        queries.astype(jnp.float32), cand, metric, precision
    )
    d = jnp.where((cand_ids >= 0) & jnp.isfinite(cand_valid_d), d, INF)
    kk = min(k, d.shape[-1])
    neg_top, pos = jax.lax.top_k(-d, kk)
    out_d = -neg_top
    out_i = jnp.take_along_axis(cand_ids, pos, axis=-1)
    out_i = jnp.where(jnp.isfinite(out_d), out_i, INVALID_ID)
    if kk < k:  # tiny corpus: pad out to k
        pad = k - kk
        out_d = jnp.pad(out_d, ((0, 0), (0, pad)), constant_values=INF)
        out_i = jnp.pad(out_i, ((0, 0), (0, pad)), constant_values=INVALID_ID)
    return out_d, out_i


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "block_rows", "coarse_factor"),
)
def flat_topk_two_stage(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,      # fp32 [cap, d]
    corpus_lp: jnp.ndarray,   # bf16 [cap, d] (same rows)
    k: int,
    metric: str = "l2",
    corpus_sq: Optional[jnp.ndarray] = None,
    invalid: Optional[jnp.ndarray] = None,
    filter_mask: Optional[jnp.ndarray] = None,
    block_rows: int = 131072,
    coarse_factor: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-stage exact-ish k-NN: bf16 coarse scan (half the memory
    traffic, bf16 tensor-core passes) over-retrieving coarse_factor*k
    candidates, then an exact fp32 rescore. cf=3 was chosen on the
    previous hardware (recall@10 0.998 on 1M x 128 clustered data; cf=1
    caps near 0.90 because bf16 ordering noise pushes true neighbors past
    rank k); not yet measured on the H100. Jitted as one program so both
    stages fuse into a single launch."""
    ck = min(coarse_factor * k, corpus.shape[0])
    cd, ci = flat_topk(
        queries.astype(jnp.bfloat16),
        corpus_lp,
        k=ck,
        metric=metric,
        corpus_sq=corpus_sq,
        invalid=invalid,
        filter_mask=filter_mask,
        block_rows=block_rows,
        precision="high",
        mode="approx",
        approx_recall_target=0.95,
        approx_over_retrieve=1,  # ck already over-retrieves
    )
    return _rescore_exact(
        queries, corpus, ci, cd, k=k, metric=metric, precision="highest"
    )


class ScanKernelUnavailable(RuntimeError):
    """``search.scan-kernel pallas`` asked for the fused kernel on a
    platform that cannot compile it."""


def fused_scan_compiles() -> bool:
    """Can the default device compile the fused Triton kernel? Only a GPU
    can; the CPU reaches the kernel only in interpret mode, which callers
    must ask for explicitly (tests do)."""
    return jax.devices()[0].platform == "gpu"


def use_fused_scan(cap: int, filter_mask) -> bool:
    """Route a coarse scan to the fused kernel?

    True when the configured scan kernel allows it, the default device can
    compile the kernel, the corpus is large enough that bucketed selection
    has headroom (>= 131072 rows → >= 1024 survivors per block), and any
    pre-filter is query-shared (per-query [B, cap] masks need the XLA
    path). ``search.scan-kernel pallas`` on a device that cannot compile
    the kernel raises ScanKernelUnavailable instead of silently
    interpreting it.
    """
    from valkey_search_tpu.runtime import config

    choice = str(config.get("search.scan-kernel"))
    if choice == "xla":
        return False
    if not fused_scan_compiles():
        if choice == "pallas":
            raise ScanKernelUnavailable(
                "search.scan-kernel pallas needs a GPU; the default device "
                f"is {jax.devices()[0].platform}"
            )
        return False
    if filter_mask is not None and filter_mask.ndim != 1:
        return False
    return cap >= 131072


def device_memory_limit(device=None) -> int:
    """Bytes the device lets this process allocate. A CPU device's limit
    is the host's physical memory; an accelerator must report its
    ``bytes_limit`` — guessing a size would size buffers for another
    card."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.device_kind} reports no memory_stats()['bytes_limit']"
        )
    return int(stats["bytes_limit"])


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "block_rows", "coarse_factor", "interpret", "span",
        "tile", "reference",
    ),
)
def flat_topk_fused(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,      # fp32 [cap, d]
    corpus_lp: Optional[jnp.ndarray],  # bf16 [cap, d]; None when int8 serves
    k: int,
    metric: str = "l2",
    corpus_sq: Optional[jnp.ndarray] = None,
    invalid: Optional[jnp.ndarray] = None,
    filter_mask: Optional[jnp.ndarray] = None,  # 1-D only (shared prefilter)
    block_rows: int = 262144,
    coarse_factor: Optional[int] = None,
    corpus_i8: Optional[jnp.ndarray] = None,  # int8 [cap, d] mirror
    i8_scale: Optional[jnp.ndarray] = None,   # scalar f32 corpus quant scale
    span: Optional[int] = None,  # int8 survivor granularity (None = auto)
    tile: Optional[ps.Tile] = None,  # kernel launch shape (None = auto)
    interpret: bool = False,
    reference: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-stage k-NN with the coarse scan fused into one kernel.

    Same contract and recall story as ``flat_topk_two_stage`` but the coarse
    stage never writes the [B, N] score matrix to device memory (see
    ops/pallas_scan.py): the kernel emits one packed (min, argmin) survivor
    per span*128 corpus rows, an exact selection picks coarse_factor*k of
    the survivors, and the fp32 rescore restores exact ordering.
    Requires a 1-D (query-shared) filter mask; per-query masks take the
    XLA path in the callers.

    ``reference=True`` computes the same survivors with the kernel's
    plain-XLA oracle instead (score matrix and all) — the comparison the
    kernel has to beat, and its correctness oracle.
    """
    cap, d = corpus.shape
    b = queries.shape[0]
    if filter_mask is not None and filter_mask.ndim != 1:
        raise ValueError("flat_topk_fused needs a 1-D filter mask")
    if metric == "l2" and corpus_sq is None:
        corpus_sq = dist_ops.squared_norms(
            corpus_lp if corpus_lp is not None else corpus
        )
    # alpha is folded into the queries; for l2 the ||q||^2 row constant
    # makes coarse scores the true non-negative squared distance,
    # unlocking the raw-bits key (see pallas_scan._scan_kernel).
    alpha = -2.0 if metric == "l2" else -1.0
    positive = metric == "l2"
    use_i8 = corpus_i8 is not None
    if coarse_factor is None:
        # Chosen on the previous hardware; not yet measured on the H100:
        # int8 cf 4 at >= 1M rows held recall@10 >= 0.99 on clustered
        # byte data, 8 at >= 4M (the survivor pool spans more blocks), 5
        # below 1M; bf16 cf 3.
        if use_i8:
            if cap >= 4_000_000:
                coarse_factor = 8
            elif cap >= 1_048_576:
                coarse_factor = 4
            else:
                coarse_factor = 5
        else:
            coarse_factor = 3
    kc = min(coarse_factor * k, cap)
    pad_d = -d % 128
    d_pad = d + pad_d

    if use_i8:
        if span is None:
            # Chosen on the previous hardware; not yet measured on the
            # H100: span 8 while the survivor array stays >= ~1k columns
            # (span 16 at 1M dropped recall@10 below 0.99), 4 down to
            # ~512k rows, 1 below that.
            if cap >= 1_048_576:
                span = 8
            elif cap >= 524_288:
                span = 4
            else:
                span = 1
        quantum = ps.GROUP * span
    else:
        span = 1
        quantum = ps.GROUP
    pad_n = -cap % quantum
    n = cap + pad_n
    block_rows = -(-block_rows // quantum) * quantum

    if use_i8:
        # packed int8 coarse stage: int8 tensor-core dot, integer
        # epilogue, one int32 survivor per span*128 rows. Queries get a
        # per-batch global scale; the corpus mirror carries its own
        # (store-published) scale.
        if i8_scale is None:
            raise ValueError("corpus_i8 needs i8_scale")
        sq = jnp.maximum(
            jnp.max(jnp.abs(queries.astype(jnp.float32))) / 127.0, 1e-30
        )
        q_i8 = jnp.clip(
            jnp.round(queries.astype(jnp.float32) / sq), -127, 127
        ).astype(jnp.int8)
        if pad_d:
            q_i8 = jnp.pad(q_i8, ((0, 0), (0, pad_d)))
        inv_two = 1.0 / (2.0 * sq * i8_scale.astype(jnp.float32))
        bias_i = ps.make_bias_i8_packed(
            cap, d_pad, span, metric, corpus_sq, inv_two, invalid,
            filter_mask,
        )
        _, _, sentinel_i, pre_shift_i, invalid_thresh = ps.i8_packed_layout(
            d_pad, span
        )
        chunk_bits = (span * (ps.GROUP // ps.BUCKET) - 1).bit_length()
        c_i8 = corpus_i8
        if pad_n:
            c_i8 = jnp.pad(c_i8, ((0, pad_n), (0, 0)))
            bias_i = jnp.pad(
                bias_i, ((0, 0), (0, pad_n)), constant_values=sentinel_i
            )
        if pad_d:
            c_i8 = jnp.pad(c_i8, ((0, 0), (0, pad_d)))
        c_scan, bias_scan = c_i8, bias_i
    else:
        if corpus_lp is None:
            raise ValueError("flat_topk_fused needs corpus_lp or corpus_i8")
        q_lp = (queries.astype(jnp.float32) * alpha).astype(jnp.bfloat16)
        qsq = (
            dist_ops.squared_norms(queries)[:, None]
            if positive
            else jnp.zeros((b, 1), jnp.float32)
        )
        if pad_d:
            q_lp = jnp.pad(q_lp, ((0, 0), (0, pad_d)))

        bias = ps.make_bias(cap, metric, corpus_sq, invalid, filter_mask)
        c_lp = corpus_lp
        if pad_n:
            c_lp = jnp.pad(c_lp, ((0, pad_n), (0, 0)))
            bias = jnp.pad(bias, ((0, 0), (0, pad_n)), constant_values=INF)
        if pad_d:
            c_lp = jnp.pad(c_lp, ((0, 0), (0, pad_d)))
        c_scan, bias_scan = c_lp, bias

    # A single kernel block is fastest (no merge pass), but the survivor
    # keys and their selection are [B, block/(128*span)] x 8 bytes — at
    # 10M rows x 65536 queries that is 41 GB — and the reference path
    # also holds the [B, block] score matrix. Budget = what device memory
    # holds beside the resident corpus mirrors (with headroom for the
    # top-k workspace and allocator fragmentation); shrink the block to
    # the largest quantum-aligned divisor of n that fits.
    resident = corpus.nbytes
    if corpus_lp is not None:
        resident += corpus_lp.nbytes
    if use_i8:
        resident += corpus_i8.nbytes
    surv_budget = max(1 << 30, int(device_memory_limit() * 0.70) - resident)
    bs = min(block_rows, n)

    def _surv_bytes(width):
        out = b * (width // (ps.BUCKET * span)) * 8
        if reference:
            # the [B, block] score matrix, and as much again for XLA's
            # autotuning of the matmul that writes it
            out += b * width * 8
        return out

    if _surv_bytes(bs) > surv_budget or n % bs:
        # largest quantum-aligned divisor of n that fits both the
        # caller's block_rows and the survivor budget (callers pass
        # arbitrary block_rows; n is quantum-padded, so m=n//quantum
        # always terminates the search)
        m = 2
        while not (
            n % m == 0
            and (n // m) % quantum == 0
            and n // m <= max(bs, quantum)
            and _surv_bytes(n // m) <= surv_budget
        ):
            m += 1
            if m > n // quantum:
                raise ValueError(
                    f"no survivor-budget block split for n={n}, B={b}"
                )
        bs = n // m
    block_rows = bs

    def _survivor_min_k(vals, kk):
        # off the TPU approx_min_k lowers to an exact selection; on an H100
        # it matched lax.top_k at 1024 survivor columns and ran 2-4% faster
        # at 2048-8192 (B=65536, k=40; PERF.md)
        return jax.lax.approx_min_k(vals, kk, recall_target=0.98)

    def coarse_block(c_blk, bias_blk, row0):
        if use_i8:
            # packed keys: the top-k runs on the f32 bitcast view (keys
            # are non-negative ints → bitcast order == integer order) and
            # the selected VALUES are the keys — no idx array, no
            # take_along gather over the survivor matrix
            if reference:
                packed = ps.bucket_min_scan_i8_packed_reference(
                    q_i8, c_blk, bias_blk, span=span)
            else:
                packed = ps.bucket_min_scan_i8_packed(
                    q_i8, c_blk, bias_blk, span=span, tile=tile,
                    interpret=interpret,
                )
            pf = jax.lax.bitcast_convert_type(packed, jnp.float32)
            kk = min(kc, pf.shape[-1])
            bf, pos = _survivor_min_k(pf, kk)
            key = jax.lax.bitcast_convert_type(bf, jnp.int32)
            chunk = key & ((span * 128) - 1)
            score = (key >> chunk_bits) << pre_shift_i
            bi = (
                row0
                + (pos // 128) * (span * ps.GROUP)
                + chunk * ps.BUCKET
                + (pos % 128)
            )
            bad = score > invalid_thresh
            bd = jnp.where(bad, INF, score.astype(jnp.float32))
            bi = jnp.where(bad, INVALID_ID, bi)
            return bd, bi
        if reference:
            vals, idx = ps.bucket_min_scan_reference(
                q_lp, qsq, c_blk, bias_blk)
        else:
            vals, idx = ps.bucket_min_scan(
                q_lp, qsq, c_blk, bias_blk, positive=positive, tile=tile,
                interpret=interpret,
            )
        kk = min(kc, vals.shape[-1])
        bd, pos = _survivor_min_k(vals, kk)
        bi = jnp.take_along_axis(idx, pos, axis=-1) + row0
        bi = jnp.where(jnp.isinf(bd), INVALID_ID, bi)
        return bd, bi

    if n <= block_rows:
        cd, ci = coarse_block(c_scan, bias_scan, 0)
    else:
        if n % block_rows:
            raise ValueError(
                f"capacity {n} not divisible by block_rows {block_rows}"
            )
        nblk = n // block_rows
        c_b = c_scan.reshape(nblk, block_rows, c_scan.shape[1])
        bias_b = bias_scan.reshape(nblk, 1, block_rows)

        def step(carry, xs):
            run_d, run_i, row0 = carry
            bd, bi = coarse_block(xs[0], xs[1], row0)
            md, mi = merge_topk(run_d, run_i, bd, bi, bd.shape[-1])
            return (md, mi, row0 + block_rows), None

        kk = min(kc, block_rows // (ps.BUCKET * span))
        init = (
            jnp.full((b, kk), INF, jnp.float32),
            jnp.full((b, kk), INVALID_ID, jnp.int32),
            jnp.int32(0),
        )
        (cd, ci, _), _ = jax.lax.scan(step, init, (c_b, bias_b))

    ci = jnp.where(ci >= cap, INVALID_ID, ci)  # padded corpus rows
    return _rescore_exact(
        queries, corpus, ci, cd, k=k, metric=metric, precision="highest"
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "block_rows", "precision", "mode",
        "approx_recall_target", "approx_over_retrieve",
    ),
)
def flat_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    metric: str = "l2",
    corpus_sq: Optional[jnp.ndarray] = None,
    invalid: Optional[jnp.ndarray] = None,
    filter_mask: Optional[jnp.ndarray] = None,
    block_rows: int = 131072,
    precision: str = "highest",
    mode: str = "exact",
    approx_recall_target: float = 0.99,
    approx_over_retrieve: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN of ``queries`` [B, d] over ``corpus`` [cap, d].

    Args:
      invalid: optional bool [cap]; True rows are never returned (unallocated
        slots and tombstoned deletes — reference hnswalg.h markDelete :1156).
      filter_mask: optional bool [cap] (or [B, cap]) of rows *allowed* by a
        hybrid pre-filter predicate (reference src/query/search.cc:456
        CalcBestMatchingPrefilteredKeys scores only qualified keys; here the
        mask is fused into the scan epilogue instead).
      block_rows: corpus rows scored per scan step; cap must be divisible by
        it unless cap <= block_rows (the flat index pads capacity).
      mode: per-block selection primitive. "exact" = lax.top_k;
        "approx" = lax.approx_min_k with over-retrieval. approx_min_k is
        an approximate partial reduce only on a TPU; elsewhere it lowers
        to an exact selection, which on an H100 ran 4% faster than
        lax.top_k at [8192, 131072] (PERF.md).

    Returns (dists [B, k], ids [B, k]) ascending; empty slots are (+inf, -1).
    """
    cap = corpus.shape[0]
    b = queries.shape[0]
    # keep bf16 queries when the corpus is bf16 (bf16 matmul passes for
    # the two-stage coarse scan); fp32 otherwise
    qdt = jnp.bfloat16 if corpus.dtype == jnp.bfloat16 else jnp.float32
    queries = queries.astype(qdt)

    if metric == "l2" and corpus_sq is None:
        corpus_sq = dist_ops.squared_norms(corpus)

    def score_block(c_vecs, c_sq, c_invalid, c_filter, row0):
        s = dist_ops.pairwise_scores(
            queries, c_vecs, metric=metric, corpus_sq=c_sq, precision=precision
        )
        if c_invalid is not None:
            s = jnp.where(c_invalid[None, :], INF, s)
        if c_filter is not None:
            fm = c_filter if c_filter.ndim == 2 else c_filter[None, :]
            s = jnp.where(fm, s, INF)
        if mode == "approx" and c_vecs.shape[0] > 1024:
            # over-retrieve then trim in the exact merge: approx errors at
            # rank <= over*k almost never reach the top-k
            kk = min(approx_over_retrieve * k, c_vecs.shape[0])
            d, pos = jax.lax.approx_min_k(
                s, kk, recall_target=approx_recall_target
            )
        else:
            kk = min(k, c_vecs.shape[0])
            neg_top, pos = jax.lax.top_k(-s, kk)
            d = -neg_top
        ids = (pos + row0).astype(jnp.int32)
        ids = jnp.where(jnp.isinf(d), INVALID_ID, ids)
        if d.shape[-1] < k:  # tiny corpus: pad out to k
            pad = k - d.shape[-1]
            d = jnp.pad(d, ((0, 0), (0, pad)), constant_values=INF)
            ids = jnp.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return d, ids

    if cap <= block_rows:
        d, ids = score_block(corpus, corpus_sq, invalid, filter_mask, 0)
        if d.shape[-1] > k:  # approx over-retrieval: exact trim to k
            neg_top, pos = jax.lax.top_k(-d, k)
            d = -neg_top
            ids = jnp.take_along_axis(ids, pos, axis=-1)
        return d, ids

    if cap % block_rows != 0:
        raise ValueError(f"capacity {cap} not divisible by block_rows {block_rows}")
    n_blocks = cap // block_rows

    corpus_b = corpus.reshape(n_blocks, block_rows, corpus.shape[1])
    sq_b = corpus_sq.reshape(n_blocks, block_rows) if corpus_sq is not None else None
    inv_b = invalid.reshape(n_blocks, block_rows) if invalid is not None else None
    if filter_mask is not None:
        if filter_mask.ndim == 2:
            filt_b = filter_mask.reshape(b, n_blocks, block_rows).swapaxes(0, 1)
        else:
            filt_b = filter_mask.reshape(n_blocks, block_rows)
    else:
        filt_b = None

    def step(carry, xs):
        run_d, run_i, row0 = carry
        c_vecs = xs[0]
        c_sq = xs[1] if sq_b is not None else None
        off = 2 if sq_b is not None else 1
        c_inv = xs[off] if inv_b is not None else None
        off += 1 if inv_b is not None else 0
        c_filt = xs[off] if filt_b is not None else None
        bd, bi = score_block(c_vecs, c_sq, c_inv, c_filt, row0)
        md, mi = merge_topk(run_d, run_i, bd, bi, k)
        return (md, mi, row0 + block_rows), None

    xs = [corpus_b]
    if sq_b is not None:
        xs.append(sq_b)
    if inv_b is not None:
        xs.append(inv_b)
    if filt_b is not None:
        xs.append(filt_b)

    init = (
        jnp.full((b, k), INF, jnp.float32),
        jnp.full((b, k), INVALID_ID, jnp.int32),
        jnp.int32(0),
    )
    (d, i, _), _ = jax.lax.scan(step, init, tuple(xs))
    return d, i
