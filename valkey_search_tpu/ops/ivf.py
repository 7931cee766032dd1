"""IVF coarse-pruned k-NN: the sub-O(N) device path for large corpora.

Why this exists: the reference's only sub-linear structure is the hnswlib
graph (third_party/hnswlib/hnswalg.h:1611 searchKnn), a pointer-chasing
walk that maps badly onto an accelerator (scattered small gathers,
data-dependent trip counts). The exact scan (ops/topk.py /
ops/pallas_scan.py) is dense and batch-friendly, but its per-query cost is
O(N). This module restores a sub-linear regime with dense,
compiler-friendly primitives only:

- the corpus is reordered **cluster-major** (two-level partition: k-means
  coarse clusters, then a principal-axis sort inside each cluster) and
  chopped into fixed S-row *blocks*; each block carries a mini-centroid
  computed from its own members, so selection granularity is the block
  (≈N/S cells), far finer than the k-means cluster count;
- stage 1 scores every query against all block mini-centroids with ONE
  matmul ([B,d] x [d,nb] — nb is N/S, i.e. 1/S-th of a full scan)
  and takes the top ``probe`` blocks per query;
- stage 2 gathers the selected blocks — contiguous [S, d] int8 tiles, the
  shape device memory streams best — and scores their rows in bf16 with
  f32 accumulation, merging a running top-k.

Per-query work drops from O(N·d) to O(nb·d + probe·S·d): at 100M rows,
S=1024, probe=64 that is ~160x less compute and ~190x less memory traffic
than the exact scan, with recall governed by ``probe`` (swept in bench.py).

Quantization is **residual, per block**: each row is stored as an int8
code of (row - block_centroid) with a per-block scale, so the
quantization step tracks the BLOCK radius rather than the corpus radius
(the same reason IVF-PQ encodes residuals). Distances decompose exactly:

  |q - x|^2 = |q|^2 - 2 q·c - 2 q·r + |x|^2      (x = c + r)
       q·x  =            q·c +   q·r

with q·c recomputed in fp32 from the (tiny) selected-centroid gather,
|x|^2 stored as the *reconstruction* norm (so the l2 score is exactly the
distance to the reconstructed point — error ∝ the distance itself, not
the row norm), and only q·r carried through int8. Measured on
tightly-clustered corpora this is ~20-50x tighter than a corpus-global
int8 scale. Callers that need
fp32-exact ordering still over-retrieve + rescore (ivf_search_rescored),
the same contract as the fused flat scan.

The index is immutable once built (mirrors the epoch-snapshot publish
discipline of vector_base.device_snapshot): mutations dirty the epoch and
the owner rebuilds/republishes, exactly like the AoS traversal mirror.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

INF = float("inf")  # python scalar — see ops/topk.py note on jnp constants


class IvfDeviceIndex(NamedTuple):
    """Device-resident IVF index (all arrays immutable once published).

    centroids:   [nb, d]  f32 block mini-centroids (exact; stage 1 casts
                 to bf16 for the cell matmul, stage 2 re-dots the
                 selected few in f32)
    cent_sq:     [nb]     f32 centroid squared norms
    block_valid: [nb]     bool — False for pow2-padding blocks
    blocks_i8:   [nb, S, d] int8 residual codes ((row - centroid)/scale_b)
    block_scale: [nb]     f32 per-block residual dequant scale
    row_sq:      [nb, S]  f32 |reconstruction|^2 (see quantize_blocks —
                 the recon norm, not the raw row norm, keeps the l2
                 score an exact distance-to-reconstruction)
    block_ids:   [nb, S]  int32 original row ids, -1 padding
    """

    centroids: jnp.ndarray
    cent_sq: jnp.ndarray
    block_valid: jnp.ndarray
    blocks_i8: jnp.ndarray
    block_scale: jnp.ndarray
    row_sq: jnp.ndarray
    block_ids: jnp.ndarray

    @property
    def n_blocks(self) -> int:
        return self.blocks_i8.shape[0]

    @property
    def block_rows(self) -> int:
        return self.blocks_i8.shape[1]

    def device_bytes(self) -> int:
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in self)


# --------------------------------------------------------------------------
# k-means (device Lloyd's — one matmul per assignment pass)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_clusters", "iters"))
def kmeans_fit(
    x: jnp.ndarray,
    n_clusters: int,
    iters: int = 12,
    seed: int = 0,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Lloyd's on device: assign via one bf16 matmul + argmin, update via
    segment-sum scatter. Empty clusters keep their previous centroid (they
    simply never win stage-1 selection). ``valid`` masks padding rows out
    of both seeding and the centroid update, so callers can pad inputs to
    pow2 shapes and reuse one compiled program. Returns [n_clusters, d]
    f32."""
    n = x.shape[0]
    # bound the per-iteration [rows, k] dots/one-hot working set: an
    # unchunked body at n=1M, k=4096 allocates a 17 GB f32 dots matrix.
    # Rows are processed in
    # lax.scan sub-chunks with running (sums, cnt) accumulators.
    chunk = max(1, min(n, (1 << 27) // max(1, n_clusters)))
    x = x.astype(jnp.float32)
    key = jax.random.PRNGKey(seed)
    if valid is None:
        perm = jax.random.permutation(key, n)
    else:
        # random order among valid rows first: argsort(uniform + big*pad)
        u = jax.random.uniform(key, (n,)) + jnp.where(valid, 0.0, 1e9)
        perm = jnp.argsort(u)
    cent0 = jnp.take(x, perm[:n_clusters], axis=0)
    w = (
        jnp.ones((n, 1), jnp.float32)
        if valid is None
        else valid.astype(jnp.float32)[:, None]
    )
    pad = -n % chunk
    if pad:  # padded rows carry w=0: they join no cluster update
        x = jnp.pad(x, ((0, pad), (0, 0)))
        w = jnp.pad(w, ((0, pad), (0, 0)))
    d = x.shape[1]
    n_ch = (n + pad) // chunk
    xbf3 = x.astype(jnp.bfloat16).reshape(n_ch, chunk, d)
    xw3 = (x * w).reshape(n_ch, chunk, d)
    w3 = w.reshape(n_ch, chunk, 1)

    def body(cent, _):
        csq = jnp.sum(cent * cent, axis=1)
        centbf = cent.T.astype(jnp.bfloat16)

        def cstep(carry, xs):
            sums_c, cnt_c = carry
            xbf_c, xw_c, w_c = xs
            dots = (xbf_c @ centbf).astype(jnp.float32)
            a = jnp.argmin(csq[None, :] - 2.0 * dots, axis=1)
            sums_c += jax.ops.segment_sum(xw_c, a, num_segments=n_clusters)
            cnt_c += jax.ops.segment_sum(w_c, a, num_segments=n_clusters)
            return (sums_c, cnt_c), None

        (sums, cnt), _ = jax.lax.scan(
            cstep,
            (
                jnp.zeros((n_clusters, d), jnp.float32),
                jnp.zeros((n_clusters, 1), jnp.float32),
            ),
            (xbf3, xw3, w3),
        )
        return jnp.where(cnt > 0, sums / jnp.maximum(cnt, 1.0), cent), None

    cent, _ = jax.lax.scan(body, cent0, None, length=iters)
    return cent


@functools.partial(jax.jit, static_argnames=("k_each", "iters"))
def kmeans_fit_batched(
    x: jnp.ndarray,       # [C, R, d] f32 per-cluster row tables (0-padded)
    valid: jnp.ndarray,   # [C, R] bool
    k_each: int,          # centroids per cluster (shared max; mask after)
    iters: int = 8,
    seed: int = 0,
) -> jnp.ndarray:
    """Lloyd's for C independent k-means problems in ONE device program.

    Per-cluster device calls would pay a launch and a host sync C times;
    here assignment is one gathered pass and the centroid update is a
    per-cluster one-hot einsum, so the whole level-2 fit is one launch.
    Returns [C, k_each, d] f32."""
    c, r, d = x.shape
    x = x.astype(jnp.float32)
    key = jax.random.PRNGKey(seed)
    # per-cluster random valid rows as seeds
    u = jax.random.uniform(key, (c, r)) + jnp.where(valid, 0.0, 1e9)
    seed_pos = jnp.argsort(u, axis=1)[:, :k_each]             # [C, k]
    cent0 = jnp.take_along_axis(x, seed_pos[:, :, None], axis=1)
    w = valid.astype(jnp.float32)
    xbf = x.astype(jnp.bfloat16)

    def body(cent, _):
        csq = jnp.sum(cent * cent, axis=2)                    # [C, k]
        dots = jnp.einsum(
            "crd,ckd->crk", xbf, cent.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        a = jnp.argmin(csq[:, None, :] - 2.0 * dots, axis=2)  # [C, R]
        # oh already carries the validity weight (w in {0,1}, so w^2 == w);
        # summing against x directly avoids materialising a second full
        # [C, R, d] f32 copy — at C=1220, R=4096, d=128 that copy alone was
        # 2.56 GiB and tipped a 10M IVF build out of device memory
        oh = jax.nn.one_hot(a, k_each, dtype=jnp.float32) * w[:, :, None]
        sums = jnp.einsum("crk,crd->ckd", oh, x)
        cnt = jnp.sum(oh, axis=1)                             # [C, k]
        return (
            jnp.where(
                cnt[:, :, None] > 0,
                sums / jnp.maximum(cnt, 1.0)[:, :, None],
                cent,
            ),
            None,
        )

    cent, _ = jax.lax.scan(body, cent0, None, length=iters)
    return cent


@jax.jit
def _assign_chunk(xc: jnp.ndarray, cent: jnp.ndarray) -> jnp.ndarray:
    csq = jnp.sum(cent * cent, axis=1)
    dots = (
        xc.astype(jnp.bfloat16) @ cent.T.astype(jnp.bfloat16)
    ).astype(jnp.float32)
    return jnp.argmin(csq[None, :] - 2.0 * dots, axis=1).astype(jnp.int32)


def assign_clusters(
    chunks: Callable[[], "np.ndarray"] | np.ndarray,
    cent: jnp.ndarray,
    chunk_rows: int = 262144,
) -> np.ndarray:
    """Chunked nearest-centroid assignment (host loop, device matmuls).
    ``chunks`` is either the full [N, d] array or an iterable of row
    chunks. Last chunk is padded so program shapes stay stable."""
    # bound the [chunk, k] f32 dots to ~512 MB — at k=4096 an unbounded
    # 262144-row chunk is a 4.3 GB temp
    chunk_rows = max(
        1024, min(chunk_rows, (1 << 27) // max(1, int(cent.shape[0])))
    )
    if isinstance(chunks, np.ndarray):
        n = chunks.shape[0]
        it = (
            chunks[s : min(s + chunk_rows, n)]
            for s in range(0, n, chunk_rows)
        )
    else:
        it = chunks
    out = []
    for xc in it:
        xc = np.ascontiguousarray(xc, np.float32)
        rows = xc.shape[0]
        if rows < chunk_rows:
            xc = np.concatenate(
                [xc, np.zeros((chunk_rows - rows, xc.shape[1]), np.float32)]
            )
        out.append(np.asarray(_assign_chunk(jnp.asarray(xc), cent))[:rows])
    return np.concatenate(out) if out else np.empty(0, np.int32)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

# test hook: called with a stage tag at every build sync point so tests can
# sample live-array residency (tests/test_ivf.py residency budget)
_RESIDENCY_PROBE: Optional[Callable[[str], None]] = None


def _probe(tag: str) -> None:
    if _RESIDENCY_PROBE is not None:
        _RESIDENCY_PROBE(tag)


def ivf_build_plan(
    n: int,
    d: int,
    *,
    block_rows: int = 1024,
    n_clusters: int = 0,
    train_sample: int = 0,
    block_align: int = 0,
    resident_bytes: int = 0,
) -> dict:
    """Device-memory residency model of ``build_ivf_device`` — an upper
    bound on the
    build's peak *array* bytes (eager jax arrays; in-jit temps are bounded
    separately by the documented 512/768 MB chunking caps and are far
    smaller than the array terms here). ``resident_bytes`` is whatever
    else lives in device memory during the build (the serving mirrors +
    the fp32 corpus the build reads). Validated against measured
    live-array peaks in tests/test_ivf.py, which also checks that the
    engine's threshold-scale build fits a 16 GiB share of a card.

    Every formula below mirrors the corresponding build_ivf_device code;
    if the code changes, this model and its validating test must move
    with it."""
    s = int(block_rows)
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if train_sample <= 0:
        train_sample = int(np.clip(256 * n_clusters, 131072, 4_000_000))
    train_sample = min(train_sample, max(1, n))
    # kmeans_fit working set: sample f32 + bf16 + weighted f32 + weights
    # (reshaped copies), plus the chunked [chunk, k] f32 dots (<=512 MB)
    fit1 = train_sample * d * (4 + 2 + 4) + (1 << 29)
    # level-2 fit table (capped) + bf16 copy + one-hot/sums temps
    r_max = _pow2_at_least(min(4096, max(train_sample // max(n_clusters, 1), 1)))
    while n_clusters * r_max * d * 4 > (768 << 20) and r_max > 256:
        r_max //= 2
    c2max = _pow2_at_least(max(1, -(-(n // max(n_clusters, 1)) // s)))
    table = n_clusters * r_max * d * 4
    fit2 = table * 2 + n_clusters * r_max * c2max * 4 + n_clusters * c2max * d * 8
    # assignment pass: [chunk, c2max, d] gather in f32 + bf16 + f32 dots
    # (~6 B/elem, the documented ~1.5 GB budget) x2 launches in flight,
    # plus the [n_chunks, 2, chunk] int32 output stack
    chunk_rows = int(np.clip((3 << 28) // max(1, c2max * d), 16384, 262144))
    chunk_rows = 1 << (chunk_rows.bit_length() - 1)
    chunk_rows = min(chunk_rows, n)
    n_chunks = -(-n // chunk_rows)
    assign = 2 * chunk_rows * c2max * d * 6 + n_chunks * 2 * chunk_rows * 4
    # layout padding (same auto policy as build_ivf_device): large builds
    # whole-allocate blocks per L1 CLUSTER (ceil(n/s) full blocks + < 1
    # pad block per cluster tail); small builds allocate per CELL (cells
    # <= ceil(n/s) + n_clusters, each tail pads < 1 block)
    if block_align <= 0:
        block_align = 1024 if (-(-n // s)) > 4096 else 0
    if block_align > 0:
        nb = (-(-n // s)) + n_clusters
        nb_pad = -(-nb // block_align) * block_align
    else:
        nb = 2 * (-(-n // s)) + 2 * n_clusters
        nb_pad = _pow2_at_least(max(nb, 1))
    # quantize: per-chunk [chunk_blocks, S, d] f32 gather + masked copy
    # (x2 chunks in flight thanks to the per-chunk sync), accumulated
    # int8/row_sq/ids parts, then the concatenate's transient double
    chunk_blocks = _pow2_at_least(max(1, (1 << 26) // max(1, s * d * 4)))
    index_bytes = nb_pad * (s * d + s * 4 + s * 4 + d * 4 + 12)
    quant = 2 * chunk_blocks * s * d * 8 + 2 * index_bytes
    peak = resident_bytes + max(fit1 + fit2, assign, quant)
    return {
        "n": n, "d": d, "block_rows": s, "n_clusters": n_clusters,
        "train_sample": train_sample, "c2max": c2max, "r_max": r_max,
        "nb_pad": nb_pad, "chunk_rows": chunk_rows,
        "chunk_blocks": chunk_blocks,
        "fit_bytes": fit1 + fit2, "assign_bytes": assign,
        "quantize_bytes": quant, "index_bytes": index_bytes,
        "resident_bytes": resident_bytes, "peak_bytes": peak,
    }


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def plan_blocks(
    assign: np.ndarray, order: np.ndarray, block_rows: int,
    block_align: int = 0,
) -> Tuple[np.ndarray, int, int]:
    """Map each corpus row (in cluster-major ``order``) to its slot in the
    flat [nb_pad * S] block layout. Each cluster occupies ceil(size/S)
    whole blocks; tails pad with -1 rows. Returns (pos [N], nb, nb_pad).

    block_align 0 pads the block count to a power of two — that keeps the
    serve program's shape stable across the product mirror's throttled
    rebuilds as the corpus grows. Very large one-shot builds pass a small
    alignment instead: pow2 wastes up to 2x code memory (at 100M x 128
    that is a 4-17 GiB difference)."""
    s = block_rows
    n_clusters = int(assign.max()) + 1 if len(assign) else 1
    sizes = np.bincount(assign, minlength=n_clusters)
    nblk = -(-sizes // s)  # ceil
    nb = int(nblk.sum())
    if block_align > 0:
        nb_pad = -(-nb // block_align) * block_align
    else:
        nb_pad = _pow2_at_least(max(nb, 1))
    base_blk = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(nblk, out=base_blk[1:])
    cluster_start = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=cluster_start[1:])
    a_sorted = assign[order]
    within = np.arange(len(order), dtype=np.int64) - cluster_start[a_sorted]
    pos = base_blk[a_sorted] * s + within
    return pos, nb, nb_pad


def principal_axis(sample: np.ndarray) -> np.ndarray:
    """First principal component of a row sample (host: d x d covariance
    eigendecomposition — d is small). Used to sort rows *within* a k-means
    cluster so contiguous blocks are spatially-coherent sub-slabs and their
    mini-centroids stay discriminative even for clusters spanning many
    blocks."""
    x = np.asarray(sample, np.float32)
    x = x - x.mean(axis=0, keepdims=True)
    cov = (x.T @ x) / max(1, x.shape[0] - 1)
    w, v = np.linalg.eigh(cov)
    return np.ascontiguousarray(v[:, -1], np.float32)


@jax.jit
def quantize_blocks(
    block_vecs: jnp.ndarray, block_ids: jnp.ndarray
) -> Tuple[jnp.ndarray, ...]:
    """Residual-quantize a chunk of blocks on device.

    block_vecs [nbc, S, d] f32 (invalid rows zero), block_ids [nbc, S].
    Returns (blocks_i8, centroids f32, cent_sq, block_scale, row_sq,
    valid). Shared by the host build and streaming (device-generated)
    builds — e.g. bench.py's 100M corpus never exists on the host.
    """
    valid = block_ids >= 0                                    # [nbc, S]
    vf = valid.astype(jnp.float32)
    cnt = jnp.maximum(jnp.sum(vf, axis=1), 1.0)               # [nbc]
    cent = jnp.einsum("bsd,bs->bd", block_vecs, vf) / cnt[:, None]
    resid = jnp.where(
        valid[:, :, None], block_vecs - cent[:, None, :], 0.0
    )
    amax = jnp.max(jnp.abs(resid), axis=(1, 2))               # [nbc]
    scale = jnp.maximum(amax, 1e-30) / 127.0
    codes = jnp.clip(
        jnp.round(resid / scale[:, None, None]), -127, 127
    ).astype(jnp.int8)
    # |recon|^2, NOT |row|^2: with the true row norm the l2 formula
    # evaluates |q - recon|^2 + (|row|^2 - |recon|^2), and that second
    # term is a per-row bias ~2|row|·quant_err — far larger than the
    # |q - recon| error near neighbors, and it scrambles ranking
    # (measured: recall@5 0.81 vs 0.99 on tight clusters). With the
    # reconstruction norm the score IS the exact distance to the
    # reconstructed point.
    recon = cent[:, None, :] + codes.astype(jnp.float32) * scale[:, None, None]
    row_sq = jnp.sum(recon * recon, axis=2)                   # [nbc, S]
    return (
        codes,
        cent,
        jnp.sum(cent * cent, axis=1),
        scale.astype(jnp.float32),
        row_sq,
        jnp.any(valid, axis=1),
    )


def finalize_blocks(
    block_vecs: np.ndarray, block_ids: np.ndarray, chunk_blocks: int = 0,
    host_quantize: bool = False,
) -> IvfDeviceIndex:
    """Assemble a published index from laid-out fp32 blocks (chunked so
    the device working set stays bounded).

    host_quantize=True runs the residual quantization in chunked numpy
    and uploads only the final arrays — at 100M x 128 that is ~13.7GB
    over the host↔device link instead of 51GB of fp32 blocks (the link,
    not compute, bounds very large builds)."""
    nb, s, d = block_vecs.shape
    if chunk_blocks <= 0:
        chunk_blocks = _pow2_at_least(max(1, (1 << 26) // max(1, s * d * 4)))
    if host_quantize:
        codes_h = np.empty((nb, s, d), np.int8)
        cent_h = np.empty((nb, d), np.float32)
        scale_h = np.empty(nb, np.float32)
        rowsq_h = np.empty((nb, s), np.float32)
        valid_h = np.empty(nb, bool)
        for st in range(0, nb, chunk_blocks):
            en = min(st + chunk_blocks, nb)
            bv = block_vecs[st:en]
            ids = block_ids[st:en]
            vmask = ids >= 0
            cnt = np.maximum(vmask.sum(axis=1), 1)[:, None]
            cent = np.einsum(
                "bsd,bs->bd", bv, vmask.astype(np.float32)
            ) / cnt
            resid = np.where(vmask[:, :, None], bv - cent[:, None, :], 0.0)
            amax = np.abs(resid).max(axis=(1, 2))
            scale = np.maximum(amax, 1e-30) / 127.0
            codes = np.clip(
                np.round(resid / scale[:, None, None]), -127, 127
            ).astype(np.int8)
            recon = cent[:, None, :] + codes * scale[:, None, None]
            codes_h[st:en] = codes
            cent_h[st:en] = cent
            scale_h[st:en] = scale
            rowsq_h[st:en] = np.einsum("bsd,bsd->bs", recon, recon)
            valid_h[st:en] = vmask.any(axis=1)
        return IvfDeviceIndex(
            centroids=jnp.asarray(cent_h),
            cent_sq=jnp.asarray(np.einsum("bd,bd->b", cent_h, cent_h)),
            block_valid=jnp.asarray(valid_h),
            blocks_i8=jnp.asarray(codes_h),
            block_scale=jnp.asarray(scale_h),
            row_sq=jnp.asarray(rowsq_h),
            block_ids=jnp.asarray(block_ids),
        )
    parts = [[] for _ in range(6)]
    for st in range(0, nb, chunk_blocks):
        en = min(st + chunk_blocks, nb)
        out = quantize_blocks(
            jnp.asarray(block_vecs[st:en], jnp.float32),
            jnp.asarray(block_ids[st:en]),
        )
        for lst, arr in zip(parts, out):
            lst.append(arr)
    codes, cent, cent_sq, scale, row_sq, valid = (
        jnp.concatenate(p) for p in parts
    )
    return IvfDeviceIndex(
        centroids=cent,
        cent_sq=cent_sq,
        block_valid=valid,
        blocks_i8=codes,
        block_scale=scale,
        row_sq=row_sq,
        block_ids=jnp.asarray(block_ids),
    )


@functools.partial(jax.jit, static_argnames=())
def _assign_chunk2(
    xc: jnp.ndarray,          # [n, d] f32
    a1: jnp.ndarray,          # [n] int32 level-1 assignment
    cents2: jnp.ndarray,      # [C1, c2max, d] f32 level-2 centroid table
    c2_valid: jnp.ndarray,    # [C1, c2max] bool
) -> jnp.ndarray:
    """Second-level assignment: each row scores only its own cluster's
    level-2 centroids (a [n, c2max, d] gathered pass — c2max is small,
    so this is cheap relative to the level-1 matmul)."""
    sub = jnp.take(cents2, a1, axis=0)            # [n, c2max, d]
    val = jnp.take(c2_valid, a1, axis=0)          # [n, c2max]
    ssq = jnp.sum(sub * sub, axis=2)
    dots = jnp.sum(
        sub.astype(jnp.bfloat16) * xc.astype(jnp.bfloat16)[:, None, :],
        axis=-1, dtype=jnp.float32,
    )
    dd = jnp.where(val, ssq - 2.0 * dots, INF)
    return jnp.argmin(dd, axis=1).astype(jnp.int32)


def _cluster_row_tables(
    rows_src: np.ndarray, a: np.ndarray, n_clusters: int, r_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather up to ``r_max`` rows per cluster into a padded [C, r_max, d]
    table (host, fully vectorized). Returns (tables, valid, sizes)."""
    order = np.argsort(a, kind="stable")
    a_sorted = a[order]
    sizes = np.bincount(a, minlength=n_clusters)
    starts = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    rank = np.arange(len(a), dtype=np.int64) - starts[a_sorted]
    keep = rank < r_max
    tables = np.zeros((n_clusters, r_max, rows_src.shape[1]), np.float32)
    valid = np.zeros((n_clusters, r_max), bool)
    tables[a_sorted[keep], rank[keep]] = rows_src[order[keep]]
    valid[a_sorted[keep], rank[keep]] = True
    return tables, valid, sizes


@functools.partial(jax.jit, static_argnames=("rows",))
def _assign_at(vec, start, cent, rows):
    """Level-1 assignment of one ``rows``-window of a device-resident
    sample (dynamic_slice clamps; callers handle tail overlap)."""
    xc = jax.lax.dynamic_slice_in_dim(vec, start, rows, axis=0).astype(
        jnp.float32
    )
    return _assign_chunk(xc, cent)


def _assign_sample_device(
    sample_d: jnp.ndarray, cent1: jnp.ndarray, n_clusters: int
) -> np.ndarray:
    """Chunked level-1 assignment of a DEVICE-resident sample; only int32
    assignments cross the link. The [chunk, C] f32 dots temp is bounded
    to ~512 MB (same budget as assign_clusters' host path)."""
    n = int(sample_d.shape[0])
    chunk = int(np.clip((1 << 27) // max(n_clusters, 1), 4096, 262144))
    chunk = min(1 << (chunk.bit_length() - 1), n)
    starts = [min(st, n - chunk) for st in range(0, n, chunk)]
    outs = [_assign_at(sample_d, st, cent1, chunk) for st in starts]
    o = np.asarray(jnp.stack(outs))  # one pull
    a1s = np.empty(n, np.int32)
    for st, start, oo in zip(range(0, n, chunk), starts, o):
        off = st - start
        en = min(st + chunk, n)
        a1s[st:en] = oo[off:off + en - st]
    return a1s


@jax.jit
def _cov_device(sample: jnp.ndarray) -> jnp.ndarray:
    x = sample.astype(jnp.float32)
    x = x - jnp.mean(x, axis=0, keepdims=True)
    return jnp.dot(x.T, x, precision=jax.lax.Precision.HIGHEST)


def principal_axis_device(sample_d: jnp.ndarray) -> jnp.ndarray:
    """principal_axis for a device-resident sample: only the [d, d]
    covariance crosses the link (65 KB at d=128 vs the full sample)."""
    cov = np.asarray(_cov_device(sample_d), np.float64)
    _, v = np.linalg.eigh(cov)
    return jnp.asarray(np.ascontiguousarray(v[:, -1], np.float32))


@functools.partial(jax.jit, static_argnames=("n_clusters", "r_max"))
def _scatter_rows_device(sample, slot_row, n_clusters, r_max):
    d = sample.shape[1]
    tab = jnp.zeros((n_clusters * r_max + 1, d), jnp.float32)
    tab = tab.at[slot_row].set(sample.astype(jnp.float32))
    return tab[:-1].reshape(n_clusters, r_max, d)


@jax.jit
def _thin_fix_device(cents2, cent1, thin):
    first = jnp.where(thin[:, None], cent1, cents2[:, 0, :])
    return cents2.at[:, 0, :].set(first)


def _fit_two_level_device(
    sample_d: jnp.ndarray,
    n_clusters: int,
    block_rows: int,
    est_total: int,
    *,
    kmeans_iters: int,
    seed: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, int]:
    """Two-level coarse-quantizer fit with the sample DEVICE-RESIDENT.

    Only O(sample) int32 assignments, the d×d covariance, and O(C)
    planning scalars cross the host↔device link. A host fit moves the
    fp32 sample across that link three times (pull for host cluster
    tables, re-upload for the level-1 k-means, re-upload for sample
    assignment); the fit path has no reason to move the sample at all.
    Same algorithm and quality tier as
    the host fit it replaces (level-2 centroids from per-cluster sample
    tables, thin-cluster fallback to level-1, principal axis for
    within-cell ordering).

    Returns (cent1, cents2, c2_valid, pc1, c2max) — all device arrays
    except the static c2max.
    """
    n_s, d = int(sample_d.shape[0]), int(sample_d.shape[1])
    s = int(block_rows)
    cent1 = kmeans_fit(sample_d, n_clusters, iters=kmeans_iters, seed=seed)
    a1s = _assign_sample_device(sample_d, cent1, n_clusters)
    sizes_s = np.bincount(a1s, minlength=n_clusters)
    r_max = _pow2_at_least(min(4096, max(int(sizes_s.max()), 1)))
    while n_clusters * r_max * d * 4 > (768 << 20) and r_max > 256:
        r_max //= 2  # same fit-table memory cap as the host fit
    # host plans slots (cheap int work on the 2.6 MB assignment pull),
    # ONE device scatter builds the [C, r_max, d] tables in place
    order = np.argsort(a1s, kind="stable")
    a_sorted = a1s[order]
    starts = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes_s, out=starts[1:])
    rank = np.arange(n_s, dtype=np.int64) - starts[a_sorted]
    keep = rank < r_max
    slot = np.where(
        keep, a_sorted.astype(np.int64) * r_max + rank, n_clusters * r_max
    )
    slot_row = np.full(n_s, n_clusters * r_max, np.int64)
    slot_row[order] = slot
    tables = _scatter_rows_device(
        sample_d, jnp.asarray(slot_row.astype(np.int32)), n_clusters, r_max
    )
    valid = np.zeros((n_clusters, r_max), bool)
    valid[a_sorted[keep], rank[keep]] = True
    est = sizes_s * (est_total / max(1, n_s))
    c2 = np.maximum(1, -(-est.astype(np.int64) // s))
    c2 = np.minimum(c2, np.maximum(sizes_s, 1))
    c2max = int(_pow2_at_least(int(c2.max())))
    cents2 = kmeans_fit_batched(
        tables, jnp.asarray(valid), c2max,
        iters=max(4, kmeans_iters // 2), seed=seed,
    )
    cents2 = _thin_fix_device(cents2, cent1, jnp.asarray(sizes_s < 2))
    c2_valid = jnp.asarray(np.arange(c2max)[None, :] < c2[:, None])
    pc1 = principal_axis_device(sample_d)
    return cent1, cents2, c2_valid, pc1, c2max


def _two_level_pass(
    vectors: np.ndarray,
    rows_idx: Optional[np.ndarray],
    a1_of_rows: np.ndarray,
    cents2: jnp.ndarray,
    c2_valid: jnp.ndarray,
    chunk_rows: int,
) -> np.ndarray:
    """Chunked level-2 assignment of (a subset of) corpus rows. Returns
    the per-row sub-cell index."""
    d = vectors.shape[1]
    n_rows = len(a1_of_rows)
    out = np.empty(n_rows, np.int32)
    for st in range(0, n_rows, chunk_rows):
        en = min(st + chunk_rows, n_rows)
        idx = slice(st, en) if rows_idx is None else rows_idx[st:en]
        xc = np.ascontiguousarray(vectors[idx], np.float32)
        a1c = np.ascontiguousarray(a1_of_rows[st:en], np.int32)
        rows_n = xc.shape[0]
        if rows_n < chunk_rows:
            xc = np.concatenate(
                [xc, np.zeros((chunk_rows - rows_n, d), np.float32)]
            )
            a1c = np.concatenate(
                [a1c, np.zeros(chunk_rows - rows_n, np.int32)]
            )
        a2c = _assign_chunk2(
            jnp.asarray(xc), jnp.asarray(a1c), cents2, c2_valid
        )
        out[st:en] = np.asarray(a2c)[:rows_n]
    return out


def sample_refined_assign(
    vectors: np.ndarray,
    sample: np.ndarray,
    n_clusters: int,
    block_rows: int,
    *,
    est_total: Optional[int] = None,
    kmeans_iters: int = 12,
    seed: int = 0,
    chunk_rows: int = 0,
    fit_rows_cap: int = 4096,
) -> np.ndarray:
    """Two-level cell assignment where level-2 centroids are fit from the
    SAMPLE only — no per-cluster gathers over the full corpus. This is the
    very-large-N path (at 100M rows the exact per-cluster refine would
    re-stream the whole corpus through host↔device transfers; the sample
    holds enough rows per coarse cluster to place ~size/S sub-centroids).
    All level-2 fits run as ONE batched device program (per-cluster calls
    would each pay a launch and a host sync). Returns a densely-renumbered
    cell
    assignment for ``vectors``."""
    s = block_rows
    n = vectors.shape[0] if est_total is None else est_total
    cent1 = kmeans_fit(
        jnp.asarray(sample), n_clusters, iters=kmeans_iters, seed=seed
    )
    a1s = assign_clusters(
        sample, cent1, chunk_rows=min(max(len(sample), 1), 262144)
    )
    sizes_s = np.bincount(a1s, minlength=n_clusters)
    r_max = _pow2_at_least(min(fit_rows_cap, max(int(sizes_s.max()), 1)))
    # same ~768 MB table cap as build_ivf_device: at 100M rows n_clusters
    # hits 4096 and an uncapped 4096x4096x128 f32 table is 8.6 GiB before
    # the batched-kmeans temps even land
    d_fit = sample.shape[1]
    while n_clusters * r_max * d_fit * 4 > (768 << 20) and r_max > 256:
        r_max //= 2
    tables, valid, _ = _cluster_row_tables(sample, a1s, n_clusters, r_max)
    est = sizes_s * (n / max(1, len(sample)))
    c2 = np.maximum(1, -(-est.astype(np.int64) // s))
    c2 = np.minimum(c2, np.maximum(sizes_s, 1))  # no more cells than rows
    c2max = int(_pow2_at_least(int(c2.max())))
    cents2 = np.array(  # np.array: asarray views of jax buffers are read-only
        kmeans_fit_batched(
            jnp.asarray(tables), jnp.asarray(valid), c2max,
            iters=max(4, kmeans_iters // 2), seed=seed,
        )
    )
    thin = sizes_s < 2  # sample missed the cluster: fall back to level-1
    cents2[thin, 0] = np.asarray(cent1)[thin]
    c2_valid = np.arange(c2max)[None, :] < c2[:, None]
    cents2_d, c2v_d = jnp.asarray(cents2), jnp.asarray(c2_valid)
    if chunk_rows <= 0:
        # chunk large enough that host↔device round trips don't dominate
        # a 100M-row pass (each chunk is 2 device calls), bounded so the
        # [chunk, c2max, d] level-2 gather (f32 + bf16 copy + f32 dots,
        # ~6 B/elem) stays ~1.5 GB of working set
        d_ = vectors.shape[1]
        chunk_rows = int(
            np.clip((3 << 28) // max(1, c2max * d_), 16384, 262144)
        )
        chunk_rows = 1 << (chunk_rows.bit_length() - 1)  # round down to pow2

    out = np.empty(vectors.shape[0], np.int64)
    d = vectors.shape[1]
    for st in range(0, vectors.shape[0], chunk_rows):
        en = min(st + chunk_rows, vectors.shape[0])
        xc = np.ascontiguousarray(vectors[st:en], np.float32)
        rows_n = xc.shape[0]
        if rows_n < chunk_rows:
            xc = np.concatenate(
                [xc, np.zeros((chunk_rows - rows_n, d), np.float32)]
            )
        a1c = _assign_chunk(jnp.asarray(xc), cent1)
        a2c = _assign_chunk2(jnp.asarray(xc), a1c, cents2_d, c2v_d)
        out[st:en] = (
            np.asarray(a1c)[:rows_n].astype(np.int64) * c2max
            + np.asarray(a2c)[:rows_n]
        )
    _, dense = np.unique(out, return_inverse=True)
    return dense.astype(np.int32)


def refine_oversized(
    vectors: np.ndarray,
    assign: np.ndarray,
    *,
    block_rows: int,
    seed: int = 0,
    iters: int = 6,
    max_span_blocks: int = 2,
    fit_rows_cap: int = 8192,
    chunk_rows: int = 32768,
) -> np.ndarray:
    """Second k-means level: split every cluster spanning more than
    ``max_span_blocks`` blocks into ~size/S sub-cells. A 1-D
    principal-axis sort partitions a big high-dimensional cluster into
    thin slabs with weak locality; local k-means keeps blocks round,
    which is what makes per-block mini-centroids discriminative
    (hierarchical IVF — the standard two-level coarse quantizer). All
    per-cluster fits run as ONE batched device program; fit rows are a
    random subsample capped at ``fit_rows_cap`` per cluster. Returns a
    refined (densely renumbered) assignment array."""
    s = block_rows
    n_clusters = int(assign.max()) + 1 if len(assign) else 0
    sizes = np.bincount(assign, minlength=n_clusters)
    over = np.nonzero(sizes > max_span_blocks * s)[0]
    if not len(over):
        return assign.astype(np.int32)
    comp = np.full(n_clusters, -1, np.int64)
    comp[over] = np.arange(len(over))
    rows_idx = np.nonzero(comp[assign] >= 0)[0]
    a_comp = comp[assign[rows_idx]].astype(np.int32)
    r_max = _pow2_at_least(min(fit_rows_cap, int(sizes[over].max())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(rows_idx))
    tables, valid, _ = _cluster_row_tables(
        vectors[rows_idx[perm]], a_comp[perm], len(over), r_max
    )
    c2 = np.minimum(-(-sizes[over] // s), np.maximum(sizes[over], 1))
    c2max = int(_pow2_at_least(int(c2.max())))
    cents2 = kmeans_fit_batched(
        jnp.asarray(tables), jnp.asarray(valid), c2max,
        iters=iters, seed=seed,
    )
    c2_valid = np.arange(c2max)[None, :] < c2[:, None]
    sub = _two_level_pass(
        vectors, rows_idx, a_comp, cents2, jnp.asarray(c2_valid), chunk_rows
    )
    base = np.zeros(len(over) + 1, np.int64)
    np.cumsum(c2, out=base[1:])
    out = assign.astype(np.int64).copy()
    out[rows_idx] = n_clusters + base[a_comp] + sub
    _, dense = np.unique(out, return_inverse=True)
    return dense.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("rows", "c2max"))
def _assign_proj_at(vec, start, cent1, cents2, c2_valid, pc1, rows, c2max):
    """Level-1 + level-2 assignment and principal-axis projection of one
    ``rows``-sized window of a device-resident corpus (start clamps).

    Returns ONE [2, rows] int32 array (combined assignment a1*c2max+a2,
    and the projection BITCAST to int32) so the caller can drain every
    chunk with a single device pull (one host sync per chunk instead of
    three). The bitcast keeps the combined index exact for ANY
    n_clusters*c2max (an f32 packing silently rounds past 2^24); hosts
    recover proj via .view(np.float32)."""
    xc = jax.lax.dynamic_slice_in_dim(vec, start, rows, axis=0).astype(
        jnp.float32
    )
    a1 = _assign_chunk(xc, cent1)
    a2 = _assign_chunk2(xc, a1, cents2, c2_valid)
    comb = a1 * c2max + a2
    proj_bits = jax.lax.bitcast_convert_type(xc @ pc1, jnp.int32)
    return jnp.stack([comb, proj_bits])


def build_ivf_device(
    dev_vectors: jnp.ndarray,
    row_ids: Optional[np.ndarray] = None,
    *,
    present: Optional[np.ndarray] = None,
    block_rows: int = 1024,
    n_clusters: int = 0,
    kmeans_iters: int = 12,
    train_sample: int = 0,
    seed: int = 0x1BF,
    chunk_rows: int = 262144,
    chunk_blocks: int = 0,
    block_align: int = 0,
) -> IvfDeviceIndex:
    """Build an IvfDeviceIndex from an ALREADY-UPLOADED [cap, d] mirror.

    ``build_ivf`` streams the fp32 corpus across the host↔device link
    roughly twice (assignment matmuls + block upload); the host link is
    far slower than device memory, so that transfer dominates the build.
    Here the corpus never crosses the link again: the k-means
    sample, assignment matmuls, projection matvec, the block-layout
    gather AND the residual quantization all read the resident device
    array; only O(cap) int32/float32 vectors (assignments, projections)
    come back for numpy's bincount/lexsort.

    dev_vectors rows are addressed by POSITION; ``present`` (bool [cap])
    masks live rows (default: all), ``row_ids`` maps position → external
    id (default: identity). Level 2 uses the sample-fit path
    (sample_refined_assign quality tier — no full-corpus re-gathers).
    """
    cap, d = dev_vectors.shape
    s = int(block_rows)
    if row_ids is None:
        row_ids = np.arange(cap, dtype=np.int64)
    row_ids = np.asarray(row_ids, np.int64)
    if present is None:
        pos_live = np.arange(cap, dtype=np.int64)
    else:
        pos_live = np.nonzero(np.asarray(present))[0]
    n = len(pos_live)
    if n == 0:
        raise ValueError("build_ivf_device: no live rows")
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if train_sample <= 0:
        train_sample = int(np.clip(256 * n_clusters, 131072, 4_000_000))
    train_sample = min(train_sample, max(1, n))
    stride = max(1, n // train_sample)
    # the k-means sample never leaves the device (level 1 + sample-fit
    # level 2, same quality tier as sample_refined_assign); the [C,r_max,d]
    # fit-table memory cap lives inside _fit_two_level_device (uncapped
    # it ran out of device memory next to the serving mirrors)
    samp_pos = pos_live[::stride][:train_sample]
    sample_d = jnp.take(dev_vectors, jnp.asarray(samp_pos), axis=0).astype(
        jnp.float32
    )
    _probe("sample")
    cent1, cents2_d, c2v_d, pc1_d, c2max = _fit_two_level_device(
        sample_d, n_clusters, s, n, kmeans_iters=kmeans_iters, seed=seed
    )
    sample_d = None
    _probe("fit")

    # bound the [chunk, c2max, d] level-2 centroid gather: the gather
    # materialises in f32 (+ a bf16 copy and the f32 dots), so budget
    # ~6 bytes/element for ~1.5 GB of working set. (The old /2 estimate
    # assumed bf16-only and let a 65536-row chunk at c2max=64 allocate a
    # 2.1 GB f32 gather.)
    chunk_rows = int(
        np.clip((3 << 28) // max(1, c2max * d), 16384, chunk_rows)
    )
    chunk_rows = 1 << (chunk_rows.bit_length() - 1)
    chunk_rows = min(chunk_rows, cap)
    # one jitted program serves every chunk (a python-int slice per chunk
    # would bake 39 distinct programs at 10M rows); dynamic_slice clamps,
    # so the tail chunk re-reads overlap instead of recompiling. Chunk
    # launches are dispatched async and drained with ONE host pull.
    starts = [min(st, cap - chunk_rows) for st in range(0, cap, chunk_rows)]
    outs = [
        _assign_proj_at(
            dev_vectors, start, cent1, cents2_d, c2v_d, pc1_d,
            chunk_rows, c2max,
        )
        for start in starts
    ]
    outs = np.asarray(jnp.stack(outs))  # one device->host transfer
    _probe("assign")
    assign64 = np.empty(cap, np.int64)
    proj = np.empty(cap, np.float32)
    for st, start, o in zip(range(0, cap, chunk_rows), starts, outs):
        off = st - start
        en = min(st + chunk_rows, cap)
        assign64[st:en] = o[0, off:off + en - st].astype(np.int64)
        proj[st:en] = o[1, off:off + en - st].view(np.float32)
    del outs
    a64_live = assign64[pos_live]
    _, dense = np.unique(a64_live, return_inverse=True)
    assign = dense.astype(np.int32)
    _, l1 = np.unique(a64_live // c2max, return_inverse=True)
    l1 = l1.astype(np.int32)

    # host layout planning (cheap O(n) int work), device gather+quantize.
    # Rows are ordered cell-major (L2 within L1, principal-axis within a
    # cell). Two layout regimes, switched together with the block_align
    # policy below:
    #  * small builds (<=4k blocks): whole-block allocation per CELL —
    #    every block is one round k-means sub-cluster, the most
    #    discriminative mini-centroids; tail padding is a few MB.
    #  * large builds: whole-block allocation at L1-CLUSTER boundaries,
    #    exactly as build_ivf_streaming lays out. Per-cell padding at the
    #    ~1-block cell sizes large builds target left blocks ~55% full at
    #    10M rows (18,432 blocks for ~9,856 needed), which both wasted
    #    scan compute and halved the real rows covered per probe (probe=8
    #    recall fell to 0.64). A straddle block's
    #    mini-centroid/scale come from its actual members
    #    (quantize_blocks); the slightly larger residual range is
    #    repaired by the rescore tier.
    # Padding policy: pow2 block counts keep serve-program shapes stable
    # across throttled rebuilds; above ~4k blocks the pow2 waste is GBs of
    # dead codes, so large one-shot builds auto-switch to 1024-alignment,
    # same policy as build_ivf_streaming.
    order = np.lexsort((proj[pos_live], assign))
    if block_align <= 0:
        n_blk_est = -(-n // s)
        block_align = 1024 if n_blk_est > 4096 else 0
    group = l1 if block_align > 0 else assign
    pos, _nb, nb_pad = plan_blocks(group, order, s, block_align=block_align)
    src_flat = np.full(nb_pad * s, -1, np.int64)   # slot -> device row
    src_flat[pos] = pos_live[order]
    ids_flat = np.full(nb_pad * s, -1, np.int64)   # slot -> external id
    ids_flat[pos] = row_ids[pos_live[order]]
    if chunk_blocks <= 0:
        chunk_blocks = _pow2_at_least(max(1, (1 << 26) // max(1, s * d * 4)))
    parts = [[] for _ in range(6)]
    src2 = src_flat.reshape(nb_pad, s)
    ids2 = ids_flat.reshape(nb_pad, s).astype(np.int32)
    for st in range(0, nb_pad, chunk_blocks):
        en = min(st + chunk_blocks, nb_pad)
        idx = jnp.asarray(np.maximum(src2[st:en], 0).reshape(-1))
        bv = (
            jnp.take(dev_vectors, idx, axis=0)
            .astype(jnp.float32)
            .reshape(en - st, s, d)
        )
        ids_c = jnp.asarray(ids2[st:en])
        bv = jnp.where((ids_c >= 0)[:, :, None], bv, 0.0)
        out = quantize_blocks(bv, ids_c)
        for lst, arr in zip(parts, out):
            lst.append(arr)
        # per-chunk sync bounds queued device memory: async dispatch with
        # no sync holds EVERY pending chunk's [chunk_blocks, S, d] f32
        # gather buffer at once — 128 launches x ~145 MB ≈ 18 GiB at 10M
        # rows.
        out[3].block_until_ready()
        _probe("quantize")
    codes, cent, cent_sq, scale, row_sq, bvalid = (
        jnp.concatenate(p) if len(p) > 1 else p[0] for p in parts
    )
    _probe("concat")
    return IvfDeviceIndex(
        centroids=cent,
        cent_sq=cent_sq,
        block_valid=bvalid,
        blocks_i8=codes,
        block_scale=scale,
        row_sq=row_sq,
        block_ids=jnp.asarray(ids2),
    )


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=("s",))
def _acc_block_means(csum, cnt, xc, dslot, s):
    blk = dslot // s
    return csum.at[blk].add(xc), cnt.at[blk].add(1.0)


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("s",))
def _acc_block_amax(amax, xc, dslot, cents, s):
    blk = dslot // s
    r = jnp.max(jnp.abs(xc - jnp.take(cents, blk, axis=0)), axis=1)
    return amax.at[blk].max(r)


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=("s",))
def _quant_scatter(codes, rowsq, xc, dslot, cents, scale, s):
    blk = dslot // s
    c = jnp.take(cents, blk, axis=0)
    sc = jnp.take(scale, blk)[:, None]
    q8 = jnp.clip(jnp.round((xc - c) / sc), -127, 127).astype(jnp.int8)
    recon = c + q8.astype(jnp.float32) * sc
    # reconstruction norm, not row norm — see quantize_blocks
    return (
        codes.at[dslot].set(q8),
        rowsq.at[dslot].set(jnp.sum(recon * recon, axis=1)),
    )


def build_ivf_streaming(
    chunk_source: Callable[[int], jnp.ndarray],
    n_chunks: int,
    *,
    block_rows: int = 1024,
    n_clusters: int = 0,
    kmeans_iters: int = 12,
    train_sample: int = 0,
    seed: int = 0x1BF,
    sub_rows: int = 262144,
    block_align: int = 1024,
    log_fn: Optional[Callable[[str], None]] = None,
) -> IvfDeviceIndex:
    """Build an IvfDeviceIndex from a CHUNK SOURCE, never holding the fp32
    corpus anywhere — not on the host, not in device memory.

    ``chunk_source(ci)`` returns chunk ci as a device [chunk_rows, d] f32
    array and must be deterministic per ci: the build reads the corpus in
    three streaming passes (assign, block means + residual max, quantize +
    scatter), regenerating/re-reading each chunk instead of storing it.
    That is what lets one card build a corpus larger than its memory:
    at 100M x 128 the fp32 corpus is 51 GiB, but the build's residency is
    just the final int8 block store (~12.9 GiB) plus one chunk of f32 (the
    reference's answer at this scale is horizontal sharding only — hnswlib
    holds every fp32 vector resident, hnswalg.h addPoint).

    Same partition quality tier as build_ivf_device (sample-fit level 2):
    the k-means sample comes from chunk 0 — chunks must be iid-equivalent
    (true for generated corpora and shuffled datasets; shard-ordered real
    datasets should pass a shuffled reader).

    Scatter passes run donated (in-place) device updates keyed by the
    host-planned slot of each row; per-chunk device transient is one f32
    chunk + gather/round temps, bounded by ``sub_rows`` sub-slices.
    block_align pads the block count to a multiple (NOT pow2 — at 100M
    pow2 padding would waste 4+ GiB of codes, see plan_blocks).
    """
    def _log(msg):
        if log_fn is not None:
            log_fn(f"ivf-streaming: {msg}")

    probe = chunk_source(0)
    ch, d = probe.shape
    s = int(block_rows)
    n = n_chunks * ch
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if train_sample <= 0:
        train_sample = int(np.clip(256 * n_clusters, 131072, 1_048_576))
    train_sample = min(train_sample, ch)
    # the fit sample never leaves the device (see _fit_two_level_device)
    sample_d = probe[:train_sample].astype(jnp.float32)
    _log(f"fit: {train_sample} sample rows, {n_clusters} clusters")
    cent1, cents2_d, c2v_d, pc1_d, c2max = _fit_two_level_device(
        sample_d, n_clusters, s, n, kmeans_iters=kmeans_iters, seed=seed
    )
    sample_d = None

    _log("fit done; pass 1 (assign)")
    # ---- pass 1: assignment + projection, chunk by chunk -------------------
    # two working sets bound the sub-chunk: the [rows, c2max, d] level-2
    # gather and the [rows, n_clusters] level-1 dots (0.5 GB each)
    chunk_sub = int(np.clip(
        min((3 << 28) // max(1, c2max * d),
            (1 << 27) // max(1, n_clusters)),
        16384, sub_rows))
    chunk_sub = 1 << (chunk_sub.bit_length() - 1)
    chunk_sub = min(chunk_sub, ch)
    assign64 = np.empty(n, np.int64)
    proj = np.empty(n, np.float32)
    for ci in range(n_chunks):
        xc = probe if ci == 0 else chunk_source(ci)
        starts = [min(st, ch - chunk_sub) for st in range(0, ch, chunk_sub)]
        outs = [
            _assign_proj_at(xc, st, cent1, cents2_d, c2v_d, pc1_d,
                            chunk_sub, c2max)
            for st in starts
        ]
        o = np.asarray(jnp.stack(outs))  # one pull per chunk
        base = ci * ch
        for st, start, oo in zip(range(0, ch, chunk_sub), starts, o):
            off = st - start
            en = min(st + chunk_sub, ch)
            assign64[base + st:base + en] = oo[0, off:off + en - st].astype(
                np.int64)
            proj[base + st:base + en] = oo[1, off:off + en - st].view(
                np.float32)
        xc = outs = o = None
    probe = None
    # the fit tables are pass-1-only; at 100M-scale cents2_d alone is
    # hundreds of MB and the endgame (block store + final reshapes) runs
    # close to the memory limit — release them before passes 2/3
    cent1 = cents2_d = c2v_d = pc1_d = None
    _, cell = np.unique(assign64, return_inverse=True)
    cell = cell.astype(np.int32)
    _, l1 = np.unique(assign64 // c2max, return_inverse=True)
    l1 = l1.astype(np.int32)
    assign64 = None

    # ---- layout plan (host int work) ---------------------------------------
    # rows are ordered cell-major (L2 within L1, principal-axis within a
    # cell) but blocks pad only at L1-cluster boundaries: per-CELL padding
    # at ~1-block cell sizes wasted 38% of the block store (161,792 vs
    # ~98,560 blocks at ~100M — 21 GB of codes). A block may straddle
    # adjacent cells of one cluster; its centroid/scale are computed from its actual members, so the cost is
    # a slightly larger residual range in straddle blocks — absorbed by
    # the rescore tier and measured honestly by the no-rescore sweep.
    _log("pass 1 done; layout plan")
    order = np.lexsort((proj, cell))
    pos, _nb, nb_pad = plan_blocks(l1, order, s, block_align=block_align)
    _log(f"layout: {_nb} blocks, padded {nb_pad} "
         f"({nb_pad * s * d / 2**30:.1f} GiB codes)")
    cell = l1 = None
    dst = np.empty(n, np.int64)
    dst[order] = pos                      # row -> slot in [nb_pad * s]
    ids_flat = np.full(nb_pad * s, -1, np.int64)
    ids_flat[pos] = order                 # slot -> row id (identity ids)
    proj = order = pos = None

    def _dst_dev(ci):
        return jnp.asarray(dst[ci * ch:(ci + 1) * ch].astype(np.int32))

    # ---- pass 2: block means, then residual amax (scatter reductions) ------
    # Each loop syncs once per chunk: that bounds queued device memory —
    # async dispatch with no sync queues every pending chunk's 0.5-1.3 GiB
    # generated buffer at once (~52 GiB at 77 chunks).
    csum = jnp.zeros((nb_pad, d), jnp.float32)
    cnt = jnp.zeros((nb_pad,), jnp.float32)
    for ci in range(n_chunks):
        csum, cnt = _acc_block_means(
            csum, cnt, chunk_source(ci), _dst_dev(ci), s)
        cnt.block_until_ready()
    cents = csum / jnp.maximum(cnt, 1.0)[:, None]
    csum = None
    _log("pass 2a (means) done")
    amax = jnp.zeros((nb_pad,), jnp.float32)
    for ci in range(n_chunks):
        amax = _acc_block_amax(amax, chunk_source(ci), _dst_dev(ci), cents, s)
        amax.block_until_ready()
    scale = (jnp.maximum(amax, 1e-30) / 127.0).astype(jnp.float32)
    amax = None
    _log("pass 2b (residual max) done")

    # ---- pass 3: quantize + scatter into the donated block store -----------
    nslot = nb_pad * s
    # bound the per-step gather/round temps (~16 bytes per row element) to
    # a third of what the donated block store leaves of device memory
    from valkey_search_tpu.ops.topk import device_memory_limit

    temp_cap = max(64 << 20,
                   (device_memory_limit() - nslot * (d + 4)) // 3)
    qsub = ch
    while qsub * d * 4 * 4 > temp_cap and qsub % 2 == 0:
        qsub //= 2
    codes = jnp.zeros((nslot, d), jnp.int8)
    rowsq = jnp.zeros((nslot,), jnp.float32)
    for ci in range(n_chunks):
        xc = chunk_source(ci)
        dslot = _dst_dev(ci)
        for st in range(0, ch, qsub):
            m = min(qsub, ch - st)
            codes, rowsq = _quant_scatter(
                codes, rowsq,
                jax.lax.dynamic_slice_in_dim(xc, st, m),
                jax.lax.dynamic_slice_in_dim(dslot, st, m),
                cents, scale, s)
        rowsq.block_until_ready()
        xc = dslot = None
        if ci % 16 == 15:
            _log(f"pass 3 (quantize+scatter): chunk {ci + 1}/{n_chunks}")

    _log("pass 3 done; uploading block ids")
    ids2 = ids_flat.reshape(nb_pad, s).astype(np.int32)
    # Final reshapes run DONATED so XLA aliases the buffers in place: an
    # eager .reshape would materialize a second copy next to the ~12.9 GiB
    # block store (at 100M rows).
    codes = jax.jit(
        lambda c: c.reshape(nb_pad, s, d), donate_argnums=0)(codes)
    rowsq = jax.jit(
        lambda r: r.reshape(nb_pad, s), donate_argnums=0)(rowsq)
    return IvfDeviceIndex(
        centroids=cents,
        cent_sq=jnp.sum(cents * cents, axis=1),
        block_valid=jnp.asarray((ids2 >= 0).any(axis=1)),
        blocks_i8=codes,
        block_scale=scale,
        row_sq=rowsq,
        block_ids=jnp.asarray(ids2),
    )


def build_ivf(
    vectors: np.ndarray,
    row_ids: Optional[np.ndarray] = None,
    *,
    block_rows: int = 1024,
    n_clusters: int = 0,
    kmeans_iters: int = 12,
    train_sample: int = 0,
    seed: int = 0x1BF,
    chunk_rows: int = 262144,
    refine: str = "auto",
    host_quantize: Optional[bool] = None,
) -> IvfDeviceIndex:
    """Build an IvfDeviceIndex from a host fp32 corpus [N, d].

    Partition: k-means into ``n_clusters`` coarse cells (default ~N/(8S),
    so a typical cluster spans ~8 blocks), a second k-means level inside
    oversized cells, then principal-axis sort within each cell, then chop
    into S-row blocks. Host does the O(N) reorder (numpy lexsort +
    gathers); the device does the O(N·C) assignment matmuls, the k-means
    fits, and the residual quantization.

    refine: "exact" gathers each oversized cluster's rows for its level-2
    fit (best quality); "sample" fits level-2 centroids from the training
    sample only (no full-corpus re-streaming — the 100M path); "none"
    skips level 2; "auto" picks exact below 20M rows, sample above.
    """
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    s = int(block_rows)
    if row_ids is None:
        row_ids = np.arange(n, dtype=np.int64)
    row_ids = np.asarray(row_ids, np.int64)
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if refine == "auto":
        refine = "exact" if n <= 20_000_000 else "sample"
    if train_sample <= 0:
        # enough rows per coarse cluster to seed level 1 (and level 2 in
        # sample mode: ~size/S sub-centroids need ~16x that many rows)
        per = 256 if refine == "sample" else 32
        train_sample = int(np.clip(per * n_clusters, 131072, 4_000_000))

    stride = max(1, n // train_sample)
    sample = vectors[::stride][:train_sample]
    if refine == "sample":
        assign = sample_refined_assign(
            vectors, sample, n_clusters, s,
            kmeans_iters=kmeans_iters, seed=seed,
        )
    else:
        cent = kmeans_fit(
            jnp.asarray(sample), n_clusters, iters=kmeans_iters, seed=seed
        )
        assign = assign_clusters(vectors, cent, chunk_rows=chunk_rows)
        if refine == "exact":
            assign = refine_oversized(
                vectors, assign, block_rows=s, seed=seed,
                iters=max(4, kmeans_iters // 2),
            )

    pc1 = principal_axis(sample)
    p = np.empty(n, np.float32)
    for st in range(0, n, chunk_rows):
        en = min(st + chunk_rows, n)
        p[st:en] = vectors[st:en] @ pc1
    order = np.lexsort((p, assign))
    pos, _nb, nb_pad = plan_blocks(assign, order, s)

    block_vecs = np.zeros((nb_pad * s, d), np.float32)
    ids_flat = np.full(nb_pad * s, -1, np.int64)
    ids_flat[pos] = row_ids[order]
    for st in range(0, n, chunk_rows):
        en = min(st + chunk_rows, n)
        block_vecs[pos[st:en]] = vectors[order[st:en]]
    if host_quantize is None:
        host_quantize = n > 20_000_000  # link-bound regime: ship int8 only
    return finalize_blocks(
        block_vecs.reshape(nb_pad, s, d),
        ids_flat.reshape(nb_pad, s).astype(np.int32),
        host_quantize=host_quantize,
    )


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------


def default_probe(index: IvfDeviceIndex) -> int:
    """Auto probe (search.ivf-probe=0). Recall sweeps on clustered
    128-d data (scripts/crossover.py) show probe=8 holding recall@10
    ≥ 0.995 through ~6M rows, then collapsing (0.9766 at 8M, 0.8828 at
    10M) as the layout's block count outgrows 8-block coverage; 16 holds
    ≥ 0.995 through 10M (nb ≈ 12288). Past that range probe scales with
    the block count (the 100M layout, nb=100352, needs probe=256 ≈
    nb/392 to hold candidate coverage), linearly interpolated as
    ceil(nb/384) and clamped to [32, 512]. The step lives on nb, not n:
    coverage is a property of the block layout."""
    nb = index.n_blocks
    if nb <= 7168:
        return 8
    if nb <= 12288:
        return 16
    return int(min(512, max(32, -(-nb // 384))))


def _select_blocks(cd: jnp.ndarray, probe: int):
    """Stage-1 block selection: the ``probe`` smallest of [B, nb] block
    scores. Both primitives are exact off the TPU; on an H100 (B=16384,
    probe=16) lax.approx_min_k took 1.15 ms against lax.top_k's 2.01 ms at
    nb=1024, and 17.4 ms against 14.4 ms at nb=16384 (PERF.md), so the
    faster one is picked by width."""
    if cd.shape[-1] >= 4096:
        neg, sel = jax.lax.top_k(-cd, probe)
        return -neg, sel
    return jax.lax.approx_min_k(cd, probe)


def _grouped_gather_cap(memory_limit: int) -> int:
    """Largest int8 block gather grouped stage 2 may plan. Its temps must
    fit next to the serving index: the gather [n_seg, S, d] plus ~2 f32
    [n_seg, S, g] score buffers (einsum output + masked distances;
    ~gather * g/16 at d=128), about twice the gather in all. A quarter of
    the device's memory admits the 10M engine shape (B=16384, probe=16,
    nb=11264 → 3.53 GiB gather) and routes the 100M shape (23.7 GiB) to
    the bounded-temps steps path. The ratio was chosen on the previous
    hardware; not yet measured on the H100."""
    return memory_limit // 4


def _grouped_gather_bytes(
    b: int, eff_probe: int, nb: int, block_rows: int, d_bytes: int
) -> int:
    """Static [n_seg, S, d] int8 gather size the grouped dispatch would
    allocate — mirrors _ivf_search_batch_grouped's capacity math exactly
    so routing sees the same n_seg."""
    e = b * eff_probe
    g = 1
    while g * 2 <= min(16, max(1, e // nb)):
        g *= 2
    g = max(g, 2)
    n_seg = -(-(e + nb * (g - 1)) // g)
    return n_seg * block_rows * d_bytes


def ivf_search_batch(
    index: IvfDeviceIndex,
    queries: jnp.ndarray,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    probe_chunk: int = 8,
    filter_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pruned k-NN: [B, d] queries → (dists [B, k], row ids [B, k]) asc.

    probe: blocks scanned per query — the recall/throughput dial (the IVF
    analog of HNSW ef_runtime; FT.SEARCH EF_RUNTIME maps here when the
    planner routes to IVF).

    Two stage-2 implementations, picked by the STATIC average block
    multiplicity m = B*probe / n_blocks:
      * m >= 2 → _ivf_search_batch_grouped: MoE-style inverted dispatch.
        Entries (query, block) are sorted by block and packed into
        capacity-G segments, so each selected block is read from device
        memory ONCE and scored against its G queries with one batched
        matmul.
        The per-query gather path materialized [B, probe, S, d] int8
        (plus a bf16 copy) — ~40 GB of memory traffic per 8k-query launch at
        10M rows, 8x off the bandwidth roof; grouping reads each block
        once (~3 GB) because engine batches average ~9 queries/block.
      * m < 2 → _ivf_search_batch_steps: the per-query gather scan
        (probe_chunk bounds working memory) — grouping cannot help when
        almost every selected block serves one query (small batches,
        very large corpora), and the scan keeps temps bounded.

    Distance decomposition (module docstring): q·centroid exact in f32
    from a [probe, d] gather, |row|^2 exact, only the residual dot rides
    int8 — error ∝ block radius. "ip" scores are 1 - q·x (hnswlib
    convention); "cosine" callers pass normalized rows/queries and use
    "ip".

    filter_mask: optional bool [row-id space], query-shared (1-D), True =
    allowed — the fused-prefilter analog (reference search.cc:456; same
    1-D-only contract as topk_ops.flat_topk_fused). Probing is unfiltered
    (block selection can't see the mask), so highly-selective filters
    should take the planner's pre-filter path instead.
    """
    b = int(queries.shape[0])
    nb = index.n_blocks
    eff_probe = min(probe, nb)
    mult = (b * eff_probe) // max(nb, 1)
    # Grouped materializes a [n_seg, S, d] int8 gather of the selected
    # blocks (each segment one block copy). Bound it: at 100M rows /
    # nb=100352 / B=512 / probe=512 the gather is 23.7 GiB — past the
    # device's memory budget — while the
    # steps path bounds temps by probe_chunk. Mirror grouped's static
    # capacity math here so the routing sees the same n_seg it would
    # allocate.
    if mult >= 2:
        gather_bytes = _grouped_gather_bytes(
            b, eff_probe, nb, index.block_rows, index.blocks_i8.shape[2])
        from valkey_search_tpu.ops.topk import device_memory_limit

        if gather_bytes <= _grouped_gather_cap(device_memory_limit()):
            return _ivf_search_batch_grouped(
                index, queries, k=k, probe=probe, metric=metric,
                filter_mask=filter_mask,
            )
    return _ivf_search_batch_steps(
        index, queries, k=k, probe=probe, metric=metric,
        probe_chunk=probe_chunk, filter_mask=filter_mask,
    )


def _ivf_search_batch_grouped(
    index: IvfDeviceIndex,
    queries: jnp.ndarray,
    k: int,
    probe: int,
    metric: str,
    filter_mask: Optional[jnp.ndarray],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverted (block-major) stage 2 — see ivf_search_batch docstring.

    Accelerator shape of the idea: the same dispatch used for MoE expert
    routing
    (sort tokens by expert, pad each expert's run to a capacity multiple,
    run one dense batched matmul) applied to (query, block) pairs. All
    shapes are static: capacity G and the padded entry count derive from
    (B, probe, n_blocks) alone, and per-block overflow never drops an
    entry because runs pad to ceil(count/G)*G segments.
    """
    S = index.block_rows
    d = index.blocks_i8.shape[2]
    nb = index.n_blocks
    b = int(queries.shape[0])
    probe = min(probe, nb)
    e = b * probe
    # static capacity: largest pow2 <= avg multiplicity, in [2, 16]
    g = 1
    while g * 2 <= min(16, max(1, e // nb)):
        g *= 2
    g = max(g, 2)
    e_pad = -(-(e + nb * (g - 1)) // g) * g
    n_seg = e_pad // g

    q = queries.astype(jnp.float32)
    qbf = q.astype(jnp.bfloat16)
    q_sq = jnp.sum(q * q, axis=1)                    # [B]

    # stage 1: block mini-centroid scores — one matmul over all cells
    dots_c = (
        qbf @ index.centroids.T.astype(jnp.bfloat16)
    ).astype(jnp.float32)                            # [B, nb]
    if metric == "l2":
        cd = index.cent_sq[None, :] - 2.0 * dots_c
    else:
        cd = -dots_c
    cd = jnp.where(index.block_valid[None, :], cd, INF)
    _, sel = _select_blocks(cd, probe)               # [B, probe]

    # ---- inverted dispatch: sort entries by block, pack into segments ----
    blk_e = sel.reshape(-1)                          # [e] int32
    q_e = jnp.repeat(jnp.arange(b, dtype=jnp.int32), probe)
    order = jnp.argsort(blk_e, stable=True)          # [e]
    blk_s = jnp.take(blk_e, order)
    q_s = jnp.take(q_e, order)
    idx = jnp.arange(e, dtype=jnp.int32)
    new_run = jnp.concatenate(
        [jnp.ones((1,), bool), blk_s[1:] != blk_s[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(new_run, idx, 0))
    rank = idx - run_start                           # position within run
    counts = jnp.bincount(blk_e, length=nb)          # [nb]
    padded = -(-counts // g) * g
    base = jnp.concatenate(
        [jnp.zeros((1,), padded.dtype), jnp.cumsum(padded)])[:-1]  # [nb]
    pos = (jnp.take(base, blk_s) + rank).astype(jnp.int32)  # [e] -> [e_pad)
    pq = jnp.full((e_pad,), -1, jnp.int32).at[pos].set(q_s)
    pb = jnp.full((e_pad,), -1, jnp.int32).at[pos].set(blk_s)
    seg_blk = jnp.max(pb.reshape(n_seg, g), axis=1)  # [n_seg] (-1 = all pad)
    seg_blk_c = jnp.maximum(seg_blk, 0)
    pq_seg = pq.reshape(n_seg, g)
    pq_c = jnp.maximum(pq_seg, 0)

    # ---- one gather per segment block, one batched matmul --------------
    blkv = jnp.take(index.blocks_i8, seg_blk_c, axis=0)   # [n_seg, S, d] i8
    qv = jnp.take(qbf, pq_c, axis=0)                      # [n_seg, g, d]
    dots = jnp.einsum(
        "nsd,ngd->nsg", blkv.astype(jnp.bfloat16), qv,
        preferred_element_type=jnp.float32,
    )                                                     # [n_seg, S, g]
    cvec = jnp.take(index.centroids, seg_blk_c, axis=0)   # [n_seg, d] f32
    qf = jnp.take(q, pq_c, axis=0)                        # [n_seg, g, d] f32
    qdotc = jnp.einsum("nd,ngd->ng", cvec, qf)            # exact f32
    scale_seg = jnp.take(index.block_scale, seg_blk_c)    # [n_seg]
    rsq_seg = jnp.take(index.row_sq, seg_blk_c, axis=0)   # [n_seg, S]
    bid_seg = jnp.take(index.block_ids, seg_blk_c, axis=0)  # [n_seg, S]
    qr = scale_seg[:, None, None] * dots                  # q·residual
    if metric == "l2":
        qsq_seg = jnp.take(q_sq, pq_c, axis=0)            # [n_seg, g]
        dd = (
            qsq_seg[:, None, :]
            - 2.0 * qdotc[:, None, :]
            - 2.0 * qr
            + rsq_seg[:, :, None]
        )
    else:
        dd = 1.0 - (qdotc[:, None, :] + qr)
    allowed = (bid_seg >= 0)[:, :, None] & (pq_seg >= 0)[:, None, :]
    if filter_mask is not None:
        allowed &= jnp.take(
            filter_mask, jnp.maximum(bid_seg, 0))[:, :, None]
    dd = jnp.where(allowed, dd, INF)

    # ---- back to query-major, one top-k over each query's probe*S -------
    ent_scores = dd.transpose(0, 2, 1).reshape(e_pad, S)
    pos_orig = jnp.zeros((e,), jnp.int32).at[order].set(pos)
    dd_q = jnp.take(ent_scores, pos_orig, axis=0).reshape(b, probe * S)
    ids_q = jnp.take(index.block_ids, sel, axis=0).reshape(b, probe * S)
    kk = min(k, probe * S)
    # approx_min_k is exact off the TPU and ran 4% faster than lax.top_k
    # on an H100 at [16384, 16384], k=40 (PERF.md)
    if probe * S >= 2048:
        sd, ppos = jax.lax.approx_min_k(dd_q, kk, recall_target=0.99)
    else:
        neg, ppos = jax.lax.top_k(-dd_q, kk)
        sd = -neg
    si = jnp.take_along_axis(ids_q, ppos, axis=-1)
    si = jnp.where(jnp.isfinite(sd), si, -1)
    if kk < k:
        sd = jnp.pad(sd, ((0, 0), (0, k - kk)), constant_values=INF)
        si = jnp.pad(si, ((0, 0), (0, k - kk)), constant_values=-1)
    return sd, si


_ivf_search_batch_grouped = functools.partial(
    jax.jit, static_argnames=("k", "probe", "metric")
)(_ivf_search_batch_grouped)


@functools.partial(
    jax.jit, static_argnames=("k", "probe", "metric", "probe_chunk")
)
def _ivf_search_batch_steps(
    index: IvfDeviceIndex,
    queries: jnp.ndarray,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    probe_chunk: int = 8,
    filter_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-query gather scan (see ivf_search_batch: the m < 2 regime).
    probe_chunk bounds stage-2 working memory to [B, probe_chunk, S, d]
    per scan step."""
    q = queries.astype(jnp.float32)
    b = q.shape[0]
    nb = index.n_blocks
    probe = min(probe, nb)
    pc = max(1, min(probe_chunk, probe))
    n_steps = -(-probe // pc)
    probe_pad = n_steps * pc

    qbf = q.astype(jnp.bfloat16)
    q_sq = jnp.sum(q * q, axis=1)                    # [B]

    # stage 1: block mini-centroid scores — one matmul over all cells
    dots_c = (
        qbf @ index.centroids.T.astype(jnp.bfloat16)
    ).astype(jnp.float32)                            # [B, nb]
    if metric == "l2":
        cd = index.cent_sq[None, :] - 2.0 * dots_c
    else:
        cd = -dots_c
    cd = jnp.where(index.block_valid[None, :], cd, INF)
    _, sel = _select_blocks(cd, probe)               # [B, probe]
    if probe_pad != probe:
        # pad slots repeat the best block for shape only — their scores
        # are hard-masked to INF below. (The old scheme scored the
        # duplicates and relied on a post-scan dedup; the copies rank
        # high — they ARE the best block — so they could evict genuine
        # candidates from the running top-k before the dedup voided
        # them, leaving INF holes: probe=6/probe_chunk=4 lost 6 of 10
        # results in the grouped-equivalence test.)
        sel = jnp.concatenate(
            [sel, jnp.broadcast_to(sel[:, :1], (b, probe_pad - probe))], 1
        )
    sel_steps = sel.reshape(b, n_steps, pc).transpose(1, 0, 2)  # [T, B, pc]
    pad_steps = (
        (jnp.arange(probe_pad) >= probe).reshape(n_steps, 1, pc)
    )  # [T, 1, pc]

    def step(carry, xs):                             # sel_c [B, pc]
        sel_c, pad_c = xs
        run_d, run_i = carry
        blk = jnp.take(index.blocks_i8, sel_c, axis=0)    # [B, pc, S, d]
        rsq = jnp.take(index.row_sq, sel_c, axis=0)       # [B, pc, S]
        bid = jnp.take(index.block_ids, sel_c, axis=0)    # [B, pc, S]
        bscale = jnp.take(index.block_scale, sel_c, axis=0)  # [B, pc]
        cvec = jnp.take(index.centroids, sel_c, axis=0)   # [B, pc, d] f32
        qdotc = jnp.sum(cvec * q[:, None, :], axis=-1)    # [B, pc] exact
        # elementwise scoring: bf16 products, f32 accumulation (no
        # batched-matvec einsum)
        dots = jnp.sum(
            blk.astype(jnp.bfloat16) * qbf[:, None, None, :],
            axis=-1,
            dtype=jnp.float32,
        )                                                 # [B, pc, S]
        qr = bscale[:, :, None] * dots                    # q·residual
        if metric == "l2":
            dd = (
                q_sq[:, None, None]
                - 2.0 * qdotc[:, :, None]
                - 2.0 * qr
                + rsq
            )
        else:
            dd = 1.0 - (qdotc[:, :, None] + qr)
        allowed = (bid >= 0) & ~pad_c[:, :, None]
        if filter_mask is not None:
            allowed &= jnp.take(filter_mask, jnp.maximum(bid, 0))
        dd = jnp.where(allowed, dd, INF)
        dd = dd.reshape(b, -1)
        bid = bid.reshape(b, -1)
        kk = min(k, dd.shape[-1])
        if dd.shape[-1] >= 2048:  # see the grouped path's note
            sd, pos = jax.lax.approx_min_k(dd, kk, recall_target=0.99)
        else:
            neg, pos = jax.lax.top_k(-dd, kk)
            sd = -neg
        si = jnp.take_along_axis(bid, pos, axis=-1)
        si = jnp.where(jnp.isfinite(sd), si, -1)
        md = jnp.concatenate([run_d, sd], axis=1)
        mi = jnp.concatenate([run_i, si], axis=1)
        neg, pos = jax.lax.top_k(-md, k)
        return ((-neg, jnp.take_along_axis(mi, pos, axis=-1)), None)

    init = (
        jnp.full((b, k), INF, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )
    (out_d, out_i), _ = jax.lax.scan(step, init, (sel_steps, pad_steps))
    return out_d, out_i


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def delta_overlay_merge(
    queries: jnp.ndarray,      # [B, d] f32
    corpus: jnp.ndarray,       # [cap, d] f32 (current snapshot)
    delta_ids: jnp.ndarray,    # [m] int32 rows written since mirror build
    invalid: jnp.ndarray,      # [cap] bool (True = not a result)
    base_d: jnp.ndarray,       # [B, k] mirror-path distances
    base_i: jnp.ndarray,       # [B, k] mirror-path ids
    k: int,
    metric: str = "l2",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact-score the delta rows (those the throttled IVF mirror has not
    absorbed yet) and merge into the mirror results — restores exact
    read-your-writes on the sub-linear path: the mirror serves the bulk,
    the (small, bounded-by-rebuild-threshold) delta is scanned precisely.
    Callers exclude delta ids from the mirror query via the filter mask,
    so no id appears twice."""
    q = queries.astype(jnp.float32)
    vecs = jnp.take(corpus, jnp.maximum(delta_ids, 0), axis=0)  # [m, d]
    # dot form: [B, m] scores without a [B, m, d] broadcast
    # (m is bounded by the mirror-rebuild threshold but B can be a full
    # serving batch)
    dots = q @ vecs.T
    if metric == "l2":
        cd = (
            jnp.sum(q * q, axis=1)[:, None]
            + jnp.sum(vecs * vecs, axis=1)[None, :]
            - 2.0 * dots
        )
    else:
        cd = 1.0 - dots
    bad = jnp.take(invalid, jnp.maximum(delta_ids, 0)) | (delta_ids < 0)
    cd = jnp.where(bad[None, :], INF, cd)
    kk = min(k, cd.shape[-1])
    neg, pos = jax.lax.top_k(-cd, kk)
    dd = -neg
    di = jnp.take(delta_ids, pos)
    di = jnp.where(jnp.isfinite(dd), di, -1)
    md = jnp.concatenate([base_d, dd], axis=1)
    mi = jnp.concatenate([base_i, di], axis=1)
    neg, pos = jax.lax.top_k(-md, k)
    return -neg, jnp.take_along_axis(mi, pos, axis=-1)


@functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("rows", "metric")
)
def _rescore_from_chunk(best, q, xc, cand, base, rows, metric):
    """Exact-score the candidates that live inside chunk [base, base+rows)
    and write them into the running ``best`` [B, kc] array (donated).
    q [B, d] f32, xc [rows, d] f32, cand [B, kc] int32 global row ids,
    base a traced int32 scalar (one compiled program serves all chunks)."""
    local = cand - base
    inchunk = (cand >= 0) & (local >= 0) & (local < rows)
    rowsv = jnp.take(xc, jnp.clip(local, 0, rows - 1), axis=0)  # [B, kc, d]
    dots = jnp.sum(
        rowsv * q[:, None, :], axis=-1, dtype=jnp.float32
    )
    if metric == "l2":
        dd = (
            jnp.sum(q * q, axis=1)[:, None]
            + jnp.sum(rowsv * rowsv, axis=-1, dtype=jnp.float32)
            - 2.0 * dots
        )
    else:
        dd = 1.0 - dots
    return jnp.where(inchunk, dd, best)


@functools.partial(jax.jit, static_argnames=("k",))
def _rescored_merge(best, cand, k):
    """Final top-k over exactly-rescored candidates, with an O(kc^2) dup
    mask (padded probes can repeat a row id; with exact scores the copies
    tie and would double-fill the top-k)."""
    first = jnp.argmax(
        (cand[:, None, :] == cand[:, :, None])
        & (cand[:, None, :] >= 0), axis=-1
    )
    kc = cand.shape[1]
    dup = first != jnp.arange(kc)[None, :]
    best = jnp.where(dup, INF, best)
    neg, pos = jax.lax.top_k(-best, min(k, kc))
    out_d = -neg
    out_i = jnp.take_along_axis(cand, pos, axis=-1)
    return out_d, jnp.where(jnp.isfinite(out_d), out_i, -1)


def ivf_search_rescored_streaming(
    index: IvfDeviceIndex,
    queries: jnp.ndarray,
    chunk_source: Callable[[int], jnp.ndarray],
    n_chunks: int,
    chunk_rows: int,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    coarse_factor: int = 4,
    probe_chunk: int = 8,
    sync_every: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The ≥0.99-recall tier for corpora larger than device memory: coarse
    IVF retrieval over the residual-int8 blocks, then an EXACT fp32
    rescore of the tiny candidate set (coarse_factor*k rows per query) by
    re-deriving each chunk from the deterministic ``chunk_source`` — the
    same contract build_ivf_streaming already imposes — and gathering
    only candidate rows. No fp32 corpus is ever resident; the cost is one
    full chunk-source pass per query batch, so this tier's throughput is
    the generator/reader's rate (amortize with large batches). Row id i
    lives in chunk i // chunk_rows at offset i % chunk_rows (identity ids,
    as build_ivf_streaming assigns).
    """
    kc = min(coarse_factor * k, index.block_rows * min(probe, index.n_blocks))
    cd, ci = ivf_search_batch(
        index, queries, k=kc, probe=probe, metric=metric,
        probe_chunk=probe_chunk,
    )
    q = queries.astype(jnp.float32)
    cd = None  # coarse scores are replaced wholesale by exact ones
    best = jnp.full((q.shape[0], kc), INF, jnp.float32)
    for c in range(n_chunks):
        best = _rescore_from_chunk(
            best, q, chunk_source(c), ci, jnp.int32(c * chunk_rows),
            chunk_rows, metric,
        )
        if c % sync_every == sync_every - 1:
            # bound queued device memory: each pending launch holds its
            # generated chunk
            best.block_until_ready()
    return _rescored_merge(best, ci, k)


def ivf_search_rescored(
    index: IvfDeviceIndex,
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    coarse_factor: int = 4,
    probe_chunk: int = 8,
    filter_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """IVF coarse retrieval + exact fp32 rescore — the engine path when a
    full-precision corpus is resident (same contract as
    topk_ops.flat_topk_fused: residual-int8 ordering noise is repaired by
    over-retrieving coarse_factor*k and re-ranking the candidates against
    ``corpus`` [cap, d] fp32, indexed by the ids stored in the IVF
    blocks). Beyond device memory, with no fp32 mirror, callers use
    ivf_search_batch directly and coarse scores are final."""
    from valkey_search_tpu.ops import topk as topk_ops

    kc = min(coarse_factor * k, index.block_rows * min(probe, index.n_blocks))
    cd, ci = ivf_search_batch(
        index, queries, k=kc, probe=probe, metric=metric,
        probe_chunk=probe_chunk, filter_mask=filter_mask,
    )
    return topk_ops._rescore_exact(
        queries.astype(jnp.float32), corpus, ci, cd, k=k, metric=metric,
        precision="highest",
    )
