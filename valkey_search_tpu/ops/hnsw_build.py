"""Vectorized HNSW bulk construction — the device side.

The reference builds its graph one point at a time: every hnswlib
``addPoint`` (third_party/hnswlib/hnswalg.h:1260) runs an
ef_construction beam search for the candidate pool, then the
``getNeighborsByHeuristic2`` select, then bidirectional connect. That
sequential loop is the index-build bottleneck (it IS the workload the
reference parallelizes across writer threads, P2).

The device build replaces the per-point beam with two *batched* device
passes over the whole corpus:

1. exact KNN candidates: every node's top-k neighbors among nodes via
   the same two-stage scan the query path uses (bf16 coarse + fp32
   rescore) — an exact candidate pool, strictly better than the
   beam's approximate one;
2. vectorized select heuristic: ``getNeighborsByHeuristic2`` ("keep a
   candidate iff it is closer to the query than to every already-kept
   candidate") runs as a K-step ``fori_loop`` whose per-step work is a
   [B, K] masked compare — all nodes pruned in parallel elementwise,
   with the candidate-pairwise distance tensor from one tensor-core einsum.

The host then only installs forward lists, adds reverse edges (with
hnswlib's overflow re-selection), and builds the tiny upper hierarchy
(~n/M nodes) classically — native/hnsw_builder.cpp bulk_build.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.ops import topk as topk_ops


@functools.partial(jax.jit, static_argnames=("m", "metric", "alpha"))
def prune_candidates(
    corpus_lp: jnp.ndarray,   # [N, d] bf16
    corpus_sq: jnp.ndarray,   # [N] f32
    ids: jnp.ndarray,         # [B, K] candidate ids, ascending by dist, -1 pad
    dq: jnp.ndarray,          # [B, K] candidate→query distances (ascending)
    self_ids: jnp.ndarray,    # [B] the node each row is being built for
    m: int,
    metric: str,
    alpha: float = 1.0,
) -> jnp.ndarray:
    """Vectorized neighbor-select heuristic → pruned links [B, m] (-1 pad).

    alpha=1: exactly hnswlib getNeighborsByHeuristic2 per row — scan
    candidates closest-first, keep c iff dist(c, q) < dist(c, s) for every
    kept s. alpha>1 is the Vamana/DiskANN RobustPrune relaxation: reject c
    only when a kept s is alpha-times-decisively closer (alpha*d(s,c) <=
    d(c,q)), which keeps longer-range edges — bulk-built graphs need them
    for navigability because they never see the incremental-build era when
    the graph was sparse and every insertion linked across the full space.
    """
    b, k = ids.shape
    safe = jnp.maximum(ids, 0)
    cv = jnp.take(corpus_lp, safe, axis=0)               # [B, K, d]
    dots = jnp.einsum(
        "bkd,bjd->bkj", cv, cv, preferred_element_type=jnp.float32
    )
    if metric == "l2":
        nsq = jnp.take(corpus_sq, safe)                  # [B, K]
        pair = nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots
    else:
        pair = 1.0 - dots
    valid = (ids >= 0) & (ids != self_ids[:, None]) & jnp.isfinite(dq)
    dqv = jnp.where(valid, dq, jnp.inf)

    def body(i, kept):
        # candidate i is rejected if any already-kept candidate j is
        # (alpha-decisively) closer to i than i is to the query
        viol = (
            (pair[:, :, i] * alpha < dqv[:, i][:, None]) & kept
        ).any(axis=1)
        ok = (~viol) & valid[:, i] & (kept.sum(axis=1) < m)
        return kept.at[:, i].set(ok)

    kept = jax.lax.fori_loop(0, k, body, jnp.zeros((b, k), bool))
    # kept first (ascending distance), then backfill with the closest
    # pruned-out candidates up to m — hnswlib keepPrunedConnections
    # semantics (mutuallyConnectNewElement). Without the backfill, dense
    # clusters prune to 2-3 links (every candidate is closer to the first
    # kept one than to the query) and the level-0 graph fragments.
    order_key = jnp.where(
        kept, jnp.arange(k, dtype=jnp.int32)[None, :],
        k + jnp.arange(k, dtype=jnp.int32)[None, :],
    )
    take = jnp.argsort(order_key, axis=1)[:, :m]
    return jnp.take_along_axis(
        jnp.where(valid, ids, -1), take, axis=1
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _candidate_scan(
    qb_lp: jnp.ndarray,      # [B, d] bf16
    qsq: jnp.ndarray,        # [B, 1] f32
    c_lp: jnp.ndarray,       # [N, d] bf16
    c_sq: jnp.ndarray,       # [N] f32
    self_ids: jnp.ndarray,   # [B] i32 (prefix bound = own node id)
    k: int,
    metric: str,
):
    """Prefix-masked coarse candidate scan → (dq [B,k], ids [B,k]).

    A deliberately minimal program (one matmul + mask + approx_min_k):
    the general two-stage scan's blocking/rescore machinery costs minutes
    of XLA compile at this shape, and candidate pools don't need the fp32
    rescore — the native side re-computes exact distances during select
    anyway."""
    dots = jax.lax.dot_general(
        qb_lp, c_lp,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric == "l2":
        scores = qsq + c_sq[None, :] - 2.0 * dots
    else:
        scores = 1.0 - dots
    prefix = (
        jnp.arange(c_lp.shape[0], dtype=jnp.int32)[None, :]
        < self_ids[:, None]
    )
    scores = jnp.where(prefix, scores, jnp.inf)
    if scores.shape[-1] >= 2048:
        # exact off the TPU; on an H100 3% faster than lax.top_k at
        # [4096, 100352], k=200 (PERF.md)
        vals, pos = jax.lax.approx_min_k(scores, k, recall_target=0.95)
    else:
        neg, pos = jax.lax.top_k(-scores, min(k, scores.shape[-1]))
        vals = -neg
    ids = jnp.where(jnp.isinf(vals), -1, pos)
    return vals, ids


@functools.partial(jax.jit, static_argnames=("metric",))
def _dists_to_rows(corpus_lp, corpus_sq, qrows, ids, metric):
    """Exact-ish distances corpus[qrows] → corpus[ids] ([B, R])."""
    qv = jnp.take(corpus_lp, qrows, axis=0).astype(jnp.float32)
    cv = jnp.take(corpus_lp, jnp.maximum(ids, 0), axis=0).astype(jnp.float32)
    dots = jnp.einsum("bd,brd->br", qv, cv)
    if metric == "l2":
        return (
            jnp.take(corpus_sq, qrows)[:, None]
            + jnp.take(corpus_sq, jnp.maximum(ids, 0))
            - 2.0 * dots
        )
    return 1.0 - dots


def build_pruned_knn_links(
    corpus: np.ndarray,
    metric: str,
    m: int,
    k_cand: int = 64,
    batch: int = 8192,
    alpha: float = 1.0,
    n_random: int = 0,
    prefix: bool = True,
    seed: int = 0xB41D,
) -> np.ndarray:
    """Forward level-0 links [N, m] for every corpus row, device-computed.

    ``prefix=True`` restricts node i's candidates to ids < i — exactly the
    set hnswlib's addPoint sees when inserting node i. This preserves the
    *era structure* that makes HNSW graphs navigable: early nodes link
    across the whole space (their prefix is globally sparse), giving the
    level-0 beam the mid/long-range edges it needs to travel between
    clusters. A symmetric pruned-KNN graph (prefix=False) loses those
    edges and fragments into cluster islands on clustered corpora — every
    candidate is intra-cluster — which the optional alpha>1 relaxation and
    ``n_random`` far candidates only partially repair.
    """
    n, d = corpus.shape
    rng = np.random.default_rng(seed)
    c_dev = jnp.asarray(corpus, jnp.float32)
    c_lp = c_dev.astype(jnp.bfloat16)
    c_sq = jnp.einsum("ij,ij->i", c_dev, c_dev)
    kk = min(k_cand + 1, n)  # +1: the self-match occupies one slot
    links = np.full((n, m), -1, np.int32)
    metric_eff = "ip" if metric == "cosine" else metric
    for s in range(0, n, batch):
        e = min(s + batch, n)
        qb = corpus[s:e]
        if e - s < batch:
            qb = np.concatenate(
                [qb, np.zeros((batch - (e - s), d), np.float32)]
            )
        self_ids = jnp.arange(s, s + batch, dtype=jnp.int32)
        if not prefix:
            # full-corpus candidates (symmetric KNN graph — see docstring
            # caveat); realized by lifting the prefix bound
            self_ids_scan = jnp.full((batch,), n, jnp.int32)
        else:
            self_ids_scan = self_ids
        qb_lp = jnp.asarray(qb, jnp.bfloat16)
        qsq = jnp.einsum(
            "ij,ij->i", qb.astype(np.float32), qb.astype(np.float32)
        )[:, None]
        dq, ids = _candidate_scan(
            qb_lp, jnp.asarray(qsq), c_lp, c_sq, self_ids_scan,
            k=kk, metric=metric_eff,
        )
        if n_random > 0 and n > kk + n_random:
            rand_ids = jnp.asarray(
                rng.integers(0, n, size=(batch, n_random)), jnp.int32
            )
            rand_dq = _dists_to_rows(
                c_lp, c_sq, self_ids, rand_ids, metric_eff
            )
            ids = jnp.concatenate([ids, rand_ids], axis=1)
            dq = jnp.concatenate([dq, rand_dq], axis=1)
        pruned = prune_candidates(
            c_lp, c_sq, ids, dq, self_ids, m=m,
            metric=metric_eff, alpha=alpha,
        )
        links[s:e] = np.asarray(pruned[: e - s])
    return links


def sample_levels(
    n: int, m: int, seed: int
) -> Tuple[np.ndarray, int]:
    """Geometric level assignment, hnswlib distribution (mult = 1/ln(M))."""
    rng = np.random.default_rng(seed)
    u = np.maximum(rng.random(n), 1e-300)
    mult = 1.0 / np.log(m)
    levels = np.floor(-np.log(u) * mult).astype(np.int32)
    return levels, int(levels.max(initial=0))


def bridge_components(
    builder, corpus: np.ndarray, max_rounds: int = 12
) -> int:
    """Connect level-0 islands (see hnsw.py _bulk_build_device).

    Each round: label components (host union-find), pick each non-giant
    component's representative, find its nearest node OUTSIDE its own
    component with one masked device scan, and add a mutual bridge edge.
    Components at least halve per round (every component gains an edge to
    a different one), so rounds are O(log n_components).

    Returns the number of rounds executed.
    """
    n = corpus.shape[0]
    c_lp = jnp.asarray(corpus, jnp.bfloat16)
    c_sq = jnp.einsum(
        "ij,ij->i", c_lp.astype(jnp.float32), c_lp.astype(jnp.float32)
    )
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        comp = builder.components()
        ncomp = int(comp.max()) + 1 if comp.size else 1
        if ncomp <= 1:
            return rounds - 1
        # biggest component keeps its label; every other sends one probe
        sizes = np.bincount(comp, minlength=ncomp)
        giant = int(sizes.argmax())
        reps = np.full(ncomp, -1, np.int64)
        seen = np.zeros(ncomp, bool)
        for i, c in enumerate(comp):  # first node of each component
            if not seen[c]:
                seen[c] = True
                reps[c] = i
        probe = np.array(
            [reps[c] for c in range(ncomp) if c != giant], np.int64
        )
        comp_dev = jnp.asarray(comp)
        bsz = 512
        for s in range(0, len(probe), bsz):
            chunk = probe[s : s + bsz]
            pad = bsz - len(chunk)
            qrows = np.concatenate([chunk, np.zeros(pad, np.int64)]) \
                if pad else chunk
            q = jnp.asarray(corpus[qrows])
            own = comp_dev[jnp.asarray(qrows)]
            mask = comp_dev[None, :] != own[:, None]  # allow only other comps
            _, ids = topk_ops.flat_topk(
                q.astype(jnp.bfloat16), c_lp, k=1, metric="l2",
                corpus_sq=c_sq, filter_mask=mask, block_rows=n,
                precision="high",
            )
            targets = np.asarray(ids)[: len(chunk), 0]
            for u, v in zip(chunk, targets):
                if v >= 0:
                    builder.add_bridge(int(u), int(v))
    return rounds
