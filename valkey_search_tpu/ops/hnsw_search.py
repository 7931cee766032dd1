"""Batched HNSW search as a device program.

device-native replacement for the reference's searchKnn hot loop
(third_party/hnswlib/hnswalg.h:1611-1685): instead of one pointer-chasing
walk per query with a SIMD distance call per hop, a whole *batch* of queries
walks the graph in lockstep —

- upper layers: batched greedy descent (one `lax.while_loop` per layer; each
  step gathers every query's neighbor rows and scores them with one tensor-core
  einsum),
- layer 0: batched best-first beam search. Per iteration each query expands
  its best unexpanded beam entry, gathers its M0 neighbors' vectors, scores
  them in one einsum, and merges them into a sorted ef-beam by argsort.

Algorithmic equivalence with hnswlib (unfiltered case): the ef-bounded
result heap and the candidate frontier coincide — any candidate with
distance below the current lower bound is by definition among the ef best
seen, so "expand the best unexpanded entry of the sorted ef-beam" visits
nodes in exactly hnswlib's order and terminates exactly when hnswlib's
`candidate_dist > lowerBound` break fires. Instead of a visited bitset
(hnswlib VisitedList), re-gathered nodes are deduplicated against the beam;
evicted nodes can never re-enter (their distance exceeds a lower bound that
only decreases), so termination is preserved and the whole state stays in
registers rather than doing scatter updates to an device memory bitmap.

With a filter (reference inline-filter functor, src/query/search.cc:102-133)
or tombstoned deletes (hnswalg.h markDelete :1156), traversal admission and
result admission separate: a parallel result list keeps the best ef
*allowed* nodes while the beam traverses everything, mirroring
searchBaseLayerST's two heaps. The candidate frontier is ef-bounded (the
reference's is unbounded) — a standard batched-HNSW approximation; recall
differences show up only under extreme filters and are covered by tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from valkey_search_tpu.ops import distance as dist_ops

INF = float("inf")  # python scalar — see ops/topk.py note on jnp constants


class HnswDeviceGraph(NamedTuple):
    """Device-resident HNSW graph (struct-of-arrays).

    vectors:   [cap, d]  fp32 node vectors
    links0:    [cap, M0] int32 level-0 adjacency, -1 padded
    deleted:   [cap]     bool tombstones
    entry:     []        int32 global entry node
    upper_id2row: tuple of [cap] int32 per level (1-based), -1 if absent
    upper_links:  tuple of [n_l_pad, M] int32 per level
    node_doc:  [cap] int32 node → schema doc id (predicate masks live in
               doc-id space; -1 for unallocated). Mirrors the reference's
               internal-id → label indirection (hnswalg.h label lookup).
    """

    vectors: jnp.ndarray
    links0: jnp.ndarray
    deleted: jnp.ndarray
    entry: jnp.ndarray
    upper_id2row: Tuple[jnp.ndarray, ...]
    upper_links: Tuple[jnp.ndarray, ...]
    node_doc: jnp.ndarray


def _gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] with negative indices mapped to row 0 (callers mask)."""
    return jnp.take(table, jnp.maximum(idx, 0), axis=0)


def _descend_level(queries, vectors, id2row, links, cur, cur_d, metric, precision):
    """Greedy move-to-best-neighbor until no query improves (one layer)."""

    def cond(state):
        _, _, improved = state
        return jnp.any(improved)

    def body(state):
        cur, cur_d, _ = state
        rows = _gather_rows(id2row, cur)  # [B]
        nbrs = _gather_rows(links, rows)  # [B, M]
        valid = (nbrs >= 0) & (rows >= 0)[:, None]
        nvecs = _gather_rows(vectors, nbrs)  # [B, M, d]
        nd = dist_ops.batched_candidate_scores(queries, nvecs, metric, precision)
        nd = jnp.where(valid, nd, INF)
        best_pos = jnp.argmin(nd, axis=1)
        best_d = jnp.take_along_axis(nd, best_pos[:, None], 1)[:, 0]
        best_i = jnp.take_along_axis(nbrs, best_pos[:, None], 1)[:, 0]
        improved = best_d < cur_d
        new_cur = jnp.where(improved, best_i, cur)
        new_d = jnp.where(improved, best_d, cur_d)
        return new_cur, new_d, improved

    cur, cur_d, _ = jax.lax.while_loop(
        cond, body, (cur, cur_d, jnp.ones(cur.shape, bool))
    )
    return cur, cur_d


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "metric", "precision", "filtered", "max_iters",
        "expand_per_iter",
    ),
)
def hnsw_search_batch(
    graph: HnswDeviceGraph,
    queries: jnp.ndarray,
    k: int,
    ef: int,
    metric: str = "l2",
    filter_mask: Optional[jnp.ndarray] = None,
    filtered: bool = False,
    precision: str = "highest",
    max_iters: Optional[int] = None,
    expand_per_iter: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched ANN search → (dists [B, k], node ids [B, k]) ascending.

    filter_mask: bool [n_docs_cap] in *doc-id* space (True = allowed); only
    consulted when ``filtered=True``. Deleted nodes are always excluded from
    results but traversed, matching hnswlib.

    expand_per_iter: beam entries expanded per loop iteration. 1 reproduces
    hnswlib's strictly-sequential expansion order; E>1 expands the E best
    unexpanded entries at once — the sequential loop shrinks ~E× (the
    device-latency win) at the same total FLOPs. Entries 2..E are expanded
    before entry 1's neighbors are seen, so a few extra nodes may be
    visited; recall can only improve, termination still fires when the
    best unexpanded entry is worse than the ef-th result.
    """
    ef = max(ef, k)
    queries = queries.astype(jnp.float32)
    b = queries.shape[0]
    e_exp = max(1, min(expand_per_iter, ef))
    if max_iters is None:
        max_iters = (16 * ef + 64 + e_exp - 1) // e_exp

    # --- upper-layer descent ------------------------------------------------
    cur = jnp.full((b,), graph.entry, jnp.int32)
    evec = _gather_rows(graph.vectors, cur)
    cur_d = dist_ops.batched_candidate_scores(
        queries, evec[:, None, :], metric, precision
    )[:, 0]
    for id2row, links in zip(
        reversed(graph.upper_id2row), reversed(graph.upper_links)
    ):
        cur, cur_d = _descend_level(
            queries, graph.vectors, id2row, links, cur, cur_d, metric, precision
        )

    # --- layer-0 beam search ------------------------------------------------
    # "excluded from results" mask per node: deleted ∪ filtered-out.
    def node_excluded(nodes):  # [B, C] int32 → bool
        ex = _gather_rows(graph.deleted, nodes)
        if filtered:
            docs = _gather_rows(graph.node_doc, nodes)
            allowed = _gather_rows(filter_mask, docs) & (docs >= 0)
            ex = ex | ~allowed
        return ex | (nodes < 0)

    beam_d = jnp.full((b, ef), INF).at[:, 0].set(cur_d)
    beam_i = jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(cur)
    beam_e = jnp.zeros((b, ef), bool)

    res_d = jnp.where(node_excluded(beam_i), INF, beam_d)
    res_i = jnp.where(node_excluded(beam_i), -1, beam_i)
    order0 = jnp.argsort(res_d, axis=1)
    res_d = jnp.take_along_axis(res_d, order0, 1)
    res_i = jnp.take_along_axis(res_i, order0, 1)

    def lower_bound(res_d):
        # hnswlib lowerBound: worst of result heap once it holds ef entries,
        # +inf before that (filtered case can leave it underfull).
        return jnp.where(jnp.isfinite(res_d[:, ef - 1]), res_d[:, ef - 1], INF)

    def cond(state):
        _, _, _, _, _, it, done = state
        return (it < max_iters) & ~jnp.all(done)

    def body(state):
        beam_d, beam_i, beam_e, res_d, res_i, it, done = state

        cand_d = jnp.where(beam_e | (beam_i < 0), INF, beam_d)
        # E best unexpanded entries (beam is distance-sorted, so the first
        # e_exp unexpanded positions are exactly the E best).
        neg_top, sel_pos = jax.lax.top_k(-cand_d, e_exp)  # [B, E]
        sel_d = -neg_top
        lb = lower_bound(res_d)
        # per-entry active: hnswlib break condition per expansion slot;
        # the query is done only when its BEST unexpanded entry fails.
        entry_active = jnp.isfinite(sel_d) & (sel_d <= lb[:, None]) & ~done[:, None]
        active = entry_active[:, 0]
        new_done = done | ~active

        sel_id = jnp.take_along_axis(beam_i, sel_pos, 1)  # [B, E]
        upd = jnp.take_along_axis(beam_e, sel_pos, 1) | entry_active
        beam_e = jax.vmap(lambda be, sp, u: be.at[sp].set(u))(
            beam_e, sel_pos, upd
        )

        nbrs = _gather_rows(graph.links0, sel_id)  # [B, E, M0]
        nbrs = jnp.where(entry_active[:, :, None], nbrs, -1)
        nbrs = nbrs.reshape(b, -1)  # [B, E*M0]
        nvecs = _gather_rows(graph.vectors, nbrs)
        nd = dist_ops.batched_candidate_scores(queries, nvecs, metric, precision)
        nd = jnp.where(nbrs >= 0, nd, INF)

        if e_exp > 1:
            # intra-iteration dedup: a node reached from two expanded
            # entries in the same step must enter the beam only once
            c_tot = nbrs.shape[1]
            earlier = jnp.tril(jnp.ones((c_tot, c_tot), bool), k=-1)
            dup_intra = jnp.any(
                (nbrs[:, :, None] == nbrs[:, None, :]) & earlier[None], axis=2
            )
            nd = jnp.where(dup_intra, INF, nd)

        # dedup against current beam (replaces the visited bitset)
        dup = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        nd_beam = jnp.where(dup, INF, nd)

        all_d = jnp.concatenate([beam_d, nd_beam], axis=1)
        all_i = jnp.concatenate([beam_i, nbrs], axis=1)
        all_e = jnp.concatenate([beam_e, jnp.zeros_like(nd_beam, bool)], axis=1)
        order = jnp.argsort(all_d, axis=1)
        beam_d = jnp.take_along_axis(all_d, order, 1)[:, :ef]
        beam_i = jnp.take_along_axis(all_i, order, 1)[:, :ef]
        beam_e = jnp.take_along_axis(all_e, order, 1)[:, :ef]

        # result list: admit allowed nodes only, dedup against res
        nd_res = jnp.where(node_excluded(nbrs), INF, nd)
        dup_r = jnp.any(nbrs[:, :, None] == res_i[:, None, :], axis=2)
        nd_res = jnp.where(dup_r, INF, nd_res)
        r_all_d = jnp.concatenate([res_d, nd_res], axis=1)
        r_all_i = jnp.concatenate(
            [res_i, jnp.where(jnp.isinf(nd_res), -1, nbrs)], axis=1
        )
        r_order = jnp.argsort(r_all_d, axis=1)
        res_d = jnp.take_along_axis(r_all_d, r_order, 1)[:, :ef]
        res_i = jnp.take_along_axis(r_all_i, r_order, 1)[:, :ef]

        return beam_d, beam_i, beam_e, res_d, res_i, it + 1, new_done

    state = (beam_d, beam_i, beam_e, res_d, res_i, jnp.int32(0), jnp.zeros(b, bool))
    _, _, _, res_d, res_i, _, _ = jax.lax.while_loop(cond, body, state)

    out_d = res_d[:, :k]
    out_i = jnp.where(jnp.isfinite(out_d), res_i[:, :k], -1)
    return out_d, out_i


class HnswAosTables(NamedTuple):
    """Gather-optimized traversal mirror (built from an HnswDeviceGraph).

    Device gathers of small scattered rows are slow: fetching one node's
    M0 neighbor VECTORS as a single contiguous [M0, dp] int8 block was
    ~3x faster than M0 scattered per-vector rows on the previous
    hardware (not yet measured on the H100), and shrinking dp via
    a random projection shrinks the per-row bytes further (the walk only
    needs distance ORDER; the final exact fp32 rescore restores
    precision — DiskANN's PQ-guided traversal plays the same trick). The
    blocks replicate each vector once per in-edge (M0x blow-up at int8),
    so this mirror is gated by a memory budget — beyond it the SoA
    traversal or the exact scan serves (planner note in indexes/hnsw.py).

    nbr_vecs_q: [cap, M0, dp] int8 — node n's row holds the (projected,)
                quantized vectors of its level-0 neighbors, 0-padded.
    scale:      f32 scalar — dequantize factor (value = q * scale).
    q_vectors:  [cap, dp] int8 — per-node quantized vector (seeding).
    proj:       [d, dp] f32 orthonormal-ish projection, or None (dp == d).
    """

    nbr_vecs_q: jnp.ndarray
    scale: jnp.ndarray
    q_vectors: jnp.ndarray
    proj: Optional[jnp.ndarray]


def build_aos_tables(
    graph: HnswDeviceGraph, project_dim: int = 0
) -> HnswAosTables:
    """Assemble the AoS traversal mirror on device (one-time publish cost;
    gather of [cap, M0] rows + reshape, all on-chip). project_dim > 0 and
    < d applies a seeded random orthonormal projection first."""
    vecs = graph.vectors
    d = vecs.shape[1]
    proj = None
    if project_dim and project_dim < d:
        # PCA on a corpus sample: real embedding corpora concentrate
        # variance in few directions, so the top-dp principal components
        # preserve distance order far better than a random projection
        # (which is lossy on isotropic data — tested both ways)
        n = vecs.shape[0]
        stride = max(1, n // 4096)
        sample = vecs[::stride]
        mean = jnp.mean(sample, axis=0)
        centered = sample - mean
        _u, _s, vt = jnp.linalg.svd(centered, full_matrices=False)
        proj = vt[:project_dim].T                     # [d, dp]
        vecs = vecs @ proj
    amax = jnp.maximum(jnp.max(jnp.abs(vecs)), 1e-30)
    scale = amax / 127.0
    q = jnp.clip(jnp.round(vecs / scale), -127, 127).astype(jnp.int8)
    nbrs = jnp.maximum(graph.links0, 0)           # [cap, M0]
    blk = jnp.take(q, nbrs, axis=0)               # [cap, M0, dp]
    blk = jnp.where((graph.links0 >= 0)[:, :, None], blk, 0)
    return HnswAosTables(nbr_vecs_q=blk, scale=scale, q_vectors=q, proj=proj)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "metric", "expand_per_iter", "max_iters", "seed_stride",
    ),
)
def hnsw_search_batch_aos(
    graph: HnswDeviceGraph,
    aos: HnswAosTables,
    queries: jnp.ndarray,
    k: int,
    ef: int,
    metric: str = "l2",
    expand_per_iter: int = 8,
    max_iters: Optional[int] = None,
    seed_stride: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fast-path batched traversal (unfiltered; deleted handled at the
    final rescore): AoS int8 neighbor blocks + bf16 elementwise scoring +
    one 3-operand sort per iteration, exact fp32 rescore of the beam at
    the end.

    Design vs hnsw_search_batch (the round-1 kernel, kept for filtered /
    over-budget cases): no einsum (batched-matvec einsums lowered
    badly on the previous hardware; not yet measured on the H100), no
    second result list (the unfiltered beam IS the result set), fewer
    and cheaper per-iteration ops, coarse int8 distances during the walk
    with recall restored by the exact rescore (the same two-stage idea as
    the flat scan's int8 coarse + fp32 rescore)."""
    ef = max(ef, k)
    queries = queries.astype(jnp.float32)
    b, d_dim = queries.shape
    m0 = graph.links0.shape[1]
    e_exp = max(1, min(expand_per_iter, ef))
    if max_iters is None:
        # ~2-4x ef expansions covers hnswlib's termination point; a
        # scan-seeded beam starts near-converged and needs far fewer
        factor = 2 if seed_stride else 4
        max_iters = (factor * ef + 32 + e_exp - 1) // e_exp

    # walk-space queries: projected when the AoS mirror is projected
    # (distances during the walk only need ORDER; the exact fp32 rescore
    # at the end is always in the full space)
    walk_q = queries if aos.proj is None else queries @ aos.proj
    qbf = walk_q.astype(jnp.bfloat16)
    scale_bf = aos.scale.astype(jnp.bfloat16)

    seed_d = seed_i = None
    if seed_stride:
        # scan-seeded initialization: one matmul pass over a strided corpus
        # subsample fills the beam with ef already-good candidates; the
        # graph walk then only has to pull in their true neighborhoods
        # (the hierarchy descent is skipped — the subsample plays the
        # upper layers' role of long-range routing)
        sub = aos.q_vectors[::seed_stride].astype(jnp.bfloat16) * scale_bf
        dots = (qbf @ sub.T).astype(jnp.float32)        # [B, S] matmul
        if metric == "l2":
            s_sq = jnp.sum(sub.astype(jnp.float32) ** 2, axis=1)
            q_sq = jnp.sum(walk_q * walk_q, axis=1)
            sd = q_sq[:, None] + s_sq[None, :] - 2.0 * dots
        else:
            sd = 1.0 - dots
        # capacity slack rows (pow2 growth) and tombstones are marked
        # deleted in the published graph — excluding them here keeps fake
        # zero-vector entries out of the beam, whose finite distances
        # would tighten the termination bound early and displace real
        # candidates (r2 review finding)
        sd = jnp.where(graph.deleted[::seed_stride][None, :], INF, sd)
        sub_ids = (
            jnp.arange(sub.shape[0], dtype=jnp.int32) * seed_stride
        )
        neg, pos = jax.lax.top_k(-sd, min(ef, sub.shape[0]))
        seed_d = -neg
        seed_i = sub_ids[pos]

    # --- upper-layer descent (tiny graphs; SoA fp32 as before) ----------
    cur = jnp.full((b,), graph.entry, jnp.int32)
    evec = _gather_rows(graph.vectors, cur)
    cur_d = jnp.sum((evec - queries) ** 2, axis=-1) if metric == "l2" else (
        1.0 - jnp.sum(evec * queries, axis=-1)
    )
    if seed_d is None:
        for id2row, links in zip(
            reversed(graph.upper_id2row), reversed(graph.upper_links)
        ):
            cur, cur_d = _descend_level(
                queries, graph.vectors, id2row, links, cur, cur_d, metric,
                "default",
            )

    # --- layer-0 beam (int8-domain distances) ---------------------------
    # distances tracked in the quantized domain; absolute values differ
    # from fp32 but the ORDER is what the walk needs
    def score_blk(blk_q):  # [B, E, M0, d] int8 -> [B, E*M0] f32
        v = blk_q.astype(jnp.bfloat16) * scale_bf
        if metric == "l2":
            diff = v - qbf[:, None, None, :]
            nd = jnp.sum(diff * diff, axis=-1)
        else:
            nd = 1.0 - jnp.sum(v * qbf[:, None, None, :], axis=-1)
        return nd.reshape(b, -1).astype(jnp.float32)

    if seed_d is not None:
        s = seed_d.shape[1]
        beam_d = jnp.full((b, ef), INF, jnp.float32).at[:, :s].set(seed_d)
        beam_i = jnp.full((b, ef), -1, jnp.int32).at[:, :s].set(seed_i)
    else:
        if aos.proj is not None:
            # beam distances live in the walk (projected) space; rescore
            # the descent's entry there so ordering is consistent
            evq = _gather_rows(aos.q_vectors, cur).astype(jnp.float32) * (
                aos.scale
            )
            if metric == "l2":
                cur_d = jnp.sum((evq - walk_q) ** 2, axis=-1)
            else:
                cur_d = 1.0 - jnp.sum(evq * walk_q, axis=-1)
        beam_d = jnp.full((b, ef), INF, jnp.float32).at[:, 0].set(cur_d)
        beam_i = jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(cur)
    beam_e = jnp.zeros((b, ef), bool)

    def cond(state):
        _, _, _, it, done = state
        return (it < max_iters) & ~jnp.all(done)

    def body(state):
        beam_d, beam_i, beam_e, it, done = state
        lb = jnp.where(jnp.isfinite(beam_d[:, ef - 1]), beam_d[:, ef - 1], INF)

        cand_d = jnp.where(beam_e | (beam_i < 0), INF, beam_d)
        neg_top, sel_pos = jax.lax.top_k(-cand_d, e_exp)       # [B, E]
        sel_d = -neg_top
        entry_active = (
            jnp.isfinite(sel_d) & (sel_d <= lb[:, None]) & ~done[:, None]
        )
        new_done = done | ~entry_active[:, 0]

        sel_id = jnp.take_along_axis(beam_i, sel_pos, 1)       # [B, E]
        upd = jnp.take_along_axis(beam_e, sel_pos, 1) | entry_active
        beam_e = jax.vmap(lambda be, sp, u: be.at[sp].set(u))(
            beam_e, sel_pos, upd
        )

        safe_sel = jnp.maximum(sel_id, 0)
        nbrs = jnp.take(graph.links0, safe_sel, axis=0)        # [B, E, M0]
        nbrs = jnp.where(entry_active[:, :, None], nbrs, -1).reshape(b, -1)
        blk = jnp.take(aos.nbr_vecs_q, safe_sel, axis=0)       # AoS gather
        nd = score_blk(blk)
        nd = jnp.where(nbrs >= 0, nd, INF)

        # dedup against beam + intra-iteration (visited-set equivalent:
        # evicted nodes can't re-enter — their distance exceeds a
        # monotonically decreasing bound; see module docstring)
        dup = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        if e_exp > 1:
            c_tot = nbrs.shape[1]
            earlier = jnp.tril(jnp.ones((c_tot, c_tot), bool), k=-1)
            dup = dup | jnp.any(
                (nbrs[:, :, None] == nbrs[:, None, :]) & earlier[None],
                axis=2,
            )
        nd = jnp.where(dup, INF, nd)

        all_d = jnp.concatenate([beam_d, nd], axis=1)
        all_i = jnp.concatenate([beam_i, nbrs], axis=1)
        all_e = jnp.concatenate([beam_e, jnp.zeros_like(nd, bool)], axis=1)
        sd, si, se = jax.lax.sort((all_d, all_i, all_e), num_keys=1)
        return (sd[:, :ef], si[:, :ef], se[:, :ef], it + 1, new_done)

    state = (beam_d, beam_i, beam_e, jnp.int32(0), jnp.zeros(b, bool))
    beam_d, beam_i, _, _, _ = jax.lax.while_loop(cond, body, state)

    # --- exact fp32 rescore of the beam (restores int8 recall; drops
    #     deleted nodes — they traversed but can't be results) -----------
    safe = jnp.maximum(beam_i, 0)
    vecs = jnp.take(graph.vectors, safe, axis=0)               # [B, ef, d]
    if metric == "l2":
        exact = jnp.sum((vecs - queries[:, None, :]) ** 2, axis=-1)
    else:
        exact = 1.0 - jnp.sum(vecs * queries[:, None, :], axis=-1)
    bad = (beam_i < 0) | _gather_rows(graph.deleted, beam_i)
    exact = jnp.where(bad, INF, exact)
    neg_top, pos = jax.lax.top_k(-exact, k)
    out_d = -neg_top
    out_i = jnp.where(
        jnp.isfinite(out_d), jnp.take_along_axis(beam_i, pos, 1), -1
    )
    return out_d, out_i


def build_device_graph(
    vectors,
    links0,
    deleted,
    uppers: Sequence[dict],
    entry: int,
    node_doc,
    m: int,
) -> HnswDeviceGraph:
    """Assemble an HnswDeviceGraph from host (numpy) arrays.

    ``uppers`` is the per-level export from native HnswBuilder.export_graph:
    [{"nodes": [n_l], "links": [n_l, M]}, ...] for levels 1..max_level.
    Per-level tables are padded to power-of-two row counts to limit
    recompilation as the graph grows.
    """
    import numpy as np

    cap = vectors.shape[0]
    id2rows, link_tables = [], []
    for lv in uppers:
        nodes = np.asarray(lv["nodes"], np.int32)
        links = np.asarray(lv["links"], np.int32)
        n_pad = max(8, 1 << int(np.ceil(np.log2(max(len(nodes), 1)))))
        id2row = np.full(cap, -1, np.int32)
        if len(nodes):
            id2row[nodes] = np.arange(len(nodes), dtype=np.int32)
        links_pad = np.full((n_pad, m), -1, np.int32)
        if len(nodes):
            links_pad[: len(nodes)] = links
        id2rows.append(jnp.asarray(id2row))
        link_tables.append(jnp.asarray(links_pad))
    return HnswDeviceGraph(
        vectors=jnp.asarray(vectors, jnp.float32),
        links0=jnp.asarray(links0, jnp.int32),
        deleted=jnp.asarray(deleted, bool),
        entry=jnp.asarray(entry, jnp.int32),
        upper_id2row=tuple(id2rows),
        upper_links=tuple(link_tables),
        node_doc=jnp.asarray(node_doc, jnp.int32),
    )
