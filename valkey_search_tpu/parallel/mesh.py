"""Sharded search programs: shard_map over a device mesh + top-k merge.

Reference mapping (SURVEY §2.4/§2.5 P5): a cluster shard = one mesh-axis
partition of the corpus; ``SearchIndexPartition`` (the per-shard gRPC RPC,
src/coordinator/coordinator.proto:21-31) = the per-device local top-k over
its shard; the coordinator's k-bounded merge heap
(src/query/fanout.cc:69-222 SearchPartitionResultsTracker) = an
``all_gather`` of per-shard top-k rows across devices followed by a
k-selection — O(S·k) bytes on the interconnect per query batch instead of S RPCs.

Consistency: the reference rejects RPCs whose index fingerprint/version
disagrees (FAILED_PRECONDITION, server.h:60-65); here each shard carries a
version scalar and the program returns the (min, max) over shards — the
host treats min≠max as the same precondition failure and retries against a
fresh snapshot.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Spec

from valkey_search_tpu.ops import distance as dist_ops
from valkey_search_tpu.ops import hnsw_search as hs_ops
from valkey_search_tpu.ops import topk as topk_ops

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (SHARD_AXIS,))


def make_mesh_2d(n_shards: int, n_replicas: int, devices=None) -> Mesh:
    """(shard × replica) mesh: corpus partitioned over `shard`, query batch
    partitioned over `replica` — replica read-scaling (reference P7,
    cluster_map.h FanoutTargetMode replica routing) as a mesh axis."""
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    need = n_shards * n_replicas
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(
        np.asarray(devices[:need]).reshape(n_shards, n_replicas),
        (SHARD_AXIS, REPLICA_AXIS),
    )


def _merge_gathered(all_d, all_i, k):
    """[S, B, k] per-shard results → [B, k] global best (fanout merge heap)."""
    s, b, kk = all_d.shape
    flat_d = jnp.swapaxes(all_d, 0, 1).reshape(b, s * kk)
    flat_i = jnp.swapaxes(all_i, 0, 1).reshape(b, s * kk)
    neg_top, pos = jax.lax.top_k(-flat_d, k)
    return -neg_top, jnp.take_along_axis(flat_i, pos, axis=-1)


def sharded_flat_topk(
    mesh: Mesh,
    corpus: jnp.ndarray,          # [S * rows_per_shard, d], sharded on axis 0
    queries: jnp.ndarray,         # [B, d] replicated
    k: int,
    metric: str = "l2",
    invalid: Optional[jnp.ndarray] = None,   # [S * rows] sharded
    filter_mask: Optional[jnp.ndarray] = None,
    shard_versions: Optional[jnp.ndarray] = None,  # [S] int32, sharded
    block_rows: int = 131072,
    precision: str = "highest",
    mode: str = "exact",
    two_stage: bool = False,
):
    """Exact k-NN over a mesh-sharded corpus.

    Returns (dists [B,k], global ids [B,k], version_minmax [2]). Each device
    scans only its local shard (1/S of memory traffic), local ids are offset to
    global ids, and one all_gather of [B,k] rows merges across devices.

    two_stage=True runs the bf16-coarse + fp32-rescore retrieval per shard
    (each device casts its own shard once; the rescore happens locally, so
    only exact-rescored [B, k] rows cross the interconnect).
    """
    n_shards = mesh.shape[SHARD_AXIS]
    rows = corpus.shape[0] // n_shards

    def local(corpus_l, queries_l, invalid_l, filter_l, version_l):
        shard_id = jax.lax.axis_index(SHARD_AXIS)
        inv = invalid_l if invalid is not None else None
        filt = filter_l if filter_mask is not None else None
        if two_stage:
            d, i = topk_ops.flat_topk_two_stage(
                queries_l,
                corpus_l,
                corpus_l.astype(jnp.bfloat16),  # local cast: one memory pass
                k=k,
                metric=metric,
                invalid=inv,
                filter_mask=filt,
                block_rows=min(block_rows, rows),
            )
        else:
            d, i = topk_ops.flat_topk(
                queries_l,
                corpus_l,
                k=k,
                metric=metric,
                invalid=inv,
                filter_mask=filt,
                block_rows=min(block_rows, rows),
                precision=precision,
                mode=mode,
            )
        gids = jnp.where(i >= 0, i + shard_id * rows, -1)
        all_d = jax.lax.all_gather(d, SHARD_AXIS)  # [S, B, k]
        all_i = jax.lax.all_gather(gids, SHARD_AXIS)
        md, mi = _merge_gathered(all_d, all_i, k)
        vmin = jax.lax.pmin(version_l[0], SHARD_AXIS)
        vmax = jax.lax.pmax(version_l[0], SHARD_AXIS)
        return md, mi, jnp.stack([vmin, vmax])

    if shard_versions is None:
        shard_versions = jnp.zeros(n_shards, jnp.int32)
    if invalid is None:
        invalid_arg = jnp.zeros(corpus.shape[0], bool)
    else:
        invalid_arg = invalid
    if filter_mask is None:
        filter_arg = jnp.zeros(corpus.shape[0], bool)
    else:
        filter_arg = filter_mask

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            Spec(SHARD_AXIS, None),  # corpus
            Spec(),                  # queries replicated
            Spec(SHARD_AXIS),        # invalid
            Spec(SHARD_AXIS),        # filter
            Spec(SHARD_AXIS),        # versions
        ),
        out_specs=(Spec(), Spec(), Spec()),
        check_vma=False,
    )
    return jax.jit(fn)(corpus, queries, invalid_arg, filter_arg, shard_versions)


def sharded_hnsw_search(
    mesh: Mesh,
    graphs: hs_ops.HnswDeviceGraph,   # every leaf stacked on axis 0 = [S, ...]
    queries: jnp.ndarray,             # [B, d] replicated
    k: int,
    ef: int,
    metric: str = "l2",
    filter_masks: Optional[jnp.ndarray] = None,  # [S, doc_cap] or None
    shard_versions: Optional[jnp.ndarray] = None,
    precision: str = "highest",
):
    """ANN over per-shard HNSW graphs: each device beam-searches its own
    subgraph, then per-shard top-k rows all_gather + merge across devices.

    ``graphs`` holds S independent subgraphs with identical capacities,
    stacked on a leading shard axis; result ids are returned as
    (shard, node) pairs encoded as shard * node_cap + node.
    """
    n_shards = mesh.shape[SHARD_AXIS]
    node_cap = graphs.vectors.shape[1]

    filtered = filter_masks is not None
    if filter_masks is None:
        filter_masks = jnp.zeros((n_shards, 1), bool)
    if shard_versions is None:
        shard_versions = jnp.zeros(n_shards, jnp.int32)

    def local(g_leaves, queries_l, fmask_l, version_l):
        shard_id = jax.lax.axis_index(SHARD_AXIS)
        graph = jax.tree_util.tree_unflatten(
            treedef, [leaf[0] for leaf in g_leaves]
        )
        d, nodes = hs_ops.hnsw_search_batch(
            graph,
            queries_l,
            k=k,
            ef=ef,
            metric=metric,
            filter_mask=fmask_l[0],
            filtered=filtered,
            precision=precision,
        )
        gids = jnp.where(nodes >= 0, nodes + shard_id * node_cap, -1)
        all_d = jax.lax.all_gather(d, SHARD_AXIS)
        all_i = jax.lax.all_gather(gids, SHARD_AXIS)
        md, mi = _merge_gathered(all_d, all_i, k)
        vmin = jax.lax.pmin(version_l[0], SHARD_AXIS)
        vmax = jax.lax.pmax(version_l[0], SHARD_AXIS)
        return md, mi, jnp.stack([vmin, vmax])

    leaves, treedef = jax.tree_util.tree_flatten(graphs)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            tuple(Spec(SHARD_AXIS) for _ in leaves),
            Spec(),
            Spec(SHARD_AXIS),
            Spec(SHARD_AXIS),
        ),
        out_specs=(Spec(), Spec(), Spec()),
        check_vma=False,
    )
    return jax.jit(fn)(tuple(leaves), queries, filter_masks, shard_versions)


def replicated_sharded_flat_topk(
    mesh: Mesh,
    corpus: jnp.ndarray,        # [S * rows, d] sharded over SHARD_AXIS
    queries: jnp.ndarray,       # [R * b, d] sharded over REPLICA_AXIS
    k: int,
    metric: str = "l2",
    precision: str = "highest",
    mode: str = "exact",
):
    """2D-mesh search: corpus split over `shard`, query batch split over
    `replica`. Each (shard, replica) device scans its corpus shard for its
    query sub-batch; the top-k merge all_gathers only across the shard axis,
    so replica groups serve disjoint query traffic in parallel (replica read
    scaling, reference P7)."""
    n_shards = mesh.shape[SHARD_AXIS]
    rows = corpus.shape[0] // n_shards

    def local(corpus_l, queries_l):
        shard_id = jax.lax.axis_index(SHARD_AXIS)
        d, i = topk_ops.flat_topk(
            queries_l, corpus_l, k=k, metric=metric,
            block_rows=rows, precision=precision,
            mode=mode,
        )
        gids = jnp.where(i >= 0, i + shard_id * rows, -1)
        all_d = jax.lax.all_gather(d, SHARD_AXIS)
        all_i = jax.lax.all_gather(gids, SHARD_AXIS)
        return _merge_gathered(all_d, all_i, k)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(Spec(SHARD_AXIS, None), Spec(REPLICA_AXIS, None)),
        out_specs=(Spec(REPLICA_AXIS, None), Spec(REPLICA_AXIS, None)),
        check_vma=False,
    )
    return jax.jit(fn)(corpus, queries)


def sharded_batch_update(
    mesh: Mesh,
    corpus: jnp.ndarray,       # [S * rows, d] sharded
    row_ids: jnp.ndarray,      # [U] global row ids (replicated)
    new_vecs: jnp.ndarray,     # [U, d] replicated
):
    """Sharded scatter-update of corpus rows (the distributed ingest step:
    each device applies only the updates that land in its shard — the
    reference's per-shard writer pools, P2, applied mesh-wide)."""
    n_shards = mesh.shape[SHARD_AXIS]
    rows = corpus.shape[0] // n_shards

    def local(corpus_l, row_ids_l, new_vecs_l):
        shard_id = jax.lax.axis_index(SHARD_AXIS)
        local_ids = row_ids_l - shard_id * rows
        mine = (local_ids >= 0) & (local_ids < rows)
        safe = jnp.where(mine, local_ids, rows)  # row `rows` = discard pad
        padded = jnp.concatenate(
            [corpus_l, jnp.zeros((1, corpus_l.shape[1]), corpus_l.dtype)]
        )
        padded = padded.at[safe].set(
            jnp.where(mine[:, None], new_vecs_l, padded[safe])
        )
        return padded[:rows]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(Spec(SHARD_AXIS, None), Spec(), Spec()),
        out_specs=Spec(SHARD_AXIS, None),
        check_vma=False,
    )
    return jax.jit(fn)(corpus, row_ids, new_vecs)


class MeshConsistencyError(RuntimeError):
    """Shard versions disagreed on every attempt (the mesh analog of the
    coordinator giving up on FAILED_PRECONDITION retries)."""


def consistent_sharded_topk(
    mesh: Mesh,
    snapshot_fn,
    queries: jnp.ndarray,
    k: int,
    metric: str = "l2",
    max_retries: int = 3,
    partial_ok: bool = False,
    dead_shards=None,
):
    """Sharded exact top-k with the coordinator's consistency protocol.

    ``snapshot_fn() -> (corpus, shard_versions, invalid_or_None)`` supplies
    a (possibly refreshed) snapshot per attempt. The device program returns
    the (min, max) shard-version pair across devices; min != max is the mesh
    analog of the reference's per-RPC fingerprint check
    (FAILED_PRECONDITION, server.h:60-65) and triggers a retry against a
    fresh snapshot — the same loop the gRPC coordinator runs
    (fanout.cc retry on mismatch).

    ``dead_shards``: iterable of shard indices considered failed. Their
    rows are masked out of the result; with partial_ok the reply is
    (dists, ids, partial=True) — reference partial-results policy,
    fanout.cc:177-221 — otherwise MeshConsistencyError is raised, like
    the first-error policy.
    """
    n_shards = mesh.shape[SHARD_AXIS]
    dead = sorted(set(int(s) for s in (dead_shards or ())))
    if dead and not partial_ok:
        raise MeshConsistencyError(
            f"shards {dead} unavailable and partial results disabled"
        )
    last = None
    for _attempt in range(max_retries):
        corpus, versions, invalid = snapshot_fn()
        rows = corpus.shape[0] // n_shards
        if dead:
            import numpy as _np

            inv = (
                _np.asarray(invalid).copy()
                if invalid is not None
                else _np.zeros(corpus.shape[0], bool)
            )
            for s in dead:
                inv[s * rows:(s + 1) * rows] = True
            invalid = jnp.asarray(inv)
            # a dead shard can't vote on the version check either
            versions = jnp.asarray(
                _np.where(
                    _np.isin(_np.arange(n_shards), dead),
                    int(_np.asarray(versions).max(initial=0)),
                    _np.asarray(versions),
                ).astype(_np.int32)
            )
        d, i, vmm = sharded_flat_topk(
            mesh, corpus, queries, k=k, metric=metric,
            invalid=invalid, shard_versions=versions,
        )
        vmm = jax.device_get(vmm)
        if int(vmm[0]) == int(vmm[1]):
            return d, i, bool(dead)
        last = (int(vmm[0]), int(vmm[1]))
    raise MeshConsistencyError(
        f"shard versions did not converge after {max_retries} attempts "
        f"(min/max {last})"
    )


def dim_sharded_flat_topk(
    mesh: Mesh,
    corpus: jnp.ndarray,     # [N, D] sharded on axis 1 (dimension/TP axis)
    queries: jnp.ndarray,    # [B, D] sharded on axis 1 to match
    k: int,
    metric: str = "l2",
):
    """TP-style exact k-NN: the *dimension* axis is split across the mesh
    (SURVEY §5.7 — the legitimate tensor-parallel extension for very
    high-d embeddings whose corpus rows exceed one device's memory).

    Each device computes partial dot products / partial squared norms
    over its dimension slice; one `psum` across devices reduces them to full
    distances, and the top-k runs replicated. Communication is O(B·N)
    scores — independent of D — so the layout pays off when D is large
    enough that row-sharding would thrash device memory.
    """
    n_shards = mesh.shape[SHARD_AXIS]
    d_total = corpus.shape[1]
    assert d_total % n_shards == 0, "D must divide the mesh"

    def local(corpus_l, queries_l):
        # partial Gram terms on the local dimension slice
        dots = jnp.einsum("bd,nd->bn", queries_l, corpus_l)
        dots = jax.lax.psum(dots, SHARD_AXIS)
        if metric == "l2":
            c_sq = jax.lax.psum(jnp.sum(corpus_l * corpus_l, axis=1), SHARD_AXIS)
            q_sq = jax.lax.psum(jnp.sum(queries_l * queries_l, axis=1), SHARD_AXIS)
            scores = q_sq[:, None] + c_sq[None, :] - 2.0 * dots
        else:  # ip / cosine (pre-normalized rows)
            scores = 1.0 - dots
        neg, ids = jax.lax.top_k(-scores, k)
        return -neg, ids

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(Spec(None, SHARD_AXIS), Spec(None, SHARD_AXIS)),
        out_specs=(Spec(), Spec()),
        check_vma=False,
    )
    return jax.jit(fn)(corpus, queries)


def sharded_ivf_topk(
    mesh: Mesh,
    index,                    # ops.ivf.IvfDeviceIndex, every leaf sharded on nb
    queries: jnp.ndarray,     # [B, d] replicated
    k: int,
    probe: int = 32,
    metric: str = "l2",
    probe_chunk: int = 8,
):
    """IVF coarse-pruned k-NN over a mesh-sharded block index — the
    "billions of vectors" scaling path (reference README.md:5): each
    device holds 1/S of the blocks (its memory bound), probes its local
    top-``probe`` cells, and one [B, k] all_gather merges across devices.

    Per-shard probe stays the FULL probe (blocks are cluster-major, so a
    query's best cells concentrate in few shards; probing ``probe`` cells
    per shard keeps recall >= the single-chip index at the same setting).
    Per-chip query cost is therefore constant as capacity scales S× —
    throughput holds while the corpus grows with the mesh.

    block_ids must hold GLOBAL row ids (build once, then shard), so no
    id offsetting is needed. nb must divide the mesh (pow2 padding in
    build_ivf makes that free).
    """
    from valkey_search_tpu.ops import ivf as ivf_ops

    n_shards = mesh.shape[SHARD_AXIS]
    assert index.n_blocks % n_shards == 0, "nb must divide the mesh"

    def local(*leaves):
        idx_l = type(index)(*leaves[:-1])
        queries_l = leaves[-1]
        d, ids = ivf_ops.ivf_search_batch(
            idx_l, queries_l, k=k, probe=probe, metric=metric,
            probe_chunk=probe_chunk,
        )
        all_d = jax.lax.all_gather(d, SHARD_AXIS)  # [S, B, k]
        all_i = jax.lax.all_gather(ids, SHARD_AXIS)
        return _merge_gathered(all_d, all_i, k)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(Spec(SHARD_AXIS) for _ in index) + (Spec(),),
        out_specs=(Spec(), Spec()),
        check_vma=False,
    )
    return jax.jit(fn)(*index, queries)


def rows_in_slot_order(corpus, block_ids):
    """[nb, S, d] fp32 rows arranged in the IVF index's slot order (the
    per-shard rescore mirror for sharded_ivf_topk_rescored): slot (b, s)
    holds the fp32 row of block_ids[b, s], zeros at -1 padding. Sharding
    this on nb puts every shard's fp32 rows next to its own blocks."""
    ids = np.asarray(block_ids)
    nb, s = ids.shape
    out = np.asarray(corpus, np.float32)[np.maximum(ids, 0).reshape(-1)]
    out[ids.reshape(-1) < 0] = 0.0
    return out.reshape(nb, s, corpus.shape[1])


def sharded_ivf_topk_rescored(
    mesh: Mesh,
    index,                     # IvfDeviceIndex, every leaf sharded on nb
    corpus_slots: jnp.ndarray,  # [nb, S, d] fp32, slot order, sharded on nb
    queries: jnp.ndarray,      # [B, d] replicated
    k: int,
    probe: int = 32,
    metric: str = "l2",
    coarse_factor: int = 4,
    probe_chunk: int = 8,
):
    """sharded_ivf_topk + per-shard EXACT fp32 rescore — the ≥0.99-recall
    tier at mesh scale: a corpus too large for one card's fp32 mirror
    shards BOTH the int8 blocks and the fp32 rows over the mesh; each shard rescores its own coarse candidates from its own
    fp32 slice (rows live in exactly one block, so candidates never need
    a remote row), and one [B, k] all_gather merges exact scores.
    Residual-int8 ordering noise never reaches the merged result —
    same contract as the single-chip ivf_search_rescored.

    The coarse pass runs on a view of the index whose block_ids are slot
    numbers, so candidate rows gather straight from ``corpus_slots``; the
    real ids re-attach after the rescore."""
    from valkey_search_tpu.ops import ivf as ivf_ops
    from valkey_search_tpu.ops import topk as topk_ops

    n_shards = mesh.shape[SHARD_AXIS]
    assert index.n_blocks % n_shards == 0, "nb must divide the mesh"
    s_rows = index.block_rows
    kc = min(coarse_factor * k,
             s_rows * min(probe, index.n_blocks // n_shards))

    def local(*leaves):
        idx_l = type(index)(*leaves[:-2])
        corpus_l, queries_l = leaves[-2], leaves[-1]
        nb_l = idx_l.blocks_i8.shape[0]
        slot_ids = jnp.where(
            idx_l.block_ids >= 0,
            jnp.arange(nb_l * s_rows, dtype=jnp.int32).reshape(nb_l, s_rows),
            -1,
        )
        cd, cs = ivf_ops.ivf_search_batch(
            idx_l._replace(block_ids=slot_ids), queries_l, k=kc,
            probe=probe, metric=metric, probe_chunk=probe_chunk,
        )
        flat = corpus_l.reshape(nb_l * s_rows, corpus_l.shape[-1])
        d2, s2 = topk_ops._rescore_exact(
            queries_l.astype(jnp.float32), flat, cs, cd, k=k,
            metric=metric, precision="highest",
        )
        ids2 = jnp.where(
            s2 >= 0,
            jnp.take(idx_l.block_ids.reshape(-1), jnp.maximum(s2, 0)),
            -1,
        )
        all_d = jax.lax.all_gather(d2, SHARD_AXIS)
        all_i = jax.lax.all_gather(ids2, SHARD_AXIS)
        return _merge_gathered(all_d, all_i, k)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(Spec(SHARD_AXIS) for _ in index) + (Spec(SHARD_AXIS),
                                                           Spec()),
        out_specs=(Spec(), Spec()),
        check_vma=False,
    )
    return jax.jit(fn)(*index, corpus_slots, queries)
