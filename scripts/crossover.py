"""Measured scan-vs-IVF crossover from 1M to 10M rows.

The planner's routing claim — exact fused scan below `search.ivf-threshold`,
IVF coarse-pruned search above — was set by argument, not measurement. This
script measures BOTH serving paths on the card at N from 1M to 10M
with the same clustered SIFT-shape recipe as bench.py (seed 42 family) and
the same serving batch as the bench's 10M section (16384), so its datums
compose with bench.py's 10M scan + 10M IVF sweep into one curve.

Graph traversal is intentionally absent above 1M: bench.py measures it on
the 1M graph it already builds (hnsw_graph_traversal_qps_ef100); a 4M+
bulk build on this 1-core host is multi-hour, and the AoS mirror at 10M is
~41 GB — the graph walk's retained roles are filtered traversal,
persistence parity, and the CPU oracle (docs/PARITY.md "planner roles").

Reference hot loop this table replaces: the hnswlib searchKnn walk
(/root/reference/third_party/hnswlib/hnswalg.h:1611) — the reference has no
IVF; its answer at every N is the graph.

Run:  python scripts/crossover.py
Prints one JSON line: {"points": {"1000000": {...}, ...}}
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from valkey_search_tpu.runtime import jaxinit  # noqa: E402

jaxinit.init()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from valkey_search_tpu.indexes.flat import FlatVectorIndex  # noqa: E402
from valkey_search_tpu.ops import ivf as ivf_ops  # noqa: E402
from valkey_search_tpu.ops import topk as topk_ops  # noqa: E402
from valkey_search_tpu.runtime import config as cfg  # noqa: E402

# int8 coarse mirror = the serving config every headline datum uses;
# without it search_batch silently serves the bf16/exact path (first
# crossover attempt measured that: 29k qps scan at recall 1.0000)
cfg.set_config("search.corpus-dtype", "int8")

D, K = 128, 10
B = int(os.environ.get("VSTPU_XOVER_B", "16384"))
# Default: bracket the configured search.ivf-threshold with measured
# points on BOTH sides through 10M.
SIZES = [int(s) for s in os.environ.get(
    "VSTPU_XOVER_SIZES",
    "1000000,2000000,4000000,6000000,8000000,10000000").split(",")]
N_GT = 64
PROBES = (8, 12, 16, 32)
# >= DEVGEN_MIN rows: generate the corpus ON DEVICE (bench big10m recipe)
# — a 6-10M host corpus is a 3-5 GiB upload that measures the host link,
# not the engine
DEVGEN_MIN = int(os.environ.get("VSTPU_XOVER_DEVGEN_MIN", "6000000"))
N_MAX = max(s for s in SIZES)

t0_all = time.perf_counter()


def log(msg):
    print(f"[xover {time.perf_counter() - t0_all:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


log(f"platform={jax.devices()[0].platform}")

rng = np.random.default_rng(42)
n_centers = 1024
centers = rng.standard_normal((n_centers, D)).astype(np.float32) * 60 + 128
host_max = max([s for s in SIZES if s < DEVGEN_MIN], default=0)
corpus = None
if host_max:
    log(f"generating host corpus N={host_max}")
    corpus = np.empty((host_max, D), np.float32)
    for i0 in range(0, host_max, 1_000_000):
        m = min(1_000_000, host_max - i0)
        a = rng.integers(0, n_centers, m)
        corpus[i0:i0 + m] = np.clip(
            centers[a] + rng.standard_normal((m, D), dtype=np.float32) * 20,
            0, 255)
qa = rng.integers(0, n_centers, B)
queries = np.clip(
    centers[qa] + rng.standard_normal((B, D), dtype=np.float32) * 20,
    0, 255).astype(np.float32)


def device_snapshot_for(n):
    """Device-generated corpus + int8/norms mirrors at row count n (the
    bench big10m recipe: only the 512 KB centers cross the host link).
    Returns (snap_dict, rows, build_s)."""
    bn = -(-n // 131072) * 131072  # fused-scan quantum
    t0 = time.perf_counter()
    cent_d = jnp.asarray(centers)

    def _gen(k1, k2, m):
        a = jax.random.randint(k1, (m,), 0, n_centers)
        z = jax.random.normal(k2, (m, D), dtype=jnp.float32)
        return jnp.clip(jnp.take(cent_d, a, axis=0) + z * 20, 0, 255)

    _gen = jax.jit(_gen, static_argnames=("m",))
    keys = jax.random.split(jax.random.PRNGKey(29), 16)
    gch = 40 * 65536
    chunks = [
        _gen(keys[2 * ci], keys[2 * ci + 1], min(gch, bn - st))
        for ci, st in enumerate(range(0, bn, gch))
    ]
    vecs = jnp.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    chunks = None
    scale = jnp.max(jnp.abs(vecs)) / 127.0
    i8 = jnp.concatenate([
        jnp.clip(jnp.round(jax.lax.dynamic_slice_in_dim(
            vecs, st, min(gch, bn - st)) / scale), -127, 127
        ).astype(jnp.int8)
        for st in range(0, bn, gch)
    ])
    norms = jnp.concatenate([
        jnp.sum(jnp.square(jax.lax.dynamic_slice_in_dim(
            vecs, st, min(gch, bn - st))), axis=1)
        for st in range(0, bn, gch)
    ])
    inv = jnp.zeros((bn,), bool)
    _ = np.asarray(norms[0])
    return ({"vectors": vecs, "vectors_i8": i8, "i8_scale": scale,
             "norms_sq": norms, "invalid": inv}, bn,
            time.perf_counter() - t0)


points = {}
for n in SIZES:
    if n >= DEVGEN_MIN:
        log(f"=== N={n}: device-generated corpus + mirrors")
        idx = None
        snap, cap, load_s = device_snapshot_for(n)
        n = cap  # rounded to the scan quantum; every row is real
    else:
        log(f"=== N={n}: bulk_load + upload")
        idx = FlatVectorIndex(dim=D, metric="l2")
        t0 = time.perf_counter()
        idx.bulk_load([f"x:{i}" for i in range(n)], corpus[:n])
        snap = idx.store.device_snapshot()
        load_s = time.perf_counter() - t0
        cap = int(snap["invalid"].shape[0])
    br = next(c for c in range(min(262144, cap), 0, -1) if cap % c == 0)
    # ground truth on-device: exact f32 blocked scan over N_GT queries
    gq = jnp.asarray(queries[:N_GT])
    _, gii = topk_ops.flat_topk(
        gq, snap["vectors"], k=K, metric="l2", corpus_sq=snap["norms_sq"],
        invalid=snap["invalid"], block_rows=br, precision="highest",
        mode="exact")
    gt = [set(r.tolist()) for r in np.asarray(gii)]
    # ---- the scan search_batch serves with (fused int8 scan where the
    # device compiles it, else the exact scan); timed to device
    # completion ----
    qd = jnp.asarray(queries)

    def _scan():
        if topk_ops.use_fused_scan(cap, None):
            return topk_ops.flat_topk_fused(
                qd, snap["vectors"], snap.get("vectors_lp"), k=K,
                metric="l2", corpus_sq=snap["norms_sq"],
                invalid=snap["invalid"], block_rows=cap,
                corpus_i8=snap.get("vectors_i8"),
                i8_scale=snap.get("i8_scale"),
            )
        return topk_ops.flat_topk(
            qd, snap["vectors"], k=K, metric="l2",
            corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
            block_rows=br, precision="highest", mode="exact")

    d, ids_d = _scan()  # compile + warm
    ids = np.asarray(ids_d)
    t0 = time.perf_counter()
    reps = 6
    outs = [_scan() for _ in range(reps)]
    jax.block_until_ready(outs)
    scan_qps = reps * B / (time.perf_counter() - t0)
    outs = d = ids_d = None
    scan_rec = float(np.mean([
        len(set(ids[b, :K].tolist()) & gt[b]) / K for b in range(N_GT)]))
    log(f"N={n} scan: {scan_qps:.0f} qps recall@10={scan_rec:.4f}")
    # ---- IVF (device-resident build; mask the store's padded rows) ----
    t0 = time.perf_counter()
    iv = ivf_ops.build_ivf_device(
        snap["vectors"], present=~np.asarray(snap["invalid"]),
        block_rows=1024,
    )
    ivf_build_s = time.perf_counter() - t0
    vecs = snap["vectors"]  # fp32 mirror stays resident for the rescore
    del idx, snap  # free the other flat mirrors before the sweep
    sweep = {}
    for probe in PROBES:
        # ivf_search_rescored = the engine's routing path (exact fp32
        # rescore over the resident mirror); ivf_search_batch alone
        # scores reconstructions and saturates ~0.95 recall
        dd, ii = ivf_ops.ivf_search_rescored(iv, qd, vecs, k=K,
                                             probe=probe, probe_chunk=4)
        np.asarray(dd)  # compile + warm
        t0 = time.perf_counter()
        for _ in range(6):
            dd, ii = ivf_ops.ivf_search_rescored(iv, qd, vecs, k=K,
                                                 probe=probe, probe_chunk=4)
        jax.block_until_ready(dd)
        q_ivf = 6 * B / (time.perf_counter() - t0)
        ii = np.asarray(ii)
        rec = float(np.mean([
            len(set(ii[b, :K].tolist()) & gt[b]) / K for b in range(N_GT)]))
        sweep[str(probe)] = [round(q_ivf, 1), round(rec, 4)]
        log(f"N={n} ivf probe={probe}: {q_ivf:.0f} qps recall@10={rec:.4f}")
    del iv, vecs
    ok99 = [(p, v) for p, v in sweep.items() if v[1] >= 0.99]
    ivf99 = max((v[0] for _, v in ok99), default=None)
    points[str(n)] = {
        "scan_qps": round(scan_qps, 1),
        "scan_recall_at_10": round(scan_rec, 4),
        "ivf_build_s": round(ivf_build_s, 1),
        "ivf_probe_sweep": sweep,
        "ivf_qps_at_recall99": ivf99,
        "load_s": round(load_s, 1),
    }

print(json.dumps({"batch": B, "points": points}), flush=True)
