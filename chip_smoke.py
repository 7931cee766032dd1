"""Bring-up smoke of the served KNN path on one GPU.

Drives the engine the way a user does (Engine.execute: FT.CREATE, HSET,
FT.SEARCH, FT.INFO, SAVE/BGSAVE, load) on a SIFT1M-shaped corpus — 1M x
128-d clustered byte-valued rows from seed 42, the recipe bench.py uses
(BASELINE.json config 1) — and checks every answer against float64 brute
force. Phases, each printing one line with wall time, compile time and
the device's peak_bytes_in_use:

  a  card identity (nvidia-smi name and power limit, jax.devices())
  b  the compiled fused-scan kernels against their plain-XLA oracles at
     B=8192, N=1M, d in {128, 768}; memory_analysis of flat_topk_fused
  c  FLAT through the engine under corpus-dtype bfloat16, int8 and
     float32 + topk-mode exact (plus the TF32 float32 scan's recall)
  d  IVF through the engine (ivf-threshold at the corpus size, probe 16)
  e  HNSW M=16 EF_CONSTRUCTION 200 at 100k rows: graph walk recall, and
     the device bulk build timed against the host build
  f  SAVE, forked BGSAVE, Engine.load: KNN answers identical after load

Usage: python chip_smoke.py                 (one card, every phase)
       python chip_smoke.py --phases a,b    (a subset)
       python chip_smoke.py --four-cards    (only the 4-card mesh path:
           10M x 96 rows, Deep-100M's width, BASELINE.json config 5)

Exits non-zero, with no result line, when JAX finds no GPU or any check
fails. The last line on success is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 10
N_GT = 64           # fp64 ground-truth queries
N_FLAT = 1_000_000  # SIFT1M rows
N_HNSW = 100_000
D = 128
B_KERNEL, N_KERNEL = 8192, 1 << 20  # phase b shapes
# --four-cards: Deep-100M's width at a tenth of its rows, 256 queries
N_MESH, D_MESH, B_MESH = 10_000_000, 96, 256
DIST_TOL = 4.0      # |returned - exact fp32| on ~1e5-1e6-sized distances


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# data: the bench.py corpus recipe (seed 42, 1024 centers, noise 20, bytes)
# ---------------------------------------------------------------------------

def clustered(n: int, d: int, n_queries: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 60 + 128
    corpus = np.clip(
        centers[rng.integers(0, 1024, size=n)]
        + rng.standard_normal((n, d)).astype(np.float32) * 20, 0, 255,
    ).astype(np.float32)
    queries = np.clip(
        centers[rng.integers(0, 1024, size=n_queries)]
        + rng.standard_normal((n_queries, d)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    return corpus, queries


def fp64_truth(corpus, queries, k, allowed=None):
    """(ids [Q, k], dists [Q, k]) exact squared-L2 in float64."""
    c64 = np.asarray(corpus, np.float64)
    c_sq = np.einsum("ij,ij->i", c64, c64)
    ids, dists = [], []
    for q in np.asarray(queries, np.float64):
        dd = c_sq - 2.0 * (c64 @ q) + q @ q
        if allowed is not None:
            dd = np.where(allowed, dd, np.inf)
        part = np.argpartition(dd, k)[:k]
        order = part[np.argsort(dd[part])]
        ids.append(order)
        dists.append(dd[order])
    return np.stack(ids), np.stack(dists)


def recall(got_ids, truth_ids) -> float:
    k = truth_ids.shape[1]
    return float(np.mean([
        len(set(g) & set(t.tolist())) / k for g, t in zip(got_ids, truth_ids)
    ]))


def exact_dist_err(corpus, queries, got_ids, got_d) -> float:
    """Largest |returned distance - fp64 distance of the returned id|."""
    err = 0.0
    for q, ids, ds in zip(queries, got_ids, got_d):
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            continue
        x = np.asarray(corpus[ids], np.float64) - np.asarray(q, np.float64)
        err = max(err, float(np.abs((x * x).sum(1) - np.asarray(ds)).max()))
    return err


# ---------------------------------------------------------------------------
# phase bookkeeping
# ---------------------------------------------------------------------------

_COMPILE_S = [0.0]


def _on_event(event: str, duration: float, **_):
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0))


def run_phase(name: str, fn, *args):
    t0, c0 = time.perf_counter(), _COMPILE_S[0]
    out = fn(*args)
    print(f"[smoke] phase {name}: wall_s={time.perf_counter() - t0:.3f} "
          f"compile_s={_COMPILE_S[0] - c0:.3f} "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)
    return out


def log(msg: str) -> None:
    print(f"[smoke]   {msg}", flush=True)


# ---------------------------------------------------------------------------
# a: card identity
# ---------------------------------------------------------------------------

def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(bool(out), "nvidia-smi reported no card")
    return out


def phase_a(card: str):
    import jax

    log(f"nvidia-smi: {card}")
    log(f"jax {jax.__version__} devices={jax.devices()}")
    check(jax.devices()[0].platform == "gpu", "default device is not a GPU")


# ---------------------------------------------------------------------------
# b: compiled kernels against their oracles
# ---------------------------------------------------------------------------

def phase_b():
    import jax
    import jax.numpy as jnp

    from valkey_search_tpu.ops import pallas_scan as ps
    from valkey_search_tpu.ops import topk as topk_ops

    b, n, span = B_KERNEL, N_KERNEL, 8
    key = jax.random.PRNGKey(7)
    for d in (128, 768):
        kq, kc, key = jax.random.split(key, 3)
        q = jax.random.normal(kq, (b, d), jnp.float32)
        c = jax.random.normal(kc, (n, d), jnp.float32)
        # int8: keys are integer arithmetic, so bit-identical
        sq = jnp.max(jnp.abs(q)) / 127
        sc = jnp.max(jnp.abs(c)) / 127
        qi = jnp.clip(jnp.round(q / sq), -127, 127).astype(jnp.int8)
        ci = jnp.clip(jnp.round(c / sc), -127, 127).astype(jnp.int8)
        bias = ps.make_bias_i8_packed(
            n, d, span, "l2", jnp.sum(c * c, 1), 1.0 / (2 * sq * sc),
            None, None)
        got = np.asarray(ps.bucket_min_scan_i8_packed(qi, ci, bias,
                                                      span=span))
        sg = span * ps.GROUP
        ref_fn = jax.jit(ps.bucket_min_scan_i8_packed_reference,
                         static_argnames="span")
        ref = np.concatenate([
            np.asarray(ref_fn(qi, ci[g:g + sg], bias[:, g:g + sg], span=span))
            for g in range(0, n, sg)], axis=1)
        same = np.array_equal(got, ref)
        log(f"int8 d={d}: keys {got.shape} bit-identical={same}")
        check(same, f"int8 kernel keys differ from the oracle at d={d}")
        del qi, ci, got, ref

        # bf16 (l2): values to 2^-16 relative; argmins may differ on ties
        q_lp = (q * -2.0).astype(jnp.bfloat16)
        qsq = jnp.sum(q * q, 1, keepdims=True)
        c_lp = c.astype(jnp.bfloat16)
        bias = ps.make_bias(n, "l2", jnp.sum(c * c, 1), None, None)
        vals, idx = ps.bucket_min_scan(q_lp, qsq, c_lp, bias, positive=True)
        vals, idx = np.asarray(vals), np.asarray(idx)
        ref_fn = jax.jit(ps.bucket_min_scan_reference)
        step = 8 * ps.GROUP
        rv, ri = [], []
        for g in range(0, n, step):
            v, i = ref_fn(q_lp, qsq, c_lp[g:g + step], bias[:, g:g + step])
            rv.append(np.asarray(v))
            ri.append(np.asarray(i) + g)
        rv, ri = np.concatenate(rv, 1), np.concatenate(ri, 1)
        rel = float(np.max(np.abs(vals - rv) / np.abs(rv)))
        agree = float((idx == ri).mean())
        # the key truncates 7 mantissa bits (< 2^-16 relative) and the f32
        # accumulation order differs from XLA's (a few ulp: 8 * 2^-23)
        limit = 2.0 ** -16 + 8 * 2.0 ** -23
        log(f"bf16 d={d}: max rel err {rel:.3e} (limit {limit:.3e}), "
            f"argmin agreement {agree:.6f}")
        check(rel <= limit, f"bf16 kernel values off at d={d}: {rel}")
        del q, c, c_lp, vals, idx, rv, ri

    # memory plan of the served step at the bench batch
    bq = 65536
    args = (
        jax.ShapeDtypeStruct((bq, 128), jnp.float32),
        jax.ShapeDtypeStruct((n, 128), jnp.float32),
        None,
    )
    compiled = topk_ops.flat_topk_fused.lower(
        *args, k=K, corpus_i8=jax.ShapeDtypeStruct((n, 128), jnp.int8),
        i8_scale=jax.ShapeDtypeStruct((), jnp.float32),
        corpus_sq=jax.ShapeDtypeStruct((n,), jnp.float32),
    ).compile()
    log(f"flat_topk_fused int8 B={bq} N={n}: "
        f"{compiled.memory_analysis()}")


# ---------------------------------------------------------------------------
# c-f: the engine
# ---------------------------------------------------------------------------

def knn_args(index, q, knn=f"*=>[KNN {K} @v $q AS dist]"):
    return ("FT.SEARCH", index, knn, "PARAMS", "2", "q", q.tobytes(),
            "RETURN", "1", "dist")


def parse_knn(reply, prefix):
    """FT.SEARCH reply → (row ids, distances)."""
    ids, dists = [], []
    for i in range(1, len(reply), 2):
        ids.append(int(str(reply[i])[len(prefix):]))
        f = reply[i + 1]
        dists.append(float(dict(zip(f[::2], f[1::2]))["dist"]))
    return ids, dists


def search_all(e, index, queries, prefix):
    got = [parse_knn(e.execute(*knn_args(index, q)), prefix) for q in queries]
    return [g[0] for g in got], [g[1] for g in got]


def check_knn(name, corpus, queries, truth, ids, dists, floor):
    rec = recall(ids, truth[0])
    err = exact_dist_err(corpus, queries, ids, dists)
    log(f"{name}: recall@10={rec:.4f} max|dist-exact|={err:.3e}")
    check(rec >= floor, f"{name}: recall {rec} < {floor}")
    check(err < DIST_TOL, f"{name}: distances not exact ({err})")
    return rec


def phase_c(e, corpus, queries, truth):
    from valkey_search_tpu.runtime.metrics import STATS

    t0 = time.perf_counter()
    e.execute("FT.CREATE", "flat", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
              "DIM", str(D), "DISTANCE_METRIC", "L2",
              "tag", "TAG", "price", "NUMERIC")
    for i in range(len(corpus)):
        e.execute("HSET", f"doc:{i}", "v", corpus[i].tobytes(),
                  "tag", "x" if i % 10 == 0 else "y", "price", str(i % 1000))
    e.drain()
    log(f"HSET {len(corpus)} docs: {time.perf_counter() - t0:.3f}s")
    info = e.execute("FT.INFO", "flat")
    info = dict(zip(map(str, info[::2]), info[1::2]))
    log(f"FT.INFO num_docs={info.get('num_docs')}")
    check(int(info.get("num_docs", -1)) == len(corpus), "FT.INFO num_docs")

    allowed = (np.arange(len(corpus)) % 10 == 0) & (
        (np.arange(len(corpus)) % 1000 >= 100)
        & (np.arange(len(corpus)) % 1000 <= 200))
    hybrid_truth = fp64_truth(corpus, queries[:16], K, allowed)

    for dtype, mode, prec, exact in (
        ("bfloat16", "approx", "high", False),
        ("int8", "approx", "high", False),
        ("float32", "exact", "high", True),
    ):
        e.config_set("search.corpus-dtype", dtype)
        e.config_set("search.topk-mode", mode)
        e.config_set("search.distance-precision", prec)
        t0 = time.perf_counter()
        ids, dists = search_all(e, "flat", queries, "doc:")
        log(f"{dtype}/{mode}: {len(queries)} sequential FT.SEARCH in "
            f"{time.perf_counter() - t0:.3f}s")
        check_knn(f"{dtype}/{mode} pure KNN", corpus, queries, truth, ids,
                  dists, 0.99)
        if exact:
            for b, (g, t, td) in enumerate(zip(ids, truth[0], truth[1])):
                # equal up to ties: any id outside the fp64 top-k must tie
                # the k-th fp64 distance
                extra = set(g) - set(t.tolist())
                x = corpus[list(extra)].astype(np.float64) - queries[b]
                check(all(np.abs((x * x).sum(1) - td[-1]) <= DIST_TOL),
                      f"exact mode: ids differ from fp64 truth at query {b}")
            log("exact mode ids == fp64 ground truth (up to ties)")

        # concurrent KNN: coalesces in query/batcher.py
        before = STATS.get("query_batches_coalesced")
        t0 = time.perf_counter()
        futs = [e.ft_search_async(*knn_args("flat", q)[1:])
                for q in np.concatenate([queries] * 4)]
        got = [parse_knn(f.result(timeout=600), "doc:") for f in futs]
        log(f"{dtype}/{mode}: {len(futs)} concurrent ft_search_async in "
            f"{time.perf_counter() - t0:.3f}s, coalesced launches "
            f"{STATS.get('query_batches_coalesced') - before}")
        check_knn(f"{dtype}/{mode} concurrent KNN", corpus,
                  np.concatenate([queries] * 4), tuple(
                      np.concatenate([a] * 4) for a in truth),
                  [g[0] for g in got], [g[1] for g in got], 0.99)

        hy = [parse_knn(e.execute(
            "FT.SEARCH", "flat",
            f"(@tag:{{x}} @price:[100 200])=>[KNN {K} @v $q AS dist]",
            "PARAMS", "2", "q", q.tobytes(), "RETURN", "1", "dist"), "doc:")
            for q in queries[:16]]
        hy_ids = [h[0] for h in hy]
        check(all(allowed[i] for g in hy_ids for i in g),
              "hybrid returned a row outside the filter")
        check_knn(f"{dtype}/{mode} hybrid KNN", corpus, queries[:16],
                  hybrid_truth, hy_ids, [h[1] for h in hy], 0.99)

    # TF32: the float32 scan at distance-precision high (reported, not a
    # gate; its distances are the TF32 scores, not a rescore)
    e.config_set("search.topk-mode", "approx")
    ids, dists = search_all(e, "flat", queries, "doc:")
    log(f"float32/approx distance-precision high (TF32): "
        f"recall@10={recall(ids, truth[0]):.4f} "
        f"max|dist-exact|={exact_dist_err(corpus, queries, ids, dists):.3e}")
    for name in ("search.corpus-dtype", "search.topk-mode",
                 "search.distance-precision"):
        e.config_set(name,
                  {"search.corpus-dtype": "bfloat16",
                   "search.topk-mode": "approx",
                   "search.distance-precision": "high"}[name])


def phase_d(e, corpus, queries, truth):
    e.config_set("search.ivf-threshold", str(len(corpus)))
    e.config_set("search.ivf-probe", "16")
    t0 = time.perf_counter()
    e.execute(*knn_args("flat", queries[0]))
    log(f"IVF build + first query: {time.perf_counter() - t0:.3f}s")
    ids, dists = search_all(e, "flat", queries, "doc:")
    check_knn("IVF probe 16", corpus, queries, truth, ids, dists, 0.97)
    e.config_set("search.ivf-threshold", "3000000")
    e.config_set("search.ivf-probe", "0")


def phase_e(e, corpus, queries):
    """HNSW on its own engine (phase f saves and loads it)."""
    from valkey_search_tpu.indexes.hnsw import HnswVectorIndex
    from valkey_search_tpu.runtime import config

    rows = corpus[:N_HNSW]
    truth = fp64_truth(rows, queries, K)
    e.config_set("search.hnsw-scan-threshold", "0")
    t0 = time.perf_counter()
    e.execute("FT.CREATE", "hnsw", "ON", "HASH", "PREFIX", "1", "h:",
              "SCHEMA", "v", "VECTOR", "HNSW", "10", "TYPE", "FLOAT32",
              "DIM", str(D), "DISTANCE_METRIC", "L2", "M", "16",
              "EF_CONSTRUCTION", "200")
    for i in range(len(rows)):
        e.execute("HSET", f"h:{i}", "v", rows[i].tobytes())
    e.drain()
    log(f"HSET {len(rows)} docs into HNSW: {time.perf_counter() - t0:.3f}s")
    walk = f"*=>[KNN {K} @v $q EF_RUNTIME 200 AS dist]"
    got = [parse_knn(e.execute(*knn_args("hnsw", q, walk)), "h:")
           for q in queries]
    ids, dists = [g[0] for g in got], [g[1] for g in got]
    check_knn("HNSW graph walk ef 200", rows, queries, truth, ids, dists,
              0.9)

    builds = {}
    # the host build gets every core (native-build-threads 0)
    config.set_config("search.native-build-threads", "0")
    for mode in ("device", "host"):
        config.set_config("search.hnsw-build-mode", mode)
        idx = HnswVectorIndex(dim=D, metric="l2", m=16, ef_construction=200)
        t0 = time.perf_counter()
        idx.bulk_load([f"r{i}" for i in range(len(rows))], rows)
        idx.device_graph()
        builds[mode] = time.perf_counter() - t0
        d, docs = idx.search_batch(queries, K, ef=200)
        got = [[int(key[1:]) for key, _ in idx.neighbors_to_keys(dd, di)]
               for dd, di in zip(d, docs)]
        rec = recall(got, truth[0])
        log(f"bulk build {mode}: {builds[mode]:.3f}s "
            f"({len(rows) / builds[mode]:.1f} vec/s) graph recall@10 "
            f"ef 200 = {rec:.4f}")
        check(rec >= 0.9, f"{mode}-built graph recall {rec}")
    config.set_config("search.hnsw-build-mode", "auto")
    config.set_config("search.native-build-threads", "1")
    log(f"device build / host build time = "
        f"{builds['device'] / builds['host']:.3f}")


def phase_f(e, queries):
    from valkey_search_tpu.server import Engine
    from valkey_search_tpu.server.resp import RespServer

    def answers(eng):
        return [eng.execute(*knn_args("hnsw", q)) for q in queries[:16]]

    before = answers(e)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        t0 = time.perf_counter()
        e.save(os.path.join(tmp, "save.vstpu"))
        log(f"SAVE: {time.perf_counter() - t0:.3f}s")
        srv = RespServer(e, port=0)
        t0 = time.perf_counter()
        srv.bgsave_forked(os.path.join(tmp, "bgsave.vstpu"))
        while srv.bgsave_status == "in-progress":
            check(time.perf_counter() - t0 < 600, "BGSAVE timed out")
            time.sleep(0.1)
        log(f"forked BGSAVE: {srv.bgsave_status} in "
            f"{time.perf_counter() - t0:.3f}s")
        check(srv.bgsave_status == "ok", "forked BGSAVE failed")
        for name in ("save.vstpu", "bgsave.vstpu"):
            t0 = time.perf_counter()
            loaded = Engine.load(os.path.join(tmp, name))
            log(f"Engine.load {name}: {time.perf_counter() - t0:.3f}s")
            check(answers(loaded) == before,
                  f"KNN answers changed after loading {name}")
    log("KNN answers identical after SAVE/BGSAVE + load")


# ---------------------------------------------------------------------------
# four cards: the sharded mesh path against one card
# ---------------------------------------------------------------------------

def four_cards():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from valkey_search_tpu.ops import ivf as ivf_ops
    from valkey_search_tpu.ops import topk as topk_ops
    from valkey_search_tpu.parallel import mesh as pm

    check(len(jax.devices()) >= 4, "--four-cards needs four GPUs")
    n, d, b = N_MESH, D_MESH, B_MESH
    corpus, queries = clustered(n, d, b)
    mesh = pm.make_mesh(4)
    sharded = jax.device_put(corpus, NamedSharding(mesh, P("shard", None)))
    where = sorted({s.device.id for s in sharded.addressable_shards})
    log(f"corpus {corpus.shape} shards on devices {where}; bytes_in_use "
        + str([(dv.memory_stats() or {}).get("bytes_in_use")
               for dv in jax.devices()[:4]]))
    check(len(where) == 4, "corpus shards did not land on four cards")
    qd = jnp.asarray(queries)

    # one card, exact: the comparison
    one = jax.device_put(corpus, jax.devices()[0])
    t0 = time.perf_counter()
    rd, ri = jax.block_until_ready(topk_ops.flat_topk(
        jax.device_put(qd, jax.devices()[0]), one, k=K,
        block_rows=n // 10, precision="highest", mode="exact"))
    log(f"one-card exact flat_topk: {time.perf_counter() - t0:.3f}s")
    rd, ri = np.asarray(rd), np.asarray(ri)
    del one

    # exact paths may still swap near-ties: ||q||²+||c||²-2q·c rounds
    # differently in f32 when the matmul's shape differs
    exact_floor = 0.999

    def compare(name, dd, ii, floor):
        dd, ii = np.asarray(dd), np.asarray(ii)
        rec = recall(ii, ri)
        err = float(np.abs(dd - rd).max())
        log(f"{name}: recall vs one card {rec:.4f} max|d - d1| {err:.3e}")
        check(rec >= floor, f"{name}: recall {rec} < {floor}")

    for two in (False, True):
        t0 = time.perf_counter()
        dd, ii, _ = jax.block_until_ready(pm.sharded_flat_topk(
            mesh, sharded, qd, k=K, block_rows=n // 20, two_stage=two))
        log(f"sharded_flat_topk two_stage={two}: "
            f"{time.perf_counter() - t0:.3f}s")
        compare(f"sharded_flat_topk two_stage={two}", dd, ii,
                0.99 if two else exact_floor)

    m2 = pm.make_mesh_2d(2, 2)
    c2 = jax.device_put(corpus, NamedSharding(m2, P("shard", None)))
    q2 = jax.device_put(qd, NamedSharding(m2, P("replica", None)))
    t0 = time.perf_counter()
    dd, ii = jax.block_until_ready(
        pm.replicated_sharded_flat_topk(m2, c2, q2, k=K))
    log(f"replicated_sharded_flat_topk 2x2: {time.perf_counter() - t0:.3f}s")
    compare("replicated_sharded_flat_topk 2x2", dd, ii, exact_floor)
    del c2, q2

    del sharded
    t0 = time.perf_counter()
    idx = ivf_ops.build_ivf_device(jax.device_put(corpus, jax.devices()[0]))
    log(f"IVF build on one card: {time.perf_counter() - t0:.3f}s, "
        f"{idx.n_blocks} blocks")
    idx = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("shard"))), idx)
    slots = jax.device_put(pm.rows_in_slot_order(corpus, idx.block_ids),
                           NamedSharding(mesh, P("shard")))
    t0 = time.perf_counter()
    dd, ii = jax.block_until_ready(pm.sharded_ivf_topk_rescored(
        mesh, idx, slots, qd, k=K, probe=64))
    log(f"sharded_ivf_topk_rescored probe 64: "
        f"{time.perf_counter() - t0:.3f}s")
    compare("sharded_ivf_topk_rescored", dd, ii, 0.97)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="abcdef")
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args()

    from valkey_search_tpu.runtime import jaxinit

    jaxinit.init()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[smoke] FATAL: no GPU (default device is {dev.platform})",
              file=sys.stderr)
        return 2
    import jax.monitoring

    jax.monitoring.register_event_duration_secs_listener(_on_event)
    card = card_identity()
    print(f"[smoke] card: {card}", flush=True)
    run_phase("a card", phase_a, card)
    if args.four_cards:
        run_phase("four-cards mesh", four_cards)
    else:
        phases = args.phases.replace(",", "")
        if "b" in phases:
            run_phase("b kernels", phase_b)
        if set(phases) & set("cdef"):
            from valkey_search_tpu.server import Engine

            corpus, queries = clustered(N_FLAT, D, N_GT)
            truth = fp64_truth(corpus, queries, K)
            if set(phases) & set("cd"):
                e = Engine()
                run_phase("c flat", phase_c, e, corpus, queries, truth)
                if "d" in phases:
                    run_phase("d ivf", phase_d, e, corpus, queries, truth)
                del e
            if set(phases) & set("ef"):
                e = Engine()
                run_phase("e hnsw", phase_e, e, corpus, queries)
                if "f" in phases:
                    run_phase("f persistence", phase_f, e, queries)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
