"""HNSW traversal micro-benchmark: AoS int8 fast path vs SoA kernel.

Measures the graph-walk QPS + recall on a clustered 100k x 128 corpus at
several batch sizes and expansion widths. Chained dependent launches +
one host sync time the whole chain to device completion.

Usage: python scripts/traversal_bench.py [n] [ef]
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from valkey_search_tpu.runtime import jaxinit  # noqa: E402

jaxinit.init()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from valkey_search_tpu.indexes.hnsw import HnswVectorIndex  # noqa: E402
from valkey_search_tpu.ops import hnsw_search as hs  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    ef = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    d, k = 128, 10
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 5
    corpus = centers[rng.integers(0, 1024, n)] + \
        rng.standard_normal((n, d)).astype(np.float32)
    print(f"[trav] platform={jax.default_backend()} n={n} ef={ef}",
          flush=True)
    idx = HnswVectorIndex(dim=d, m=16, ef_construction=200, seed=7)
    t0 = time.perf_counter()
    idx.bulk_load([f"k{i}" for i in range(n)], corpus)
    print(f"[trav] build {n/(time.perf_counter()-t0):.0f} vec/s", flush=True)
    graph = idx.device_graph()
    aos = hs.build_aos_tables(graph)

    queries = centers[rng.integers(0, 1024, 1024)] + \
        rng.standard_normal((1024, d)).astype(np.float32)
    gt = []
    c_sq = np.einsum("ij,ij->i", corpus, corpus)
    for q in queries[:256]:
        dd = c_sq - 2.0 * (corpus @ q)
        gt.append(set(np.argpartition(dd, k)[:k].tolist()))

    def run(kind, b, e_exp):
        qd = jnp.asarray(queries[:b])
        if kind == "aos":
            f = lambda qv: hs.hnsw_search_batch_aos(
                graph, aos, qv, k=k, ef=ef, expand_per_iter=e_exp)
        elif kind == "seed":
            stride = max(1, n // 8192)
            f = lambda qv: hs.hnsw_search_batch_aos(
                graph, aos, qv, k=k, ef=ef, expand_per_iter=e_exp,
                seed_stride=stride)
        else:
            f = lambda qv: hs.hnsw_search_batch(
                graph, qv, k=k, ef=ef, metric="l2", precision="high",
                expand_per_iter=e_exp)
        dd, ii = f(qd)
        _ = np.asarray(ii)  # warm + sync
        t0 = time.perf_counter()
        reps = 4
        qv = qd
        for _r in range(reps):
            dd, ii = f(qv)
            qv = qd + dd[0, 0] * 0  # chain: next launch depends on this
        ids = np.asarray(ii)
        dt = (time.perf_counter() - t0) / reps
        rec = np.mean([
            len(set(ids[i, :k].tolist()) & gt[i]) / k
            for i in range(min(b, 256))
        ])
        print(f"[trav] {kind:3s} B={b:5d} E={e_exp:2d}: "
              f"{b/dt:8.0f} qps  recall@10={rec:.4f}  "
              f"({dt*1e3:.1f} ms/launch)", flush=True)
        return b / dt, rec

    for b in (256, 1024):
        for e_exp in (4, 8, 16):
            run("aos", b, e_exp)
    for e_exp in (4, 8, 16):
        run("seed", 1024, e_exp)
    run("soa", 1024, 4)


if __name__ == "__main__":
    main()
