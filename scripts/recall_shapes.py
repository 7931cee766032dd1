"""Recall robustness of the fused-scan defaults across corpus shapes
(the headline recall comes from ONE clustered-bytes recipe, with a thin
margin over the 0.99 floor).

Measures the DEFAULT serving path (auto span/coarse-factor int8 fused
scan + exact fp32 rescore) plus a span x cf sweep, on three 1M-row
shapes:

  clustered128  the bench/SIFT recipe (1024 centers, byte-valued, d=128)
  uniform128    iid uniform bytes, d=128 — distance concentration's worst
                case (hostile to ANY ANN structure; the reference's
                hnswlib loses recall here too, BASELINE.md ef=10 0.607)
  lowrank768    embedding-like high-d: 768-d, rank-64 latent structure +
                isotropic noise, unit-normalized (GloVe/BERT-shape)

Prints one JSON line:
  {"shapes": {name: {"default": [qps, recall], "sweep": {"s8cf4": ...}}}}

Run on the card: python scripts/recall_shapes.py
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

from valkey_search_tpu.ops import topk as topk_ops  # noqa: E402

N = int(os.environ.get("VSTPU_SHAPES_N", "1048576"))
B = int(os.environ.get("VSTPU_SHAPES_B", "16384"))
K = 10
N_GT = 64
t0_all = time.perf_counter()


def log(msg):
    print(f"[shapes {time.perf_counter() - t0_all:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def gen_on_device(shape_name):
    """Device-generated (corpus, queries) for one shape; only O(KB)
    parameters cross the host link."""
    if shape_name == "clustered128":
        d = 128
        rng = np.random.default_rng(42)
        cent = rng.standard_normal((1024, d)).astype(np.float32) * 60 + 128
        cent_d = jnp.asarray(cent)

        def gen(key, m):
            k1, k2 = jax.random.split(key)
            a = jax.random.randint(k1, (m,), 0, 1024)
            z = jax.random.normal(k2, (m, d), dtype=jnp.float32)
            return jnp.clip(jnp.take(cent_d, a, axis=0) + z * 20, 0, 255)
    elif shape_name == "uniform128":
        d = 128

        def gen(key, m):
            return jax.random.uniform(key, (m, d), jnp.float32, 0.0, 255.0)
    elif shape_name == "lowrank768":
        d, r = 768, 64
        rng = np.random.default_rng(7)
        proj = jnp.asarray(
            rng.standard_normal((r, d)).astype(np.float32) / np.sqrt(r))

        def gen(key, m):
            k1, k2 = jax.random.split(key)
            lat = jax.random.normal(k1, (m, r), dtype=jnp.float32)
            z = jax.random.normal(k2, (m, d), dtype=jnp.float32) * 0.25
            x = lat @ proj + z
            return x / jnp.linalg.norm(x, axis=1, keepdims=True)
    else:
        raise ValueError(shape_name)

    gen = jax.jit(gen, static_argnames=("m",))
    gch = min(N, 20 * 65536)
    keys = jax.random.split(jax.random.PRNGKey(11), -(-N // gch) + 1)
    chunks = [gen(keys[i], min(gch, N - st))
              for i, st in enumerate(range(0, N, gch))]
    vecs = jnp.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    queries = gen(keys[-1], B)
    return vecs, queries


def snap_of(vecs):
    scale = jnp.max(jnp.abs(vecs)) / 127.0
    i8 = jnp.clip(jnp.round(vecs / scale), -127, 127).astype(jnp.int8)
    norms = jnp.sum(vecs * vecs, axis=1)
    inv = jnp.zeros((vecs.shape[0],), bool)
    return {"vectors": vecs, "vectors_i8": i8, "i8_scale": scale,
            "norms_sq": norms, "invalid": inv}


def measure(snap, qd, gt, span=None, cf=None, reps=3):
    cap = int(snap["vectors"].shape[0])

    def launch():
        return topk_ops.flat_topk_fused(
            qd, snap["vectors"], None, k=K, metric="l2",
            corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
            block_rows=cap, corpus_i8=snap["vectors_i8"],
            i8_scale=snap["i8_scale"], span=span, coarse_factor=cf,
        )

    d, i = launch()
    ids = np.asarray(i)
    t0 = time.perf_counter()
    outs = [launch() for _ in range(reps)]
    jax.block_until_ready(outs)
    qps = reps * int(qd.shape[0]) / (time.perf_counter() - t0)
    rec = float(np.mean([
        len(set(ids[b, :K].tolist()) & gt[b]) / K for b in range(N_GT)]))
    return round(qps, 1), round(rec, 4)


def main():
    if not topk_ops.fused_scan_compiles():
        raise SystemExit("needs a GPU: the fused scan compiles only there")
    log(f"platform={jax.devices()[0].platform} N={N} B={B}")
    out = {}
    shapes = os.environ.get(
        "VSTPU_SHAPES", "clustered128,uniform128,lowrank768").split(",")
    for name in shapes:
        log(f"=== {name}: generating on device")
        vecs, qd = gen_on_device(name)
        snap = snap_of(vecs)
        # exact fp32 GT on device (same iterative-argmin trick as bench)
        cap = int(vecs.shape[0])
        br = next(c for c in range(min(262144, cap), 0, -1) if cap % c == 0)
        _, gii = topk_ops.flat_topk(
            qd[:N_GT], snap["vectors"], k=K, metric="l2",
            corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
            block_rows=br, precision="highest", mode="exact")
        gt = [set(r.tolist()) for r in np.asarray(gii)]
        res = {"n": cap, "d": int(vecs.shape[1])}
        res["default"] = list(measure(snap, qd, gt))
        log(f"{name} default: {res['default'][0]} qps "
            f"recall@10={res['default'][1]}")
        sweep = {}
        for span in (4, 8):
            for cf in (4, 5, 8):
                q, r = measure(snap, qd, gt, span=span, cf=cf)
                sweep[f"s{span}cf{cf}"] = [q, r]
                log(f"{name} span={span} cf={cf}: {q} qps recall={r}")
        res["sweep"] = sweep
        out[name] = res
        vecs = snap = qd = None
    print(json.dumps({"n": N, "b": B, "shapes": out}), flush=True)


if __name__ == "__main__":
    main()
