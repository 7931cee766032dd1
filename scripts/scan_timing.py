"""Time the fused coarse scan against its plain-XLA version, and
lax.approx_min_k against lax.top_k at the engine's selection shapes.

Run on the card (one process):  python scripts/scan_timing.py
    [--dims 128,768] [--batches 1,64,8192,65536] [--scans triton,xla]
    [--skip-select] [--skip-scan]

1. ``flat_topk_fused`` end to end (coarse scan + survivor selection +
   exact rescore, to ``block_until_ready``) with the Triton kernel and with
   ``reference=True`` (the kernel's XLA oracle plus the same selection),
   at B in {1, 64, 8192, 65536}, N = 1,048,576, d in {128, 768}, for the
   int8 and bf16 corpora. The XLA version holds the [B, block] score
   matrix, so above B=8192 it runs as 8192-query launches.
2. Each approx_min_k site's shape, both primitives.

Prints one JSON object per measurement (median of the timed calls) and
writes them to chiprun_out/scan_timing.jsonl. Every line names the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from valkey_search_tpu.runtime import jaxinit  # noqa: E402

jaxinit.init()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from valkey_search_tpu.ops import topk as topk_ops  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chiprun_out", "scan_timing.jsonl")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def timed(fn, reps: int = 5, budget_s: float = 3.0):
    """(first-call seconds incl. compile, median warm seconds)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    t_end = time.perf_counter() + budget_s
    while len(times) < reps and (len(times) < 2 or time.perf_counter() < t_end):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


def emit(rec, fh):
    rec["card"] = CARD
    line = json.dumps(rec)
    print(line, flush=True)
    fh.write(line + "\n")
    fh.flush()


XLA_MAX_B = 8192


def scan_cells(fh, batches, dims, scans):
    n, k = 1 << 20, 10
    key = jax.random.PRNGKey(3)
    for d in dims:
        kc, kq, key = jax.random.split(key, 3)
        corpus = jax.random.normal(kc, (n, d), jnp.float32)
        scale = jnp.max(jnp.abs(corpus)) / 127
        c_i8 = jnp.clip(jnp.round(corpus / scale), -127, 127).astype(jnp.int8)
        c_lp = corpus.astype(jnp.bfloat16)
        c_sq = jnp.sum(corpus * corpus, 1)
        for b in batches:
            q = jax.random.normal(jax.random.fold_in(kq, b), (b, d))
            for dtype in ("int8", "bfloat16"):
                for scan in scans:
                    ref = scan == "xla"
                    kw = dict(k=k, corpus_sq=c_sq, reference=ref,
                              block_rows=n)
                    if dtype == "int8":
                        kw.update(corpus_i8=c_i8, i8_scale=scale)
                        lp = None
                    else:
                        lp = c_lp
                    rec = {"what": "flat_topk_fused", "dtype": dtype,
                           "scan": scan, "B": b, "N": n, "d": d}
                    step = XLA_MAX_B if ref else b

                    def run():
                        return [topk_ops.flat_topk_fused(
                            q[i:i + step], corpus, lp, **kw)
                            for i in range(0, b, step)]

                    try:
                        first, warm = timed(run)
                        rec.update(first_s=first, ms=warm * 1e3,
                                   qps=b / warm)
                    except Exception as exc:  # record and go on
                        rec["error"] = f"{type(exc).__name__}: {exc}"[:300]
                    emit(rec, fh)
        del corpus, c_i8, c_lp


def selection_cells(fh):
    key = jax.random.PRNGKey(5)
    shapes = [
        ("survivor_min_k", 65536, 1024, 40),
        ("survivor_min_k", 65536, 2048, 40),
        ("survivor_min_k", 65536, 4096, 40),
        ("survivor_min_k", 65536, 8192, 40),
        ("ivf_stage1_1M", 16384, 1024, 16),
        ("ivf_stage1_10M", 16384, 16384, 16),
        ("ivf_stage2", 16384, 16384, 40),
        ("flat_score_block", 8192, 131072, 30),
        ("hnsw_build_pool", 4096, 100352, 200),
    ]
    for site, b, w, kk in shapes:
        x = jax.random.normal(jax.random.fold_in(key, w * 7 + b), (b, w))
        fns = {
            "approx_min_k": jax.jit(
                lambda v, kk=kk: jax.lax.approx_min_k(
                    v, kk, recall_target=0.95)),
            "top_k": jax.jit(lambda v, kk=kk: jax.lax.top_k(-v, kk)),
        }
        for name, fn in fns.items():
            first, warm = timed(lambda: fn(x))
            emit({"what": "select", "site": site, "op": name, "B": b,
                  "width": w, "k": kk, "first_s": first, "ms": warm * 1e3},
                 fh)
        del x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="128,768")
    ap.add_argument("--batches", default="1,64,8192,65536")
    ap.add_argument("--scans", default="triton,xla")
    ap.add_argument("--skip-select", action="store_true")
    ap.add_argument("--skip-scan", action="store_true")
    args = ap.parse_args()
    global CARD
    CARD = card()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as fh:
        emit({"what": "device", "kind": dev.device_kind,
              "count": len(jax.devices())}, fh)
        if not args.skip_select:
            selection_cells(fh)
        if not args.skip_scan:
            scan_cells(fh, [int(x) for x in args.batches.split(",")],
                       [int(x) for x in args.dims.split(",")],
                       args.scans.split(","))


CARD = ""

if __name__ == "__main__":
    main()
