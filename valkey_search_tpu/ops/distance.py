"""Distance metrics as tensor-core contractions.

Semantics match the reference's hnswlib spaces exactly:
- ``l2``:      squared Euclidean distance (reference third_party/hnswlib/
               space_l2.h:12-30 — returns the *squared* L2, no sqrt).
- ``ip``:      1 - <q, x>  (reference third_party/hnswlib/space_ip.h — the
               "inner product distance").
- ``cosine``:  identical kernel to ``ip``; vectors are L2-normalized at
               ingest and the original magnitude tracked separately
               (reference src/indexes/vector_base.cc NormalizeEmbedding,
               vector_base.h:46-60), so cosine distance = 1 - dot of the
               normalized embeddings.

All batched distances are computed as a single ``dot_general`` so XLA tiles
them onto the tensor cores; the expansion
``||q-x||² = ||q||² + ||x||² - 2 q·x`` turns L2 into the same matmul as IP plus two cheap rank-1 adds that XLA
fuses into the matmul epilogue.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

VALID_METRICS = ("l2", "ip", "cosine")

# Precision for the q·x contraction. HIGHEST keeps fp32-exact ordering so
# exact-KNN results are bit-comparable with a CPU float implementation;
# "default" lets the tensor cores use bf16 passes (faster, fine for ANN).
_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def resolve_precision(precision: str | jax.lax.Precision) -> jax.lax.Precision:
    if isinstance(precision, jax.lax.Precision):
        return precision
    return _PRECISION[precision]


def squared_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise ||x||² in fp32. Shape [N]."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def normalize_rows(x: jnp.ndarray, eps: float = 1e-30):
    """L2-normalize rows, returning (normalized, magnitudes).

    Mirrors reference src/indexes/vector_base.cc NormalizeEmbedding: the
    magnitude is kept so the original vector can be denormalized for
    RETURN-field externalization (src/vector_externalizer.cc).
    """
    xf = x.astype(jnp.float32)
    mag = jnp.sqrt(jnp.sum(xf * xf, axis=-1, keepdims=True))
    return xf / jnp.maximum(mag, eps), jnp.squeeze(mag, -1)


@functools.partial(jax.jit, static_argnames=("metric", "precision"))
def pairwise_scores(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    metric: str = "l2",
    corpus_sq: Optional[jnp.ndarray] = None,
    precision: str = "highest",
) -> jnp.ndarray:
    """All-pairs distance matrix [B, N] between queries [B, d] and corpus [N, d].

    ``corpus_sq`` is an optional precomputed ||x||² per corpus row (kept
    device-resident by the flat index so it is not recomputed per query).
    """
    if metric not in VALID_METRICS:
        raise ValueError(f"unknown metric {metric!r}; want one of {VALID_METRICS}")
    prec = resolve_precision(precision)
    dots = jax.lax.dot_general(
        queries,
        corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=prec,
        preferred_element_type=jnp.float32,
    )
    if metric == "l2":
        if corpus_sq is None:
            corpus_sq = squared_norms(corpus)
        q_sq = squared_norms(queries)
        return q_sq[:, None] + corpus_sq[None, :] - 2.0 * dots
    # ip / cosine share the 1 - dot kernel.
    return 1.0 - dots


def batched_candidate_scores(
    queries: jnp.ndarray,
    cand_vecs: jnp.ndarray,
    metric: str,
    precision: str = "highest",
) -> jnp.ndarray:
    """Per-query candidate distances: queries [B, d] × cand_vecs [B, C, d] → [B, C].

    The per-hop distance step of batched HNSW beam search: one einsum so the
    whole batch lands on the tensor cores (replaces the per-candidate SIMD
    call in the reference's searchBaseLayerST hot loop, hnswalg.h:1611-1685).
    """
    prec = resolve_precision(precision)
    dots = jnp.einsum(
        "bd,bcd->bc",
        queries.astype(jnp.float32),
        cand_vecs.astype(jnp.float32),
        precision=prec,
    )
    if metric == "l2":
        q_sq = squared_norms(queries)
        c_sq = jnp.sum(
            cand_vecs.astype(jnp.float32) * cand_vecs.astype(jnp.float32), axis=-1
        )
        return q_sq[:, None] + c_sq - 2.0 * dots
    return 1.0 - dots
