"""Fused coarse scan: distance matmul + per-bucket min, one Triton kernel.

The plain two-stage coarse scan (ops/topk.py flat_topk_two_stage) writes
the whole [B, N] score matrix to device memory before a selection reads it
back: at B=65536 and N=1M that is 262 GB of f32 traffic against a 128 MB
int8 corpus. This kernel folds the reduction into the matmul: each program
keeps a [block_b, 128] int32 accumulator in registers, walks its corpus rows
in 128-row tiles (one tensor-core ``dot`` per 128-wide slice of the
contraction dimension) and min-folds every tile's scores into the
accumulator, so device memory sees only the corpus stream plus a survivor
array span*128 times smaller than the score matrix.

This plays the same role as the reference's fused scoring loop — the
brute-force scan in third_party/hnswlib/bruteforce.h:213 never materializes
all scores either; it folds selection into the distance pass via a bounded
heap. Selection here is bucketed because a data-dependent heap does not map
to the tensor cores; the candidate loss from bucket collisions is recovered
by coarse over-retrieval plus the exact fp32 rescore.

Survivor layout (shared by both key functions and decoded in
ops/topk.py): survivor group g covers ``span * GROUP`` consecutive corpus
rows; its survivor column g*128 + l keeps the min over the rows
{g*span*GROUP + m*BUCKET + l : m < span*128}, and the low ``chunk_bits`` of
each int32 key carry the m of the winning row. One survivor group is one
program's work; small batches split a group's tiles over ``split``
programs and a tiny XLA min over the split axis finishes the fold (min of
keys is associative, so the result is bit-identical).

Keys are "smaller is better": ``alpha * <q, c> + bias[c]`` with
- l2:        alpha=-2, bias=||c||²   (the per-query ||q||² offset cannot
                                      change per-query ordering, so it is
                                      dropped until the exact rescore)
- ip/cosine: alpha=-1, bias=0
Invalid rows (unallocated capacity, tombstones, filtered-out) carry
bias=+inf (bf16) or the SENTINEL (int8), which survives min-reduction and
marks the survivor invalid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

INF = float("inf")
INVALID_ID = -1

BUCKET = 128              # corpus rows per tile = survivor lanes per group
GROUP = BUCKET * BUCKET   # rows per survivor group at span 1 (128 chunks)
_INT32_MAX = 0x7FFFFFFF
# Programs wanted in flight before a group's tiles are split across
# programs: a few waves over the streaming multiprocessors of any current
# data-center card (132 on an H100).
_MIN_PROGRAMS = 512


class Tile(NamedTuple):
    """Launch shape of the fused scan: query rows per program, Triton's
    warps and pipeline stages, and how many programs share one survivor
    group's tiles."""

    block_b: int
    num_warps: int
    num_stages: int
    split: int


def choose_tile(b: int, groups: int, chunks: int) -> Tile:
    """Tile for a [b, *] query batch over ``groups`` survivor groups of
    ``chunks`` 128-row tiles each.

    block_b is a power of two in [16, 128] (16 is the tensor cores'
    smallest dot tile). At block_b=128 the int32 accumulator plus one tile
    of scores is 128 KB of registers, which needs 8 warps to stay under
    255 registers a thread. Small batches leave most of the card idle with
    one program per survivor group, so the group's tiles are split over
    programs until about _MIN_PROGRAMS are in flight.
    """
    block_b = min(128, max(16, pl.next_power_of_2(b)))
    programs = -(-b // block_b) * groups
    split = 1
    while (programs * split < _MIN_PROGRAMS
           and chunks % (2 * split) == 0):
        split *= 2
    return Tile(block_b, 8 if block_b >= 128 else 4, 3, split)


def _scan_kernel(q_ref, qsq_ref, c_ref, bias_ref, out_ref, *, nd: int,
                 steps: int, chunk_bits: int, pre_shift: int, mode: str):
    """One program: min-fold ``steps`` 128-row corpus tiles into a
    [block_b, 128] int32 key accumulator.

    mode "i8": int8 x int8 -> int32 dot; key = ((bias - dot) >> pre_shift)
    << chunk_bits | m. With pre_shift == 0 the chunk id is folded into the
    bias row first, so the per-score work is one shift, one subtract and
    one min: both shifted terms have zero low chunk_bits and the offset
    bias keeps bias - dot >= 0, so the subtraction never borrows out of the
    chunk field (bit-identical to the general form).

    modes "l2" / "ip": bf16 dot with f32 accumulation, score = dot + bias
    (+ ||q||² for l2, which makes it the true non-negative squared
    distance, so its raw f32 bits are already min-ordered as int32). ip
    scores have no sign guarantee and take the total-order involution
    key = bits ^ ((bits >> 31) & 0x7fffffff). The low chunk_bits of the key
    are then replaced by the chunk id (quantizing the coarse score by
    < 2^chunk_bits ulp, noise the over-retrieval + rescore absorb).
    """
    acc_t = jnp.int32 if mode == "i8" else jnp.float32
    block_b = q_ref.shape[0]
    m0 = pl.program_id(2) * steps
    low = jnp.int32((1 << chunk_bits) - 1)
    qsq = qsq_ref[...][:, None] if mode == "l2" else None

    def slice_dot(rows, kd, dot):
        cols = pl.ds(kd * 128, 128)
        return dot + jax.lax.dot_general(
            q_ref[:, cols], c_ref[rows, cols],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_t,
        )

    def body(t, acc):
        rows = pl.ds(t * BUCKET, BUCKET)
        dot = jnp.zeros((block_b, BUCKET), acc_t)
        if nd == 1:
            dot = slice_dot(rows, 0, dot)
        else:
            # one 128-wide contraction slice per inner step: Triton
            # pipelines this loop, so shared memory holds num_stages
            # slices rather than num_stages whole d-wide rows (d=768 at
            # three stages would need 576 KB of the 227 KB a block gets)
            dot = jax.lax.fori_loop(
                0, nd, lambda kd, x: slice_dot(rows, kd, x), dot)
        m = m0 + t
        bias = bias_ref[rows]
        if mode == "i8":
            if pre_shift:
                score = (bias[None, :] - dot) >> pre_shift
                key = (score << chunk_bits) | m
            else:
                bias_c = (bias << chunk_bits) | m
                key = bias_c[None, :] - (dot << chunk_bits)
        else:
            s = dot + bias[None, :]
            if qsq is not None:
                s = s + qsq
            bits = jax.lax.bitcast_convert_type(s, jnp.int32)
            if mode == "ip":
                bits = bits ^ ((bits >> 31) & jnp.int32(_INT32_MAX))
            key = (bits & ~low) | m
        return jnp.minimum(acc, key)

    acc = jax.lax.fori_loop(
        0, steps, body, jnp.full((block_b, BUCKET), _INT32_MAX, jnp.int32))
    out_ref[...] = acc


def _scan(queries, qsq, corpus, bias, *, span: int, pre_shift: int,
          mode: str, tile: Optional[Tile], interpret: bool) -> jnp.ndarray:
    """Packed survivor keys [B, N/(128*span)] i32 (layout in the module
    docstring). Shapes must already be padded: N % (span*GROUP) == 0,
    D % 128 == 0; B is padded here to the tile."""
    b, d = queries.shape
    n = corpus.shape[0]
    sg = span * GROUP
    if n % sg or d % 128 or bias.shape[-1] != n:
        raise ValueError(
            f"fused scan alignment: N={n}%{sg}, D={d}%128, "
            f"bias {bias.shape} must match N"
        )
    chunks = span * (GROUP // BUCKET)
    chunk_bits = (chunks - 1).bit_length()
    groups = n // sg
    tile = tile or choose_tile(b, groups, chunks)
    if chunks % tile.split:
        raise ValueError(f"split {tile.split} must divide {chunks} tiles")
    pad_b = -b % tile.block_b
    if pad_b:
        queries = jnp.pad(queries, ((0, pad_b), (0, 0)))
        qsq = jnp.pad(qsq, (0, pad_b))
    bp = b + pad_b
    split = tile.split
    rows_pp = sg // split
    out = pl.pallas_call(
        functools.partial(
            _scan_kernel, nd=d // 128, steps=chunks // split,
            chunk_bits=chunk_bits, pre_shift=pre_shift, mode=mode,
        ),
        grid=(bp // tile.block_b, groups, split),
        in_specs=[
            pl.BlockSpec((tile.block_b, d), lambda i, g, s: (i, 0)),
            pl.BlockSpec((tile.block_b,), lambda i, g, s: (i,)),
            pl.BlockSpec(
                (rows_pp, d), lambda i, g, s, p=split: (g * p + s, 0)),
            pl.BlockSpec((rows_pp,), lambda i, g, s, p=split: (g * p + s,)),
        ],
        out_specs=pl.BlockSpec(
            (None, tile.block_b, BUCKET), lambda i, g, s: (s, i, g)),
        out_shape=jax.ShapeDtypeStruct((split, bp, groups * BUCKET),
                                       jnp.int32),
        compiler_params=pltr.CompilerParams(
            num_warps=tile.num_warps, num_stages=tile.num_stages),
        backend="triton",
        interpret=interpret,
        name=f"fused_scan_{mode}",
    )(queries, qsq, corpus, bias.reshape(n))
    return out.min(axis=0)[:b]


@functools.partial(
    jax.jit, static_argnames=("positive", "tile", "interpret")
)
def bucket_min_scan(
    queries: jnp.ndarray,   # [B, D] bf16, alpha PRE-FOLDED (see wrapper)
    qsq: jnp.ndarray,       # [B, 1] f32 ||q||^2 (zeros unless positive)
    corpus: jnp.ndarray,    # [N, D] bf16 (N % GROUP == 0)
    bias: jnp.ndarray,      # [1, N] f32 (+inf rows are invalid)
    positive: bool,
    tile: Optional[Tile] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused bf16 coarse scan → (vals [B, N/128] f32, idx [B, N/128] i32).

    ``positive``: scores qsq + bias + <q, c> are >= 0 up to bf16 rounding
    (true for l2 with alpha folded into q) — enables the raw-bits key.
    vals carry the key's quantized score (low 7 mantissa bits dropped).
    """
    key = _scan(
        queries, qsq.reshape(-1).astype(jnp.float32), corpus, bias,
        span=1, pre_shift=0, mode="l2" if positive else "ip", tile=tile,
        interpret=interpret,
    )
    return _decode_bf16(key, positive)


def _decode_bf16(key, positive):
    vbits = key & jnp.int32(~127)
    if not positive:
        vbits = vbits ^ ((vbits >> 31) & jnp.int32(_INT32_MAX))
    vals = jax.lax.bitcast_convert_type(vbits, jnp.float32)
    col = jnp.arange(key.shape[1], dtype=jnp.int32)[None, :]
    idx = (col // BUCKET) * GROUP + (key & 127) * BUCKET + col % BUCKET
    return vals, idx


def bucket_min_scan_reference(
    queries: jnp.ndarray,
    qsq: jnp.ndarray,
    corpus: jnp.ndarray,
    bias: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Plain-XLA oracle for the bf16 kernel.

    Mirrors the wrapper contract: alpha pre-folded into queries, qsq a
    per-row constant ([B, 1], zeros when unused). Values are full f32
    (the kernel quantizes its low 7 mantissa bits for index packing, so
    comparisons need ~2^-16 relative tolerance)."""
    dots = jax.lax.dot_general(
        queries, corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    s = dots + bias + qsq  # [B, N]
    b, n = s.shape
    sb = s.reshape(b, n // GROUP, GROUP // BUCKET, BUCKET)
    vals = sb.min(axis=2)                                  # [b, G, BUCKET]
    amin = jnp.argmin(sb, axis=2).astype(jnp.int32)        # chunk index m
    g = jnp.arange(n // GROUP, dtype=jnp.int32)[None, :, None]
    l = jnp.arange(BUCKET, dtype=jnp.int32)[None, None, :]
    idx = g * GROUP + amin * BUCKET + l
    return vals.reshape(b, n // BUCKET), idx.reshape(b, n // BUCKET)


# ---------------------------------------------------------------------------
# int8 keys
# ---------------------------------------------------------------------------
#
# The int8 tensor-core rate is twice bf16's, and because the dot is already
# an int32 the packed min-key needs only integer ops — no bitcast tricks
# (int32 min IS total order). Quantization error only perturbs the coarse
# ranking; survivors are re-scored in exact fp32 (same recovery as the bf16
# path, reference parity per bruteforce.h exact scan).
#
# The survivor top-k runs on the f32 bitcast of the keys (monotone only for
# non-negative ints), so scores are offset to be provably >= 0:
#   score' = (bias + DOTMAX) - dot,  DOTMAX = d * 127 * 127.


def i8_packed_layout(d: int, span: int) -> Tuple[int, int, int, int, int]:
    """(bias_offset, bias_clamp, sentinel, pre_shift, invalid_thresh) for
    the packed int8 kernel at padded dim ``d``.

    chunk_bits = log2(span * 128) low bits carry the chunk id; pre_shift
    drops score LSBs until (max score' << chunk_bits) fits in int31. The
    slack keeps valid and invalid scores disjoint even after the pre-shift
    quantization."""
    dotmax = d * 127 * 127
    bias_clamp = 1 << 22
    sentinel = bias_clamp + 3 * dotmax + 4096
    chunk_bits = (span * (GROUP // BUCKET) - 1).bit_length()
    pre_shift = 0
    while ((sentinel + dotmax) >> pre_shift) >= (1 << (31 - chunk_bits)):
        pre_shift += 1
    invalid_thresh = bias_clamp + 2 * dotmax + 2048
    return dotmax, bias_clamp, sentinel, pre_shift, invalid_thresh


@functools.partial(jax.jit, static_argnames=("span", "tile", "interpret"))
def bucket_min_scan_i8_packed(
    queries: jnp.ndarray,   # [B, D] int8
    corpus: jnp.ndarray,    # [N, D] int8 (N % (span*GROUP) == 0)
    bias: jnp.ndarray,      # [1, N] int32 (already offset by +DOTMAX)
    span: int = 4,
    tile: Optional[Tile] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Fused packed int8 coarse scan → packed keys [B, N/(128*span)] i32.

    Decode of a selected key at survivor column ``c``:
      chunk = key & (span*128 - 1); score = (key >> chunk_bits) << pre_shift
      row   = (c // 128) * span * GROUP + chunk * BUCKET + (c % 128)
    """
    _, _, _, pre_shift, _ = i8_packed_layout(queries.shape[1], span)
    return _scan(
        queries, jnp.zeros((queries.shape[0],), jnp.float32), corpus, bias,
        span=span, pre_shift=pre_shift, mode="i8", tile=tile,
        interpret=interpret,
    )


def bucket_min_scan_i8_packed_reference(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    bias: jnp.ndarray,
    span: int = 4,
) -> jnp.ndarray:
    """Plain-XLA oracle for the packed int8 kernel."""
    d = queries.shape[1]
    _, _, _, pre_shift, _ = i8_packed_layout(d, span)
    chunk_bits = (span * (GROUP // BUCKET) - 1).bit_length()
    dots = jax.lax.dot_general(
        queries, corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    s = (bias - dots) >> pre_shift
    b, n = s.shape
    sg = span * GROUP
    sb = s.reshape(b, n // sg, sg // BUCKET, BUCKET)
    col = jnp.arange(sg // BUCKET, dtype=jnp.int32)[None, None, :, None]
    packed = (sb << chunk_bits) | jnp.broadcast_to(col, sb.shape)
    return packed.min(axis=2).reshape(b, n // (BUCKET * span))


def make_bias_i8_packed(
    n: int,
    d_pad: int,
    span: int,
    metric: str,
    corpus_sq: Optional[jnp.ndarray],
    inv_two_scales: jnp.ndarray,
    invalid: Optional[jnp.ndarray],
    filter_mask: Optional[jnp.ndarray],
) -> jnp.ndarray:
    """[1, n] int32 offset bias for the packed kernel: DOTMAX + (l2 term),
    SENTINEL for excluded rows (all >= 0 so keys bitcast-order as f32)."""
    dotmax, bias_clamp, sentinel, _, _ = i8_packed_layout(d_pad, span)
    if metric == "l2":
        if corpus_sq is None:
            raise ValueError("l2 int8 bias needs corpus_sq")
        f = corpus_sq.astype(jnp.float32) * inv_two_scales
        bias = jnp.clip(jnp.round(f), 0, bias_clamp).astype(jnp.int32)
    else:
        bias = jnp.zeros((n,), jnp.int32)
    bias = bias + dotmax
    if invalid is not None:
        bias = jnp.where(invalid, sentinel, bias)
    if filter_mask is not None:
        bias = jnp.where(filter_mask, bias, sentinel)
    return bias[None, :]


def make_bias(
    n: int,
    metric: str,
    corpus_sq: Optional[jnp.ndarray],
    invalid: Optional[jnp.ndarray],
    filter_mask: Optional[jnp.ndarray],
) -> jnp.ndarray:
    """[1, n] coarse-score bias: norms for l2, 0 for ip/cosine; +inf for
    rows that must not be returned (invalid or excluded by a shared 1-D
    pre-filter)."""
    if metric == "l2":
        if corpus_sq is None:
            raise ValueError("l2 bias needs corpus_sq")
        bias = corpus_sq.astype(jnp.float32)
    else:
        bias = jnp.zeros((n,), jnp.float32)
    if invalid is not None:
        bias = jnp.where(invalid, INF, bias)
    if filter_mask is not None:
        bias = jnp.where(filter_mask, bias, INF)
    return bias[None, :]
