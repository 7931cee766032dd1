"""Fused coarse-scan kernel vs its XLA oracle + end-to-end recall.

The kernel is written for Pallas's Triton route. On the CPU test mesh
(tests/conftest.py pins JAX_PLATFORMS=cpu) every call passes
``interpret=True``; the compiled kernel is checked on the card by the
``gpu``-marked test below and by chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from valkey_search_tpu.ops import pallas_scan as ps
from valkey_search_tpu.ops import topk as topk_ops
from valkey_search_tpu.runtime import config


def _mk(rng, b, n, d):
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    return (
        jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(c, jnp.bfloat16),
        q,
        c,
    )


def _bf16_inputs(rng, b, n, d, positive):
    _, c_lp, q, c = _mk(rng, b, n, d)
    q_lp = jnp.asarray(-2.0 * q, jnp.bfloat16)  # alpha pre-folded
    qsq = (
        jnp.asarray((q ** 2).sum(1, keepdims=True))
        if positive
        else jnp.zeros((b, 1), jnp.float32)
    )
    bias = jnp.asarray(((c.astype(np.float32) ** 2).sum(1))[None, :])
    return q_lp, qsq, c_lp, bias


@pytest.mark.parametrize("positive", [True, False])
def test_kernel_matches_reference(rng, positive):
    b, n, d = 16, ps.GROUP, 128
    q_lp, qsq, c_lp, bias = _bf16_inputs(rng, b, n, d, positive)
    vals, idx = ps.bucket_min_scan(
        q_lp, qsq, c_lp, bias, positive=positive, interpret=True
    )
    rvals, ridx = ps.bucket_min_scan_reference(q_lp, qsq, c_lp, bias)
    # the kernel quantizes low 7 mantissa bits into the packed index
    np.testing.assert_allclose(
        np.asarray(vals), np.asarray(rvals), rtol=4e-5, atol=1e-2
    )
    agree = (np.asarray(idx) == np.asarray(ridx)).mean()
    assert agree > 0.99


def test_kernel_invalid_rows_survive_as_inf(rng):
    b, n, d = 8, ps.GROUP, 128
    _, c_lp, q, c = _mk(rng, b, n, d)
    q_lp = jnp.asarray(-2.0 * q, jnp.bfloat16)
    qsq = jnp.asarray((q ** 2).sum(1, keepdims=True))
    invalid = np.zeros(n, bool)
    # buckets are strided: lane 0 of group 0 = rows {m*BUCKET + 0}
    invalid[np.arange(0, ps.GROUP, ps.BUCKET)] = True
    bias = ps.make_bias(
        n, "l2", jnp.asarray((c ** 2).sum(1)), jnp.asarray(invalid), None
    )
    vals, _ = ps.bucket_min_scan(
        q_lp, qsq, c_lp, bias, positive=True, interpret=True
    )
    assert np.isinf(np.asarray(vals)[:, 0]).all()
    assert np.isfinite(np.asarray(vals)[:, 1:]).all()


@pytest.mark.parametrize("block_b,split", [(16, 1), (16, 8), (32, 128)])
def test_kernel_tile_and_split_do_not_change_keys(rng, block_b, split):
    """Splitting a survivor group's tiles over programs (the small-batch
    occupancy fix) and the query tile only change the launch, never the
    keys: min over the split axis is associative."""
    b, n, d = 20, 2 * ps.GROUP, 128
    q_lp, qsq, c_lp, bias = _bf16_inputs(rng, b, n, d, True)
    ref_v, ref_i = ps.bucket_min_scan(
        q_lp, qsq, c_lp, bias, positive=True,
        tile=ps.Tile(16, 4, 3, 1), interpret=True,
    )
    v, i = ps.bucket_min_scan(
        q_lp, qsq, c_lp, bias, positive=True,
        tile=ps.Tile(block_b, 4, 3, split), interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_choose_tile():
    # large batch: full 128-row query tiles, 8 warps, no split needed
    t = ps.choose_tile(65536, 8, 1024)
    assert t == ps.Tile(128, 8, 3, 1)
    # one query over 1M rows at span 8: 8 programs -> split to fill the card
    t = ps.choose_tile(1, 8, 1024)
    assert t.block_b == 16 and t.num_warps == 4
    assert t.split * 8 >= ps._MIN_PROGRAMS and 1024 % t.split == 0
    # power-of-two query tiles between 16 and 128
    assert ps.choose_tile(100, 1, 128).block_b == 128
    assert ps.choose_tile(40, 1, 128).block_b == 64
    # a split never exceeds (or fails to divide) the group's tile count
    t = ps.choose_tile(1, 1, 384)
    assert 384 % t.split == 0 and t.split <= 128


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused_pipeline_recall(rng, metric):
    b, n, d, k = 24, 2 * ps.GROUP, 64, 10
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    dists, ids = topk_ops.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16),
        k=k, metric=metric, interpret=True,
    )
    if metric == "l2":
        gt = np.argsort(
            ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1), axis=1
        )[:, :k]
    else:
        gt = np.argsort(1.0 - q @ c.T, axis=1)[:, :k]
    rec = np.mean([
        len(set(ids[i].tolist()) & set(gt[i].tolist())) / k for i in range(b)
    ])
    assert rec >= 0.95, rec
    assert np.all(np.diff(np.asarray(dists), axis=1) >= -1e-6)


def test_fused_pipeline_filter_and_padding(rng):
    # capacity NOT a multiple of GROUP → row padding; odd B → query padding
    b, n, d, k = 5, ps.GROUP + 300, 32, 5
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    allowed = np.zeros(n, bool)
    allowed[::7] = True
    dists, ids = topk_ops.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16),
        k=k, metric="l2", filter_mask=jnp.asarray(allowed), interpret=True,
    )
    ids = np.asarray(ids)
    assert (ids % 7 == 0).all() and (ids < n).all()
    masked = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    masked[:, ~allowed] = np.inf
    gt = np.argsort(masked, axis=1)[:, :k]
    rec = np.mean([
        len(set(ids[i].tolist()) & set(gt[i].tolist())) / k for i in range(b)
    ])
    assert rec >= 0.9, rec


def test_fused_multiblock_merge(rng):
    # two scan blocks: block_rows = GROUP
    b, n, d, k = 8, 4 * ps.GROUP, 32, 10
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    dists, ids = topk_ops.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16),
        k=k, metric="l2", block_rows=2 * ps.GROUP, interpret=True,
    )
    gt = np.argsort(((q[:, None, :] - c[None, :, :]) ** 2).sum(-1), 1)[:, :k]
    rec = np.mean([
        len(set(np.asarray(ids)[i].tolist()) & set(gt[i].tolist())) / k
        for i in range(b)
    ])
    assert rec >= 0.95, rec


def test_fused_block_rows_not_a_divisor(rng):
    """Regression: a block_rows that does not divide the padded capacity
    must shrink to the largest quantum-aligned divisor instead of raising
    'capacity not divisible' (callers pass arbitrary config values;
    10,027,008 % 262,144 != 0)."""
    b, n, d, k = 8, 3 * ps.GROUP, 32, 10
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    dists, ids = topk_ops.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16),
        k=k, metric="l2", block_rows=2 * ps.GROUP, interpret=True,
    )
    gt = np.argsort(((q[:, None, :] - c[None, :, :]) ** 2).sum(-1), 1)[:, :k]
    rec = np.mean([
        len(set(np.asarray(ids)[i].tolist()) & set(gt[i].tolist())) / k
        for i in range(b)
    ])
    assert rec >= 0.95, rec


# ---------------------------------------------------------------------------
# int8 keys
# ---------------------------------------------------------------------------

def _quant(x, scale):
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


@pytest.mark.parametrize("span", [1, 2, 4])
def test_i8_packed_kernel_matches_reference(rng, span):
    # span=1 exercises the chunk-folded bias (pre_shift==0 at d=128);
    # span=2/4 exercise the shifted key — same oracle, bit for bit
    b, n, d = 16, 4 * ps.GROUP, 128
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    sq = np.abs(q).max() / 127
    sc = np.abs(c).max() / 127
    qi = jnp.asarray(_quant(q, sq))
    ci = jnp.asarray(_quant(c, sc))
    inv_two = jnp.float32(1.0 / (2 * sq * sc))
    bias = ps.make_bias_i8_packed(
        n, d, span, "l2", jnp.asarray((c ** 2).sum(1)), inv_two, None, None
    )
    packed = ps.bucket_min_scan_i8_packed(
        qi, ci, bias, span=span, interpret=True
    )
    ref = ps.bucket_min_scan_i8_packed_reference(qi, ci, bias, span=span)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(ref))


def test_i8_fused_pipeline_recall(rng):
    b, n, d, k = 16, 2 * ps.GROUP, 24, 10
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    sc = np.float32(np.abs(c).max() / 127)
    ci8 = jnp.asarray(_quant(c, sc))
    dists, ids = topk_ops.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16), k=k,
        metric="l2", corpus_i8=ci8, i8_scale=jnp.float32(sc),
        interpret=True,
    )
    gt = np.argsort(((c[None] - q[:, None]) ** 2).sum(-1), axis=1)[:, :k]
    recall = np.mean([
        len(set(np.asarray(ids)[i].tolist()) & set(gt[i].tolist())) / k
        for i in range(b)
    ])
    assert recall >= 0.95, recall
    # returned distances are exact fp32
    ref_d = ((c[np.asarray(ids)[0]] - q[0]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(dists)[0], ref_d, rtol=1e-4)


def test_i8_fused_filter(rng):
    b, n, d, k = 8, 2 * ps.GROUP, 16, 5
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    sc = np.float32(np.abs(c).max() / 127)
    keep = rng.random(n) < 0.3
    dists, ids = topk_ops.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16), k=k,
        metric="l2", corpus_i8=jnp.asarray(_quant(c, sc)),
        i8_scale=jnp.float32(sc), filter_mask=jnp.asarray(keep),
        interpret=True,
    )
    ids = np.asarray(ids)
    assert (keep[ids[ids >= 0]]).all()


@pytest.mark.parametrize(
    "dtype,metric,b,d",
    [
        ("int8", "l2", 5, 100),    # d padded to 128, B to the tile
        ("int8", "ip", 3, 768),    # six 128-wide contraction slices
        ("bfloat16", "l2", 7, 100),
        ("bfloat16", "ip", 2, 768),
    ],
)
def test_fused_kernel_matches_reference_path(rng, dtype, metric, b, d):
    """The whole fused pipeline gives the same answers with the kernel as
    with its plain-XLA oracle (``reference=True``) under padding of B, N
    and d. int8 keys are integer arithmetic, so results are identical;
    bf16 keys drop 7 mantissa bits, so only ties may reorder."""
    n, k = ps.GROUP + 1000, 10
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(k=k, metric=metric)
    if dtype == "int8":
        sc = np.float32(np.abs(c).max() / 127)
        kw.update(corpus_i8=jnp.asarray(_quant(c, sc)),
                  i8_scale=jnp.float32(sc))
        lp = None
    else:
        lp = jnp.asarray(c, jnp.bfloat16)
    args = (jnp.asarray(q), jnp.asarray(c), lp)
    d1, i1 = topk_ops.flat_topk_fused(*args, interpret=True, **kw)
    d2, i2 = topk_ops.flat_topk_fused(*args, reference=True, **kw)
    if dtype == "int8":
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    else:
        agree = np.mean([
            len(set(np.asarray(i1)[r].tolist())
                & set(np.asarray(i2)[r].tolist())) / k
            for r in range(b)
        ])
        assert agree >= 0.9, agree
        np.testing.assert_allclose(np.asarray(d1)[:, 0],
                                   np.asarray(d2)[:, 0], rtol=1e-5)


# ---------------------------------------------------------------------------
# routing and budgets
# ---------------------------------------------------------------------------

def test_routing_picks_plain_path_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    assert not topk_ops.fused_scan_compiles()
    assert not topk_ops.use_fused_scan(1 << 20, None)
    config.set_config("search.scan-kernel", "xla")
    try:
        assert not topk_ops.use_fused_scan(1 << 20, None)
    finally:
        config.set_config("search.scan-kernel", "auto")


def test_scan_kernel_pallas_off_gpu_raises():
    config.set_config("search.scan-kernel", "pallas")
    try:
        with pytest.raises(topk_ops.ScanKernelUnavailable):
            topk_ops.use_fused_scan(1 << 20, None)
    finally:
        config.set_config("search.scan-kernel", "auto")


def test_memory_budget_needs_bytes_limit():
    """An accelerator that reports no bytes_limit is an error, not a
    guessed size; the CPU device's limit is the host's memory."""
    card = types.SimpleNamespace(
        platform="gpu", device_kind="test card", memory_stats=lambda: {})
    with pytest.raises(RuntimeError, match="bytes_limit"):
        topk_ops.device_memory_limit(card)
    card.memory_stats = lambda: {"bytes_limit": 123}
    assert topk_ops.device_memory_limit(card) == 123
    assert topk_ops.device_memory_limit() > 1 << 30


@pytest.mark.gpu
def test_compiled_kernels_match_reference(gpu, rng):
    """Compiled (not interpreted) kernels agree with their oracles: int8
    keys bit for bit; bf16 values to 2^-16 relative (the key drops 7
    mantissa bits) plus a few ulp for the kernel's own f32 accumulation
    order."""
    b, n, d = 256, 8 * ps.GROUP, 128
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    sq, sc = np.abs(q).max() / 127, np.abs(c).max() / 127
    qi, ci = jnp.asarray(_quant(q, sq)), jnp.asarray(_quant(c, sc))
    bias = ps.make_bias_i8_packed(
        n, d, 8, "l2", jnp.asarray((c ** 2).sum(1)),
        jnp.float32(1.0 / (2 * sq * sc)), None, None)
    np.testing.assert_array_equal(
        np.asarray(ps.bucket_min_scan_i8_packed(qi, ci, bias, span=8)),
        np.asarray(ps.bucket_min_scan_i8_packed_reference(qi, ci, bias, 8)))
    q_lp, qsq, c_lp, bias = _bf16_inputs(rng, b, n, d, True)
    vals, _ = ps.bucket_min_scan(q_lp, qsq, c_lp, bias, positive=True)
    rvals, _ = ps.bucket_min_scan_reference(q_lp, qsq, c_lp, bias)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(rvals),
                               rtol=2.0 ** -16 + 8 * 2.0 ** -23)
