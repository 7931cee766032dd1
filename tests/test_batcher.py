"""Query batcher (P1 batched execution) + async reader-pool search.

Mirrors reference reader-thread-pool coverage (thread_pool_test.cc +
async query integration tests) with the accelerator twist: concurrency must
COALESCE into fewer device launches, not more threads."""

import threading

import numpy as np
import pytest

from valkey_search_tpu.query import batcher as B
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS
from valkey_search_tpu.server.engine import Engine


@pytest.fixture(autouse=True)
def _reset():
    yield
    config.REGISTRY.reset_all()


class FakeIndex:
    """Records batch sizes; returns distances = row sums."""

    def __init__(self):
        self.batches = []
        self.lock = threading.Lock()

    def search_batch(self, queries, k, ef=None):
        with self.lock:
            self.batches.append(len(queries))
        b = len(queries)
        d = np.tile(np.arange(k, dtype=np.float32), (b, 1))
        ids = np.tile(np.arange(k, dtype=np.int32), (b, 1))
        return d + queries.sum(1, keepdims=True), ids


def test_single_query_passthrough():
    idx = FakeIndex()
    f = B.VectorQueryBatcher().submit(idx, np.zeros(4, np.float32), 3, None)
    d, ids = f.result(timeout=5)
    assert list(ids) == [0, 1, 2]
    assert idx.batches == [1]


def test_concurrent_queries_coalesce():
    config.set_config("search.query-batch-window-us", 20000)  # 20ms window
    idx = FakeIndex()
    bat = B.VectorQueryBatcher()
    futures = []
    threads = []

    def go(i):
        futures.append(
            (i, bat.submit(idx, np.full(4, float(i), np.float32), 2, None))
        )

    for i in range(8):
        t = threading.Thread(target=go, args=(i,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    results = {i: f.result(timeout=5) for i, f in futures}
    # every caller got its own row back (distance offset = 4*i)
    for i, (d, ids) in results.items():
        assert d[0] == pytest.approx(4.0 * i)
    # coalesced: strictly fewer launches than queries
    assert sum(idx.batches) == 8
    assert len(idx.batches) < 8


def test_max_batch_respected():
    config.set_config("search.query-batch-window-us", 20000)
    config.set_config("search.query-max-batch", 4)
    idx = FakeIndex()
    bat = B.VectorQueryBatcher()
    threads = [
        threading.Thread(
            target=lambda: bat.submit(idx, np.zeros(4, np.float32), 1, None).result(5)
        )
        for _ in range(10)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert max(idx.batches) <= 4
    assert sum(idx.batches) == 10


def test_error_propagates_to_all_waiters():
    config.set_config("search.query-batch-window-us", 20000)

    class Boom:
        def search_batch(self, queries, k, ef=None):
            raise RuntimeError("kaput")

    bat = B.VectorQueryBatcher()
    futs = []
    threads = [
        threading.Thread(
            target=lambda: futs.append(bat.submit(Boom(), np.zeros(2), 1, None))
        )
        for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=5)


def test_engine_async_search(rng):
    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "v", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "L2")
    vecs = rng.standard_normal((30, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        e.hset(f"k:{i}", {"v": v.tobytes()})
    futs = [
        e.ft_search_async(
            "i", "*=>[KNN 3 @v $q]",
            "PARAMS", "2", "q", vecs[i].tobytes(), "NOCONTENT",
        )
        for i in range(10)
    ]
    for i, f in enumerate(futs):
        r = f.result(timeout=30)
        assert r[1] == f"k:{i}"
    assert STATS.get("batched_queries") >= 10


def test_coalesced_batches_pad_to_pow2():
    """The dispatcher pads coalesced batches to the next power of two so
    the per-shape XLA compile set stays at log2(max-batch) programs
    (measured 16s p99 spikes from mid-serving compiles without it); the
    duplicated tail rows never reach waiters."""
    idx = FakeIndex()
    bat = B.VectorQueryBatcher()
    n = 11  # coalesces to <=11-row chunks -> padded to 16 (or pow2 pieces)
    start = threading.Barrier(n + 1)
    futs = {}
    lock = threading.Lock()

    def go(i):
        start.wait()
        f = bat.submit(idx, np.full(4, float(i), np.float32), 2, None)
        with lock:
            futs[i] = f

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    start.wait()
    for t in threads:
        t.join()
    for i, f in futs.items():
        d, ids = f.result(timeout=5)
        # row sum of query i is 4*i; FakeIndex adds it to arange(k)
        assert d[0] == pytest.approx(4.0 * i)
    assert all(b & (b - 1) == 0 for b in idx.batches), idx.batches
