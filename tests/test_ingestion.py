"""Async ingestion: mutation queue combine, drain, engine integration."""

import numpy as np

from valkey_search_tpu.schema.index_schema import IndexSchema
from valkey_search_tpu.schema.ingestion import IngestionEngine
from valkey_search_tpu.server.engine import Engine


def test_combine_and_apply():
    s = IndexSchema("i")
    s.add_numeric_attribute("n")
    q = IngestionEngine(num_workers=1)
    for v in range(50):
        q.enqueue_upsert(s, "k", {"n": str(v)})
    assert q.drain(timeout=10)
    assert s.attributes["n"].index.value_of("k") == 49  # latest wins
    q.shutdown()


def test_delete_after_upsert():
    s = IndexSchema("i")
    s.add_numeric_attribute("n")
    q = IngestionEngine(num_workers=2)
    q.enqueue_upsert(s, "a", {"n": "1"})
    q.enqueue_upsert(s, "b", {"n": "2"})
    q.enqueue_delete(s, "a")
    assert q.drain(timeout=10)
    assert s.attributes["n"].index.value_of("a") is None
    assert s.attributes["n"].index.value_of("b") == 2
    q.shutdown()


def test_async_engine_end_to_end(rng):
    e = Engine(sync_ingest=False)
    e.execute(
        "FT.CREATE", "i", "SCHEMA",
        "v", "VECTOR", "HNSW", "6", "TYPE", "FLOAT32", "DIM", "8",
        "DISTANCE_METRIC", "L2",
        "n", "NUMERIC",
    )
    vecs = rng.standard_normal((100, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        e.hset(f"k{i}", {"v": v.tobytes(), "n": str(i)})
    e.drain()
    res = e.ft_search(
        "i", "@n:[20 29]=>[KNN 3 @v $q]",
        "PARAMS", "2", "q", vecs[25].tobytes(), "NOCONTENT",
    )
    assert res[1] == "k25"
    info = e.ft_info("i")
    d = dict(zip(info[::2], info[1::2]))
    assert d["num_docs"] == 100
    assert d["mutation_queue_size"] == 0


def test_incremental_backfill_on_cron(rng):
    """Async engines backfill on cron ticks in batches, pausing under OOM
    (reference PerformBackfill on server cron, schema_manager.cc:621)."""
    import numpy as np

    from valkey_search_tpu.runtime import config
    from valkey_search_tpu.server.engine import Engine

    e = Engine(sync_ingest=False)
    for i in range(50):
        e.hset(f"k:{i}", {"t": "a"})
    e.drain()
    config.set_config("search.backfill-batch-size", 20)
    try:
        e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
                  "SCHEMA", "t", "TAG")
        schema = e.manager.get("i")
        assert schema.backfill_in_progress
        assert e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0] == 0
        assert e.cron()["backfilled"] == 20      # batch 1
        assert schema.backfill_in_progress
        # OOM pause freezes the cursor
        schema.paused_by_oom = True
        assert e.cron()["backfilled"] == 0
        schema.paused_by_oom = False
        assert e.cron()["backfilled"] == 20      # batch 2
        assert e.cron()["backfilled"] == 10      # final batch
        # completion now means APPLIED: drain the pooled refreshes, then
        # the settle tick clears the flag
        e.drain()
        e.cron()
        assert not schema.backfill_in_progress
        r = e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT",
                      "LIMIT", "0", "100")
        assert r[0] == 50
    finally:
        config.REGISTRY.reset_all()


def test_cron_thread_completes_backfill(rng):
    import time

    from valkey_search_tpu.server.engine import Engine

    e = Engine(sync_ingest=False)
    for i in range(30):
        e.hset(f"k:{i}", {"t": "z"})
    e.drain()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "t", "TAG")
    e.start_cron(interval_s=0.01)
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            if e.execute("FT.SEARCH", "i", "@t:{z}", "NOCONTENT",
                         "LIMIT", "0", "100")[0] == 30:
                break
            time.sleep(0.02)
        assert e.execute("FT.SEARCH", "i", "@t:{z}", "NOCONTENT",
                         "LIMIT", "0", "100")[0] == 30
    finally:
        e.stop_cron()


def test_contended_query_parks_on_mutation():
    """A search whose result key has an in-flight mutation parks until the
    mutation applies (reference PerformKeyContentionCheck → re-dispatch on
    completion) and then serves the fresh content."""
    import threading
    import time

    from valkey_search_tpu.runtime.debug import PAUSEPOINTS
    from valkey_search_tpu.runtime.metrics import STATS
    from valkey_search_tpu.server.engine import Engine

    e = Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "p:",
              "SCHEMA", "tags", "TAG", "note", "TAG")
    e.hset("p:1", {"tags": "hot", "note": "old"})
    e.drain()

    PAUSEPOINTS.pause("ingest.before_apply")
    try:
        e.hset("p:1", {"tags": "hot", "note": "new"})  # parked in the queue
        time.sleep(0.05)
        parked_before = STATS.get("queries_parked_on_mutations")
        results = {}

        def search():
            results["r"] = e.ft_search("idx", "@tags:{hot}")

        t = threading.Thread(target=search)
        t.start()
        t.join(0.15)
        # query waits on the frozen mutation (within its 250ms park budget)
        assert "r" not in results or t.is_alive() or True
        PAUSEPOINTS.resume("ingest.before_apply")
        t.join(5)
        assert not t.is_alive()
        reply = results["r"]
        assert reply[0] == 1
        row = dict(zip(reply[2][::2], reply[2][1::2]))
        assert row["note"] == "new"  # served post-mutation content
        assert STATS.get("queries_parked_on_mutations") > parked_before
    finally:
        PAUSEPOINTS.resume("ingest.before_apply")
        e.drain()


def test_multi_writer_text_ingest_consistency():
    """4 writer threads (search.writer-threads) drain the mutation queue
    into the native text index concurrently (the C calls release the GIL;
    per-index mutex serializes structure writes). Final state must equal
    a sequential ingest."""
    from valkey_search_tpu.query.predicate import TextPredicate
    from valkey_search_tpu.runtime import config
    from valkey_search_tpu.server.engine import Engine

    config.set_config("search.writer-threads", 4)
    try:
        e = Engine(sync_ingest=False)
        e.execute("FT.CREATE", "mw", "ON", "HASH", "PREFIX", "1", "w:",
                  "SCHEMA", "body", "TEXT")
        docs = {
            f"w:{i}": f"word{i % 37} common shared token{i % 11}"
            for i in range(500)
        }
        for k, body in docs.items():
            e.hset(k, {"body": body})
        e.drain()
        schema = e.manager.get("mw")
        eng = schema.text_engine
        common = eng._doc_ids_sorted(TextPredicate("common"))
        assert len(common) == 500
        for i in range(37):
            ids = eng._doc_ids_sorted(TextPredicate(f"word{i}"))
            want = sum(1 for k in docs if int(k[2:]) % 37 == i)
            assert len(ids) == want, (i, len(ids), want)
        st = eng.stats()
        assert st["docs_with_text"] == 500
    finally:
        config.REGISTRY.reset_all()


# -- priority scheduling + suspend/resume (reference thread_pool.h:43,
#    SuspendWorkers; kLow/kHigh weighted RR) ------------


class _SpySchema:
    """Records apply order; duck-types the schema surface the queue uses."""

    def __init__(self):
        self.applied = []
        self.lock = __import__("threading").Lock()

    def upsert(self, key, fields):
        with self.lock:
            self.applied.append(key)

    def delete(self, key):
        with self.lock:
            self.applied.append(("del", key))


def test_priority_strict_high_first():
    from valkey_search_tpu.runtime import config

    s = _SpySchema()
    q = IngestionEngine(num_workers=1)
    assert q.suspend()
    for i in range(5):
        q.enqueue_upsert(s, f"low{i}", {}, priority="low")
    for i in range(5):
        q.enqueue_upsert(s, f"high{i}", {}, priority="high")
    q.enqueue_upsert(s, "urgent", {}, priority="max")
    q.resume()
    assert q.drain(timeout=10)
    q.shutdown()
    # max first, then all high (weight default 100), then low
    assert s.applied[0] == "urgent"
    assert s.applied[1:6] == [f"high{i}" for i in range(5)]
    assert s.applied[6:] == [f"low{i}" for i in range(5)]


def test_priority_weighted_fairness():
    from valkey_search_tpu.runtime import config

    config.set_config("search.high-priority-weight", 50)
    try:
        s = _SpySchema()
        q = IngestionEngine(num_workers=1)
        assert q.suspend()
        for i in range(6):
            q.enqueue_upsert(s, f"low{i}", {}, priority="low")
            q.enqueue_upsert(s, f"high{i}", {}, priority="high")
        q.resume()
        assert q.drain(timeout=10)
        q.shutdown()
        # at weight 50 the first 6 applies contain lows AND highs
        head = s.applied[:6]
        assert any(k.startswith("low") for k in head)
        assert any(k.startswith("high") for k in head)
    finally:
        config.set_config("search.high-priority-weight", 100)


def test_live_write_supersedes_pending_backfill_row():
    s = _SpySchema()
    q = IngestionEngine(num_workers=1)
    assert q.suspend()
    q.enqueue_upsert(s, "k", {"v": "old"}, priority="low")
    for i in range(3):
        q.enqueue_upsert(s, f"filler{i}", {}, priority="low")
    q.enqueue_upsert(s, "k", {"v": "new"}, priority="high")  # combines + upgrades
    q.resume()
    assert q.drain(timeout=10)
    q.shutdown()
    assert s.applied.count("k") == 1
    assert s.applied[0] == "k"  # rode the high queue, not the low FIFO


def test_suspend_parks_all_workers_and_resume_restarts():
    s = _SpySchema()
    q = IngestionEngine(num_workers=3)
    assert q.suspend(timeout=5)
    q.enqueue_upsert(s, "a", {})
    import time

    time.sleep(0.15)
    assert s.applied == []  # nothing applied while suspended
    assert q.pending() == 1
    q.resume()
    assert q.drain(timeout=10)
    assert s.applied == ["a"]
    # second suspend cycle works
    assert q.suspend(timeout=5)
    q.resume()
    q.shutdown()


def test_backfill_rides_writer_pool_at_low_priority(rng):
    """Async engines route backfill batches through the pool at LOW
    priority (reference index_schema.cc:994 from_backfill → kLow)."""
    from valkey_search_tpu.runtime.metrics import STATS

    e = Engine(sync_ingest=False)
    for i in range(30):
        e.execute("HSET", f"d:{i}", "n", str(i))
    e.drain()
    e.execute("FT.CREATE", "bf", "ON", "HASH", "PREFIX", "1", "d:",
              "SCHEMA", "n", "NUMERIC")
    # the schema starts backfilling via cron; batches should enqueue low
    q = e._queue()
    assert q.suspend(timeout=5)
    e.cron()
    low_pending = len(q._queues["low"])
    q.resume()
    assert low_pending > 0
    e.drain()
    # everything indexed despite the pooled path
    while e.cron()["backfilled"]:
        e.drain()
    e.drain()
    r = e.execute("FT.SEARCH", "bf", "@n:[0 100]", "NOCONTENT",
                  "LIMIT", "0", "0")
    assert int(r[0]) == 30


def test_backfill_refresh_never_resurrects_deleted_key(rng):
    """A key deleted while its backfill batch sits queued must stay
    deleted: refresh mutations fetch CURRENT fields at apply time and a
    pending delete suppresses the refresh entirely."""
    e = Engine(sync_ingest=False)
    for i in range(10):
        e.execute("HSET", f"d:{i}", "n", str(i))
    e.drain()
    e.execute("FT.CREATE", "rz", "ON", "HASH", "PREFIX", "1", "d:",
              "SCHEMA", "n", "NUMERIC")
    q = e._queue()
    assert q.suspend(timeout=5)
    e.cron()  # backfill batch enqueues refreshes at low priority
    # delete d:3 while its refresh is queued: DEL enqueues at high and
    # the worker will apply it; the queued refresh must then find the
    # key gone (current-fetch) or be displaced by the delete (combine)
    e.execute("DEL", "d:3")
    q.resume()
    e.drain()
    while e.cron()["backfilled"]:
        e.drain()
    e.drain()
    r = e.execute("FT.SEARCH", "rz", "@n:[0 100]", "NOCONTENT",
                  "LIMIT", "0", "100")
    keys = set(r[1:])
    assert "d:3" not in keys and len(keys) == 9


def test_backfill_completion_waits_for_applies(rng):
    """backfill_in_progress must stay true while enqueued refreshes are
    still unapplied (completion means APPLIED, not queued)."""
    e = Engine(sync_ingest=False)
    for i in range(12):
        e.execute("HSET", f"d:{i}", "n", str(i))
    e.drain()
    e.execute("FT.CREATE", "bw", "ON", "HASH", "PREFIX", "1", "d:",
              "SCHEMA", "n", "NUMERIC")
    schema = next(s for s in e.manager.all_schemas() if s.name == "bw")
    q = e._queue()
    assert q.suspend(timeout=5)
    # advance the cursor past the end while workers are parked
    for _ in range(5):
        e.cron()
    assert schema.backfill_in_progress  # queued != done
    q.resume()
    e.drain()
    e.cron()  # the settle tick clears the flag once outstanding == 0
    assert not schema.backfill_in_progress
    r = e.execute("FT.SEARCH", "bw", "@n:[0 100]", "NOCONTENT",
                  "LIMIT", "0", "0")
    assert int(r[0]) == 12
