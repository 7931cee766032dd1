"""Checkpoint save/restore tests.

Mirrors reference rdb_serialization_test.cc + IndexSchemaRDBTest.SaveAndLoad
+ integration/test_saverestore.py (SURVEY.md §4): full round trip across
every index kind, identical search results after restore, doc-id space
preserved verbatim, skip-vector-payload rebuild, and corrupt-file
rejection."""

import numpy as np
import pytest

from valkey_search_tpu.persistence.format import (
    ChunkReader,
    ChunkWriter,
    FormatError,
)
from valkey_search_tpu.server.engine import Engine


def blob(v):
    return np.asarray(v, np.float32).tobytes()


@pytest.fixture()
def populated(rng, tmp_path):
    e = Engine()
    e.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
        "SCHEMA",
        "emb", "VECTOR", "HNSW", "8",
        "TYPE", "FLOAT32", "DIM", "12", "DISTANCE_METRIC", "L2", "M", "8",
        "color", "TAG",
        "price", "NUMERIC",
        "title", "TEXT",
    )
    vecs = rng.standard_normal((120, 12)).astype(np.float32)
    colors = ["red", "green", "blue"]
    titles = ["running fast", "sleeping dog", "quick search engine"]
    for i, v in enumerate(vecs):
        e.hset(f"doc:{i}", {
            "emb": v.tobytes(), "color": colors[i % 3],
            "price": str(i), "title": titles[i % 3],
        })
    # churn: deletes + updates so free ids and tombstones exist
    for i in range(0, 20, 2):
        e.delete(f"doc:{i}")
    for i in range(20, 30):
        e.hset(f"doc:{i}", {"emb": vecs[(i + 50) % 120].tobytes(),
                            "color": "violet", "price": str(1000 + i),
                            "title": "updated document"})
    return e, vecs, str(tmp_path / "ckpt.vstpu")


def _query_suite(e, vecs):
    out = {}
    q = vecs[33].tobytes()
    out["knn"] = e.execute(
        "FT.SEARCH", "idx", "*=>[KNN 10 @emb $q]",
        "PARAMS", "2", "q", q, "NOCONTENT")
    out["hybrid"] = e.execute(
        "FT.SEARCH", "idx", "(@color:{violet})=>[KNN 5 @emb $q]",
        "PARAMS", "2", "q", q, "NOCONTENT")
    out["numeric"] = e.execute(
        "FT.SEARCH", "idx", "@price:[1000 2000]", "NOCONTENT", "LIMIT", "0", "100")
    out["text"] = e.execute("FT.SEARCH", "idx", "updated", "NOCONTENT")
    out["phrase"] = e.execute("FT.SEARCH", "idx", '"search engine"', "NOCONTENT")
    return out


def test_round_trip_identical_results(populated):
    e, vecs, path = populated
    before = _query_suite(e, vecs)
    summary = e.save(path)
    assert summary["schemas"] == 1
    e2 = Engine.load(path)
    after = _query_suite(e2, vecs)
    for name in before:
        assert before[name] == after[name], name


def test_round_trip_preserves_doc_ids(populated):
    e, vecs, path = populated
    e.save(path)
    e2 = Engine.load(path)
    s1 = e.manager.get("idx")
    s2 = e2.manager.get("idx")
    assert dict(s1.interner.items()) == dict(s2.interner.items())
    assert s1.interner.capacity == s2.interner.capacity
    assert s2.mutation_epoch == s1.mutation_epoch


def test_round_trip_keyspace(populated):
    e, vecs, path = populated
    e.save(path)
    e2 = Engine.load(path)
    assert set(e2.keyspace) == set(e.keyspace)
    assert e2.hgetall("doc:21") == e.hgetall("doc:21")
    # bytes values survive
    assert isinstance(e2.keyspace["doc:21"]["emb"], bytes)


def test_restored_engine_accepts_mutations(populated):
    e, vecs, path = populated
    e.save(path)
    e2 = Engine.load(path)
    rng = np.random.default_rng(5)
    nv = rng.standard_normal(12).astype(np.float32)
    e2.hset("doc:999", {"emb": nv.tobytes(), "color": "gold",
                        "price": "7", "title": "brand new"})
    r = e2.execute("FT.SEARCH", "idx", "@color:{gold}", "NOCONTENT")
    assert r == [1, "doc:999"]
    r2 = e2.execute("FT.SEARCH", "idx", "*=>[KNN 1 @emb $q]",
                    "PARAMS", "2", "q", nv.tobytes(), "NOCONTENT")
    assert r2[1] == "doc:999"
    e2.delete("doc:999")
    assert e2.execute("FT.SEARCH", "idx", "@color:{gold}", "NOCONTENT")[0] == 0


def test_skip_vector_payload_rebuilds(populated):
    e, vecs, path = populated
    before = _query_suite(e, vecs)
    e.save(path)
    e2 = Engine.load(path, skip_vector_payload=True)
    after = _query_suite(e2, vecs)
    # non-vector results identical; KNN results equivalent as sets (the
    # rebuilt graph may tie-break differently)
    assert before["numeric"] == after["numeric"]
    assert before["text"] == after["text"]
    assert after["knn"][0] == before["knn"][0]
    assert set(after["hybrid"][1:]) == set(before["hybrid"][1:])


def test_multiple_schemas(tmp_path, rng):
    e = Engine()
    e.execute("FT.CREATE", "a", "ON", "HASH", "PREFIX", "1", "x:",
              "SCHEMA", "v", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "COSINE")
    e.execute("FT.CREATE", "b", "ON", "HASH", "PREFIX", "1", "y:",
              "SCHEMA", "t", "TAG")
    v = rng.standard_normal(4).astype(np.float32)
    e.hset("x:1", {"v": v.tobytes()})
    e.hset("y:1", {"t": "alpha,beta"})
    p = str(tmp_path / "multi.vstpu")
    e.save(p)
    e2 = Engine.load(p)
    assert e2.execute("FT._LIST") == ["a", "b"]
    r = e2.execute("FT.SEARCH", "a", "*=>[KNN 1 @v $q]",
                   "PARAMS", "2", "q", v.tobytes(), "NOCONTENT")
    assert r[1] == "x:1"
    assert e2.execute("FT.SEARCH", "b", "@t:{beta}", "NOCONTENT") == [1, "y:1"]


def test_corrupt_magic_rejected(tmp_path):
    p = tmp_path / "bad.vstpu"
    p.write_bytes(b"NOTAMAGIC trailing garbage")
    with pytest.raises(FormatError):
        Engine.load(str(p))


def test_truncated_file_rejected(populated):
    e, vecs, path = populated
    e.save(path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(FormatError):
        Engine.load(path)


def test_future_min_version_rejected(tmp_path):
    import struct

    p = tmp_path / "future.vstpu"
    with open(p, "wb") as f:
        f.write(b"VSTPURDB")
        f.write(struct.pack("<II", 99, 99))
        f.write(struct.pack("<I", 0))
    with pytest.raises(FormatError):
        Engine.load(str(p))


def test_chunk_format_large_array_roundtrip(tmp_path, rng):
    # exercise multi-chunk payload streaming (> 4MiB)
    big = rng.standard_normal((1200, 1200)).astype(np.float32)
    p = str(tmp_path / "big.bin")
    with ChunkWriter(p) as w:
        w.section({"type": "t"}, [big, np.arange(7, dtype=np.int32)])
    with ChunkReader(p) as r:
        (meta, arrays), = list(r.sections())
    assert np.array_equal(arrays[0], big)
    assert arrays[1].tolist() == list(range(7))


def test_round_trip_json_schema(tmp_path, rng):
    """ON JSON schemas round-trip: JSONPath attrs, tag arrays, vector field
    (reference: RDB carries the full index_schema proto incl. the
    attribute data type, index_schema.cc SaveIndex/LoadIndex)."""
    import json

    from valkey_search_tpu.persistence.checkpoint import (
        load_engine,
        save_engine,
    )

    e = Engine()
    e.execute(
        "FT.CREATE", "j", "ON", "JSON", "PREFIX", "1", "j:",
        "SCHEMA",
        "$.v", "AS", "v", "VECTOR", "FLAT", "6",
        "TYPE", "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "COSINE",
        "$.tags[*]", "AS", "t", "TAG",
        "$.score", "AS", "s", "NUMERIC",
    )
    vecs = rng.standard_normal((40, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        e.execute("JSON.SET", f"j:{i}", "$", json.dumps({
            "v": [float(x) for x in v],
            "tags": ["a", "b"] if i % 2 else ["c"],
            "score": i,
        }))
    path = str(tmp_path / "j.vstpu")
    save_engine(e, path)
    e2 = load_engine(path)

    q = vecs[7].tobytes()
    for eng in (e, e2):
        r = eng.execute("FT.SEARCH", "j", "(@t:{c})=>[KNN 5 @v $q]",
                        "PARAMS", "2", "q", q, "NOCONTENT")
        assert r == e.execute("FT.SEARCH", "j", "(@t:{c})=>[KNN 5 @v $q]",
                              "PARAMS", "2", "q", q, "NOCONTENT")
    assert (e2.execute("FT.SEARCH", "j", "@s:[10 12]", "NOCONTENT")[0]
            == 3)
    # restored engine keeps indexing new JSON docs
    e2.execute("JSON.SET", "j:new", "$", json.dumps({
        "v": [float(x) for x in vecs[0]], "tags": ["zz"], "score": 999}))
    assert e2.execute("FT.SEARCH", "j", "@t:{zz}", "NOCONTENT")[0] == 1


def test_round_trip_text_suffix_and_fuzzy(tmp_path):
    """TEXT internals (suffix trie, stems, positions) rebuild on load:
    suffix/fuzzy/phrase queries agree before and after."""
    from valkey_search_tpu.persistence.checkpoint import (
        load_engine,
        save_engine,
    )

    e = Engine()
    e.execute("FT.CREATE", "t", "ON", "HASH", "PREFIX", "1", "d:",
              "SCHEMA", "body", "TEXT", "WITHSUFFIXTRIE")
    docs = ["the running dogs", "a dog runs fast", "cats sleeping soundly",
            "fastest runner wins", "sound of silence"]
    for i, b in enumerate(docs):
        e.hset(f"d:{i}", {"body": b})
    path = str(tmp_path / "t.vstpu")
    save_engine(e, path)
    e2 = load_engine(path)
    for q in ("run*", "*ing", "%dogz%", '"dog runs"', "@body:fast"):
        assert (e.execute("FT.SEARCH", "t", q, "NOCONTENT")
                == e2.execute("FT.SEARCH", "t", q, "NOCONTENT")), q


def test_round_trip_preserves_ttl(tmp_path):
    """Keys carrying a TTL keep it across save/restore (reference RDB
    stores expiry; volatile keys must still expire after load)."""
    import time

    from valkey_search_tpu.persistence.checkpoint import (
        load_engine,
        save_engine,
    )

    e = Engine()
    e.hset("k1", {"f": "v"})
    e.hset("k2", {"f": "v"})
    e.execute("EXPIRE", "k1", "100")
    path = str(tmp_path / "ttl.vstpu")
    save_engine(e, path)
    e2 = load_engine(path)
    ttl = int(e2.execute("TTL", "k1"))
    assert 1 <= ttl <= 100
    assert int(e2.execute("TTL", "k2")) == -1


# -- op journal (AOF analog) -----------------------------------
# Reference durability story: mutations ride valkey's AOF
# (ft_internal_update.cc:55) and payloads ride RDB. The standalone engine
# carries its own write-ahead journal: persistence/journal.py.

def test_journal_roundtrip_and_torn_tail(tmp_path):
    from valkey_search_tpu.persistence.journal import OpJournal, read_records

    p = str(tmp_path / "ops.journal")
    j = OpJournal(p, fsync_ms=0)
    j.append([b"HSET", b"k1", b"f", b"v1"], db=0)
    j.append([b"DEL", b"k2"], db=3)
    j.append(["FT.CREATE", "idx", "SCHEMA", "t", "TAG"], db=0)  # str argv
    j.close()

    recs = list(read_records(p))
    assert [(db, argv) for _ts, db, argv in recs] == [
        (0, [b"HSET", b"k1", b"f", b"v1"]),
        (3, [b"DEL", b"k2"]),
        (0, [b"FT.CREATE", b"idx", b"SCHEMA", b"t", b"TAG"]),
    ]
    assert all(ts > 1_600_000_000_000 for ts, _, _ in recs)

    # torn tail: garbage appended by a crash mid-write must not break
    # replay, and reopening for append must chop it
    with open(p, "ab") as f:
        f.write(b"\x55" * 13)
    assert len(list(read_records(p))) == 3
    j2 = OpJournal(p, fsync_ms=0)
    j2.append([b"HSET", b"k3", b"f", b"v"], db=0)
    j2.close()
    recs = list(read_records(p))
    assert len(recs) == 4 and recs[-1][2][1] == b"k3"


def test_journal_replay_rebases_relative_ttls(tmp_path):
    from valkey_search_tpu.persistence.journal import (
        OpJournal, _encode, read_records,
    )
    from valkey_search_tpu.server.resp import RespServer

    p = str(tmp_path / "ops.journal")
    j = OpJournal(p, fsync_ms=0)
    j.append([b"HSET", b"k1", b"f", b"v"], db=0)
    j.close()
    # hand-craft an EXPIRE journaled 40 seconds ago with a 100s TTL: the
    # replayed key must carry ~60s, not a fresh 100
    import time as _time

    with open(p, "ab") as f:
        f.write(_encode(int((_time.time() - 40) * 1000), 0,
                        [b"EXPIRE", b"k1", b"100"]))
    srv = RespServer(port=0)
    n = srv._replay_journal(read_records(p))
    assert n == 2
    ttl = float(srv.engine.execute("TTL", "k1"))
    assert 50 <= ttl <= 70


def _spawn_journal_server(tmp_path, script_path):
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, script_path,
         str(tmp_path / "ops.journal"), str(tmp_path / "ckpt.vstpu")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, text=True,
    )
    line = p.stdout.readline().strip()
    assert line.startswith("READY "), line
    return p, int(line.split()[1])


_JOURNAL_SERVER = """
import sys, time
from valkey_search_tpu.runtime import config
from valkey_search_tpu.server.resp import RespServer
config.set_config("search.journal-path", sys.argv[1])
config.set_config("search.journal-fsync-ms", 0)  # appendfsync=always
config.set_config("search.checkpoint-path", sys.argv[2])
srv = RespServer(port=0)
srv.start()
print("READY", srv.port, flush=True)
while True:
    time.sleep(1)
"""


@pytest.mark.slow
def test_journal_kill9_drill(tmp_path):
    """The drill: kill -9 between checkpoints loses
    nothing past the fsync window (0 here => nothing at all). Runs a real
    server subprocess: SIGKILL cannot be faked in-process."""
    import signal

    from valkey_search_tpu.cluster.transport import RespConnection

    script = tmp_path / "journal_server.py"
    script.write_text(_JOURNAL_SERVER)
    p, port = _spawn_journal_server(tmp_path, str(script))
    try:
        c = RespConnection(("127.0.0.1", port), timeout=10)
        assert c.cmd("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:",
                     "SCHEMA", "t", "TAG", "n", "NUMERIC") == "OK"
        for i in range(20):
            c.cmd("HSET", f"d:{i}", "t", "even" if i % 2 == 0 else "odd",
                  "n", str(i))
        # checkpoint mid-stream: later writes live only in the journal
        assert c.cmd("SAVE") == "OK"
        for i in range(20, 35):
            c.cmd("HSET", f"d:{i}", "t", "post", "n", str(i))
        c.cmd("DEL", "d:0")
        c.cmd("MULTI")
        c.cmd("HSET", "d:100", "t", "txn", "n", "100")
        c.cmd("HSET", "d:101", "t", "txn", "n", "101")
        c.cmd("EXEC")
        c.close()
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(10)

    # restart: checkpoint + journal replay must restore EVERYTHING
    p2, port2 = _spawn_journal_server(tmp_path, str(script))
    try:
        c = RespConnection(("127.0.0.1", port2), timeout=10)
        n_all = c.cmd("FT.SEARCH", "idx", "*", "NOCONTENT",
                      "LIMIT", "0", "0")[0]
        assert int(n_all) == 20 + 15 + 2 - 1  # 36: deletes replay too
        assert int(c.cmd("FT.SEARCH", "idx", "@t:{post}", "NOCONTENT",
                         "LIMIT", "0", "0")[0]) == 15
        assert int(c.cmd("FT.SEARCH", "idx", "@t:{txn}", "NOCONTENT",
                         "LIMIT", "0", "0")[0]) == 2
        assert c.cmd("HGET", "d:0", "t") is None  # DEL survived
        # SAVE truncation worked: journal holds only post-SAVE ops
        from valkey_search_tpu.persistence.journal import read_records
        cmds = [argv[0] for _ts, _db, argv in
                read_records(str(tmp_path / "ops.journal"))]
        assert b"FT.CREATE" not in cmds  # pre-SAVE op is checkpointed
        c.close()
    finally:
        p2.send_signal(signal.SIGKILL)
        p2.wait(10)


# -- fork-isolated BGSAVE (reference: valkey fork BGSAVE + AtForkPrepare
#    pool suspension, valkey_search.cc:1029) -----------


def test_bgsave_fork_point_in_time(tmp_path):
    """The forked child snapshots the instant of fork: parent writes made
    AFTER BGSAVE returns must not appear in the checkpoint, and their
    journal records must survive the post-success prefix truncation."""
    import os
    import time

    from valkey_search_tpu.persistence.journal import read_records
    from valkey_search_tpu.runtime import config
    from valkey_search_tpu.server.resp import RespServer

    from valkey_search_tpu.cluster.transport import RespConnection

    jpath = str(tmp_path / "ops.journal")
    ckpt = str(tmp_path / "ckpt.vstpu")
    config.set_config("search.journal-path", jpath)
    config.set_config("search.journal-fsync-ms", 0)
    config.set_config("search.checkpoint-path", ckpt)
    try:
        srv = RespServer(port=0)
        srv.start()
        c = RespConnection(("127.0.0.1", srv.port), timeout=10)
        c.cmd("HSET", "k:pre", "f", "before-fork")
        assert c.cmd("BGSAVE") == "Background saving started"
        # parent keeps serving immediately; this write is post-fork (the
        # fork happened synchronously inside the BGSAVE dispatch)
        c.cmd("HSET", "k:post", "f", "after-fork")
        deadline = time.time() + 30
        while srv.bgsave_pid is not None and time.time() < deadline:
            time.sleep(0.05)
        assert srv.bgsave_status == "ok"
        # checkpoint holds the pre-fork state only
        from valkey_search_tpu.server.engine import Engine

        restored = Engine.load(ckpt)
        assert restored.execute("HGET", "k:pre", "f") in (b"before-fork", "before-fork")
        assert restored.execute("HGET", "k:post", "f") is None
        # journal kept the post-fork record (prefix-only truncation)
        replayed = [argv for _, _, argv in read_records(jpath)]
        flat = [b" ".join(a) for a in replayed]
        assert any(b"k:post" in x for x in flat)
        assert not any(b"k:pre" in x for x in flat)
        c.close()
        srv.close()
    finally:
        config.set_config("search.journal-path", "")
        config.set_config("search.journal-fsync-ms", 1000)
        config.set_config("search.checkpoint-path", "")


def test_bgsave_fork_suspends_and_resumes_writers(tmp_path):
    import time

    from valkey_search_tpu.runtime import config
    from valkey_search_tpu.server.resp import RespServer

    ckpt = str(tmp_path / "c2.vstpu")
    srv = RespServer(port=0)
    eng = srv.engine
    eng.execute("HSET", "a", "f", "1")
    # force the async ingestion pool into existence
    q = eng._queue() if hasattr(eng, "_queue") else None
    srv.bgsave_forked(ckpt)
    deadline = time.time() + 30
    while srv.bgsave_pid is not None and time.time() < deadline:
        time.sleep(0.05)
    assert srv.bgsave_status == "ok"
    if q is not None:
        assert not q.suspended  # resumed after fork
    # engine still serves writes
    eng.execute("HSET", "b", "f", "2")
    assert eng.execute("HGET", "b", "f") == "2"
    srv.close()


def test_journal_truncate_upto_keeps_tail(tmp_path):
    from valkey_search_tpu.persistence.journal import OpJournal, read_records

    p = str(tmp_path / "j.journal")
    j = OpJournal(p, fsync_ms=0)
    j.append([b"HSET", b"one", b"f", b"1"])
    off = j.size()
    j.append([b"HSET", b"two", b"f", b"2"])
    j.truncate_upto(off)
    recs = [argv for _, _, argv in read_records(p)]
    assert recs == [[b"HSET", b"two", b"f", b"2"]]
    # journal still appendable after the rewrite
    j.append([b"HSET", b"three", b"f", b"3"])
    recs = [argv for _, _, argv in read_records(p)]
    assert [r[1] for r in recs] == [b"two", b"three"]
    j.close()


def test_bgsave_overlap_rejected(tmp_path):
    """Only one forked BGSAVE at a time (valkey: 'Background save already
    in progress') — overlapping forks would race their journal-prefix
    truncations."""
    import time

    import pytest as _pytest

    from valkey_search_tpu.server.resp import RespError, RespServer

    srv = RespServer(port=0)
    srv.engine.execute("HSET", "a", "f", "1")
    ck = str(tmp_path / "o.vstpu")
    srv.bgsave_forked(ck)
    # the guard window: pid is set until the reaper clears it
    if srv.bgsave_pid is not None:
        with _pytest.raises(RespError):
            srv.bgsave_forked(str(tmp_path / "o2.vstpu"))
    deadline = time.time() + 30
    while srv.bgsave_pid is not None and time.time() < deadline:
        time.sleep(0.05)
    assert srv.bgsave_status == "ok"
    # after completion a new BGSAVE is accepted again
    srv.bgsave_forked(str(tmp_path / "o3.vstpu"))
    deadline = time.time() + 30
    while srv.bgsave_pid is not None and time.time() < deadline:
        time.sleep(0.05)
    assert srv.bgsave_status == "ok"
    srv.close()
