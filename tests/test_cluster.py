"""Cluster layer tests: metadata gossip/reconcile, slot routing, fanout.

Mirrors reference integration cluster coverage (test_ft_create_consistency,
test_ft_metadata_cluster_validation, test_fanout_base, test_info_cluster —
SURVEY.md §4.2) with in-process nodes instead of real processes."""

import numpy as np
import pytest

from valkey_search_tpu.cluster import (
    ClusterBus,
    ClusterEngine,
    MetadataManager,
    fingerprint64,
)
from valkey_search_tpu.cluster.node import ConsistencyError, key_slot
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.debug import CONTROLLED, reset_all


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()
    config.REGISTRY.reset_all()


# -- metadata manager ---------------------------------------------------------

def test_fingerprint_is_stable_and_keyed():
    assert fingerprint64(b"abc") == fingerprint64(b"abc")
    assert fingerprint64(b"abc") != fingerprint64(b"abd")


def test_create_entry_gossips_to_all_nodes():
    bus = ClusterBus()
    applied = {i: [] for i in range(3)}
    mms = [
        MetadataManager(f"n{i}", bus,
                        on_apply=lambda name, p, i=i: applied[i].append((name, p)))
        for i in range(3)
    ]
    e = mms[0].create_entry("idx", {"dim": 4})
    for i, mm in enumerate(mms):
        got = mm.get("idx")
        assert got is not None
        assert (got.version, got.fingerprint) == (e.version, e.fingerprint)
        assert applied[i][-1] == ("idx", {"dim": 4})
    assert mms[0].top_fingerprint() == mms[1].top_fingerprint() \
        == mms[2].top_fingerprint()


def test_reconcile_last_writer_wins():
    bus = ClusterBus()
    a = MetadataManager("a", bus)
    b = MetadataManager("b", bus)
    a.create_entry("idx", {"v": 1})
    # b re-creates at higher version → b's definition wins everywhere
    b.create_entry("idx", {"v": 2})
    assert a.get("idx").payload == {"v": 2}
    assert a.get("idx").version == 2


def test_version_tie_breaks_on_fingerprint():
    bus1, bus2 = ClusterBus(), ClusterBus()  # isolated at first
    a = MetadataManager("a", bus1)
    b = MetadataManager("b", bus2)
    a.create_entry("idx", {"v": "A"})
    b.create_entry("idx", {"v": "B"})  # same version 1, different payload
    # join: simulate partition heal by reconciling both ways
    ea, eb = a.get("idx"), b.get("idx")
    a.reconcile({"idx": eb})
    b.reconcile({"idx": ea})
    assert a.get("idx").payload == b.get("idx").payload
    assert a.get("idx").fingerprint == b.get("idx").fingerprint


def test_drop_entry_tombstone_propagates():
    bus = ClusterBus()
    a = MetadataManager("a", bus)
    b = MetadataManager("b", bus)
    a.create_entry("idx", {"v": 1})
    a.drop_entry("idx")
    assert b.get("idx") is None
    assert "idx" in b.entries()  # tombstone retained with bumped version
    assert b.entries()["idx"].version == 2


def test_internal_update_replication_and_corruption():
    bus = ClusterBus()
    a = MetadataManager("a", bus)
    import json

    raw = json.dumps({"name": "idx", "version": 3, "payload": {"x": 1}}).encode()
    assert a.internal_update(raw)
    assert a.get("idx").version == 3
    with pytest.raises(Exception):
        a.internal_update(b"not json")
    assert a.internal_update(b"not json", skip_corrupted=True) is False


# -- slot routing ----------------------------------------------------------------

def test_key_slot_hash_tags():
    assert key_slot("{user1}.a") == key_slot("{user1}.b")
    assert key_slot("foo{}{bar}") == key_slot("foo{}{bar}")  # empty tag → whole key
    # CRC16 reference value (redis docs): "123456789" → 0x31C3
    from valkey_search_tpu.cluster.node import crc16

    assert crc16(b"123456789") == 0x31C3


def test_cluster_routes_keys_to_owners():
    c = ClusterEngine(n_nodes=3)
    keys = [f"doc:{i}" for i in range(200)]
    for k in keys:
        c.hset(k, {"f": "1"})
    per_node = [len(n.engine.keyspace) for n in c.nodes]
    assert sum(per_node) == 200
    assert all(p > 0 for p in per_node)  # spread across shards
    for k in keys:
        assert c.hgetall(k) == {"f": "1"}


# -- cluster index lifecycle --------------------------------------------------------

@pytest.fixture()
def cluster(rng):
    c = ClusterEngine(n_nodes=3)
    vecs = rng.standard_normal((90, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        c.hset(f"doc:{i}", {
            "emb": v.tobytes(), "color": ["red", "blue"][i % 2],
            "n": str(i),
        })
    c.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
        "SCHEMA",
        "emb", "VECTOR", "HNSW", "8",
        "TYPE", "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "L2", "M", "8",
        "color", "TAG", "n", "NUMERIC",
    )
    return c, vecs


def test_ft_create_backfills_every_shard(cluster):
    c, vecs = cluster
    for node in c.nodes:
        schema = node.engine.manager.get("idx")
        assert schema.num_docs() == len(node.engine.keyspace)
    info = c.ft_info("idx", "CLUSTER")
    d = dict(zip(info[::2], info[1::2]))
    assert d["num_docs"] == 90


def test_fanout_knn_matches_ground_truth(cluster):
    c, vecs = cluster
    q = vecs[17]
    r = c.execute("FT.SEARCH", "idx", "*=>[KNN 5 @emb $q]",
                  "PARAMS", "2", "q", q.tobytes(), "NOCONTENT")
    d2 = ((vecs - q) ** 2).sum(1)
    truth = [f"doc:{i}" for i in np.argsort(d2, kind="stable")[:5]]
    assert r[0] == 5
    assert r[1] == "doc:17"
    assert set(r[1:]) == set(truth)


def test_fanout_hybrid_filter(cluster):
    c, vecs = cluster
    q = vecs[4]
    r = c.execute("FT.SEARCH", "idx", "(@color:{red})=>[KNN 4 @emb $q]",
                  "PARAMS", "2", "q", q.tobytes(), "NOCONTENT")
    assert r[0] == 4
    for k in r[1:]:
        assert int(k.split(":")[1]) % 2 == 0  # red = even docs


def test_fanout_nonvector_with_limit(cluster):
    c, vecs = cluster
    r = c.execute("FT.SEARCH", "idx", "@n:[10 29]", "NOCONTENT",
                  "LIMIT", "0", "100")
    assert r[0] == 20
    assert {k for k in r[1:]} == {f"doc:{i}" for i in range(10, 30)}
    r2 = c.execute("FT.SEARCH", "idx", "@n:[10 29]", "NOCONTENT",
                   "LIMIT", "5", "5")
    assert r2[0] == 20 and len(r2[1:]) == 5


def test_mutations_visible_through_fanout(cluster):
    c, vecs = cluster
    nv = np.full(8, 0.5, np.float32)
    c.hset("doc:500", {"emb": nv.tobytes(), "color": "gold", "n": "500"})
    r = c.execute("FT.SEARCH", "idx", "@color:{gold}", "NOCONTENT")
    assert r == [1, "doc:500"]
    c.delete("doc:500")
    assert c.execute("FT.SEARCH", "idx", "@color:{gold}", "NOCONTENT")[0] == 0


def test_dropindex_converges(cluster):
    from valkey_search_tpu.schema.schema_manager import SchemaError

    c, vecs = cluster
    assert c.ft_dropindex("idx") == "OK"
    for node in c.nodes:
        with pytest.raises(SchemaError):
            node.engine.manager.get("idx")


def test_forced_fingerprint_mismatch_fails_then_partial(cluster):
    c, vecs = cluster
    CONTROLLED.set("force_invalid_index_fingerprint", "true")
    q = vecs[0]
    with pytest.raises(ConsistencyError):
        c.execute("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]",
                  "PARAMS", "2", "q", q.tobytes(), "NOCONTENT")
    # partial-results policy returns what succeeded (here: nothing, but no raise)
    config.set_config("search.prefer-partial-results", True)
    r = c.execute("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]",
                  "PARAMS", "2", "q", q.tobytes(), "NOCONTENT")
    assert r[0] == 0


def test_late_joining_node_converges():
    c = ClusterEngine(n_nodes=2)
    c.hset("doc:1", {"t": "x"})
    c.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "t", "TAG")
    # simulate a node that missed the broadcast: wipe its index + metadata
    from valkey_search_tpu.cluster.node import ClusterNode

    late = ClusterNode("late", c.bus)
    late.slots = (0, 0)
    assert late.metadata.get("idx") is None
    # any gossip round pulls it in
    c.nodes[0].metadata.broadcast()
    assert late.metadata.get("idx") is not None
    assert late.engine.manager.get("idx") is not None


def test_cluster_text_search(rng):
    c = ClusterEngine(n_nodes=3)
    titles = ["running shoes", "blue suede shoes", "quantum computing",
              "running late again", "the art of computing"]
    for i, t in enumerate(titles * 4):
        c.hset(f"doc:{i}", {"title": t, "n": str(i)})
    c.execute("FT.CREATE", "t", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "title", "TEXT", "n", "NUMERIC")
    r = c.execute("FT.SEARCH", "t", "@title:run", "NOCONTENT",
                  "LIMIT", "0", "50")
    want = {f"doc:{i}" for i, t in enumerate(titles * 4) if "running" in t}
    assert set(r[1:]) == want
    r2 = c.execute("FT.SEARCH", "t", '"quantum computing"', "NOCONTENT")
    assert set(r2[1:]) == {f"doc:{i}" for i, t in enumerate(titles * 4)
                           if t == "quantum computing"}
    # fanout + numeric + text conjunction
    r3 = c.execute("FT.SEARCH", "t", "@title:shoes @n:[0 9]", "NOCONTENT",
                   "LIMIT", "0", "50")
    assert all(int(k.split(":")[1]) <= 9 for k in r3[1:])
    assert r3[0] >= 2


def test_cluster_json_documents(rng):
    import json as _json

    c = ClusterEngine(n_nodes=2)
    c.execute("FT.CREATE", "j", "ON", "JSON", "PREFIX", "1", "p:",
              "SCHEMA", "$.v", "AS", "v", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2",
              "$.tag", "AS", "tag", "TAG")
    vecs = rng.standard_normal((20, 4)).astype(np.float32)
    for i, v in enumerate(vecs):
        node = c.owner(f"p:{i}")
        node.engine.json_set(f"p:{i}", "$", _json.dumps(
            {"v": [float(x) for x in v], "tag": ["a", "b"][i % 2]}
        ))
    q = vecs[11].tobytes()
    r = c.execute("FT.SEARCH", "j", "(@tag:{b})=>[KNN 3 @v $q]",
                  "PARAMS", "2", "q", q, "NOCONTENT")
    assert r[1] == "p:11"
    assert all(int(k.split(":")[1]) % 2 == 1 for k in r[1:])


def test_cluster_save_load_roundtrip(cluster, tmp_path, rng):
    from valkey_search_tpu.cluster.node import ClusterEngine

    c, vecs = cluster
    q = vecs[17].tobytes()
    before = c.execute("FT.SEARCH", "idx", "*=>[KNN 5 @emb $q]",
                       "PARAMS", "2", "q", q, "NOCONTENT")
    d = str(tmp_path / "cluster_ckpt")
    totals = c.save(d)
    assert totals["keys"] == 90
    c2 = ClusterEngine.load(d)
    after = c2.execute("FT.SEARCH", "idx", "*=>[KNN 5 @emb $q]",
                       "PARAMS", "2", "q", q, "NOCONTENT")
    assert before == after
    # metadata survived with its version → new creates bump past it
    e = c2.nodes[0].metadata.get("idx")
    assert e is not None and e.version >= 1
    # writes still route and index after restore
    nv = np.full(8, 0.25, np.float32)
    c2.hset("doc:900", {"emb": nv.tobytes(), "color": "gold", "n": "900"})
    assert c2.execute("FT.SEARCH", "idx", "@color:{gold}",
                      "NOCONTENT") == [1, "doc:900"]
    # drop converges across restored nodes
    assert c2.ft_dropindex("idx") == "OK"


def test_cluster_engine_aggregate_fanout():
    import numpy as np

    from valkey_search_tpu.cluster.node import ClusterEngine

    ce = ClusterEngine(n_nodes=3)
    ce.ft_create("idx", "ON", "HASH", "PREFIX", "1", "doc:",
                 "SCHEMA", "price", "NUMERIC", "tags", "TAG")
    for i in range(40):
        ce.hset(f"doc:{i}", {"price": str(i), "tags": "a" if i < 10 else "b"})
    reply = ce.execute(
        "FT.AGGREGATE", "idx", "*", "LOAD", "2", "@tags", "@price",
        "GROUPBY", "1", "@tags",
        "REDUCE", "COUNT", "0", "AS", "cnt",
        "REDUCE", "SUM", "1", "@price", "AS", "total",
    )
    assert reply[0] == 2
    rows = [dict(zip(r[::2], r[1::2])) for r in reply[1:]]
    by_tag = {r["tags"]: r for r in rows}
    assert int(by_tag["a"]["cnt"]) == 10
    assert float(by_tag["a"]["total"]) == sum(range(10))
    assert int(by_tag["b"]["cnt"]) == 30


@pytest.mark.slow
def test_cluster_checkpoint_under_write_storm(tmp_path, rng):
    """Concurrent checkpoint while writers hammer every shard (a
    gap: cluster-path save-under-write was untested — reference analog:
    endurance save/restore under memtier load). The snapshot must load
    into a fully consistent cluster: every restored key searchable, index
    metadata converged, no partial/corrupt shard files."""
    import threading

    c = ClusterEngine(n_nodes=3)
    c.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
        "SCHEMA", "emb", "VECTOR", "FLAT", "6",
        "TYPE", "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "L2",
        "color", "TAG",
    )
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    for i in range(100):  # settled base
        c.hset(f"doc:{i}", {"emb": vecs[i].tobytes(), "color": "base"})

    stop = threading.Event()
    errors = []

    def storm(tid):
        i = 100 + tid
        while not stop.is_set():
            try:
                c.hset(f"doc:{i}", {
                    "emb": vecs[i % 400].tobytes(), "color": "storm",
                })
                i += 2
            except Exception as exc:
                errors.append(exc)

    threads = [threading.Thread(target=storm, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    try:
        snaps = []
        for round_i in range(3):
            d = tmp_path / f"snap{round_i}"
            d.mkdir()
            c.save(str(d))
            snaps.append(d)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors[:3]

    for d in snaps:
        restored = ClusterEngine.load(str(d))
        # metadata converged on every node
        for node in restored._all_nodes():
            assert "idx" in node.engine.ft_list()
        # every restored key is searchable and content-consistent
        total_keys = sum(len(n.engine.keyspace) for n in restored.nodes)
        assert total_keys >= 100
        reply = restored.ft_search("idx", "@color:{base}", "NOCONTENT",
                                   "LIMIT", "0", "200")
        assert reply[0] == 100  # the settled base is fully present
        # storm keys: whatever was captured must be indexed consistently
        reply = restored.ft_search("idx", "@color:{storm}", "NOCONTENT",
                                   "LIMIT", "0", "1000")
        n_storm = reply[0]
        storm_keys = sum(
            1 for n in restored.nodes
            for k, f in n.engine.keyspace.items()
            if f.get("color") in ("storm", b"storm")
        )
        assert n_storm == storm_keys
