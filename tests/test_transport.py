"""Socket cluster transport: NodeServer + ClusterClient over real TCP.

In-process tier: N NodeServers on ephemeral ports inside this process
(fast); multi-process tier: real `python -m valkey_search_tpu.cluster.
transport` subprocesses — the analog of the reference's integration
harness booting real valkey-server processes into a localhost cluster
(integration/valkey_search_test_case.py:335)."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from valkey_search_tpu.cluster.transport import (
    ClusterClient,
    ConsistencyError,
    NodeServer,
    ReplyError,
    RespConnection,
    assign_slot_ranges,
)
from valkey_search_tpu.runtime import config


@pytest.fixture()
def trio():
    """Three-node cluster on ephemeral ports with mutual gossip."""
    nodes = [
        NodeServer(f"n{i}", port=0, gossip_interval_s=0.05) for i in range(3)
    ]
    for (lo, hi), n in zip(assign_slot_ranges(3), nodes):
        n.slots = (lo, hi)
    for n in nodes:
        n.resp.start()
    addrs = [f"127.0.0.1:{n.port}" for n in nodes]
    for i, n in enumerate(nodes):
        n.peers = [a for j, a in enumerate(addrs) if j != i]
        if n.peers:
            import threading

            n._gossip_thread = threading.Thread(
                target=n._gossip_loop, daemon=True
            )
            n._gossip_thread.start()
    client = ClusterClient(addrs)
    yield nodes, client
    client.close()
    for n in nodes:
        n.close()


def _txt(x):
    return x.decode() if isinstance(x, bytes) else x


def _mk_index(client, dim=8):
    assert client.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
        "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
        "DIM", str(dim), "DISTANCE_METRIC", "L2", "tags", "TAG",
    ) == "OK"


def test_create_converges_and_routes(trio):
    nodes, client = trio
    _mk_index(client)
    # every node has the index
    for n in nodes:
        assert "idx" in n.engine.ft_list()
    # keys land on their slot owners
    dim = 8
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((30, dim)).astype(np.float32)
    for i in range(30):
        assert client.execute(
            "HSET", f"doc:{i}", "emb", vecs[i].tobytes(),
            "tags", "even" if i % 2 == 0 else "odd",
        ) == 2
    counts = [len(n.engine.keyspace) for n in nodes]
    assert sum(counts) == 30
    assert all(c > 0 for c in counts), counts  # keys spread across shards
    # hgetall routes to the owner
    got = client.execute("HGETALL", "doc:3")
    d = {got[i]: got[i + 1] for i in range(0, len(got), 2)}
    assert d[b"emb"] == vecs[3].tobytes()
    # multi-key EXISTS fans out per key (keys hash to different
    # nodes; routing the whole argv by argv[1] undercounted)
    assert client.execute("EXISTS", *[f"doc:{i}" for i in range(30)]) == 30
    assert client.execute("EXISTS", "doc:1", "nope", "doc:2") == 2


def test_fanout_knn_recall(trio):
    nodes, client = trio
    dim = 8
    _mk_index(client, dim)
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((60, dim)).astype(np.float32)
    for i in range(60):
        client.execute("HSET", f"doc:{i}", "emb", vecs[i].tobytes(),
                       "tags", "even" if i % 2 == 0 else "odd")
    q = rng.standard_normal(dim).astype(np.float32)
    gt = set(np.argsort(((vecs - q) ** 2).sum(1))[:10].tolist())
    reply = client.execute(
        "FT.SEARCH", "idx", "*=>[KNN 10 @emb $q]",
        "PARAMS", "2", "q", q.tobytes(), "NOCONTENT",
    )
    assert reply[0] == 10
    got = {int(_txt(k).split(":")[1]) for k in reply[1:]}
    assert got == gt
    # hybrid across shards
    reply = client.execute(
        "FT.SEARCH", "idx", "@tags:{odd}=>[KNN 5 @emb $q]",
        "PARAMS", "2", "q", q.tobytes(), "NOCONTENT",
    )
    assert reply[0] == 5
    assert all(int(_txt(k).split(":")[1]) % 2 == 1 for k in reply[1:])
    # content comes back from the owning shard
    reply = client.execute(
        "FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]",
        "PARAMS", "2", "q", q.tobytes(),
    )
    assert reply[0] == 3
    row = reply[2]
    d = {_txt(row[i]): row[i + 1] for i in range(0, len(row), 2)}
    assert "emb" in d


def test_nonvector_fanout_with_limit(trio):
    nodes, client = trio
    _mk_index(client)
    rng = np.random.default_rng(7)
    for i in range(40):
        client.execute(
            "HSET", f"doc:{i}", "emb",
            rng.standard_normal(8).astype(np.float32).tobytes(),
            "tags", "x",
        )
    reply = client.execute(
        "FT.SEARCH", "idx", "@tags:{x}", "LIMIT", "0", "7", "NOCONTENT",
    )
    assert reply[0] == 40        # total across shards
    assert len(reply) == 1 + 7   # window respected


def test_gossip_converges_without_client_push(trio):
    nodes, client = trio
    # create directly on node0 only (no client-side push)
    c0 = RespConnection(("127.0.0.1", nodes[0].port))
    assert c0.cmd(
        "FT.CREATE", "gidx", "ON", "HASH", "SCHEMA", "t", "TAG"
    ) == "OK"
    deadline = time.time() + 5
    while time.time() < deadline:
        if all("gidx" in n.engine.ft_list() for n in nodes):
            break
        time.sleep(0.02)
    assert all("gidx" in n.engine.ft_list() for n in nodes)
    c0.close()


def test_info_fanout_aggregates(trio):
    nodes, client = trio
    _mk_index(client)
    rng = np.random.default_rng(8)
    for i in range(12):
        client.execute("HSET", f"doc:{i}", "emb",
                       rng.standard_normal(8).astype(np.float32).tobytes(),
                       "tags", "t")
    info = client.ft_info("idx")
    d = {_txt(info[i]): info[i + 1] for i in range(0, len(info), 2)}
    assert int(d["num_docs"]) == 12


def test_partial_results_on_node_down(trio):
    nodes, client = trio
    dim = 8
    _mk_index(client, dim)
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((30, dim)).astype(np.float32)
    for i in range(30):
        client.execute("HSET", f"doc:{i}", "emb", vecs[i].tobytes(),
                       "tags", "t")
    q = rng.standard_normal(dim).astype(np.float32)
    nodes[2].close()  # shard failure
    config.set_config("search.enable-partial-results", "yes")
    try:
        reply = client.execute(
            "FT.SEARCH", "idx", "*=>[KNN 10 @emb $q]",
            "PARAMS", "2", "q", q.tobytes(), "NOCONTENT",
        )
        assert 0 < reply[0] <= 10  # surviving shards answered
        config.set_config("search.enable-partial-results", "no")
        with pytest.raises((ReplyError, OSError, EOFError)):
            client.execute(
                "FT.SEARCH", "idx", "*=>[KNN 10 @emb $q]",
                "PARAMS", "2", "q", q.tobytes(), "NOCONTENT",
            )
    finally:
        config.set_config("search.enable-partial-results", "no")


def test_dropindex_converges(trio):
    nodes, client = trio
    _mk_index(client)
    assert client.execute("FT.DROPINDEX", "idx") == "OK"
    for n in nodes:
        assert "idx" not in n.engine.ft_list()


@pytest.mark.slow
def test_multiprocess_cluster():
    """Real process boundary: two node subprocesses, one coordinator."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    ports = []
    try:
        ranges = assign_slot_ranges(2)
        for i in range(2):
            p = subprocess.Popen(
                [sys.executable, "-m", "valkey_search_tpu.cluster.transport",
                 "--node-id", f"p{i}", "--port", "0",
                 "--slots", f"{ranges[i][0]}:{ranges[i][1]}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                env=env, text=True,
            )
            procs.append(p)
            line = p.stdout.readline().strip()
            assert line.startswith("READY "), line
            ports.append(int(line.split()[1]))
        # peers can't be known before launch with port 0; metadata converges
        # through the client push path instead (gossip is covered in-process)
        client = ClusterClient([f"127.0.0.1:{pt}" for pt in ports])
        dim = 4
        assert client.execute(
            "FT.CREATE", "idx", "ON", "HASH", "SCHEMA",
            "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
            "DIM", str(dim), "DISTANCE_METRIC", "L2",
        ) == "OK"
        vecs = np.eye(dim, dtype=np.float32)
        for i in range(dim):
            client.execute("HSET", f"k{i}", "emb", vecs[i].tobytes())
        reply = client.execute(
            "FT.SEARCH", "idx", "*=>[KNN 2 @emb $q]",
            "PARAMS", "2", "q", vecs[1].tobytes(), "NOCONTENT",
        )
        assert reply[0] == 2
        assert _txt(reply[1]) == "k1"
        client.close()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_aggregate_fanout(trio):
    nodes, client = trio
    _mk_index(client)
    rng = np.random.default_rng(12)
    for i in range(30):
        client.execute(
            "HSET", f"doc:{i}", "emb",
            rng.standard_normal(8).astype(np.float32).tobytes(),
            "tags", "even" if i % 2 == 0 else "odd",
        )
    reply = client.execute(
        "FT.AGGREGATE", "idx", "*", "LOAD", "1", "@tags",
        "GROUPBY", "1", "@tags", "REDUCE", "COUNT", "0", "AS", "cnt",
        "SORTBY", "2", "@cnt", "DESC",
    )
    assert reply[0] == 2
    rows = [
        {_txt(r[i]): _txt(r[i + 1]) for i in range(0, len(r), 2)}
        for r in reply[1:]
    ]
    counts = {r["tags"]: int(r["cnt"]) for r in rows}
    assert counts == {"even": 15, "odd": 15}
    # same pipeline WITHOUT LOAD: GROUPBY keys resolve implicitly from
    # document content across the fanout too (reference registers every
    # parsed @field, CreateRecordsFromNeighbors)
    reply = client.execute(
        "FT.AGGREGATE", "idx", "*",
        "GROUPBY", "1", "@tags", "REDUCE", "COUNT", "0", "AS", "cnt",
    )
    assert reply[0] == 2
    rows = [
        {_txt(r[i]): _txt(r[i + 1]) for i in range(0, len(r), 2)}
        for r in reply[1:]
    ]
    assert {r["tags"]: int(r["cnt"]) for r in rows} == {
        "even": 15, "odd": 15}


def test_socket_replica_read_scaling():
    """A replica NodeServer registers with its primary over TCP, receives
    a full sync + the ongoing write stream, and serves fanout reads when
    the target mode selects replicas (reference FanoutTargetMode)."""
    from valkey_search_tpu.cluster.transport import NodeServer

    primary = NodeServer("p0", port=0).start()
    # pre-replica state (exercises the full-sync path)
    pc = RespConnection(("127.0.0.1", primary.port))
    pc.cmd("FT.CREATE", "idx", "ON", "HASH", "SCHEMA", "tags", "TAG")
    pc.cmd("HSET", "k0", "tags", "old")

    replica = NodeServer("r0", port=0, gossip_interval_s=0.05).start()
    replica.become_replica_of(f"127.0.0.1:{primary.port}")
    try:
        deadline = time.time() + 5
        while time.time() < deadline:
            if "idx" in replica.engine.ft_list() and \
                    "k0" in replica.engine.keyspace:
                break
            time.sleep(0.02)
        assert "idx" in replica.engine.ft_list()
        assert replica.engine.hgetall("k0")

        # ongoing stream: new write on the primary reaches the replica
        pc.cmd("HSET", "k1", "tags", "fresh")
        deadline = time.time() + 5
        while time.time() < deadline and "k1" not in replica.engine.keyspace:
            time.sleep(0.02)
        assert replica.engine.hgetall("k1")

        # fanout read served by the replica
        client = ClusterClient(
            [f"127.0.0.1:{primary.port}"],
            replica_addrs=[[f"127.0.0.1:{replica.port}"]],
        )
        config.set_config("search.fanout-target-mode", "replica")
        try:
            reply = client.execute(
                "FT.SEARCH", "idx", "@tags:{fresh}", "NOCONTENT"
            )
            assert reply[0] == 1
            stats_before = replica.engine.info().get("search_queries_total")
        finally:
            config.set_config("search.fanout-target-mode", "random")
        client.close()
    finally:
        replica.close()
        primary.close()
        pc.close()


def test_single_slot_index_routing(trio):
    """Hash-tagged index name → queries hit only the owning shard
    (reference single_slot_number_, commands.cc:99-136)."""
    from valkey_search_tpu.cluster.node import key_slot
    from valkey_search_tpu.runtime.metrics import STATS

    nodes, client = trio
    name = "idx{route}"
    assert client.execute(
        "FT.CREATE", name, "ON", "HASH", "PREFIX", "1", "doc{route}:",
        "SCHEMA", "tags", "TAG",
    ) == "OK"
    # keys hash-tagged to the same slot as the index
    for i in range(8):
        client.execute("HSET", f"doc{{route}}:{i}", "tags", "x")
    slot = key_slot(name)
    owner = next(
        i for i, n in enumerate(nodes) if n.slots[0] <= slot < n.slots[1]
    )
    before = [n.engine.info().get("queries_total",
              n.engine.info().get("search_queries_total", 0))
              for n in nodes]
    n0 = STATS.get("single_slot_queries")
    reply = client.execute("FT.SEARCH", name, "@tags:{x}", "NOCONTENT")
    assert reply[0] == 8
    assert STATS.get("single_slot_queries") == n0 + 1


def test_ft_internal_update_command(trio):
    import json as _json

    from valkey_search_tpu.runtime import config as _cfg

    nodes, client = trio
    _mk_index(client)
    entry = nodes[0].metadata.entries()["idx"]
    raw = _json.dumps({
        "name": "idx", "version": entry.version + 1,
        "payload": entry.payload,
    })
    c = RespConnection(("127.0.0.1", nodes[1].port))
    try:
        assert c.cmd("FT.INTERNAL_UPDATE", raw) == 1
        assert nodes[1].metadata.get("idx").version == entry.version + 1
        with pytest.raises(Exception, match="corrupted"):
            c.cmd("FT.INTERNAL_UPDATE", "not json")
        _cfg.set_config(
            "search.skip-corrupted-internal-update-entries", "yes"
        )
        try:
            assert c.cmd("FT.INTERNAL_UPDATE", "not json") == 0
        finally:
            _cfg.set_config(
                "search.skip-corrupted-internal-update-entries", "no"
            )
    finally:
        c.close()


def test_multi_exec_writes_replicate():
    from valkey_search_tpu.cluster.transport import NodeServer

    primary = NodeServer("pm", port=0).start()
    replica = NodeServer("rm", port=0).start()
    replica.become_replica_of(f"127.0.0.1:{primary.port}")
    pc = RespConnection(("127.0.0.1", primary.port))
    try:
        # raw MULTI/EXEC over the wire
        pc.sock.sendall(
            b"*1\r\n$5\r\nMULTI\r\n"
        )
        assert pc._read() == "OK"
        pc.cmd("HSET", "tx1", "f", "1")
        pc.cmd("HSET", "tx2", "f", "2")
        pc.sock.sendall(b"*1\r\n$4\r\nEXEC\r\n")
        res = pc._read()
        assert res[0] == 1 and res[1] == 1
        deadline = time.time() + 5
        while time.time() < deadline:
            if "tx1" in replica.engine.keyspace and \
                    "tx2" in replica.engine.keyspace:
                break
            time.sleep(0.02)
        assert replica.engine.hgetall("tx1") and replica.engine.hgetall("tx2")
    finally:
        pc.close()
        replica.close()
        primary.close()


def test_moved_redirect(trio):
    """Keys in foreign slots answer -MOVED <slot> <owner> so redis-cluster
    clients can follow redirects against the nodes directly."""
    from valkey_search_tpu.cluster.node import key_slot

    nodes, client = trio
    # let gossip learn peer slot ranges
    for n in nodes:
        n.gossip_once()
    slot = key_slot("somekey")
    owner_i = next(
        i for i, n in enumerate(nodes) if n.slots[0] <= slot < n.slots[1]
    )
    wrong = nodes[(owner_i + 1) % len(nodes)]
    c = RespConnection(("127.0.0.1", wrong.port))
    try:
        with pytest.raises(ReplyError) as ei:
            c.cmd("HSET", "somekey", "f", "v")
        assert ei.value.code == "MOVED"
        parts = str(ei.value).split()
        assert int(parts[1]) == slot
        assert parts[2].endswith(f":{nodes[owner_i].port}")
        # the owner accepts it
        co = RespConnection(("127.0.0.1", nodes[owner_i].port))
        assert co.cmd("HSET", "somekey", "f", "v") == 1
        co.close()
    finally:
        c.close()


def test_cluster_command_surface(trio):
    nodes, client = trio
    for n in nodes:
        n.gossip_once()
    c = RespConnection(("127.0.0.1", nodes[0].port))
    try:
        slots = c.cmd("CLUSTER", "SLOTS")
        assert len(slots) == 3
        covered = sorted((int(r[0]), int(r[1])) for r in slots)
        assert covered[0][0] == 0 and covered[-1][1] == 16383
        assert _txt(c.cmd("CLUSTER", "MYID")) == "n0"
        info = _txt(c.cmd("CLUSTER", "INFO"))
        assert "cluster_state:ok" in info and "cluster_known_nodes:3" in info
    finally:
        c.close()


class _SlotMapClient:
    """What redis-py's RedisCluster does at bootstrap, reduced to its
    protocol essentials: CLUSTER SLOTS from a seed node → slot→endpoint
    map → route each command by its first key's slot → follow -MOVED.
    Proves an off-the-shelf cluster client's requirements are met by the
    node surface (reference side: vmsdk/src/cluster_map.cc
    builds the same map from CLUSTER SLOTS)."""

    def __init__(self, seed_addr):
        from valkey_search_tpu.cluster.node import key_slot

        self._key_slot = key_slot
        self._conns = {}
        seed = self._conn(seed_addr)
        self.slot_map = []  # (lo, hi_incl, (host, port))
        for row in seed.cmd("CLUSTER", "SLOTS"):
            lo, hi, master = int(row[0]), int(row[1]), row[2]
            host = master[0].decode() if isinstance(master[0], bytes) \
                else master[0]
            self.slot_map.append((lo, hi, (host, int(master[1]))))

    def _conn(self, addr):
        c = self._conns.get(addr)
        if c is None:
            c = self._conns[addr] = RespConnection(addr)
        return c

    def _node_for(self, key):
        s = self._key_slot(key)
        for lo, hi, addr in self.slot_map:
            if lo <= s <= hi:
                return self._conn(addr)
        raise AssertionError(f"slot {s} uncovered")

    def cmd_key(self, key, *argv):
        try:
            return self._node_for(key).cmd(*argv)
        except ReplyError as exc:
            msg = str(exc)
            if msg.startswith("MOVED "):
                _slot, addr = msg.split()[1:3]
                host, port_s = addr.rsplit(":", 1)
                return self._conn((host, int(port_s))).cmd(*argv)
            raise

    def any_node(self):
        return self._conn(self.slot_map[0][2])

    def close(self):
        for c in self._conns.values():
            c.close()


def test_cluster_client_protocol_e2e(trio):
    """Drive the mesh exactly like redis-py RedisCluster would: slot-map
    bootstrap from CLUSTER SLOTS, per-key routing, MOVED redirects, then
    FT.SEARCH fanout from an arbitrary node."""
    nodes, _client = trio
    for n in nodes:
        n.gossip_once()
    cc = _SlotMapClient(("127.0.0.1", nodes[0].port))
    try:
        assert len(cc.slot_map) == 3
        assert cc.any_node().cmd(
            "FT.CREATE", "cidx", "ON", "HASH", "SCHEMA", "t", "TAG",
        ) == "OK"
        for n in nodes:
            n.gossip_once()
        for i in range(30):
            assert cc.cmd_key(f"k{i}", "HSET", f"k{i}", "t",
                              "even" if i % 2 == 0 else "odd") == 1
        # a MOVED redirect is followed transparently (send to wrong node)
        wrong = cc._conn(cc.slot_map[-1][2])
        moved_key = None
        for i in range(30):
            s = cc._key_slot(f"k{i}")
            if not (cc.slot_map[-1][0] <= s <= cc.slot_map[-1][1]):
                moved_key = f"k{i}"
                break
        with pytest.raises(ReplyError, match="MOVED"):
            wrong.cmd("HSET", moved_key, "t", "x")
        # fanout query from any node sees the whole corpus
        deadline = time.time() + 5
        while time.time() < deadline:
            total = cc.any_node().cmd(
                "FT.SEARCH", "cidx", "@t:{even}", "NOCONTENT",
                "LIMIT", "0", "0",
            )[0]
            if int(total) == 15:
                break
            time.sleep(0.05)
        assert int(total) == 15
        # CLUSTER NODES parses: one myself,master + 2 masters
        txt = cc.any_node().cmd("CLUSTER", "NODES")
        txt = txt.decode() if isinstance(txt, bytes) else txt
        lines = [ln for ln in txt.strip().splitlines()]
        assert len(lines) == 3
        assert sum("myself,master" in ln for ln in lines) == 1
        assert all("connected" in ln for ln in lines)
    finally:
        cc.close()


def test_save_bgsave_over_wire(tmp_path):
    from valkey_search_tpu.cluster.transport import NodeServer

    node = NodeServer("sv", port=0).start()
    c = RespConnection(("127.0.0.1", node.port))
    try:
        c.cmd("FT.CREATE", "idx", "ON", "HASH", "SCHEMA", "t", "TAG")
        c.cmd("HSET", "k1", "t", "a")
        path = str(tmp_path / "dump.vstpu")
        assert c.cmd("SAVE", path) == "OK"
        from valkey_search_tpu.persistence import load_engine

        e2 = load_engine(path)
        assert "idx" in e2.ft_list()
        assert e2.hgetall("k1")
        with pytest.raises(ReplyError, match="no checkpoint path"):
            c.cmd("SAVE")
        assert "saving" in c.cmd("BGSAVE", path).lower()
        deadline = time.time() + 5
        import os as _os

        while time.time() < deadline and not _os.path.exists(path):
            time.sleep(0.02)
    finally:
        c.close()
        node.close()


def test_cluster_wide_dbsize_flushall(trio):
    nodes, client = trio
    for i in range(12):
        client.execute("HSET", f"doc:{i}", "f", "v")
    assert client.execute("DBSIZE") == 12
    assert client.execute("FLUSHALL") == "OK"
    assert client.execute("DBSIZE") == 0


def test_multi_exec_moved_in_transaction(trio):
    """A MULTI-wrapped write for a foreign-slot key must answer -MOVED in
    the EXEC results (round-1 bug: queued writes bypassed the slot
    interceptor and were silently applied + replicated locally)."""
    from valkey_search_tpu.cluster.node import key_slot

    nodes, client = trio
    # let gossip learn peer slot ranges so -MOVED carries the owner
    deadline = time.time() + 5
    while time.time() < deadline:
        if all(len(n._peer_slots) == 2 for n in nodes):
            break
        time.sleep(0.02)
    # pick a key NOT owned by node 0
    key = next(
        f"mk{i}" for i in range(10000)
        if not (nodes[0].slots[0] <= key_slot(f"mk{i}") < nodes[0].slots[1])
    )
    local = next(
        f"mk{i}" for i in range(10000)
        if nodes[0].slots[0] <= key_slot(f"mk{i}") < nodes[0].slots[1]
    )
    pc = RespConnection(("127.0.0.1", nodes[0].port))
    try:
        pc.sock.sendall(b"*1\r\n$5\r\nMULTI\r\n")
        assert pc._read() == "OK"
        pc.cmd("HSET", key, "f", "1")     # foreign slot
        pc.cmd("HSET", local, "f", "2")   # owned slot
        pc.sock.sendall(b"*1\r\n$4\r\nEXEC\r\n")
        # the EXEC array carries a -MOVED element for the foreign write
        # (the simple test reader surfaces nested errors by raising)
        try:
            res = pc._read()
            assert any("MOVED" in str(x) for x in res)
        except ReplyError as exc:
            assert "MOVED" in str(exc)
        # server-side contract: foreign write rejected, owned write applied
        assert key not in nodes[0].engine.keyspace
        assert local in nodes[0].engine.keyspace
    finally:
        pc.close()


def test_replica_stream_ordering_under_concurrency():
    """Concurrent writers to the same key: the replica must converge to
    the primary's final value (round-1 bug: apply and forward were not
    atomic, so streams could interleave A,B applied / B,A forwarded)."""
    import threading as _t

    primary = NodeServer("po", port=0).start()
    replica = NodeServer("ro", port=0).start()
    replica.become_replica_of(f"127.0.0.1:{primary.port}")
    conns = [RespConnection(("127.0.0.1", primary.port)) for _ in range(4)]
    try:
        def storm(conn, tag):
            for i in range(100):
                conn.cmd("HSET", "hot", "f", f"{tag}:{i}")

        threads = [
            _t.Thread(target=storm, args=(c, t))
            for t, c in enumerate(conns)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # wait for the ordered stream to drain
        deadline = time.time() + 10
        while time.time() < deadline:
            with primary._repl_cv:
                empty = not primary._repl_log
            backlog = any(
                r.backlog for r in primary._replica_conns.values()
            )
            if empty and not backlog:
                break
            time.sleep(0.02)
        time.sleep(0.2)  # let the last in-flight send land
        assert replica.engine.hgetall("hot") == primary.engine.hgetall("hot")
    finally:
        for c in conns:
            c.close()
        replica.close()
        primary.close()


def test_replica_full_sync_during_write_storm():
    """A replica registering while the primary is under write load must
    converge exactly (round-1 bug: live writes could be overwritten by a
    stale snapshot replay because registration preceded the snapshot)."""
    import threading as _t

    primary = NodeServer("ps", port=0).start()
    pc = RespConnection(("127.0.0.1", primary.port))
    for i in range(200):
        pc.cmd("HSET", f"pre{i}", "f", str(i))
    stop = _t.Event()
    wc = RespConnection(("127.0.0.1", primary.port))

    def writer():
        i = 0
        while not stop.is_set():
            wc.cmd("HSET", f"pre{i % 200}", "f", f"new{i}")
            i += 1

    wt = _t.Thread(target=writer)
    wt.start()
    try:
        replica = NodeServer("rs", port=0).start()
        replica.become_replica_of(f"127.0.0.1:{primary.port}")
        time.sleep(0.3)  # storm continues over the live stream
    finally:
        stop.set()
        wt.join()
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            with primary._repl_cv:
                empty = not primary._repl_log
            if empty and all(
                r.ready and not r.backlog
                for r in primary._replica_conns.values()
            ):
                break
            time.sleep(0.02)
        time.sleep(0.3)
        mismatches = [
            k for k in primary.engine.keyspace
            if replica.engine.hgetall(k) != primary.engine.hgetall(k)
        ]
        assert not mismatches, f"diverged keys: {mismatches[:5]}"
    finally:
        replica.close()
        primary.close()
        pc.close()
        wc.close()


# ---------------------------------------------------------------------------
# Cluster failure drills (reference fanout.cc:177-221
# partial-results policy, integration/test_fanout_base.py)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_node_kill_mid_fanout_partial_results():
    """A REAL process kill (SIGKILL, not a controlled variable) mid-query:
    with partial results enabled the fanout returns the surviving shards'
    rows; without it the query surfaces the failure."""
    import signal

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, ports = [], []
    try:
        ranges = assign_slot_ranges(3)
        for i in range(3):
            p = subprocess.Popen(
                [sys.executable, "-m", "valkey_search_tpu.cluster.transport",
                 "--node-id", f"f{i}", "--port", "0",
                 "--slots", f"{ranges[i][0]}:{ranges[i][1]}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                env=env, text=True,
            )
            procs.append(p)
            line = p.stdout.readline().strip()
            assert line.startswith("READY "), line
            ports.append(int(line.split()[1]))
        client = ClusterClient([f"127.0.0.1:{pt}" for pt in ports])
        assert client.execute(
            "FT.CREATE", "idx", "ON", "HASH", "SCHEMA", "tags", "TAG",
        ) == "OK"
        for i in range(60):
            client.execute("HSET", f"fk{i}", "tags", "x")
        total = client.execute("FT.SEARCH", "idx", "@tags:{x}", "NOCONTENT")[0]
        assert total == 60

        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(timeout=10)

        config.set_config("search.enable-partial-results", "yes")
        try:
            reply = client.execute("FT.SEARCH", "idx", "@tags:{x}", "NOCONTENT")
            # partial: the two surviving shards' docs only
            assert 0 < reply[0] < 60
        finally:
            config.set_config("search.enable-partial-results", "no")
        with pytest.raises((ReplyError, OSError, EOFError, ConsistencyError)):
            client.execute("FT.SEARCH", "idx", "@tags:{x}", "NOCONTENT")
        client.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_slot_migration_moved_during_write_storm():
    """Reshard n0's whole range to n1 while writers hammer its keys: the
    drained node answers -MOVED, writers follow the redirect (client
    refreshes its slot map), and no write is lost across the handoff."""
    import threading as _t

    from valkey_search_tpu.cluster.node import key_slot
    from valkey_search_tpu.runtime.metrics import STATS

    n0 = NodeServer("m0", port=0).start()
    n1 = NodeServer("m1", port=0).start()
    half = 8192
    n0.slots = (0, half)
    n1.slots = (half, 16384)
    n0._peer_slots[f"127.0.0.1:{n1.port}"] = (half, 16384)
    n1._peer_slots[f"127.0.0.1:{n0.port}"] = (0, half)
    client = ClusterClient([f"127.0.0.1:{n0.port}", f"127.0.0.1:{n1.port}"])
    try:
        client.execute("FT.CREATE", "mig", "ON", "HASH", "SCHEMA", "t", "TAG")
        # keys owned by n0 before the migration
        mig_keys = [k for k in (f"migk{i}" for i in range(4000))
                    if key_slot(k) < half][:120]
        assert len(mig_keys) >= 60
        stop = _t.Event()
        errors: list = []
        written: list = []

        def writer(keys):
            i = 0
            while not stop.is_set():
                k = keys[i % len(keys)]
                try:
                    client.execute("HSET", k, "t", f"v{i}")
                    written.append((k, f"v{i}"))
                except Exception as exc:  # no write may fail permanently
                    errors.append(exc)
                i += 1

        t = _t.Thread(target=writer, args=(mig_keys,))
        moved0 = STATS.get("moved_redirects")
        t.start()
        time.sleep(0.15)
        # --- reshard. Handoff order matters: flip ownership FIRST (the
        # old owner freezes — every new write answers -MOVED and lands on
        # n1), THEN copy the frozen keyspace without clobbering keys the
        # redirected writers already re-wrote on n1 (same
        # stale-snapshot-overwrite hazard as replica full sync).
        n1.slots = (0, 16384)
        n0.slots = (16384, 16384)  # drained: owns nothing
        n0._peer_slots[f"127.0.0.1:{n1.port}"] = (0, 16384)
        n1._peer_slots.pop(f"127.0.0.1:{n0.port}", None)
        with n0.engine._lock:
            snapshot = {k: dict(v) for k, v in n0.engine.keyspace.items()}
        for k, fields in snapshot.items():
            with n1.engine._lock:
                if k not in n1.engine.keyspace:
                    n1.engine.hset(k, fields)
        time.sleep(0.3)  # storm continues against the new owner
        stop.set()
        t.join()
        assert not errors, errors[:3]
        assert STATS.get("moved_redirects") > moved0  # redirects happened
        # the last write per key landed on the new owner
        last = {}
        for k, v in written:
            last[k] = v
        missing = [
            k for k, v in list(last.items())[:60]
            if _txt(n1.engine.hgetall(k).get("t", b"")) != v
        ]
        assert not missing, missing[:5]
        client.close()
    finally:
        n0.close()
        n1.close()


def test_replica_failover_promotion():
    """Kill the primary; the replica — whose engine indexed its own copy
    of the write stream — is promoted and serves reads AND writes for
    the slot range with no data loss."""
    primary = NodeServer("fp", port=0).start()
    pc = RespConnection(("127.0.0.1", primary.port))
    pc.cmd("FT.CREATE", "fo", "ON", "HASH", "SCHEMA", "t", "TAG")
    for i in range(50):
        pc.cmd("HSET", f"fok{i}", "t", "alive")
    replica = NodeServer("fr", port=0, gossip_interval_s=0.05).start()
    replica.become_replica_of(f"127.0.0.1:{primary.port}")
    try:
        deadline = time.time() + 10
        while time.time() < deadline and (
            "fo" not in replica.engine.ft_list()
            or len(replica.engine.keyspace) < 50
        ):
            time.sleep(0.02)
        assert len(replica.engine.keyspace) == 50

        # hard failover: primary dies
        primary.close()
        replica.promote_to_primary()

        rc = RespConnection(("127.0.0.1", replica.port))
        # promoted node serves reads with the full dataset...
        reply = rc.cmd("FT.SEARCH", "fo", "@t:{alive}", "NOCONTENT")
        assert reply[0] == 50
        # ...and accepts writes for its slots
        rc.cmd("HSET", "fok_new", "t", "alive")
        reply = rc.cmd("FT.SEARCH", "fo", "@t:{alive}", "NOCONTENT")
        assert reply[0] == 51
        rc.close()
    finally:
        replica.close()
        pc.close()


def test_multi_exec_query_guard_cme(trio):
    """MULTI-wrapped FT.SEARCH in cluster mode is refused unless the index
    is single-slot ({hash-tagged}) and owned by the receiving node
    (reference CME restriction, integration/test_multi_lua.py)."""
    nodes, client = trio
    client.execute("FT.CREATE", "plainidx", "ON", "HASH", "PREFIX", "1",
                   "pg:", "SCHEMA", "n", "NUMERIC")
    # multi-slot index inside MULTI → the reference error
    c = RespConnection(("127.0.0.1", nodes[0].port))
    assert c.cmd("MULTI") == "OK"
    assert c.cmd("FT.SEARCH", "plainidx", "@n:[0 10]") == "QUEUED"
    with pytest.raises(ReplyError, match="not supported in CME mode"):
        c.cmd("EXEC")
    c.close()

    # single-slot index owned by the receiving node → allowed
    from valkey_search_tpu.cluster.node import key_slot
    tag_idx = None
    owner = None
    for t in range(200):
        name = "{t%d}idx" % t
        slot = key_slot(name)
        for n in nodes:
            if n.slots[0] <= slot < n.slots[1]:
                tag_idx, owner = name, n
                break
        if tag_idx:
            break
    oc = RespConnection(("127.0.0.1", owner.port))
    oc.cmd("FT.CREATE", tag_idx, "ON", "HASH", "PREFIX", "1",
           "{%s}d:" % tag_idx.split("}")[0][1:], "SCHEMA", "n", "NUMERIC")
    assert oc.cmd("MULTI") == "OK"
    assert oc.cmd("FT.SEARCH", tag_idx, "@n:[0 10]") == "QUEUED"
    res = oc.cmd("EXEC")
    assert isinstance(res, list) and res[0] == [0]
    oc.close()

    # single-slot index sent to a NON-owner → refused
    non_owner = next(n for n in nodes if n is not owner)
    nc = RespConnection(("127.0.0.1", non_owner.port))
    assert nc.cmd("MULTI") == "OK"
    assert nc.cmd("FT.SEARCH", tag_idx, "@n:[0 10]") == "QUEUED"
    with pytest.raises(ReplyError, match="not supported in CME mode"):
        nc.cmd("EXEC")
    nc.close()


def test_ft_search_consistency_controls(trio):
    """CONSISTENT/INCONSISTENT query flags gate the slot/index fingerprint
    checks (reference test_ft_search_partition_consistency_controls.py):
    a forced invalid fingerprint fails only CONSISTENT queries, with the
    reference's exact error string."""
    from valkey_search_tpu.runtime.debug import CONTROLLED

    nodes, client = trio
    client.execute("FT.CREATE", "cc", "ON", "HASH", "PREFIX", "1", "cc:",
                   "SCHEMA", "n", "NUMERIC")
    for i in range(30):
        client.execute("HSET", f"cc:{i}", "n", str(i))
    nominal = client.execute("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT")
    assert nominal[0] == 30
    # consistent passes while fingerprints are valid
    r = client.execute("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT",
                       "CONSISTENT")
    assert r[0] == 30
    try:
        CONTROLLED.set("force_invalid_index_fingerprint", "yes")
        # INCONSISTENT: forced fingerprint ignored, valid results
        r = client.execute("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT",
                           "INCONSISTENT")
        assert r[0] == 30
        # CONSISTENT: the reference error
        with pytest.raises(ReplyError,
                           match="Index or slot consistency check failed"):
            client.execute("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT",
                           "CONSISTENT")
    finally:
        CONTROLLED.clear("force_invalid_index_fingerprint")


def test_ft_search_partition_timeout_controls(trio):
    """ForceTimeout controlled variable: ALLSHARDS queries fail with the
    timeout error and tick the ForceCancels test counter; SOMESHARDS
    returns partial (possibly empty) results without raising."""
    from valkey_search_tpu.runtime.debug import CONTROLLED, TEST_COUNTERS

    nodes, client = trio
    client.execute("FT.CREATE", "tc", "ON", "HASH", "PREFIX", "1", "tc:",
                   "SCHEMA", "n", "NUMERIC")
    for i in range(12):
        client.execute("HSET", f"tc:{i}", "n", str(i))
    assert client.execute("FT.SEARCH", "tc", "@n:[0 11]",
                          "NOCONTENT")[0] == 12
    base = TEST_COUNTERS.get("ForceCancels")
    try:
        CONTROLLED.set("ForceTimeout", "yes")
        with pytest.raises(ReplyError, match="cancelled due to timeout"):
            client.execute("FT.SEARCH", "tc", "@n:[0 11]", "NOCONTENT",
                           "ALLSHARDS")
        assert TEST_COUNTERS.get("ForceCancels") > base
        r = client.execute("FT.SEARCH", "tc", "@n:[0 11]", "NOCONTENT",
                           "SOMESHARDS")
        assert r[0] == 0  # every shard timed out; partial = empty, no raise
    finally:
        CONTROLLED.clear("ForceTimeout")
    assert client.execute("FT.SEARCH", "tc", "@n:[0 11]",
                          "NOCONTENT")[0] == 12


def test_ft_info_primary_mode_and_retry(trio):
    """FT.INFO PRIMARY aggregates across primaries; forced per-shard
    failures (ForceIndexNotFoundError / ForceRemoteFailCount) are retried
    and counted in search_info_fanout_retry_count (reference
    integration/test_info_primary.py)."""
    from valkey_search_tpu.runtime.debug import CONTROLLED
    from valkey_search_tpu.runtime.metrics import STATS

    nodes, client = trio
    client.execute("FT.CREATE", "index1", "ON", "HASH", "PREFIX", "1",
                   "doc:", "SCHEMA", "price", "NUMERIC")
    for i in range(5):
        client.execute("HSET", f"doc:{i}", "price", str(10 + i))
    info = dict(zip(*(iter(client.ft_info("index1", "PRIMARY")),) * 2))
    assert str(info["mode"]) == "primary"
    assert int(info["num_docs"]) == 5
    assert int(info["hash_indexing_failures"]) == 0

    for var, n in (("ForceIndexNotFoundError", 3),
                   ("ForceRemoteFailCount", 1)):
        before = STATS.get("info_fanout_retries")
        CONTROLLED.set(var, n)
        info = dict(zip(*(iter(client.ft_info("index1", "PRIMARY")),) * 2))
        assert int(info["num_docs"]) == 5
        assert STATS.get("info_fanout_retries") == before + n
        CONTROLLED.clear(var)


def test_ft_info_primary_attribute_gauges(trio):
    """Per-attribute num_records + user_indexed_memory in FT.INFO
    (reference test_ft_info_primary_attribute: title indexed in 2 docs,
    body in 1)."""
    nodes, client = trio
    client.execute("FT.CREATE", "index2", "ON", "HASH", "PREFIX", "1",
                   "ad:", "SCHEMA", "title", "TEXT", "body", "TEXT")
    client.execute("HSET", "ad:1", "title", "hello", "body", "world")
    client.execute("HSET", "ad:2", "title", "valkey")
    info = dict(zip(*(iter(client.ft_info("index2", "PRIMARY")),) * 2))
    assert int(info["num_docs"]) == 2
    def _d(x):
        return x.decode() if isinstance(x, bytes) else x

    attrs = {}
    for a in info["attributes"]:
        d = {_d(k): v for k, v in zip(a[::2], a[1::2])}
        attrs[_d(d["attribute"])] = d
    assert int(attrs["title"]["num_records"]) == 2
    assert int(attrs["body"]["num_records"]) == 1
    assert int(attrs["title"]["user_indexed_memory"]) > 0
    assert int(attrs["body"]["user_indexed_memory"]) > 0


def test_flushall_keeps_indexes_cluster(trio):
    """CME-mode FLUSHALL recreates/keeps the index definitions (a
    cluster-level construct) with zero docs (reference schema_manager.cc
    recreate branch, test_flushall.py CME)."""
    nodes, client = trio
    client.execute("FT.CREATE", "kidx", "ON", "HASH", "PREFIX", "1",
                   "fk:", "SCHEMA", "n", "NUMERIC")
    for i in range(9):
        client.execute("HSET", f"fk:{i}", "n", str(i))
    for n in nodes:
        c = RespConnection(("127.0.0.1", n.port))
        c.cmd("FLUSHALL")
        c.close()
    for n in nodes:
        assert "kidx" in [str(x) for x in n.engine.ft_list()]
        assert n.engine.manager.get("kidx").num_docs() == 0


def test_cluster_node_kill9_journal_replay(tmp_path):
    """A cluster node SIGKILLed mid-stream must replay
    its op journal on restart and reconverge with the mesh — checkpoint +
    journal restore every write (including past-SAVE ones and a DEL), the
    restarted node rejoins metadata convergence (a post-restart FT.CREATE
    reaches it), and a replica re-registers against the restarted primary
    and full-syncs the journal-restored keys. Real subprocess: SIGKILL
    cannot be faked in-process."""
    import signal

    from valkey_search_tpu.cluster.node import key_slot

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    ranges = assign_slot_ranges(2)
    jpath = str(tmp_path / "b.journal")
    cpath = str(tmp_path / "b.ckpt")

    def spawn(node_id, slots, extra=()):
        p = subprocess.Popen(
            [sys.executable, "-m", "valkey_search_tpu.cluster.transport",
             "--node-id", node_id, "--port", "0",
             "--slots", f"{slots[0]}:{slots[1]}", *extra],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=env, text=True,
        )
        line = p.stdout.readline().strip()
        assert line.startswith("READY "), line
        return p, int(line.split()[1])

    procs = []
    replica = None
    try:
        pa, port_a = spawn("pa", ranges[0])
        procs.append(pa)
        pb, port_b = spawn(
            "pb", ranges[1], ["--journal", jpath, "--checkpoint", cpath])
        procs.append(pb)

        client = ClusterClient(
            [f"127.0.0.1:{port_a}", f"127.0.0.1:{port_b}"])
        assert client.execute(
            "FT.CREATE", "idx", "ON", "HASH", "SCHEMA", "t", "TAG",
        ) == "OK"
        b_lo, b_hi = ranges[1]

        def owned_by_b(key):
            return b_lo <= key_slot(key) < b_hi

        for i in range(40):
            client.execute("HSET", f"k{i}", "t",
                           "even" if i % 2 == 0 else "odd")
        # checkpoint mid-stream on B: later writes live only in its journal
        cb = RespConnection(("127.0.0.1", port_b), timeout=10)
        assert cb.cmd("SAVE") == "OK"
        cb.close()
        post_save_b = [f"k{i}" for i in range(40, 80) if owned_by_b(f"k{i}")]
        assert post_save_b, "slot split left B no post-SAVE keys"
        for i in range(40, 80):
            client.execute("HSET", f"k{i}", "t", "post")
        victim = next(f"k{i}" for i in range(40) if owned_by_b(f"k{i}"))
        client.execute("DEL", victim)
        total_before = int(client.execute(
            "FT.SEARCH", "idx", "*", "NOCONTENT", "LIMIT", "0", "0")[0])
        assert total_before == 79
        client.close()

        pb.send_signal(signal.SIGKILL)
        pb.wait(10)

        # restart B (new ephemeral port, same slots + journal): checkpoint
        # load + journal replay must restore every owned write
        pb2, port_b2 = spawn(
            "pb", ranges[1], ["--journal", jpath, "--checkpoint", cpath,
                              "--peers", f"127.0.0.1:{port_a}"])
        procs.append(pb2)
        client2 = ClusterClient(
            [f"127.0.0.1:{port_a}", f"127.0.0.1:{port_b2}"])
        total_after = int(client2.execute(
            "FT.SEARCH", "idx", "*", "NOCONTENT", "LIMIT", "0", "0")[0])
        assert total_after == total_before  # zero data loss
        assert _txt(client2.execute("HGET", post_save_b[0], "t")) == "post"
        assert client2.execute("HGET", victim, "t") is None  # DEL replayed
        assert int(client2.execute(
            "FT.SEARCH", "idx", "@t:{post}", "NOCONTENT",
            "LIMIT", "0", "0")[0]) == 40

        # metadata reconvergence: a NEW index created after the restart
        # must reach the restarted node and serve cluster-wide
        assert client2.execute(
            "FT.CREATE", "idx2", "ON", "HASH", "SCHEMA", "u", "TAG",
        ) == "OK"
        client2.execute("HSET", "fresh:1", "u", "x", "t", "x")
        assert int(client2.execute(
            "FT.SEARCH", "idx2", "@u:{x}", "NOCONTENT",
            "LIMIT", "0", "0")[0]) == 1

        # replica re-register: a replica syncing from the RESTARTED primary
        # receives the journal-restored keys via full sync
        replica = NodeServer("r0", port=0, gossip_interval_s=0.05).start()
        replica.become_replica_of(f"127.0.0.1:{port_b2}")
        deadline = time.time() + 10
        while time.time() < deadline and \
                post_save_b[0] not in replica.engine.keyspace:
            time.sleep(0.05)
        assert replica.engine.hgetall(post_save_b[0]), \
            "replica full sync missing journal-restored key"
        assert victim not in replica.engine.keyspace
        client2.close()
    finally:
        if replica is not None:
            replica.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
