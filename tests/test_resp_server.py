"""RESP serving layer: drive the engine over a real TCP socket exactly the
way a redis/valkey client drives the reference module (integration-harness
analog of the reference's valkey_search_test_case.py, which spawns real
valkey-server processes and speaks RESP to them)."""

import socket
import threading

import numpy as np
import pytest

from valkey_search_tpu.server.engine import Engine
from valkey_search_tpu.server.resp import RespServer, encode, SimpleString


class ReplyError(Exception):
    pass


class RespClient:
    """Minimal binary-safe RESP2/RESP3 client."""

    def __init__(self, port, host="127.0.0.1"):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.f = self.sock.makefile("rwb")

    def close(self):
        try:
            self.f.close()
        finally:
            self.sock.close()

    def send_raw(self, data: bytes):
        self.f.write(data)
        self.f.flush()

    def cmd(self, *argv):
        enc = b"*%d\r\n" % len(argv)
        for a in argv:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, (int, float)):
                a = str(a).encode()
            enc += b"$%d\r\n" % len(a) + a + b"\r\n"
        self.send_raw(enc)
        return self.read_reply()

    def read_reply(self):
        line = self.f.readline()
        if not line:
            raise EOFError("connection closed")
        t, rest = line[:1], line[1:-2]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise ReplyError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self.f.read(n + 2)
            return data[:-2]
        if t in (b"*", b">"):
            n = int(rest)
            if n == -1:
                return None
            return [self.read_reply() for _ in range(n)]
        if t == b"%":
            n = int(rest)
            out = {}
            for _ in range(n):
                k = self.read_reply()
                out[k if not isinstance(k, bytes) else k.decode()] = (
                    self.read_reply()
                )
            return out
        if t == b"_":
            return None
        if t == b"#":
            return rest == b"t"
        if t == b",":
            return float(rest)
        raise AssertionError(f"unknown reply type {line!r}")


@pytest.fixture()
def server():
    srv = RespServer(Engine(), port=0).start()
    yield srv
    srv.close()


@pytest.fixture()
def client(server):
    c = RespClient(server.port)
    yield c
    c.close()


def test_ping_echo_quit(server, client):
    assert client.cmd("PING") == "PONG"
    assert client.cmd("PING", b"\x00bin\xff") == b"\x00bin\xff"
    assert client.cmd("ECHO", "hello") == b"hello"
    assert client.cmd("QUIT") == "OK"
    with pytest.raises(EOFError):
        client.cmd("PING")


def test_hello3_switches_protocol(server, client):
    info = client.cmd("HELLO", "3")
    assert isinstance(info, dict)
    assert info["proto"] == 3
    assert info[b"server" if b"server" in info else "server"] == b"valkey-search-tpu"
    # RESP3 null
    assert client.cmd("HGETALL", "missing") == {}


def test_hset_hgetall_binary_roundtrip(server, client):
    blob = np.arange(4, dtype=np.float32).tobytes()
    assert client.cmd("HSET", "doc:1", "emb", blob, "title", "hi") == 2
    fields = client.cmd("HGETALL", "doc:1")
    d = {fields[i]: fields[i + 1] for i in range(0, len(fields), 2)}
    assert d[b"emb"] == blob
    assert d[b"title"] == b"hi"
    assert client.cmd("DBSIZE") == 1
    assert client.cmd("DEL", "doc:1") == 1
    assert client.cmd("DBSIZE") == 0


def test_knn_search_over_wire(server, client):
    dim = 8
    assert (
        client.cmd(
            "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
            "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
            "DIM", str(dim), "DISTANCE_METRIC", "L2",
            "tags", "TAG",
        )
        == "OK"
    )
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((20, dim)).astype(np.float32)
    for i, v in enumerate(vecs):
        client.cmd(
            "HSET", f"doc:{i}", "emb", v.tobytes(),
            "tags", "even" if i % 2 == 0 else "odd",
        )
    q = vecs[7]
    reply = client.cmd(
        "FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]",
        "PARAMS", "2", "q", q.tobytes(), "DIALECT", "2",
    )
    assert reply[0] == 3
    assert b"doc:7" in reply[1::2][0:3][0] or reply[1] == b"doc:7"
    # hybrid: tag filter over the wire
    reply = client.cmd(
        "FT.SEARCH", "idx", "@tags:{odd}=>[KNN 2 @emb $q]",
        "PARAMS", "2", "q", q.tobytes(), "NOCONTENT",
    )
    assert reply[0] == 2
    names = set(reply[1:])
    assert all(int(n.decode().split(":")[1]) % 2 == 1 for n in names)


def test_error_replies(server, client):
    with pytest.raises(ReplyError, match="unknown command"):
        client.cmd("NOSUCH")
    with pytest.raises(ReplyError, match="not found"):
        client.cmd("FT.INFO", "ghost")
    with pytest.raises(ReplyError, match="wrong number"):
        client.cmd("HSET", "k")


def test_multi_exec(server, client):
    assert client.cmd("MULTI") == "OK"
    assert client.cmd("HSET", "k1", "f", "1") == "QUEUED"
    assert client.cmd("HSET", "k2", "f", "2") == "QUEUED"
    assert client.cmd("DBSIZE") == "QUEUED"
    res = client.cmd("EXEC")
    assert res[0] == 1 and res[1] == 1 and res[2] == 2
    # DISCARD drops the queue
    assert client.cmd("MULTI") == "OK"
    assert client.cmd("HSET", "k3", "f", "3") == "QUEUED"
    assert client.cmd("DISCARD") == "OK"
    assert client.cmd("DBSIZE") == 2
    with pytest.raises(ReplyError, match="EXEC without MULTI"):
        client.cmd("EXEC")


def test_config_get_set(server, client):
    reply = client.cmd("CONFIG", "GET", "search.reader-threads")
    d = {reply[i].decode(): reply[i + 1] for i in range(0, len(reply), 2)}
    assert "search.reader-threads" in d
    assert client.cmd("CONFIG", "SET", "search.timeout-ms", "1234") == "OK"
    reply = client.cmd("CONFIG", "GET", "search.timeout-ms")
    assert reply[1] == b"1234"
    client.cmd("CONFIG", "SET", "search.timeout-ms", "50")
    # glob pattern
    reply = client.cmd("CONFIG", "GET", "search.*threads*")
    assert len(reply) >= 4
    # the registry is process-global: restore the default so later tests
    # (cluster fanout bounds futures by search.timeout-ms) keep their
    # normal budget — leaking 50ms made test_fanout_knn_recall flaky
    from valkey_search_tpu.runtime import config as _cfg

    client.cmd("CONFIG", "SET", "search.timeout-ms",
               str(_cfg.REGISTRY._entries["search.timeout-ms"].default))


def test_info_sections(server, client):
    blob = client.cmd("INFO")
    assert blob.startswith(b"# search")
    assert b"search_queries_total" in blob
    assert client.cmd("INFO", "replication") == b"\r\n"


def test_inline_commands(server, client):
    client.send_raw(b"PING\r\n")
    assert client.read_reply() == "PONG"
    client.send_raw(b'ECHO "two words"\r\n')
    assert client.read_reply() == b"two words"


def test_ft_list_and_dropindex(server, client):
    client.cmd(
        "FT.CREATE", "a", "ON", "HASH", "SCHEMA", "t", "TAG"
    )
    assert client.cmd("FT._LIST") == [b"a"]
    assert client.cmd("FT.DROPINDEX", "a") == "OK"
    assert client.cmd("FT._LIST") == []


def test_concurrent_connections_coalesce(server):
    """Two connections issuing KNN at once — the reader pool + batcher
    coalesce them into one device launch; replies stay per-connection."""
    c0 = RespClient(server.port)
    dim = 4
    c0.cmd(
        "FT.CREATE", "idx", "ON", "HASH", "SCHEMA",
        "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
        "DIM", str(dim), "DISTANCE_METRIC", "L2",
    )
    vecs = np.eye(dim, dtype=np.float32)
    for i in range(dim):
        c0.cmd("HSET", f"k{i}", "emb", vecs[i].tobytes())

    results = {}

    def worker(i):
        c = RespClient(server.port)
        try:
            r = c.cmd(
                "FT.SEARCH", "idx", "*=>[KNN 1 @emb $q]",
                "PARAMS", "2", "q", vecs[i].tobytes(), "NOCONTENT",
            )
            results[i] = r
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(dim)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(dim):
        assert results[i][0] == 1
        assert results[i][1] == f"k{i}".encode()
    c0.close()


def test_flushall(server, client):
    client.cmd("HSET", "x", "f", "v")
    assert client.cmd("FLUSHALL") == "OK"
    assert client.cmd("DBSIZE") == 0


def test_json_over_wire(server, client):
    assert client.cmd("JSON.SET", "j:1", "$", '{"a": 1}') == "OK"
    assert client.cmd("JSON.GET", "j:1") == b'{"a": 1}'


def test_expire_ttl(server, client):
    client.cmd("HSET", "e", "f", "v")
    assert client.cmd("EXPIRE", "e", "100") == 1
    ttl = client.cmd("TTL", "e")
    assert 0 < float(ttl) <= 100
    assert client.cmd("PERSIST", "e") == 1
    assert client.cmd("TTL", "e") == -1


def test_encode_helpers():
    assert encode(SimpleString("OK")) == b"+OK\r\n"
    assert encode(None) == b"$-1\r\n"
    assert encode(None, proto=3) == b"_\r\n"
    assert encode(True) == b":1\r\n"
    assert encode(True, proto=3) == b"#t\r\n"
    assert encode(1.5, proto=3) == b",1.5\r\n"
    assert encode([1, "a"]) == b"*2\r\n:1\r\n$1\r\na\r\n"
    assert encode({"k": 1}, proto=3) == b"%1\r\n$1\r\nk\r\n:1\r\n"


def test_multi_exec_strict_order(server, client):
    """Queued commands execute strictly in queue order: a read between a
    write and a delete sees the write (redis MULTI semantics; round-1
    impl applied all writes first, breaking HSET/READ/DEL ordering)."""
    client.cmd("HSET", "mk", "f", "old")
    assert client.cmd("MULTI") == "OK"
    assert client.cmd("HSET", "mk", "f", "new") == "QUEUED"
    assert client.cmd("HGETALL", "mk") == "QUEUED"
    assert client.cmd("DEL", "mk") == "QUEUED"
    assert client.cmd("HGETALL", "mk") == "QUEUED"
    res = client.cmd("EXEC")
    assert res[0] == 0  # field existed -> 0 new fields
    assert res[1] == [b"f", b"new"]  # read AFTER the write sees it
    assert res[2] == 1
    assert res[3] == []  # read after DEL sees the delete
    assert client.cmd("DBSIZE") == 0


def test_multi_execabort_on_bad_queue(server, client):
    assert client.cmd("MULTI") == "OK"
    with pytest.raises(ReplyError, match="unknown command"):
        client.cmd("NOSUCHCMD", "x")
    assert client.cmd("HSET", "ek", "f", "1") == "QUEUED"
    with pytest.raises(ReplyError, match="EXECABORT"):
        client.cmd("EXEC")
    # transaction discarded: nothing applied, and state machine reset
    assert client.cmd("DBSIZE") == 0
    assert client.cmd("MULTI") == "OK"
    assert client.cmd("HSET", "ek", "f", "1") == "QUEUED"
    assert client.cmd("EXEC") == [1]


def test_multi_ft_search_inline(server, client):
    """FT.SEARCH inside MULTI runs inline (reader-pool dispatch would
    self-deadlock on the engine lock held for the transaction)."""
    import struct

    client.cmd(
        "FT.CREATE", "mIdx", "SCHEMA", "emb", "VECTOR", "FLAT", "6",
        "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2",
    )
    blob = struct.pack("<4f", 1.0, 0.0, 0.0, 0.0)
    client.cmd("MULTI")
    client.cmd("HSET", "v:1", "emb", blob)
    client.cmd(
        "FT.SEARCH", "mIdx", "*=>[KNN 1 @emb $q]",
        "PARAMS", "2", "q", blob, "DIALECT", "2",
    )
    res = client.cmd("EXEC")
    assert res[0] == 1
    # the search ran before the group's index notifications committed:
    # result shape is a valid reply (total count first)
    assert isinstance(res[1], list) and res[1][0] in (0, 1)


def test_auth_no_password_configured(server, client):
    from valkey_search_tpu.runtime import config

    assert str(config.get("search.requirepass")) == ""
    with pytest.raises(ReplyError, match="no password is set"):
        client.cmd("AUTH", "whatever")
    # switching to a named user without credentials must be refused
    with pytest.raises(ReplyError, match="WRONGPASS"):
        client.cmd("AUTH", "alice", "whatever")


def test_auth_requirepass_gate(server):
    from valkey_search_tpu.runtime import config

    config.set_config("search.requirepass", "sekret")
    try:
        c = RespClient(server.port)
        with pytest.raises(ReplyError, match="NOAUTH"):
            c.cmd("DBSIZE")
        with pytest.raises(ReplyError, match="NOAUTH"):
            c.cmd("FLUSHALL")
        with pytest.raises(ReplyError, match="NOAUTH"):
            c.cmd("SHUTDOWN")
        with pytest.raises(ReplyError, match="WRONGPASS"):
            c.cmd("AUTH", "wrong")
        assert c.cmd("AUTH", "sekret") == "OK"
        assert c.cmd("DBSIZE") == 0
        # RESET deauthenticates
        assert c.cmd("RESET") == "RESET"
        with pytest.raises(ReplyError, match="NOAUTH"):
            c.cmd("DBSIZE")
        c.close()
        # HELLO AUTH path
        c2 = RespClient(server.port)
        info = c2.cmd("HELLO", "2", "AUTH", "default", "sekret")
        assert b"server" in info or "server" in str(info)
        assert c2.cmd("DBSIZE") == 0
        c2.close()
    finally:
        config.set_config("search.requirepass", "")


def test_auth_acl_user_password(server, client):
    server.engine.acl.setuser("alice", "on", ">alicepw", "~doc:*",
                              "+@search")
    with pytest.raises(ReplyError, match="WRONGPASS"):
        client.cmd("AUTH", "alice", "bad")
    assert client.cmd("AUTH", "alice", "alicepw") == "OK"
    # alice's prefix ACL now applies to FT.CREATE
    with pytest.raises(ReplyError, match="NOPERM|ACL|lacks"):
        client.cmd(
            "FT.CREATE", "other", "PREFIX", "1", "secret:",
            "SCHEMA", "t", "TAG",
        )


def test_acl_new_user_fails_closed(server, client):
    """A user created with no category rules ('on >pw ~*')
    must not be able to run ANY FT.* command — valkey's new-user default
    is -@all; permissions are granted explicitly."""
    server.engine.acl.setuser("carol", "on", ">pw", "~*")
    assert client.cmd("AUTH", "carol", "pw") == "OK"
    for cmd in (("FT._LIST",),
                ("FT.CREATE", "x", "SCHEMA", "t", "TAG"),
                ("FT._DEBUG", "SHOW_INFO")):
        with pytest.raises(ReplyError, match="NOPERM|no permissions"):
            client.cmd(*cmd)
    # explicit grant opens the granted surface
    server.engine.acl.setuser("carol", "+@search")
    assert client.cmd("FT._LIST") == []


def test_acl_command_surface(server, client):
    assert client.cmd("ACL", "WHOAMI") == b"default"
    assert client.cmd(
        "ACL", "SETUSER", "bob", "on", ">pw1", "~doc:*"
    ) == "OK"
    users = client.cmd("ACL", "LIST")
    assert any(b"bob" in u for u in users)
    gu = client.cmd("ACL", "GETUSER", "bob")
    assert b"keys" in gu
    # the new user authenticates and is prefix-limited
    assert client.cmd("AUTH", "bob", "pw1") == "OK"
    assert client.cmd("ACL", "WHOAMI") == b"bob"
    # no categories granted yet: the command gate fires first
    with pytest.raises(ReplyError, match="NOPERM|no permissions"):
        client.cmd("FT.CREATE", "other", "PREFIX", "1", "x:",
                   "SCHEMA", "t", "TAG")
    # with the category granted, the PREFIX acl still limits index keys
    client.cmd("ACL", "SETUSER", "bob", "+@search")
    with pytest.raises(ReplyError, match="ACL|lacks"):
        client.cmd("FT.CREATE", "other", "PREFIX", "1", "x:",
                   "SCHEMA", "t", "TAG")
    client.cmd("RESET")
    assert client.cmd("ACL", "DELUSER", "bob") == 1


def test_basic_keyspace_command_surface(server, client):
    client.cmd("HSET", "h1", "a", "1", "b", "2")
    assert client.cmd("EXISTS", "h1", "ghost") == 1
    assert client.cmd("TYPE", "h1") == b"hash"
    assert client.cmd("TYPE", "ghost") == b"none"
    assert client.cmd("HGET", "h1", "a") == b"1"
    assert client.cmd("HGET", "h1", "zz") is None
    assert client.cmd("HMGET", "h1", "a", "zz", "b") == [b"1", None, b"2"]
    assert client.cmd("HDEL", "h1", "b") == 1
    assert client.cmd("HGETALL", "h1") == [b"a", b"1"]
    client.cmd("HSET", "h2", "x", "1")
    keys = client.cmd("KEYS", "h*")
    assert sorted(keys) == [b"h1", b"h2"]
    # SCAN paging covers the whole keyspace
    seen = set()
    cursor = b"0"
    while True:
        cursor, page = client.cmd("SCAN", cursor, "COUNT", "1")
        seen.update(page)
        if cursor == b"0":
            break
    assert seen == {b"h1", b"h2"}
    # HDEL of the last field deletes the key and deindexes it
    client.cmd("FT.CREATE", "ks", "ON", "HASH", "SCHEMA", "a", "TAG")
    client.cmd("HSET", "h3", "a", "tagged")
    assert client.cmd("FT.SEARCH", "ks", "@a:{tagged}", "NOCONTENT")[0] >= 1
    client.cmd("HDEL", "h3", "a")
    assert client.cmd("EXISTS", "h3") == 0


def test_multidb_select_isolation_and_swapdb(server, client):
    """Logical DBs: SELECT isolates keyspaces AND index schemas (reference
    integration/test_multidb_search.py, per-db schema registry
    schema_manager.h GetIndexSchema(db_num, ...)); SWAPDB swaps content."""
    client.cmd("HSET", "k", "f", "zero")
    assert client.cmd("SELECT", "1") == "OK"
    assert client.cmd("EXISTS", "k") == 0
    client.cmd("HSET", "k", "f", "one")
    client.cmd("FT.CREATE", "idx1", "ON", "HASH",
               "SCHEMA", "f", "TAG")
    r = client.cmd("FT.SEARCH", "idx1", "@f:{one}", "NOCONTENT")
    assert r[0] == 1
    # index is invisible from db 0
    assert client.cmd("SELECT", "0") == "OK"
    with pytest.raises(ReplyError, match="not found"):
        client.cmd("FT.SEARCH", "idx1", "@f:{one}", "NOCONTENT")
    assert client.cmd("HGET", "k", "f") == b"zero"
    # SWAPDB 0 1: the connection stays on db 0 but sees db 1's data
    assert client.cmd("SWAPDB", "0", "1") == "OK"
    assert client.cmd("HGET", "k", "f") == b"one"
    r = client.cmd("FT.SEARCH", "idx1", "@f:{one}", "NOCONTENT")
    assert r[0] == 1
    # out-of-range / bad args
    with pytest.raises(ReplyError, match="out of range"):
        client.cmd("SELECT", "16")
    with pytest.raises(ReplyError):
        client.cmd("SELECT", "x")
    # RESET returns to db 0
    client.cmd("SELECT", "1")
    assert client.cmd("RESET") == "RESET"
    assert client.cmd("HGET", "k", "f") == b"one"  # post-swap db 0


def test_multidb_in_cluster_mode(server, client):
    """valkey 9 dbnum: SELECT works in cluster mode (test_dbnum.py);
    SWAPDB stays a standalone-only operation."""
    server.key_router = lambda key: None  # cluster hook installed
    try:
        assert client.cmd("SELECT", "2") == "OK"
        with pytest.raises(ReplyError, match="cluster"):
            client.cmd("SWAPDB", "0", "1")
        assert client.cmd("SELECT", "0") == "OK"
    finally:
        server.key_router = None


def test_multidb_save_restore(server, client, tmp_path):
    path = str(tmp_path / "dump.vstpu")
    client.cmd("HSET", "a", "f", "db0")
    client.cmd("SELECT", "3")
    client.cmd("FT.CREATE", "i3", "ON", "HASH", "SCHEMA", "f", "TAG")
    client.cmd("HSET", "b", "f", "db3")
    assert client.cmd("SAVE", path) == "OK"

    srv2 = RespServer(Engine(), port=0)
    srv2.load_all(path)
    srv2.start()
    try:
        c2 = RespClient(srv2.port)
        assert c2.cmd("HGET", "a", "f") == b"db0"
        assert c2.cmd("EXISTS", "b") == 0
        c2.cmd("SELECT", "3")
        assert c2.cmd("HGET", "b", "f") == b"db3"
        assert c2.cmd("FT.SEARCH", "i3", "@f:{db3}", "NOCONTENT")[0] == 1
        c2.close()
    finally:
        srv2.close()


def test_client_id_list_kill_cancels_blocked_query(server):
    """CLIENT ID / LIST / KILL ID: killing a connection whose FT.SEARCH is
    parked on a pausepoint unblocks it with a connection error (reference
    integration/test_cancel.py canceller flow)."""
    import time

    c1 = RespClient(server.port)
    c2 = RespClient(server.port)
    try:
        id1 = c1.cmd("CLIENT", "ID")
        assert isinstance(id1, int) and id1 > 0
        c1.cmd("CLIENT", "SETNAME", "victim")
        listing = c2.cmd("CLIENT", "LIST")
        text = listing.decode() if isinstance(listing, bytes) else listing
        assert f"id={id1} name=victim" in text
        assert c2.cmd("CLIENT", "KILL", "ID", id1) == 1
        with pytest.raises((EOFError, ConnectionError, OSError)):
            for _ in range(5):
                c1.cmd("PING")
                time.sleep(0.05)
        with pytest.raises(ReplyError, match="No such client"):
            c2.cmd("CLIENT", "KILL", "ID", 99999)
    finally:
        c1.close()
        c2.close()


def test_ft_debug_denied_without_admin(server, client):
    """FT._DEBUG requires the admin category (reference registers it with
    admin flags — integration/test_debug.py)."""
    server.engine.execute("FT._DEBUG", "HELP")  # default user: allowed
    assert client.cmd(
        "ACL", "SETUSER", "debug_user", "on", ">password",
        "~*", "&*", "-@all", "+@read",
    ) == "OK"
    assert client.cmd("AUTH", "debug_user", "password") == "OK"
    with pytest.raises(ReplyError, match="has no permissions to run"):
        client.cmd("FT._DEBUG", "HELP")
    # granting admin unlocks it
    client.cmd("RESET")
    client.cmd("ACL", "SETUSER", "debug_user", "+@admin")
    assert client.cmd("AUTH", "debug_user", "password") == "OK"
    client.cmd("FT._DEBUG", "HELP")
    client.cmd("RESET")
    assert client.cmd("ACL", "DELUSER", "debug_user") == 1


def test_flushall_drops_indexes_standalone(server, client):
    """CMD-mode FLUSHALL deletes index schemas (reference OnFlushDBEnded,
    test_flushall.py: FT._LIST == [] afterwards)."""
    client.cmd("FT.CREATE", "fidx", "SCHEMA", "n", "NUMERIC")
    client.cmd("HSET", "fk", "n", "1")
    assert client.cmd("FT._LIST")
    assert client.cmd("FLUSHALL") == "OK"
    assert client.cmd("FT._LIST") == []


@pytest.mark.parametrize(
    "rules,search,info_ok,write,list_ok,debug",
    [
        (["-@all"], False, False, False, False, False),
        (["~*", "&*", "+@all"], True, True, True, True, True),
        (["~*", "&*", "-@all", "+@search"], True, True, True, True, True),
        (["~*", "&*", "-@all", "+@write", "+@read"],
         True, True, True, True, False),
        (["~*", "&*", "-@all", "+@write"], False, False, True, False, False),
        (["~*", "&*", "-@all", "+@read"], True, True, False, True, False),
        (["~*", "&*", "-@all", "+@slow"], True, False, False, True, True),
        (["~*", "&*", "-@all", "+@dangerous"],
         False, False, False, False, True),
        (["~*", "&*", "-@all", "+@admin"], False, False, False, True, True),
    ],
)
def test_acl_category_permissions(server, client, rules, search, info_ok,
                                  write, list_ok, debug):
    """Reference per-command category matrix (commands.h:46-59, drilled by
    integration/test_valkey_search_acl.py test_acl_category_permissions)."""
    server.engine.execute("FT.CREATE", "aclidx", "SCHEMA", "n", "NUMERIC")
    client.cmd("ACL", "SETUSER", "user1", "on", ">search_pass", *rules)
    assert client.cmd("AUTH", "user1", "search_pass") == "OK"

    def probe(ok, *cmd):
        if ok:
            try:
                client.cmd(*cmd)
            except ReplyError as e:  # non-ACL errors are fine
                assert "no permissions" not in str(e).lower(), (cmd, e)
        else:
            with pytest.raises(ReplyError, match="no permissions"):
                client.cmd(*cmd)

    probe(search, "FT.SEARCH", "aclidx", "@n:[0 1]")
    probe(search, "FT.AGGREGATE", "aclidx", "@n:[0 1]")
    probe(info_ok, "FT.INFO", "aclidx")
    probe(write, "FT.CREATE", "aclw", "SCHEMA", "n", "NUMERIC")
    probe(list_ok, "FT._LIST")
    probe(debug, "FT._DEBUG", "HELP")
    client.cmd("RESET")
    client.cmd("ACL", "DELUSER", "user1")
