"""EVAL/EVALSHA scripting over the embedded Lua interpreter
(server/lua.py wired through server/resp.py).

Mirrors reference integration/test_multi_lua.py::test_lua_all_commands
(FT.* through EVAL) and the CME single-slot restriction drilled by
TestMultiLuaCME; adds the engine-integration contracts: KEYS/ARGV,
atomicity, SCRIPT LOAD/EVALSHA, reply conversion in both directions,
real-Lua control flow against the live keyspace, and the step budget
that replaces valkey's busy-script watchdog."""

import pytest

from valkey_search_tpu.server import lua as lua_mod
from valkey_search_tpu.server.resp import RespServer

from tests.test_resp_server import RespClient, ReplyError


@pytest.fixture()
def server():
    srv = RespServer(port=0)
    srv.start()
    yield srv
    srv.close()


@pytest.fixture()
def client(server):
    c = RespClient(server.port)
    yield c
    c.close()


def _lua_call(cmd, *args):
    quoted = ", ".join(f"'{a}'" for a in args)
    return f"return redis.call('{cmd}', {quoted})"


# -- compile contract ----------------------------------------------------------

def test_compile_accepts_real_lua():
    for src in (
        "for i=1,10 do redis.call('DEL', 'k'..i) end",
        "if redis.call('EXISTS', KEYS[1]) == 1 then return 1 end return 0",
        "local t = {} t[#t+1] = 'x' return cjson.encode(t)",
        "return KEYS",
        "while true do end",  # parses; the step budget stops it at run
    ):
        lua_mod.compile_script(src)


def test_compile_rejects_malformed():
    for src in ("return 1 +", "if x then", "local = 3", "return 'abc"):
        with pytest.raises(lua_mod.LuaError):
            lua_mod.compile_script(src)


# -- reference test_lua_all_commands analog -----------------------------------

def test_lua_ft_commands_e2e(client):
    assert client.cmd(
        "EVAL",
        _lua_call("FT.CREATE", "idx", "SCHEMA", "price", "NUMERIC",
                  "title", "TEXT"),
        "0",
    ) == "OK"
    lst = client.cmd("EVAL", "return redis.call('FT._LIST')", "0")
    assert b"idx" in lst
    client.cmd("HSET", "doc:1", "price", "42", "title", "hello world")
    client.cmd("HSET", "doc:2", "price", "99", "title", "hello")
    res = client.cmd(
        "EVAL", _lua_call("FT.SEARCH", "idx", "@price:[40 50] @title:hello"),
        "0",
    )
    assert res[0] == 1 and res[1] == b"doc:1"
    agg = client.cmd(
        "EVAL",
        "return redis.call('FT.AGGREGATE', 'idx', '@price:[5 50]', "
        "'LOAD', '1', 'price')",
        "0",
    )
    assert agg[0] == 1
    assert client.cmd(
        "EVAL", _lua_call("FT.DROPINDEX", "idx"), "0",
    ) == "OK"
    assert client.cmd("FT._LIST") == []


def test_eval_keys_argv_and_atomicity(client):
    r = client.cmd(
        "EVAL",
        "redis.call('HSET', KEYS[1], 'f', ARGV[1])\n"
        "redis.call('HSET', KEYS[2], 'f', ARGV[2])\n"
        "return redis.call('HGET', KEYS[2], 'f')",
        "2", "ka", "kb", "va", "vb",
    )
    assert r == b"vb"
    assert client.cmd("HGET", "ka", "f") == b"va"
    # an error mid-script aborts and surfaces (applied writes stay — redis
    # scripts are not rolled back)
    with pytest.raises(ReplyError):
        client.cmd(
            "EVAL",
            "redis.call('HSET', KEYS[1], 'f', 'x')\n"
            "redis.call('NOSUCHCMD')\n"
            "redis.call('HSET', KEYS[1], 'f', 'y')",
            "1", "kc",
        )
    assert client.cmd("HGET", "kc", "f") == b"x"


def test_eval_literal_returns_and_locals(client):
    assert client.cmd("EVAL", "return 42", "0") == 42
    assert client.cmd("EVAL", "return 3.7", "0") == 3  # Lua truncation
    assert client.cmd("EVAL", "return 'pong'", "0") == b"pong"
    assert client.cmd("EVAL", "return ARGV[1]", "0", "zz") == b"zz"
    client.cmd("HSET", "h", "f", "deep")
    assert client.cmd(
        "EVAL",
        "local v = redis.call('HGET', KEYS[1], 'f')\nreturn v",
        "1", "h",
    ) == b"deep"
    assert client.cmd(
        "EVAL", "return redis.status_reply('GOOD')", "0",
    ) == "GOOD"
    with pytest.raises(ReplyError, match="boom"):
        client.cmd("EVAL", "return redis.error_reply('boom')", "0")


def test_eval_real_lua_control_flow(client):
    # loop writes, conditional reads, table construction through cjson
    client.cmd(
        "EVAL",
        "for i=1,5 do redis.call('HSET', 'it:'..i, 'n', tostring(i)) end",
        "0",
    )
    assert client.cmd("HGET", "it:4", "n") == b"4"
    out = client.cmd(
        "EVAL",
        "local t = {}\n"
        "for i=1,5 do\n"
        "  local v = redis.call('HGET', 'it:'..i, 'n')\n"
        "  if tonumber(v) % 2 == 1 then table.insert(t, v) end\n"
        "end\n"
        "return cjson.encode(t)",
        "0",
    )
    assert out == b'["1","3","5"]'
    # pcall survives a command error and the script keeps running
    assert client.cmd(
        "EVAL",
        "local e = redis.pcall('NOSUCHCMD')\n"
        "if e.err then return 'caught' end return 'missed'",
        "0",
    ) == b"caught"
    # string library against reply data
    client.cmd("HSET", "s", "csv", "a,b,c")
    assert client.cmd(
        "EVAL",
        "local v = redis.call('HGET', KEYS[1], 'csv')\n"
        "local parts = {}\n"
        "for w in string.gmatch(v, '[^,]+') do parts[#parts+1] = w end\n"
        "return #parts",
        "1", "s",
    ) == 3


def test_eval_step_budget(client):
    with pytest.raises(ReplyError, match="instruction budget"):
        client.cmd("EVAL", "while true do end", "0")
    # the connection stays usable afterwards
    assert client.cmd("EVAL", "return 1", "0") == 1


def test_eval_sandbox(client):
    with pytest.raises(ReplyError, match="nil"):
        client.cmd("EVAL", "os.execute('rm -rf /tmp/x')", "0")
    with pytest.raises(ReplyError, match="not allowed from script"):
        client.cmd("EVAL", "redis.call('EVAL', 'return 1', '0')", "0")


def test_script_load_evalsha(server, client):
    sha = client.cmd("SCRIPT", "LOAD", "return redis.call('DBSIZE')")
    sha = sha.decode() if isinstance(sha, bytes) else sha
    assert len(sha) == 40
    assert client.cmd("SCRIPT", "EXISTS", sha, "0" * 40) == [1, 0]
    assert client.cmd("EVALSHA", sha, "0") == 0
    client.cmd("HSET", "k", "f", "v")
    assert client.cmd("EVALSHA", sha, "0") == 1
    with pytest.raises(ReplyError, match="NOSCRIPT"):
        client.cmd("EVALSHA", "f" * 40, "0")
    # malformed Lua refused at LOAD time, not silently stored
    with pytest.raises(ReplyError, match="parse error"):
        client.cmd("SCRIPT", "LOAD", "return 1 +")
    client.cmd("SCRIPT", "FLUSH")
    assert client.cmd("SCRIPT", "EXISTS", sha) == [0]
    # compiled ASTs are dropped too (the AST cache accumulated
    # unboundedly across flush cycles)
    assert getattr(server, "_script_ast_cache", {}) == {}


def test_eval_writes_reach_replication_stream(server, client):
    seen = []
    server.write_observer = lambda argv, db=0: seen.append(
        [bytes(a) if not isinstance(a, bytes) else a for a in argv]
    )
    client.cmd("EVAL", "redis.call('HSET', KEYS[1], 'f', 'v')", "1", "rk")
    assert [b"HSET", b"rk", b"f", b"v"] in seen
    # loop writes land once per applied command, in order
    seen.clear()
    client.cmd(
        "EVAL",
        "for i=1,3 do redis.call('HSET', 'lk:'..i, 'f', tostring(i)) end",
        "0",
    )
    hsets = [a for a in seen if a[0] == b"HSET"]
    assert [a[1] for a in hsets] == [b"lk:1", b"lk:2", b"lk:3"]


def test_eval_single_slot_restriction_cluster():
    """CME mode: a script touching FT.SEARCH must target a single-slot
    ({hash-tagged}) index owned locally (reference TestMultiLuaCME)."""
    from valkey_search_tpu.cluster.transport import (
        NodeServer, RespConnection, assign_slot_ranges,
    )
    from valkey_search_tpu.cluster.transport import ReplyError as TReplyError

    nodes = [NodeServer(f"s{i}", port=0) for i in range(2)]
    for (lo, hi), n in zip(assign_slot_ranges(2), nodes):
        n.slots = (lo, hi)
    for n in nodes:
        n.resp.start()
    try:
        c = RespConnection(("127.0.0.1", nodes[0].port))
        c.cmd("FT.CREATE", "fanidx", "ON", "HASH", "SCHEMA", "t", "TAG")
        with pytest.raises(TReplyError, match="single-slot"):
            c.cmd("EVAL", _lua_call("FT.SEARCH", "fanidx", "@t:{x}"), "0")
        c.close()
    finally:
        for n in nodes:
            n.close()
