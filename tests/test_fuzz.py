"""Fuzz: random query strings and argv vectors must raise typed errors or
return well-formed replies — never crash, hang, or corrupt state.

The reference gets this robustness from its depth/term-count limits and
typed status propagation (filter_parser depth limits, VMSDK status
macros); here the same contract is checked by hammering the public
surfaces with garbage."""

import random
import string

import numpy as np
import pytest

from valkey_search_tpu.query.parser import QuerySyntaxError, parse_query
from valkey_search_tpu.server.engine import CommandError, Engine

ALPHABET = string.ascii_letters + string.digits + " @${}[]()|\"'%*-:~!;,.\\<>=+&"


def _rand_text(rng, n):
    return "".join(rng.choice(ALPHABET) for _ in range(n))


def test_parse_query_never_crashes():
    rng = random.Random(1234)
    ok = err = 0
    for _ in range(3000):
        q = _rand_text(rng, rng.randrange(1, 60))
        try:
            parse_query(q, {"q": b"\x00" * 16, "p": "5"})
            ok += 1
        except (QuerySyntaxError, ValueError):
            err += 1
    # both outcomes occur; no other exception type escaped
    assert ok > 0 and err > 0


def test_engine_execute_garbage_argv():
    rng = random.Random(99)
    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "t", "TAG", "n", "NUMERIC", "title", "TEXT")
    e.hset("k:1", {"t": "a", "n": "1", "title": "hello world"})
    cmds = ["FT.SEARCH", "FT.AGGREGATE", "FT.INFO", "FT.CREATE",
            "FT.DROPINDEX", "FT._DEBUG", "HSET", "DEL", "EXPIRE", "TTL"]
    for _ in range(800):
        argv = [rng.choice(cmds)] + [
            _rand_text(rng, rng.randrange(1, 12))
            for _ in range(rng.randrange(0, 6))
        ]
        try:
            r = e.execute(*argv)
            if argv[0] == "FT.SEARCH" and isinstance(r, list) and r:
                assert isinstance(r[0], int) and r[0] >= 0
        except Exception as exc:
            # only typed errors may escape
            assert isinstance(exc, (ValueError, KeyError, PermissionError,
                                    TimeoutError)), type(exc)
    # the engine still works after the storm
    assert e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT") == [1, "k:1"]


def test_deep_nesting_bounded():
    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "SCHEMA", "t", "TAG")
    deep = "(" * 3000 + "@t:{a}" + ")" * 3000
    with pytest.raises(ValueError):
        e.execute("FT.SEARCH", "i", deep)


def test_huge_term_count_bounded():
    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "SCHEMA", "title", "TEXT")
    q = " ".join(f"w{i}" for i in range(5000))
    with pytest.raises(ValueError):
        e.execute("FT.SEARCH", "i", q)


def test_random_vector_blobs_rejected_cleanly(rng):
    e = Engine()
    e.execute("FT.CREATE", "v", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "emb", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "L2")
    r = random.Random(5)
    for i in range(100):
        blob = bytes(r.randrange(256) for _ in range(r.randrange(0, 64)))
        e.hset(f"k:{i}", {"emb": blob})  # wrong sizes → INVALID_DATA path
    good = rng.standard_normal(8).astype(np.float32)
    e.hset("k:good", {"emb": good.tobytes()})
    res = e.execute("FT.SEARCH", "v", "*=>[KNN 5 @emb $q]",
                    "PARAMS", "2", "q", good.tobytes(), "NOCONTENT")
    assert res[1] == "k:good"
    # only blobs that were exactly 32 bytes indexed; the rest dropped
    schema = e.manager.get("v")
    for key in schema.attribute("emb").index.tracked_keys():
        if key != "k:good":
            assert len(e.hgetall(key)["emb"]) == 32


def test_resp_wire_fuzz_never_kills_connection_handler():
    """Byte-level fuzz of the RESP parser over a real socket: random
    garbage, truncated frames, huge declared lengths, binary inline
    junk — the server must answer -ERR or drop the connection cleanly,
    then keep serving fresh connections (no RESP fuzz)."""
    import socket

    import numpy as np

    from valkey_search_tpu.server.engine import Engine
    from valkey_search_tpu.server.resp import RespServer

    srv = RespServer(Engine(), port=0).start()
    rng = np.random.default_rng(99)
    try:
        payloads = [
            b"*abc\r\n",
            b"*2\r\n$3\r\nfoo",              # truncated frame
            b"*1\r\n$-5\r\nx\r\n",           # negative bulk length
            b"*1\r\n$999999999999\r\n",      # absurd bulk length
            b"$5\r\nhello\r\n",              # bulk outside array
            b"\x00\xff\xfe garbage \r\n",
            b"*1000001\r\n",                 # multibulk cap
            b"PING extra args here\r\n",     # inline
            b"'unbalanced quote\r\n",
            b"*2\r\n$4\r\nHSET\r\n$100\r\nshort\r\n",  # length > payload
        ]
        for _ in range(30):
            payloads.append(bytes(rng.integers(0, 256, rng.integers(1, 200),
                                               dtype=np.uint8)))
        for p in payloads:
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            try:
                s.sendall(p)
                s.settimeout(2)
                try:
                    s.recv(4096)  # error reply or EOF — both fine
                except (socket.timeout, ConnectionResetError):
                    pass
            finally:
                s.close()
        # server still healthy for a well-formed client
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.sendall(b"*1\r\n$4\r\nPING\r\n")
        assert s.recv(64).startswith(b"+PONG")
        s.close()
    finally:
        srv.close()


def test_resp_pipelined_and_split_frames():
    """Pipelining + frames split at arbitrary byte boundaries parse
    identically (the reader must handle partial reads)."""
    import socket

    from valkey_search_tpu.server.engine import Engine
    from valkey_search_tpu.server.resp import RespServer

    srv = RespServer(Engine(), port=0).start()
    try:
        blob = (b"*1\r\n$4\r\nPING\r\n" * 3
                + b"*3\r\n$4\r\nHSET\r\n$2\r\nk1\r\n$1\r\nf\r\n")
        # ^ wrong arity HSET -> error reply, connection stays up
        for cut in (1, 3, 7, len(blob) - 2):
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            s.sendall(blob[:cut])
            import time as _t

            _t.sleep(0.02)
            s.sendall(blob[cut:])
            out = b""
            s.settimeout(2)
            while out.count(b"\r\n") < 4:
                out += s.recv(4096)
            assert out.count(b"+PONG") == 3
            assert b"-ERR" in out or b"wrong number" in out
            s.close()
    finally:
        srv.close()
