"""FT._DEBUG pausepoints/controlled vars, ACL prefix checks, INFO registry.

Mirrors reference vmsdk debug.h + acl_test.cc + info-field coverage
(SURVEY.md §2.1/§2.6/§5.5)."""

import os
import threading
import time

import pytest

from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.debug import CONTROLLED, PAUSEPOINTS, reset_all
from valkey_search_tpu.runtime.info import REGISTRY as INFO, format_si_bytes
from valkey_search_tpu.server.acl import AclError, AclManager
from valkey_search_tpu.server.engine import Engine


@pytest.fixture(autouse=True)
def _clean_debug():
    reset_all()
    yield
    reset_all()
    config.REGISTRY.reset_all()


# -- pausepoints -----------------------------------------------------------------

def test_pausepoint_blocks_and_releases():
    PAUSEPOINTS.pause("pt")
    hit = threading.Event()
    done = threading.Event()

    def worker():
        hit.set()
        PAUSEPOINTS.test("pt")
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    hit.wait(2)
    time.sleep(0.05)
    assert not done.is_set()
    assert PAUSEPOINTS.waiting("pt") == 1
    PAUSEPOINTS.resume("pt")
    assert done.wait(2)
    assert PAUSEPOINTS.waiting("pt") == 0


def test_pausepoint_freezes_async_ingest():
    config.set_config("search.debug-mode", True)
    e = Engine(sync_ingest=False)
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "t", "TAG")
    e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "ingest.before_apply")
    e.hset("k:1", {"t": "a"})
    # mutation is parked: not yet visible
    deadline = time.time() + 2
    while time.time() < deadline and PAUSEPOINTS.waiting("ingest.before_apply") == 0:
        time.sleep(0.01)
    assert PAUSEPOINTS.waiting("ingest.before_apply") == 1
    assert e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0] == 0
    e.execute("FT._DEBUG", "PAUSEPOINT", "RESET", "ingest.before_apply")
    e.drain()
    assert e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT") == [1, "k:1"]


def test_ft_debug_requires_debug_mode():
    e = Engine()
    with pytest.raises(Exception):
        e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "x")


def test_controlled_variables_roundtrip():
    config.set_config("search.debug-mode", True)
    e = Engine()
    assert e.execute("FT._DEBUG", "CONTROLLED_VARIABLE", "SET", "force_x", "true") == "OK"
    assert e.execute("FT._DEBUG", "CONTROLLED_VARIABLE", "GET", "force_x") == "true"
    assert CONTROLLED.is_true("force_x")
    lst = e.execute("FT._DEBUG", "CONTROLLED_VARIABLE", "LIST")
    assert lst == ["force_x", "true"]


def test_ft_debug_inspection_commands():
    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "t", "TAG", "title", "TEXT")
    e.hset("k:1", {"t": "a", "title": "hello world"})
    show = e.execute("FT._DEBUG", "SHOW_INDEX", "i")
    d = dict(zip(show[::2], show[1::2]))
    assert d["name"] == "i" and d["num_docs"] == 1
    assert d["text_distinct_words"] == 2
    pool = e.execute("FT._DEBUG", "STRING_POOL_STATS")
    pd = dict(zip(pool[::2], pool[1::2]))
    assert pd["interned_keys"] == 1 and pd["keyspace_keys"] == 1
    metrics = e.execute("FT._DEBUG", "METRICS")
    assert "mutations_enqueued" in metrics or len(metrics) >= 0
    cfg = e.execute("FT._DEBUG", "CONFIG")
    cd = dict(zip(cfg[::2], cfg[1::2]))
    assert "search.hnsw-block-size" in cd


def test_ft_debug_textinfo_showinfo_help():
    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "title", "TEXT")
    e.hset("k:1", {"title": "hello helping worlds"})
    e.hset("k:2", {"title": "hello again"})
    # PREFIX walk: both 'hello' and the stemmed-stored 'helping'
    rows = e.execute("FT._DEBUG", "TEXTINFO", "i", "PREFIX", "hel")
    words = {r[0]: r[1] for r in rows}
    assert words["hello"] == 2 and "helping" in words
    rows = e.execute("FT._DEBUG", "TEXTINFO", "i", "PREFIX", "hello",
                     "WITHKEYS", "WITHPOSITIONS")
    (w, cnt, keys), = [r for r in rows if r[0] == "hello"]
    assert cnt == 2 and [k for k, _ in keys] == ["k:1", "k:2"]
    assert keys[0][1] == [0]  # 'hello' at position 0 in k:1
    # SUFFIX walk over the reversed-word trie
    rows = e.execute("FT._DEBUG", "TEXTINFO", "i", "SUFFIX", "lo")
    assert any(r[0] == "hello" for r in rows)
    # STEM: 'helping' stems to 'help'
    st = e.execute("FT._DEBUG", "TEXTINFO", "i", "STEM", "help")
    sd = dict(zip(st[::2], st[1::2]))
    assert "helping" in sd.get("help", [])
    info = e.execute("FT._DEBUG", "SHOW_INFO")
    idict = dict(zip(info[::2], info[1::2]))
    assert "search_number_of_indexes" in idict or len(idict) > 10
    hp = e.execute("FT._DEBUG", "HELP")
    assert "FT._DEBUG SHOW_INFO" in hp


# -- ACL -------------------------------------------------------------------------

def test_acl_prefix_coverage_rules():
    acl = AclManager()
    acl.setuser("alice", "on", "~doc:*")
    acl.check_index_access("alice", ["doc:"])          # covered
    acl.check_index_access("alice", ["doc:sub:"])      # narrower is fine
    with pytest.raises(AclError):
        acl.check_index_access("alice", ["other:"])
    with pytest.raises(AclError):
        # index over ALL keys needs ~*
        acl.check_index_access("alice", [""])
    acl.setuser("alice", "allkeys")
    acl.check_index_access("alice", [""])


def test_acl_disabled_user():
    acl = AclManager()
    acl.setuser("bob", "off", "~*")
    with pytest.raises(AclError):
        acl.check_index_access("bob", ["doc:"])


def test_acl_enforced_on_commands():
    e = Engine()
    # categories must be granted explicitly (new users fail closed)
    e.acl.setuser("carol", "on", "~doc:*", "+@search")
    e.execute("FT.CREATE", "mine", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "t", "TAG", user="carol")
    e.hset("doc:1", {"t": "x"})
    assert e.execute("FT.SEARCH", "mine", "@t:{x}", "NOCONTENT",
                     user="carol")[0] == 1
    with pytest.raises(AclError):
        e.execute("FT.CREATE", "theirs", "ON", "HASH", "PREFIX", "1", "sec:",
                  "SCHEMA", "t", "TAG", user="carol")
    e.execute("FT.CREATE", "all", "ON", "HASH", "SCHEMA", "t", "TAG")
    with pytest.raises(AclError):
        e.execute("FT.SEARCH", "all", "@t:{x}", user="carol")
    # default user unaffected
    assert e.execute("FT.SEARCH", "all", "@t:{x}", "NOCONTENT")[0] == 1


# -- INFO ------------------------------------------------------------------------

def test_format_si_bytes():
    assert format_si_bytes(512) == "512B"
    assert format_si_bytes(2048) == "2.00KiB"
    assert format_si_bytes(3 * 1024 * 1024) == "3.00MiB"


def test_info_fields(rng):
    import numpy as np

    e = Engine()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:",
              "SCHEMA", "v", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "L2")
    v = rng.standard_normal(8).astype(np.float32)
    e.hset("k:1", {"v": v.tobytes()})
    snap = e.info()
    assert snap["search_number_of_indexes"] == 1
    assert snap["search_total_indexed_documents"] == 1
    assert snap["search_keyspace_keys"] == 1
    assert snap["search_used_vector_bytes"].endswith("iB") or \
        snap["search_used_vector_bytes"].endswith("B")
    # dev fields hidden without debug mode
    assert "search_hnsw_graph_rebuilds" not in snap
    config.set_config("search.debug-mode", True)
    snap2 = e.info()
    assert "search_hnsw_graph_rebuilds" in snap2


def test_info_two_engines_do_not_alias():
    e1, e2 = Engine(), Engine()
    e1.execute("FT.CREATE", "a", "ON", "HASH", "SCHEMA", "t", "TAG")
    assert e1.info()["search_number_of_indexes"] == 1
    assert e2.info()["search_number_of_indexes"] == 0


def test_thread_cpu_monitor_samples_pools():
    import threading
    import time as _time

    from valkey_search_tpu.runtime.threadmon import (
        MONITOR,
        ThreadCpuMonitor,
        _pool_of,
    )

    assert _pool_of("reader-3") == "reader"
    assert _pool_of("gossip:n0") == "gossip"
    assert _pool_of("MainThread") == "MainThread"

    mon = ThreadCpuMonitor()
    stop = _time.monotonic() + 0.5

    def burn():
        x = 0
        while _time.monotonic() < stop:
            x += 1
        return x

    t = threading.Thread(target=burn, name="burner-0")
    t.start()
    _time.sleep(0.05)
    mon.sample()          # baseline with the thread alive
    _time.sleep(0.3)
    pct = mon.sample()    # delta while it burns
    t.join()
    assert pct.get("burner", 0) > 5.0, pct  # busy thread shows real CPU%
    # engine INFO carries the field
    from valkey_search_tpu.server.engine import Engine

    e = Engine()
    fields = e.info(include_dev=True)
    assert "search_thread_pool_cpu_percent" in fields


def test_ft_debug_reference_spelling_aliases():
    """Reference subcommand names (ft_debug.cc) work verbatim:
    SHOW_INDEXSCHEMAS, STRINGPOOLSTATS, LIST_METRICS, LIST_CONFIGS."""
    from valkey_search_tpu.server.engine import Engine

    e = Engine()
    e.execute("FT.CREATE", "dbg1", "ON", "HASH", "PREFIX", "1", "a:",
              "SCHEMA", "t", "TAG")
    e.execute("FT.CREATE", "dbg2", "ON", "HASH", "PREFIX", "1", "b:",
              "SCHEMA", "n", "NUMERIC")
    # SHOW_INDEXSCHEMAS: every schema listed as [name, stats] pairs
    out = e.execute("FT._DEBUG", "SHOW_INDEXSCHEMAS")
    names = out[0::2]
    assert "dbg1" in names and "dbg2" in names
    assert e.execute("FT._DEBUG", "STRINGPOOLSTATS")[0] == "interned_keys"
    m = e.execute("FT._DEBUG", "LIST_METRICS", "APP", "NAMES_ONLY")
    assert m and all(isinstance(x, str) for x in m)
    c = e.execute("FT._DEBUG", "LIST_CONFIGS")
    assert "search.maxmemory-policy" in c


def test_jaxinit_cache_dir_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins; without it the cache sits at the
    checkout's fixed .jax_cache."""
    from valkey_search_tpu.runtime import jaxinit

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxinit.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxinit.cache_dir() == os.path.join(root, ".jax_cache")
