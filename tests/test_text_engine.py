"""Text engine tests: postings, matchers, field masks, and e2e FT.SEARCH.

Mirrors reference testing/text_test.cc + posting_test.cc +
integration text-search coverage (SURVEY.md §4)."""

import numpy as np
import pytest

from valkey_search_tpu.query.predicate import TextPredicate
from valkey_search_tpu.schema.index_schema import IndexSchema
from valkey_search_tpu.server.engine import Engine
from valkey_search_tpu.text.posting import Postings


# -- postings -----------------------------------------------------------------

def test_postings_field_masks():
    p = Postings()
    p.add(1, 0, 0b01)
    p.add(1, 0, 0b10)   # same position seen by second field -> mask union
    p.add(1, 3, 0b01)
    p.add(2, 5, 0b10)
    assert p.key_count() == 2
    assert p.position_count() == 3
    assert sorted(p.docs()) == [1, 2]
    assert sorted(p.docs(0b01)) == [1]
    assert sorted(p.docs(0b10)) == [1, 2]
    assert p.positions(1, 0b01) == [0, 3]
    assert p.positions(1, 0b10) == [0]
    p.remove_field(1, 0b01)
    assert p.positions(1, 0b10) == [0]
    assert not p.contains(1, 0b01)
    p.remove_doc(2)
    assert p.key_count() == 1


# -- schema-level engine --------------------------------------------------------

@pytest.fixture()
def schema():
    s = IndexSchema("t", prefixes=("d:",))
    s.add_text_attribute("title")
    s.add_text_attribute("body")
    s.upsert("d:1", {"title": "The quick brown fox", "body": "jumps over lazy dogs"})
    s.upsert("d:2", {"title": "Quick brown foxes run", "body": "running quickly away"})
    s.upsert("d:3", {"title": "slow red turtle", "body": "the turtle naps"})
    return s


def _docs(schema, pred):
    eng = schema.text_engine
    return {schema.interner.key_of(d) for d in eng.fetch_ids(pred)}


def test_term_exact(schema):
    assert _docs(schema, TextPredicate("brown")) == {"d:1", "d:2"}
    assert _docs(schema, TextPredicate("turtle")) == {"d:3"}
    assert _docs(schema, TextPredicate("missing")) == set()


def test_term_stemming_bidirectional(schema):
    # query 'run' matches docs with 'run' or 'running' (stem tree)
    assert _docs(schema, TextPredicate("run")) == {"d:2"}
    # query inflected form matches the base form too
    assert _docs(schema, TextPredicate("runs")) == {"d:2"}
    assert _docs(schema, TextPredicate("foxes")) == {"d:1", "d:2"}
    assert _docs(schema, TextPredicate("fox")) == {"d:1", "d:2"}


def test_term_field_scoped(schema):
    assert _docs(schema, TextPredicate("quick", field="title")) == {"d:1", "d:2"}
    # 'quickly' stems to quick — body field of d:2
    assert _docs(schema, TextPredicate("quick", field="body")) == {"d:2"}
    assert _docs(schema, TextPredicate("turtle", field="title")) == {"d:3"}


def test_stop_word_term_matches_nothing(schema):
    assert _docs(schema, TextPredicate("the")) == set()


def test_prefix(schema):
    assert _docs(schema, TextPredicate("qui", match="prefix")) == {"d:1", "d:2"}
    assert _docs(schema, TextPredicate("turt", match="prefix")) == {"d:3"}
    assert _docs(schema, TextPredicate("zzz", match="prefix")) == set()


def test_suffix_and_infix(schema):
    assert _docs(schema, TextPredicate("own", match="suffix")) == {"d:1", "d:2"}
    assert _docs(schema, TextPredicate("urtl", match="infix")) == {"d:3"}


def test_fuzzy(schema):
    assert _docs(schema, TextPredicate("quack", match="fuzzy", distance=1)) == \
        {"d:1", "d:2"}
    assert _docs(schema, TextPredicate("qxack", match="fuzzy", distance=1)) == set()
    assert _docs(schema, TextPredicate("qxack", match="fuzzy", distance=2)) == \
        {"d:1", "d:2"}


def test_phrase_exact_order(schema):
    p = TextPredicate("", match="phrase", phrase=("quick", "brown"))
    assert _docs(schema, p) == {"d:1", "d:2"}
    # wrong order: no match with inorder (default)
    p2 = TextPredicate("", match="phrase", phrase=("brown", "quick"))
    assert _docs(schema, p2) == set()
    # non-adjacent words need slop
    p3 = TextPredicate("", match="phrase", phrase=("quick", "fox"))
    assert _docs(schema, p3) == set()
    p4 = TextPredicate("", match="phrase", phrase=("quick", "fox"), slop=1)
    assert _docs(schema, p4) == {"d:1", "d:2"}  # quick _ fox / quick _ foxes


def test_phrase_unordered_slop(schema):
    p = TextPredicate("", match="phrase", phrase=("brown", "quick"),
                      slop=0, inorder=False)
    assert _docs(schema, p) == {"d:1", "d:2"}


def test_phrase_stop_words_dropped(schema):
    # "the quick" — 'the' was never indexed; phrase reduces to 'quick'
    p = TextPredicate("", match="phrase", phrase=("the", "quick"))
    assert _docs(schema, p) == {"d:1", "d:2"}


def test_phrase_cross_field_isolation(schema):
    # words in different fields must not form a phrase
    p = TextPredicate("", match="phrase", phrase=("fox", "jumps"))
    assert _docs(schema, p) == set()
    p_title = TextPredicate("", match="phrase", phrase=("brown", "fox"),
                            field="title")
    assert _docs(schema, p_title) == {"d:1", "d:2"}


def test_update_and_delete_cleanup(schema):
    schema.upsert("d:3", {"title": "green turtle", "body": "swims"})
    assert _docs(schema, TextPredicate("slow")) == set()
    assert _docs(schema, TextPredicate("green")) == {"d:3"}
    schema.delete("d:3")
    assert _docs(schema, TextPredicate("turtle")) == set()
    st = schema.text_engine.stats()
    assert st["docs_with_text"] == 2


def test_estimate_orders(schema):
    eng = schema.text_engine
    assert eng.estimate(TextPredicate("quick")) >= 2
    assert eng.estimate(TextPredicate("missing")) == 0


def test_no_stem_field():
    s = IndexSchema("t2")
    s.add_text_attribute("exact", no_stem=True)
    s.upsert("k1", {"exact": "running shoes"})
    # exact word matches
    assert _docs(s, TextPredicate("running", field="exact")) == {"k1"}
    # no stem expansion for a NOSTEM field
    assert _docs(s, TextPredicate("run", field="exact")) == set()


def test_nosuffixtrie_field_suffix_search_errors():
    """Reference parity (docs/topics/search-query.md): a field-scoped
    suffix search against a NOSUFFIXTRIE field errors rather than falling
    back to a dictionary scan (round-1 extension removed)."""
    s = IndexSchema("t3")
    s.add_text_attribute("a", with_suffix_trie=False)
    s.upsert("k1", {"a": "wonderful"})
    with pytest.raises(ValueError, match="WITHSUFFIXTRIE"):
        _docs(s, TextPredicate("ful", match="suffix", field="a"))


def test_max_text_fields_limit():
    from valkey_search_tpu.text.text_index import MAX_TEXT_FIELDS

    s = IndexSchema("t4")
    for i in range(MAX_TEXT_FIELDS):
        s.add_text_attribute(f"f{i}")
    with pytest.raises(ValueError):
        s.add_text_attribute("overflow")


# -- e2e through the command surface --------------------------------------------

@pytest.fixture()
def text_eng():
    e = Engine()
    e.execute(
        "FT.CREATE", "docs", "ON", "HASH", "PREFIX", "1", "b:",
        "SCHEMA", "title", "TEXT", "body", "TEXT", "year", "NUMERIC",
    )
    e.hset("b:1", {"title": "Snow Crash", "body": "a sword fighting hacker", "year": "1992"})
    e.hset("b:2", {"title": "Crash Override", "body": "hackers hacking code", "year": "1995"})
    e.hset("b:3", {"title": "Quiet Winter", "body": "snow falls on cedars", "year": "1994"})
    return e


def _keys(reply):
    # NOCONTENT reply: [count, key1, key2, ...]
    return set(reply[1:])


def test_ft_search_text_term(text_eng):
    r = text_eng.execute("FT.SEARCH", "docs", "crash", "NOCONTENT")
    assert r[0] == 2 and _keys(r) == {"b:1", "b:2"}


def test_ft_search_text_field_scoped(text_eng):
    r = text_eng.execute("FT.SEARCH", "docs", "@title:snow", "NOCONTENT")
    assert _keys(r) == {"b:1"}
    r2 = text_eng.execute("FT.SEARCH", "docs", "@body:snow", "NOCONTENT")
    assert _keys(r2) == {"b:3"}


def test_ft_search_text_stemmed(text_eng):
    # hackers ~ hacker (both stem to 'hacker'); hacking ~ hack
    r = text_eng.execute("FT.SEARCH", "docs", "hackers", "NOCONTENT")
    assert _keys(r) == {"b:1", "b:2"}
    r2 = text_eng.execute("FT.SEARCH", "docs", "hack", "NOCONTENT")
    assert _keys(r2) == {"b:2"}


def test_ft_search_phrase(text_eng):
    r = text_eng.execute("FT.SEARCH", "docs", '"sword fighting"', "NOCONTENT")
    assert _keys(r) == {"b:1"}
    r2 = text_eng.execute("FT.SEARCH", "docs", '"fighting sword"', "NOCONTENT")
    assert r2[0] == 0


def test_ft_search_prefix_and_fuzzy(text_eng):
    r = text_eng.execute("FT.SEARCH", "docs", "hack*", "NOCONTENT")
    assert _keys(r) == {"b:1", "b:2"}
    r2 = text_eng.execute("FT.SEARCH", "docs", "%crish%", "NOCONTENT")
    assert _keys(r2) == {"b:1", "b:2"}


def test_ft_search_text_and_numeric(text_eng):
    r = text_eng.execute(
        "FT.SEARCH", "docs", "crash @year:[1993 2000]", "NOCONTENT"
    )
    assert _keys(r) == {"b:2"}


def test_ft_search_negate_text(text_eng):
    r = text_eng.execute("FT.SEARCH", "docs", "-crash", "NOCONTENT")
    assert _keys(r) == {"b:3"}


def test_nostem_field_removal_keeps_stem_links():
    """Regression: removing a NOSTEM field whose word is also
    indexed in a stemmed field must NOT eat the stem refcount — stem
    expansion (@a:run matching 'running') must survive the removal.
    Exercised against both the native C++ index and the Python fallback."""
    from valkey_search_tpu.server.ft_create import parse_ft_create

    for force_python in (False, True):
        schema, _ = parse_ft_create(
            ["dx", "ON", "HASH", "PREFIX", "1", "d:",
             "SCHEMA", "a", "TEXT", "b", "TEXT", "NOSTEM"]
        )
        if force_python:
            schema.text_engine._nt = None
        else:
            assert schema.text_engine._nt is not None
        # 'running' lives in a stemmed field (links stem 'run') AND in a
        # NOSTEM field of other docs (which must not touch the link)
        schema.upsert("d:1", {"a": "running fast"})
        schema.upsert("d:2", {"b": "running shoes"})
        schema.upsert("d:3", {"b": "running water"})

        def hits(pred):
            return {schema.interner.key_of(d)
                    for d in schema.text_engine.fetch_ids(pred)}

        assert hits(TextPredicate("run", field="a")) == {"d:1"}
        # delete the NOSTEM docs — with the bug this drove the 'run' stem
        # refcount to zero and dropped the stem->word mapping
        schema.delete("d:2")
        schema.delete("d:3")
        assert hits(TextPredicate("run", field="a")) == {"d:1"}, (
            "python" if force_python else "native")
        # and the update path: overwrite a NOSTEM field that shared a word
        schema.upsert("d:4", {"b": "running club"})
        schema.upsert("d:4", {"b": "walking club"})
        assert hits(TextPredicate("run", field="a")) == {"d:1"}


def test_native_vs_python_text_engines_agree():
    """Differential check: the C++ text index (native/text_index.cpp) and
    the pure-Python structures must give identical answers for every
    matcher kind across a randomized workload with updates + deletes."""
    import numpy as np

    from valkey_search_tpu.query.predicate import TextPredicate
    from valkey_search_tpu.schema.index_schema import IndexSchema
    from valkey_search_tpu.server.ft_create import parse_ft_create

    rng = np.random.default_rng(77)
    vocab = ["running", "runner", "jumped", "jumping", "quick", "quickly",
             "form", "formal", "formality", "zebra", "apple", "apply",
             "banana", "band", "bandit"]

    def make_schema():
        schema, _ = parse_ft_create(
            ["dx", "ON", "HASH", "PREFIX", "1", "d:",
             "SCHEMA", "a", "TEXT", "b", "TEXT", "NOSTEM"]
        )
        return schema

    s_native = make_schema()
    s_py = make_schema()
    assert s_native.text_engine._nt is not None, "native index unavailable"
    # force the fallback on the second engine
    s_py.text_engine._nt = None

    ops = []
    for i in range(300):
        doc = f"d:{rng.integers(0, 60)}"
        if rng.random() < 0.15:
            ops.append(("del", doc))
        else:
            words_a = " ".join(rng.choice(vocab, rng.integers(1, 6)))
            words_b = " ".join(rng.choice(vocab, rng.integers(1, 4)))
            ops.append(("up", doc, {"a": words_a, "b": words_b}))
    for op in ops:
        for s in (s_native, s_py):
            if op[0] == "del":
                s.delete(op[1])
            else:
                s.upsert(op[1], op[2])

    preds = []
    for w in ("run", "running", "form", "quick", "zebra", "missing"):
        preds.append(TextPredicate(w))
        preds.append(TextPredicate(w, field="a"))
        preds.append(TextPredicate(w, field="b"))
    for p in ("ru", "form", "ba", "q"):
        preds.append(TextPredicate(p, match="prefix"))
    preds.append(TextPredicate("ning", match="suffix"))
    preds.append(TextPredicate("an", match="infix"))
    preds.append(TextPredicate("runing", match="fuzzy", distance=1))
    # phrases ride the native tix_phrase_docs fast path vs the Python
    # position walk — cover slop/inorder variants and 3-word shapes
    for slop, inorder in ((0, True), (1, True), (0, False), (2, False)):
        preds.append(TextPredicate("", match="phrase",
                                   phrase=("quick", "jumped"),
                                   slop=slop, inorder=inorder))
        preds.append(TextPredicate("", match="phrase", field="a",
                                   phrase=("running", "quick"),
                                   slop=slop, inorder=inorder))
        preds.append(TextPredicate("", match="phrase",
                                   phrase=("banana", "band", "apple"),
                                   slop=slop, inorder=inorder))

    for pred in preds:
        e_n, e_p = s_native.text_engine, s_py.text_engine
        got = set(int(x) for x in e_n._doc_ids_sorted(e_n._effective(pred)))
        want = set(int(x) for x in e_p._doc_ids_sorted(
            e_p._effective(pred)))
        assert got == want, (pred.match, pred.term, got ^ want)
        assert e_n.estimate(pred) == e_p.estimate(pred), (
            pred.match, pred.term)
        for doc in list(got)[:5]:
            assert e_n.doc_matches(pred, doc)
    # stats agreement on the structural counters
    st_n, st_p = s_native.text_engine.stats(), s_py.text_engine.stats()
    for key in ("distinct_words", "docs_with_text", "stem_entries"):
        assert st_n[key] == st_p[key], (key, st_n[key], st_p[key])


def test_event_buffer_overflow_keeps_dictionary_mirror():
    """A single doc introducing more new unique words than the 64KiB
    native event buffer holds: the retry must FETCH the recorded events
    (tix_last_events), not re-execute — a re-run emits no '+word' births
    for postings created by the first pass, silently desyncing the
    radix/suffix mirrors (code-review r2 finding)."""
    from valkey_search_tpu.server.engine import Engine

    e = Engine()
    e.execute("FT.CREATE", "big", "ON", "HASH", "PREFIX", "1", "bg:",
              "SCHEMA", "body", "TEXT")
    words = [f"zqword{i:06d}" for i in range(7000)]  # ~13 bytes/event
    e.hset("bg:1", {"body": " ".join(words)})
    schema = e.manager.get("big")
    te = schema.text_engine
    # every word must exist in the python dictionary mirror
    assert len(te._words) >= 7000
    # prefix query resolves through the radix tree
    r = e.ft_search("big", "@body:zqword00*", "NOCONTENT")
    assert r[0] == 1 and str(r[1]) == "bg:1"
    # update shrinking the doc must emit the deaths too
    e.hset("bg:1", {"body": "zqword000001 alone"})
    r = e.ft_search("big", "@body:zqword00345*", "NOCONTENT")
    assert r[0] == 0
    assert "zqword003450" not in te._words


def test_word_death_then_rebirth_in_one_update():
    """Regression: a doc update that removes a word's LAST posting and
    re-adds the same word in the new content emits '-word' then '+word'
    in ONE native event blob; the mirror must apply removals before
    additions or the word vanishes from the radix/suffix trees forever
    (term, prefix, and suffix queries all went permanently empty, and
    even brand-new docs containing the word never matched again)."""
    e = Engine(sync_ingest=True)
    e.execute("FT.CREATE", "idx", "SCHEMA", "content", "TEXT")
    e.hset("doc:1", {"content": "hello world"})
    assert e.ft_search("idx", "@content:hello", "NOCONTENT")[0] == 1
    # 'hello' dies (doc:1 was its only posting) and is reborn at pos 1
    e.hset("doc:1", {"content": "updated hello"})
    assert e.ft_search("idx", "@content:hello", "NOCONTENT")[0] == 1
    assert e.ft_search("idx", "@content:hel*", "NOCONTENT")[0] == 1
    # the dictionary must keep serving the word for new docs too
    e.hset("doc:2", {"content": "hello two"})
    assert e.ft_search("idx", "@content:hello", "NOCONTENT")[0] == 2
    # true death still removes it...
    e.hset("doc:1", {"content": "bye"})
    e.hset("doc:2", {"content": "gone"})
    assert e.ft_search("idx", "@content:hello", "NOCONTENT")[0] == 0
    # ...and a later rebirth resurrects it
    e.hset("doc:1", {"content": "hello again"})
    assert e.ft_search("idx", "@content:hello", "NOCONTENT")[0] == 1
    assert e.ft_search("idx", "@content:*ello", "NOCONTENT")[0] == 1


def test_suffix_search_on_nosuffixtrie_field_errors():
    """Field-scoped suffix search against a NOSUFFIXTRIE field errors
    (docs/topics/search-query.md suffix matching note); unscoped and
    trie-enabled fields still serve."""
    from valkey_search_tpu.server.engine import Engine

    e = Engine(sync_ingest=True)
    e.execute("FT.CREATE", "sfx", "SCHEMA",
              "a", "TEXT", "NOSUFFIXTRIE", "b", "TEXT")
    e.hset("k1", {"a": "ohello", "b": "whello"})
    with pytest.raises(Exception, match="WITHSUFFIXTRIE"):
        e.execute("FT.SEARCH", "sfx", "@a:*hello")
    assert e.execute("FT.SEARCH", "sfx", "@b:*hello", "NOCONTENT")[0] == 1
    # unscoped suffix search stays available (searches trie-enabled fields)
    assert e.execute("FT.SEARCH", "sfx", "*hello", "NOCONTENT")[0] == 1


class TestNativeExpansion:
    """tix_expand / tix_docs_union_expand parity with the Python radix
    walks, including word-death liveness and the max_exp cap order."""

    def _build(self, n_docs=300):
        import numpy as np

        s = IndexSchema("nx", prefixes=("d:",))
        s.add_text_attribute("body")
        rng = np.random.default_rng(3)
        vocab = [f"app{i:03d}" for i in range(40)] + [
            f"net{i:03d}" for i in range(40)
        ] + ["running", "runner", "runs", "apple", "applied", "nets"]
        for i in range(n_docs):
            words = rng.choice(vocab, size=6)
            s.upsert(f"d:{i}", {"body": " ".join(words)})
        return s

    def _python_expand(self, eng, pred):
        nt = eng._nt
        try:
            eng._nt = None
            return eng.expand_words(pred)
        finally:
            eng._nt = nt

    @pytest.mark.parametrize("pred", [
        TextPredicate("app", match="prefix"),
        TextPredicate("net0", match="prefix"),
        TextPredicate("zzz", match="prefix"),
        TextPredicate("ing", match="suffix"),
        TextPredicate("s", match="suffix"),
        TextPredicate("pp", match="infix"),
        TextPredicate("runing", match="fuzzy", distance=1),
        TextPredicate("aple", match="fuzzy", distance=2),
    ])
    def test_expand_matches_python_walk(self, pred):
        s = self._build()
        eng = s.text_engine
        assert eng._nt is not None
        native = eng.expand_words(pred)
        python = self._python_expand(eng, pred)
        assert native == python

    def test_fused_union_matches_per_word_union(self):
        s = self._build()
        eng = s.text_engine
        for pred in (TextPredicate("app", match="prefix"),
                     TextPredicate("ing", match="suffix"),
                     TextPredicate("et0", match="infix"),
                     TextPredicate("runing", match="fuzzy", distance=1)):
            fused = set(eng._doc_ids_sorted(pred).tolist())
            words = self._python_expand(eng, pred)
            mask = eng.field_mask(pred.field)
            manual = set(eng._nt.docs_union(words, mask).tolist())
            assert fused == manual

    def test_dead_words_not_expanded(self):
        s = IndexSchema("nx2", prefixes=("d:",))
        s.add_text_attribute("body")
        s.upsert("d:1", {"body": "zebra zealot"})
        s.upsert("d:2", {"body": "zebra only"})
        eng = s.text_engine
        assert set(eng.expand_words(TextPredicate("ze", match="prefix"))) == {
            "zebra", "zealot"
        }
        s.delete("d:1")  # zealot dies; zebra survives via d:2
        assert eng.expand_words(TextPredicate("ze", match="prefix")) == [
            "zebra"
        ]
        docs = eng._doc_ids_sorted(TextPredicate("ze", match="prefix"))
        assert len(docs) == 1

    def test_max_exp_cap_selects_same_words(self):
        from valkey_search_tpu.runtime import config

        s = self._build()
        eng = s.text_engine
        config.set_config("search.max-term-expansions", 7)
        try:
            pred = TextPredicate("app", match="prefix")
            assert eng.expand_words(pred) == self._python_expand(eng, pred)
            assert len(eng.expand_words(pred)) == 7
        finally:
            config.set_config("search.max-term-expansions", 200)


def test_phrase_native_merge_matches_python_oracle():
    """Differential fuzz of the native merge-driven phrase intersection
    (phrase_docs_merge, native/text_index.cpp) against the Python
    positional oracle across random corpora, slop, order, field scoping,
    and 2-3 slot phrases (guards the round-5 leapfrog rewrite)."""
    rng = np.random.default_rng(77)
    vocab = [f"t{i}" for i in range(12)]  # tiny vocab: dense collisions
    s = IndexSchema("pf", prefixes=("p:",))
    s.add_text_attribute("a")
    s.add_text_attribute("b")
    for i in range(300):
        wa = " ".join(vocab[w] for w in rng.integers(0, 12, size=8))
        wb = " ".join(vocab[w] for w in rng.integers(0, 12, size=6))
        s.upsert(f"p:{i}", {"a": wa, "b": wb})
    te = s.text_engine
    assert te._nt is not None  # the native path must be what we test
    checked = 0
    for _ in range(120):
        n_slots = int(rng.integers(2, 4))
        words = tuple(vocab[w] for w in rng.integers(0, 12, size=n_slots))
        pred = TextPredicate(
            "" if rng.random() < 0.5 else ("a" if rng.random() < 0.5
                                           else "b"),
            match="phrase", phrase=words,
            slop=int(rng.integers(0, 3)),
            inorder=bool(rng.random() < 0.5),
        )
        mask = te.field_mask(pred.field)
        native = set(te._phrase_doc_ids(pred, mask).tolist())
        oracle = te._phrase_docs(pred, mask)
        assert native == oracle, (words, pred.slop, pred.inorder,
                                  pred.field, len(native), len(oracle))
        checked += 1
    assert checked == 120
