"""Golden-answer conformance harness.

The reference ships pickled Redisearch answers
(integration/compatibility/*.pickle.gz — SURVEY.md §4.2 calls them "the
conformance oracle the device build should reuse"). This harness loads the
reference's deterministic dataset generator (read at test time from the
read-only reference tree, never copied), feeds the same documents through
this engine, replays each recorded command, and compares results
order-insensitively with numeric tolerance — this file's comparison logic
is an independent implementation of the same contract the reference's
compatibility_test.py enforces.
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import math
import pickle
import sys
import types
from typing import Dict, List, Optional, Tuple

REF_COMPAT = "/root/reference/integration/compatibility"

_ds_module = None


def load_ref_data_sets():
    """Import the reference's dataset generator (stubs its valkey import)."""
    global _ds_module
    if _ds_module is not None:
        return _ds_module
    sys.modules.setdefault("valkey", types.ModuleType("valkey"))
    spec = importlib.util.spec_from_file_location(
        "ref_data_sets", f"{REF_COMPAT}/data_sets.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _ds_module = mod
    return mod


def load_answers(name: str) -> List[dict]:
    with gzip.open(f"{REF_COMPAT}/{name}") as f:
        data = pickle.load(f)
    return data["answers"] if isinstance(data, dict) else data


def build_engine(data_set_name: str, key_type: str, schema_type: str):
    """Engine loaded with the reference dataset (text pickles)."""
    from valkey_search_tpu.server.engine import Engine

    ds = load_ref_data_sets()
    data = ds.compute_text_data_sets(
        data_set_name, seed=123, schema_type=schema_type
    )[data_set_name]
    eng = Engine()
    for create in data[f"{key_type} creates"]:
        eng.execute(*create.split(" "))
    for key, fields in data[f"{key_type} sets"]:
        if key_type == "hash":
            eng.hset(key, {k: str(v) for k, v in fields.items()})
        else:
            eng.json_set(key, "$", json.dumps(fields))
    return eng


def _s(v) -> str:
    if isinstance(v, bytes):
        return v.decode(errors="surrogateescape")  # vector blobs compare raw
    return str(v)


def _rows_from_search_reply(reply: list) -> Tuple[int, Dict[str, Dict[str, str]]]:
    """[count, key, [sortkey,] fields, ...] → (count, {key: fields}).

    Sort keys (WITHSORTKEYS triplet format, detected like the reference's
    result_has_sortkeys) are skipped — the reference harness drops them
    too (unpack_search_result, compatibility_test.py:138)."""
    count = int(reply[0])
    rows: Dict[str, Dict[str, str]] = {}
    i = 1
    while i < len(reply):
        key = _s(reply[i])
        i += 1
        # optional sortkey: a non-list scalar followed by a fields list
        if (
            i + 1 < len(reply)
            and not isinstance(reply[i], (list, tuple))
            and isinstance(reply[i + 1], (list, tuple))
        ):
            i += 1  # skip sortkey
        fields: Dict[str, str] = {}
        if i < len(reply) and isinstance(reply[i], (list, tuple)):
            fl = reply[i]
            fields = {_s(fl[j]): _s(fl[j + 1]) for j in range(0, len(fl), 2)}
            i += 1
        rows[key] = fields
    return count, rows


def _num_eq(a: str, b: str) -> bool:
    try:
        fa, fb = float(a.replace("-nan", "nan")), float(b.replace("-nan", "nan"))
        if math.isnan(fa) and math.isnan(fb):
            return True  # reference compare_number_eq: nan == nan (== -nan)
        return math.isclose(fa, fb, abs_tol=0.01)
    except (TypeError, ValueError):
        return False


def _field_eq(name: str, a: str, b: str) -> bool:
    if a == b:
        return True
    # numeric-ish fields compare with tolerance (reference compare_row
    # heuristic: n*-prefixed and *score fields)
    if name.startswith(("n", "price")) or name.endswith("score"):
        return _num_eq(a, b)
    # JSON-encoded values (ON JSON returns serialized scalars)
    try:
        if json.loads(a) == json.loads(b):
            return True
    except (ValueError, TypeError):
        pass
    if _num_eq(a, b):
        return True
    return False


def compare_search_results(mine: list, expected: list) -> Optional[str]:
    """None if equivalent, else a mismatch description."""
    my_count, my_rows = _rows_from_search_reply(mine)
    ex_count, ex_rows = _rows_from_search_reply(expected)
    if my_count != ex_count:
        return f"count {my_count} != {ex_count}"
    if set(my_rows) != set(ex_rows):
        missing = set(ex_rows) - set(my_rows)
        extra = set(my_rows) - set(ex_rows)
        return f"keys differ: missing={sorted(missing)} extra={sorted(extra)}"
    for key, ex_fields in ex_rows.items():
        my_fields = my_rows[key]
        if set(my_fields) != set(ex_fields):
            return f"{key}: fields differ {sorted(my_fields)} vs {sorted(ex_fields)}"
        for f, ev in ex_fields.items():
            if not _field_eq(f, my_fields[f], ev):
                return f"{key}.{f}: {my_fields[f]!r} != {ev!r}"
    return None


def build_engine_agg(data_set_name: str, key_type: str):
    """Engine loaded with one of compute_data_sets()'s datasets (the
    aggregate/expr pickles). Pins search.emulate-release like the
    reference's compatibility suite (COMPAT_EMULATE_RELEASE,
    compatibility_test.py:27)."""
    from valkey_search_tpu.runtime import config as _cfg
    from valkey_search_tpu.server.engine import Engine

    _cfg.set_config("search.emulate-release", "1.3.0")

    ds = load_ref_data_sets()
    all_sets = ds.compute_data_sets()
    if data_set_name in all_sets:
        data = all_sets[data_set_name]
    else:  # text datasets (the expr pickle mixes both families)
        data = ds.compute_text_data_sets(data_set_name, seed=123)[data_set_name]
    eng = Engine()
    for create in data[f"{key_type} creates"]:
        eng.execute(*create.split(" "))
    for key, fields in data[f"{key_type} sets"]:
        if key_type == "hash":
            eng.hset(
                key,
                {k: (v if isinstance(v, bytes) else str(v))
                 for k, v in fields.items()},
            )
        else:
            eng.json_set(key, "$", json.dumps(fields))
    return eng


def _rows_from_agg_reply(reply: list) -> Tuple[int, List[Dict[str, str]]]:
    """FT.AGGREGATE reply [count, [f,v,...], ...] → (count, row dicts)."""
    count = int(reply[0])
    rows = []
    for fl in reply[1:]:
        rows.append({_s(fl[j]): _s(fl[j + 1]) for j in range(0, len(fl), 2)})
    return count, rows


def compare_agg_results(mine: list, expected: list, ordered: bool) -> Optional[str]:
    my_count, my_rows = _rows_from_agg_reply(mine)
    ex_count, ex_rows = _rows_from_agg_reply(expected)
    if len(my_rows) != len(ex_rows):
        return f"row count {len(my_rows)} != {len(ex_rows)}"
    if not ordered:
        keyf = lambda r: sorted(r.items())
        my_rows = sorted(my_rows, key=keyf)
        ex_rows = sorted(ex_rows, key=keyf)
    for i, (m, e) in enumerate(zip(my_rows, ex_rows)):
        if set(m) != set(e):
            return f"row {i}: fields {sorted(m)} vs {sorted(e)}"
        for f, ev in e.items():
            if not _field_eq(f, m[f], ev):
                return f"row {i}.{f}: {m[f]!r} != {ev!r}"
    return None


def run_group(
    engine,
    answers: List[dict],
    max_failures_kept: int = 25,
) -> Tuple[int, int, List[dict]]:
    """Replay one (key_type, dataset, schema) group. Returns
    (passed, total_compared, failures[:kept]) — excluded entries are not
    counted in the total."""
    passed = 0
    failures: List[dict] = []
    for a in answers:
        if a.get("excluded"):
            # the reference's own compatibility suite skips these entries
            # (known Redisearch/valkey-search divergences)
            continue
        cmd = a["cmd"]
        expected_exc = bool(a.get("exception", False))
        try:
            mine = engine.execute(*cmd)
            if expected_exc:
                failures.append({"cmd": cmd, "why": "expected error, got result"})
                continue
            if str(cmd[0]).lower() == "ft.aggregate":
                ordered = any(str(t).upper() == "SORTBY" for t in cmd)
                diff = compare_agg_results(mine, a["result"], ordered)
            else:
                diff = compare_search_results(mine, a["result"])
            if diff is None:
                passed += 1
            else:
                failures.append(
                    {"cmd": cmd, "why": diff, "mine": mine, "expected": a["result"]}
                )
        except Exception as exc:
            if expected_exc:
                passed += 1
            else:
                failures.append(
                    {"cmd": cmd, "why": f"raised {type(exc).__name__}: {exc}"}
                )
    total = sum(1 for a in answers if not a.get("excluded"))
    return passed, total, failures[:max_failures_kept]


def group_answers(answers: List[dict]):
    groups: Dict[tuple, List[dict]] = {}
    for a in answers:
        groups.setdefault(
            (a["key_type"], a["data_set_name"], a.get("schema_type", "default")),
            [],
        ).append(a)
    return groups
