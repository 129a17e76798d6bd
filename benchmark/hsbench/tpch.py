"""TPC-H's lineitem table at full width, made with numpy from a seed.

Every one of lineitem's 16 columns is made as clause 4.2.3 of the TPC-H
specification (v3.0.1) defines it, with the types and lengths it states,
over dbgen's key structure: sparse order keys (8 used of every 32), 1 to
7 lines an order (adjusted to the exact row count), the supplier key
derived from the part key, the extended price from the part's retail
price, ship, commit and receipt dates from the order date, the return
flag and line status from the spec's current date, and comments cut from
a pseudo-text of the spec's words. It is not dbgen's output: the draws
are numpy's. Decimals are stored as doubles, quantity as a whole number
(its values are whole by the spec), dates as days since 1970-01-01 and
text as bytes (numpy ``S`` arrays, no NUL inside).

Frozen here, as part of the yardstick: a later change to the program is
measured on the same data. It grew out of ``chip_smoke.py:make_tables``
(the port's smoke run), which made five of the columns. The row counts
come from the configuration's file.
"""

from __future__ import annotations

import datetime

import numpy as np

# clause 4.2.3's dates, in days since 1970-01-01
START_DATE = 8035  # 1992-01-01
END_DATE = 10591  # 1998-12-31
CURRENT_DATE = 9298  # 1995-06-17

LINEITEM_SCHEMA = {
    "l_orderkey": "int64", "l_partkey": "int64", "l_suppkey": "int64",
    "l_linenumber": "int32", "l_quantity": "int64", "l_extendedprice": "float64",
    "l_discount": "float64", "l_tax": "float64", "l_returnflag": "string",
    "l_linestatus": "string", "l_shipdate": "date32", "l_commitdate": "date32",
    "l_receiptdate": "date32", "l_shipinstruct": "string", "l_shipmode": "string",
    "l_comment": "string",
}
SCHEMAS = {"lineitem": LINEITEM_SCHEMA}

INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
# the grammar's words (clause 4.2.2.13), from which the pseudo-text is drawn
WORDS = (
    "foxes ideas theodolites pinto beans instructions dependencies excuses platelets "
    "asymptotes courts dolphins multipliers sauternes warthogs frets dinos attainments "
    "somas Tiresias' patterns forges braids hockey players frays warhorses dugouts "
    "notornis epitaphs pearls tithes waters orbits gifts sheaves depths sentiments "
    "decoys realms pains grouches escapades sleep wake are cajole haggle nag use boost "
    "affix detect integrate maintain nod was lose sublate solve thrash promise engage "
    "hinder print x-ray breach eat grow impress mold poach serve run dazzle snooze doze "
    "unwind kindle play hang believe doubt furious sly careful blithe quick fluffy slow "
    "quiet ruthless thin close dogged daring brave stealthy permanent enticing idle busy "
    "regular final ironic even bold silent sometimes always never furiously slyly "
    "carefully blithely quickly fluffily slowly quietly ruthlessly thinly closely "
    "doggedly daringly bravely stealthily permanently enticingly idly busily regularly "
    "finally ironically evenly boldly silently about above according to across after "
    "against along alongside of among around at atop before behind beneath beside "
    "besides between beyond by despite during except for from in place of inside "
    "instead of into near on outside over past since through throughout toward under "
    "until up upon without with within . ; : ? ! --"
).split()
TEXT_POOL_BYTES = 1 << 20
COMMENT_LEN = (10, 43)  # lineitem's comment: text of 10 to 43 characters


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date, as date32 stores it."""
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def _text(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` text strings of ``lo`` to ``hi`` characters, each cut at a
    random offset from a pseudo-text of the grammar's words."""
    per = TEXT_POOL_BYTES // 6
    words = np.array(WORDS, dtype=object)[rng.integers(len(WORDS), size=per)]
    pool = np.frombuffer(" ".join(words).encode()[:TEXT_POOL_BYTES], dtype=np.uint8)
    start = rng.integers(0, len(pool) - hi, n)
    length = rng.integers(lo, hi + 1, n)
    out = np.empty((n, hi), dtype=np.uint8)
    cols = np.arange(hi)
    for s in range(0, n, 1 << 18):  # in slices: the gather's index is 8 bytes a character
        e = min(s + (1 << 18), n)
        out[s:e] = pool[start[s:e, None] + cols]
        out[s:e][cols[None, :] >= length[s:e, None]] = 0
    return out.view(f"S{hi}").ravel()


def _choice(rng, values, n: int) -> np.ndarray:
    return np.array(values, dtype="S")[rng.integers(len(values), size=n)]


def make_tables(seed: int, rows: dict) -> dict:
    """``{"lineitem": columns}``, each column a numpy array. ``rows``
    holds the counts of ``orders`` (the lines' key structure; the table
    itself is not made), ``lineitem``, ``part`` and ``supplier``."""
    n_orders, n_lines = rows["orders"], rows["lineitem"]
    n_parts, n_supp = rows["part"], rows["supplier"]
    rng = np.random.default_rng(seed)
    idx = np.arange(n_orders, dtype=np.int64)
    # dbgen's sparse keys: 8 used out of every 32
    o_orderkey = (idx // 8) * 32 + (idx % 8) + 1
    o_orderdate = rng.integers(START_DATE, END_DATE - 151 + 1, n_orders).astype(np.int32)
    # 1..7 lines per order, adjusted to exactly n_lines lines
    counts = rng.integers(1, 8, n_orders)
    diff = n_lines - int(counts.sum())
    while diff:
        pick = np.flatnonzero(counts < 7) if diff > 0 else np.flatnonzero(counts > 1)
        take = rng.choice(pick, min(abs(diff), len(pick)), replace=False)
        counts[take] += 1 if diff > 0 else -1
        diff = n_lines - int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    orderdate = np.repeat(o_orderdate, counts)
    partkey = rng.integers(1, n_parts + 1, n_lines).astype(np.int64)
    # clause 4.2.3: the i-th of a part's four suppliers
    supp_i = rng.integers(0, 4, n_lines)
    suppkey = (partkey + supp_i * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100.0
    quantity = rng.integers(1, 51, n_lines).astype(np.int64)
    shipdate = (orderdate + rng.integers(1, 122, n_lines)).astype(np.int32)
    receiptdate = (shipdate + rng.integers(1, 31, n_lines)).astype(np.int32)
    returned = rng.integers(0, 2, n_lines).astype(bool)
    lineitem = {
        "l_orderkey": np.repeat(o_orderkey, counts),
        "l_partkey": partkey,
        "l_suppkey": suppkey.astype(np.int64),
        "l_linenumber": (np.arange(n_lines) - first + 1).astype(np.int32),
        "l_quantity": quantity,
        "l_extendedprice": np.round(quantity * retail, 2),
        "l_discount": rng.integers(0, 11, n_lines) / 100.0,
        "l_tax": rng.integers(0, 9, n_lines) / 100.0,
        "l_returnflag": np.where(receiptdate <= CURRENT_DATE,
                                 np.where(returned, b"R", b"A"), b"N").astype("S1"),
        "l_linestatus": np.where(shipdate > CURRENT_DATE, b"O", b"F").astype("S1"),
        "l_shipdate": shipdate,
        "l_commitdate": (orderdate + rng.integers(30, 91, n_lines)).astype(np.int32),
        "l_receiptdate": receiptdate,
        "l_shipinstruct": _choice(rng, INSTRUCTIONS, n_lines),
        "l_shipmode": _choice(rng, MODES, n_lines),
        "l_comment": _text(rng, n_lines, *COMMENT_LEN),
    }
    return {"lineitem": lineitem}


def int_bounds(tables: dict) -> dict:
    """(min, max) of every integer column of the tables."""
    return {c: (int(a.min()), int(a.max())) for t in tables.values() for c, a in t.items()
            if a.dtype.kind in "iu"}
