"""TPC-H schemas and a deterministic in-process data generator.

The reference registers the 8 TPC-H tables from ``testdata/`` CSVs with
hand-written schemas (ballista/rust/scheduler/src/test_utils.rs:45-138, and
the benchmark binary benchmarks/src/bin/tpch.rs:250-252 against dbgen
output). This module provides the same schemas plus a numpy-based generator
so benchmarks and tests need no external dbgen: cardinalities, key
relationships (PK/FK integrity), and value domains follow the TPC-H spec;
text columns use the spec's vocabularies. Deterministic per (table, scale,
seed).
"""

from __future__ import annotations

import datetime

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.datatypes import DataType, Field, Schema

EPOCH = datetime.date(1970, 1, 1)


def _d(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - EPOCH).days


# -- schemas (mirror test_utils.rs:45-138; decimals -> float64 deviation) ----

TPCH_TABLES = (
    "part", "supplier", "partsupp", "customer", "orders", "lineitem",
    "nation", "region",
)


def tpch_schema(table: str) -> Schema:
    f = Field
    D = DataType
    schemas = {
        "part": [
            f("p_partkey", D.INT64, False),
            f("p_name", D.STRING, False),
            f("p_mfgr", D.STRING, False),
            f("p_brand", D.STRING, False),
            f("p_type", D.STRING, False),
            f("p_size", D.INT32, False),
            f("p_container", D.STRING, False),
            f("p_retailprice", D.FLOAT64, False),
            f("p_comment", D.STRING, False),
        ],
        "supplier": [
            f("s_suppkey", D.INT64, False),
            f("s_name", D.STRING, False),
            f("s_address", D.STRING, False),
            f("s_nationkey", D.INT64, False),
            f("s_phone", D.STRING, False),
            f("s_acctbal", D.FLOAT64, False),
            f("s_comment", D.STRING, False),
        ],
        "partsupp": [
            f("ps_partkey", D.INT64, False),
            f("ps_suppkey", D.INT64, False),
            f("ps_availqty", D.INT32, False),
            f("ps_supplycost", D.FLOAT64, False),
            f("ps_comment", D.STRING, False),
        ],
        "customer": [
            f("c_custkey", D.INT64, False),
            f("c_name", D.STRING, False),
            f("c_address", D.STRING, False),
            f("c_nationkey", D.INT64, False),
            f("c_phone", D.STRING, False),
            f("c_acctbal", D.FLOAT64, False),
            f("c_mktsegment", D.STRING, False),
            f("c_comment", D.STRING, False),
        ],
        "orders": [
            f("o_orderkey", D.INT64, False),
            f("o_custkey", D.INT64, False),
            f("o_orderstatus", D.STRING, False),
            f("o_totalprice", D.FLOAT64, False),
            f("o_orderdate", D.DATE32, False),
            f("o_orderpriority", D.STRING, False),
            f("o_clerk", D.STRING, False),
            f("o_shippriority", D.INT32, False),
            f("o_comment", D.STRING, False),
        ],
        "lineitem": [
            f("l_orderkey", D.INT64, False),
            f("l_partkey", D.INT64, False),
            f("l_suppkey", D.INT64, False),
            f("l_linenumber", D.INT32, False),
            f("l_quantity", D.FLOAT64, False),
            f("l_extendedprice", D.FLOAT64, False),
            f("l_discount", D.FLOAT64, False),
            f("l_tax", D.FLOAT64, False),
            f("l_returnflag", D.STRING, False),
            f("l_linestatus", D.STRING, False),
            f("l_shipdate", D.DATE32, False),
            f("l_commitdate", D.DATE32, False),
            f("l_receiptdate", D.DATE32, False),
            f("l_shipinstruct", D.STRING, False),
            f("l_shipmode", D.STRING, False),
            f("l_comment", D.STRING, False),
        ],
        "nation": [
            f("n_nationkey", D.INT64, False),
            f("n_name", D.STRING, False),
            f("n_regionkey", D.INT64, False),
            f("n_comment", D.STRING, False),
        ],
        "region": [
            f("r_regionkey", D.INT64, False),
            f("r_name", D.STRING, False),
            f("r_comment", D.STRING, False),
        ],
    }
    return Schema(schemas[table])


def all_schemas() -> dict[str, Schema]:
    return {t: tpch_schema(t) for t in TPCH_TABLES}


# -- spec vocabularies (TPC-H v3 §4.2.2.13) ----------------------------------

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = [
    "DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN",
]
CONTAINERS = [
    f"{a} {b}"
    for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
    for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "hotpink", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
COMMENT_WORDS = [
    "carefully", "quickly", "slowly", "furiously", "blithely", "express",
    "regular", "special", "final", "pending", "ironic", "even", "bold",
    "silent", "unusual", "deposits", "requests", "packages", "accounts",
    "instructions", "theodolites", "platelets", "foxes", "ideas", "asymptotes",
    "dependencies", "excuses", "pinto", "beans", "sleep", "haggle", "nag",
    "wake", "cajole", "integrate", "detect", "among", "above", "along",
]

# TPC-H base cardinalities at SF=1
_CARD = {
    "part": 200_000,
    "supplier": 10_000,
    "customer": 150_000,
    "orders": 1_500_000,
    # lineitem ~= 4 per order (spec: 1-7 uniform)
}

DATE_LO = _d(1992, 1, 1)
DATE_HI = _d(1998, 12, 1)  # o_orderdate upper bound (spec: CURRENTDATE-151)


def _phone(rng: np.random.Generator, nk: np.ndarray) -> list[str]:
    a = rng.integers(100, 1000, len(nk))
    b = rng.integers(100, 1000, len(nk))
    c = rng.integers(1000, 10000, len(nk))
    return [
        f"{10 + int(n)}-{x}-{y}-{z}" for n, x, y, z in zip(nk, a, b, c)
    ]


def _comments(rng: np.random.Generator, n: int, nwords: int = 5) -> list[str]:
    idx = rng.integers(0, len(COMMENT_WORDS), (n, nwords))
    return [" ".join(COMMENT_WORDS[j] for j in row) for row in idx]


def gen_table(table: str, scale: float = 0.01, seed: int = 42) -> pa.Table:
    """Generate one TPC-H table as an Arrow table."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, TPCH_TABLES.index(table)])
    )
    if table == "region":
        return pa.table(
            {
                "r_regionkey": pa.array(np.arange(5, dtype=np.int64)),
                "r_name": pa.array(REGIONS),
                "r_comment": pa.array(_comments(rng, 5)),
            }
        )
    if table == "nation":
        return pa.table(
            {
                "n_nationkey": pa.array(np.arange(len(NATIONS), dtype=np.int64)),
                "n_name": pa.array([n for n, _ in NATIONS]),
                "n_regionkey": pa.array(
                    np.asarray([r for _, r in NATIONS], dtype=np.int64)
                ),
                "n_comment": pa.array(_comments(rng, len(NATIONS))),
            }
        )
    if table == "part":
        n = max(1, int(_CARD["part"] * scale))
        keys = np.arange(1, n + 1, dtype=np.int64)
        w = rng.integers(0, len(P_NAME_WORDS), (n, 5))
        names = [" ".join(P_NAME_WORDS[j] for j in row) for row in w]
        mfgr = rng.integers(1, 6, n)
        brand = mfgr * 10 + rng.integers(1, 6, n)
        t1 = rng.integers(0, len(TYPE_S1), n)
        t2 = rng.integers(0, len(TYPE_S2), n)
        t3 = rng.integers(0, len(TYPE_S3), n)
        types = [
            f"{TYPE_S1[a]} {TYPE_S2[b]} {TYPE_S3[c]}"
            for a, b, c in zip(t1, t2, t3)
        ]
        return pa.table(
            {
                "p_partkey": pa.array(keys),
                "p_name": pa.array(names),
                "p_mfgr": pa.array([f"Manufacturer#{m}" for m in mfgr]),
                "p_brand": pa.array([f"Brand#{b}" for b in brand]),
                "p_type": pa.array(types),
                "p_size": pa.array(rng.integers(1, 51, n).astype(np.int32)),
                "p_container": pa.array(
                    [CONTAINERS[i] for i in rng.integers(0, len(CONTAINERS), n)]
                ),
                "p_retailprice": pa.array(
                    (90000 + (keys % 20001) + 100 * (keys % 1000)) / 100.0
                ),
                "p_comment": pa.array(_comments(rng, n, 3)),
            }
        )
    if table == "supplier":
        n = max(1, int(_CARD["supplier"] * scale))
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, len(NATIONS), n).astype(np.int64)
        # spec: 5 suppliers per 10000 have the Complaints text
        comments = _comments(rng, n)
        for i in rng.choice(n, max(1, n // 2000), replace=False):
            comments[i] = "wake Customer Complaints sleep"
        for i in rng.choice(n, max(1, n // 2000), replace=False):
            comments[i] = "even Customer Recommends haggle"
        return pa.table(
            {
                "s_suppkey": pa.array(keys),
                "s_name": pa.array([f"Supplier#{k:09d}" for k in keys]),
                "s_address": pa.array(_comments(rng, n, 2)),
                "s_nationkey": pa.array(nk),
                "s_phone": pa.array(_phone(rng, nk)),
                "s_acctbal": pa.array(
                    np.round(rng.uniform(-999.99, 9999.99, n), 2)
                ),
                "s_comment": pa.array(comments),
            }
        )
    if table == "partsupp":
        npart = max(1, int(_CARD["part"] * scale))
        nsupp = max(1, int(_CARD["supplier"] * scale))
        pk = np.repeat(np.arange(1, npart + 1, dtype=np.int64), 4)
        n = len(pk)
        # spec formula spreads the 4 suppliers of a part across the key space
        i = np.tile(np.arange(4, dtype=np.int64), npart)
        sk = (pk + i * (nsupp // 4 + ((pk - 1) // nsupp))) % nsupp + 1
        return pa.table(
            {
                "ps_partkey": pa.array(pk),
                "ps_suppkey": pa.array(sk),
                "ps_availqty": pa.array(
                    rng.integers(1, 10000, n).astype(np.int32)
                ),
                "ps_supplycost": pa.array(
                    np.round(rng.uniform(1.0, 1000.0, n), 2)
                ),
                "ps_comment": pa.array(_comments(rng, n, 8)),
            }
        )
    if table == "customer":
        n = max(1, int(_CARD["customer"] * scale))
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, len(NATIONS), n).astype(np.int64)
        return pa.table(
            {
                "c_custkey": pa.array(keys),
                "c_name": pa.array([f"Customer#{k:09d}" for k in keys]),
                "c_address": pa.array(_comments(rng, n, 2)),
                "c_nationkey": pa.array(nk),
                "c_phone": pa.array(_phone(rng, nk)),
                "c_acctbal": pa.array(
                    np.round(rng.uniform(-999.99, 9999.99, n), 2)
                ),
                "c_mktsegment": pa.array(
                    [SEGMENTS[i] for i in rng.integers(0, 5, n)]
                ),
                "c_comment": pa.array(_comments(rng, n, 6)),
            }
        )
    if table == "orders":
        ncust = max(1, int(_CARD["customer"] * scale))
        n = max(1, int(_CARD["orders"] * scale))
        # spec: order keys are sparse (1/4 of key space used)
        keys = (np.arange(n, dtype=np.int64) * 4) + 1
        ck = rng.integers(1, ncust + 1, n).astype(np.int64)
        odate = rng.integers(DATE_LO, DATE_HI - 151, n).astype(np.int32)
        status = np.where(
            odate + 100 < _d(1995, 6, 17),
            "F",
            np.where(odate > _d(1996, 1, 1), "O", "P"),
        )
        return pa.table(
            {
                "o_orderkey": pa.array(keys),
                "o_custkey": pa.array(ck),
                "o_orderstatus": pa.array(status.tolist()),
                "o_totalprice": pa.array(
                    np.round(rng.uniform(850.0, 555000.0, n), 2)
                ),
                "o_orderdate": pa.array(
                    odate.astype("datetime64[D]").astype(datetime.date)
                ),
                "o_orderpriority": pa.array(
                    [PRIORITIES[i] for i in rng.integers(0, 5, n)]
                ),
                "o_clerk": pa.array(
                    [f"Clerk#{i:09d}" for i in rng.integers(1, max(2, n // 1000), n)]
                ),
                "o_shippriority": pa.array(np.zeros(n, dtype=np.int32)),
                "o_comment": pa.array(_comments(rng, n, 6)),
            }
        )
    if table == "lineitem":
        orders = gen_table("orders", scale, seed)
        okeys = np.asarray(orders["o_orderkey"])
        odates = np.asarray(
            orders["o_orderdate"].cast(pa.int32())
        )
        npart = max(1, int(_CARD["part"] * scale))
        nsupp = max(1, int(_CARD["supplier"] * scale))
        nline = rng.integers(1, 8, len(okeys))
        lok = np.repeat(okeys, nline)
        lod = np.repeat(odates, nline)
        n = len(lok)
        linenumber = np.concatenate(
            [np.arange(1, k + 1) for k in nline]
        ).astype(np.int32)
        pk = rng.integers(1, npart + 1, n).astype(np.int64)
        # supplier chosen among the part's 4 partsupp suppliers (FK integrity)
        i4 = rng.integers(0, 4, n).astype(np.int64)
        sk = (pk + i4 * (nsupp // 4 + ((pk - 1) // nsupp))) % nsupp + 1
        qty = rng.integers(1, 51, n).astype(np.float64)
        retail = (90000 + (pk % 20001) + 100 * (pk % 1000)) / 100.0
        eprice = np.round(retail * qty, 2)
        ship_delta = rng.integers(1, 122, n)
        commit_delta = rng.integers(30, 91, n)
        receipt_delta = rng.integers(1, 31, n)
        sdate = (lod + ship_delta).astype(np.int32)
        cdate = (lod + commit_delta).astype(np.int32)
        rdate = (sdate + receipt_delta).astype(np.int32)
        rf = np.where(
            rdate <= _d(1995, 6, 17),
            np.where(rng.random(n) < 0.5, "R", "A"),
            "N",
        )
        ls = np.where(sdate > _d(1995, 6, 17), "O", "F")
        return pa.table(
            {
                "l_orderkey": pa.array(lok),
                "l_partkey": pa.array(pk),
                "l_suppkey": pa.array(sk),
                "l_linenumber": pa.array(linenumber),
                "l_quantity": pa.array(qty),
                "l_extendedprice": pa.array(eprice),
                "l_discount": pa.array(
                    np.round(rng.integers(0, 11, n) / 100.0, 2)
                ),
                "l_tax": pa.array(np.round(rng.integers(0, 9, n) / 100.0, 2)),
                "l_returnflag": pa.array(rf.tolist()),
                "l_linestatus": pa.array(ls.tolist()),
                "l_shipdate": pa.array(
                    sdate.astype("datetime64[D]").astype(datetime.date)
                ),
                "l_commitdate": pa.array(
                    cdate.astype("datetime64[D]").astype(datetime.date)
                ),
                "l_receiptdate": pa.array(
                    rdate.astype("datetime64[D]").astype(datetime.date)
                ),
                "l_shipinstruct": pa.array(
                    [SHIPINSTRUCT[i] for i in rng.integers(0, 4, n)]
                ),
                "l_shipmode": pa.array(
                    [SHIPMODES[i] for i in rng.integers(0, 7, n)]
                ),
                "l_comment": pa.array(_comments(rng, n, 4)),
            }
        )
    raise ValueError(f"unknown TPC-H table {table!r}")


def gen_all(scale: float = 0.01, seed: int = 42) -> dict[str, pa.Table]:
    return {t: gen_table(t, scale, seed) for t in TPCH_TABLES}


def spec_substitutions(query: str, tables: dict[str, pa.Table]) -> dict[str, str]:
    """Spec constants of TPC-H ``query`` ("q7", ...) replaced by values
    chosen from ``tables``, as ``tests/test_tpch_oracle.py`` chooses them:
    at a small scale a spec constant (q11's GERMANY, q18's 300, q20's
    CANADA and 'forest%', q22's country codes, ...) may select nothing, and
    the path under test would be trivially empty. Returns {spec text:
    replacement}; empty for a query without such constants."""
    import pandas as pd

    def f(name: str, *cols: str) -> pd.DataFrame:
        return tables[name].select(list(cols)).to_pandas()

    lo, hi = datetime.date(1995, 1, 1), datetime.date(1996, 12, 31)

    def top_nation(left: pd.DataFrame, key: str) -> str:
        n = f("nation", "n_nationkey", "n_name")
        return left.merge(n, left_on=key, right_on="n_nationkey").n_name.value_counts().index[0]

    if query == "q7":
        nation = f("nation", "n_nationkey", "n_name")
        j = (
            f("supplier", "s_suppkey", "s_nationkey")
            .merge(f("lineitem", "l_suppkey", "l_orderkey", "l_shipdate"),
                   left_on="s_suppkey", right_on="l_suppkey")
            .merge(f("orders", "o_orderkey", "o_custkey"), left_on="l_orderkey", right_on="o_orderkey")
            .merge(f("customer", "c_custkey", "c_nationkey"), left_on="o_custkey", right_on="c_custkey")
            .merge(nation.add_prefix("s_n_"), left_on="s_nationkey", right_on="s_n_n_nationkey")
            .merge(nation.add_prefix("c_n_"), left_on="c_nationkey", right_on="c_n_n_nationkey")
        )
        j = j[(j.l_shipdate >= lo) & (j.l_shipdate <= hi)]
        pairs = (
            j[j.s_n_n_name != j.c_n_n_name]
            .groupby(["s_n_n_name", "c_n_n_name"]).size().sort_values(ascending=False)
        )
        a, b = pairs.index[0]
        return {"FRANCE": a, "GERMANY": b}
    if query == "q8":
        nation = f("nation", "n_nationkey", "n_name", "n_regionkey")
        j = (
            f("part", "p_partkey", "p_type")
            .merge(f("lineitem", "l_partkey", "l_suppkey", "l_orderkey"),
                   left_on="p_partkey", right_on="l_partkey")
            .merge(f("supplier", "s_suppkey", "s_nationkey"), left_on="l_suppkey", right_on="s_suppkey")
            .merge(f("orders", "o_orderkey", "o_custkey", "o_orderdate"),
                   left_on="l_orderkey", right_on="o_orderkey")
            .merge(f("customer", "c_custkey", "c_nationkey"), left_on="o_custkey", right_on="c_custkey")
            .merge(nation.add_prefix("c_n_"), left_on="c_nationkey", right_on="c_n_n_nationkey")
            .merge(nation.add_prefix("s_n_"), left_on="s_nationkey", right_on="s_n_n_nationkey")
            .merge(f("region", "r_regionkey", "r_name"),
                   left_on="c_n_n_regionkey", right_on="r_regionkey")
        )
        j = j[(j.r_name == "AMERICA") & (j.o_orderdate >= lo) & (j.o_orderdate <= hi)]
        ptype = j.p_type.value_counts().index[0]
        nat = j[j.p_type == ptype].s_n_n_name.value_counts().index[0]
        return {"BRAZIL": nat, "ECONOMY ANODIZED STEEL": ptype}
    if query == "q11":
        j = f("partsupp", "ps_suppkey").merge(
            f("supplier", "s_suppkey", "s_nationkey"), left_on="ps_suppkey", right_on="s_suppkey"
        )
        return {"GERMANY": top_nation(j, "s_nationkey")}
    if query == "q17":
        j = f("lineitem", "l_partkey").merge(
            f("part", "p_partkey", "p_brand", "p_container"), left_on="l_partkey", right_on="p_partkey"
        )
        brand, cont = (
            j.groupby(["p_brand", "p_container"]).size().sort_values(ascending=False).index[0]
        )
        return {"Brand#23": brand, "MED BOX": cont}
    if query == "q18":
        per_order = f("lineitem", "l_orderkey", "l_quantity").groupby("l_orderkey").l_quantity.sum()
        return {"> 300": f"> {int(np.floor(per_order.quantile(0.95)))}"}
    if query == "q19":
        j = f("lineitem", "l_partkey", "l_shipmode", "l_shipinstruct", "l_quantity").merge(
            f("part", "p_partkey", "p_brand", "p_container", "p_size"),
            left_on="l_partkey", right_on="p_partkey",
        )
        base = j.l_shipmode.isin(["AIR", "AIR REG"]) & (j.l_shipinstruct == "DELIVER IN PERSON")
        out = {}
        for containers, qlo, qhi, shi, spec in (
            (["SM CASE", "SM BOX", "SM PACK", "SM PKG"], 1, 11, 5, "Brand#12"),
            (["MED BAG", "MED BOX", "MED PKG", "MED PACK"], 10, 20, 10, "Brand#23"),
            (["LG CASE", "LG BOX", "LG PACK", "LG PKG"], 20, 30, 15, "Brand#34"),
        ):
            m = (
                base & j.p_container.isin(containers)
                & (j.l_quantity >= qlo) & (j.l_quantity <= qhi)
                & (j.p_size >= 1) & (j.p_size <= shi)
            )
            brands = j.p_brand[m].value_counts()
            out[spec] = brands.index[0] if len(brands) else spec
        return out
    if query in ("q20", "q21"):
        nat = top_nation(f("supplier", "s_nationkey"), "s_nationkey")
        if query == "q21":
            return {"SAUDI ARABIA": nat}
        prefix = f("part", "p_name").p_name.str[:3].value_counts().index[0]
        return {"CANADA": nat, "'forest%'": f"'{prefix}%'"}
    if query == "q22":
        c = f("customer", "c_custkey", "c_acctbal", "c_phone")
        o = f("orders", "o_custkey")
        # prefer codes of customers without orders, so NOT EXISTS keeps rows
        no_orders = c[~c.c_custkey.isin(o.o_custkey) & (c.c_acctbal > 0)]
        base = no_orders if len(no_orders) else c
        codes = list(base.c_phone.str[:2].value_counts().index[:7])
        return {
            "('13', '31', '23', '29', '30', '18', '17')":
                "(" + ", ".join(f"'{x}'" for x in codes) + ")"
        }
    return {}
