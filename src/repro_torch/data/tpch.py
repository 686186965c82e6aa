"""TPC-H dbgen-lite: synthetic generator for the paper's benchmark schema.

Generates all 8 TPC-H tables at a given scale factor with dbgen-like
cardinalities and value domains (uniform approximations of dbgen's
distributions — the benchmark exercises the same operator mix).  Same
seed, same arrays as the reference engine's generator, so both packages
can be held to one data set.
"""

from __future__ import annotations

import numpy as np

from ..core.types import DBType, date_from_string

SF_ROWS = {
    "lineitem": 6_000_000,
    "orders": 1_500_000,
    "customer": 150_000,
    "part": 200_000,
    "supplier": 10_000,
    "partsupp": 800_000,
    "nation": 25,
    "region": 5,
}

NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
TYPES = [f"{a} {b} {c}" for a in ("ECONOMY", "LARGE", "MEDIUM", "PROMO",
                                  "SMALL", "STANDARD")
         for b in ("ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED")
         for c in ("BRASS", "COPPER", "NICKEL", "STEEL", "TIN")]
CONTAINERS = [f"{a} {b}" for a in ("JUMBO", "LG", "MED", "SM", "WRAP")
              for b in ("BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK",
                        "PKG")]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]

DATE0 = int(date_from_string("1992-01-01"))
DATE1 = int(date_from_string("1998-08-02"))


def _pick(rng, options, n):
    return np.asarray(options, dtype=object)[rng.integers(0, len(options), n)]


def generate(sf: float = 0.01, seed: int = 7) -> dict[str, dict]:
    """Returns {table: (columns dict, types dict, scales dict)}."""
    rng = np.random.default_rng(seed)
    n_li = max(100, int(SF_ROWS["lineitem"] * sf))
    n_or = max(25, int(SF_ROWS["orders"] * sf))
    n_cu = max(10, int(SF_ROWS["customer"] * sf))
    n_pa = max(10, int(SF_ROWS["part"] * sf))
    n_su = max(5, int(SF_ROWS["supplier"] * sf))
    n_ps = max(20, int(SF_ROWS["partsupp"] * sf))

    D = DBType
    out = {}

    out["region"] = ({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.asarray(REGIONS, dtype=object),
        "r_comment": np.asarray([f"region comment {i}" for i in range(5)],
                                dtype=object),
    }, {"r_regionkey": D.INT64, "r_name": D.VARCHAR, "r_comment": D.VARCHAR},
        {})

    out["nation"] = ({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.asarray(NATIONS, dtype=object),
        "n_regionkey": np.asarray(NATION_REGION, dtype=np.int64),
        "n_comment": np.asarray([f"nation comment {i}" for i in range(25)],
                                dtype=object),
    }, {"n_nationkey": D.INT64, "n_name": D.VARCHAR,
        "n_regionkey": D.INT64, "n_comment": D.VARCHAR}, {})

    out["supplier"] = ({
        "s_suppkey": np.arange(n_su, dtype=np.int64),
        "s_name": np.asarray([f"Supplier#{i:09d}" for i in range(n_su)],
                             dtype=object),
        "s_address": np.asarray([f"addr{i}" for i in range(n_su)],
                                dtype=object),
        "s_nationkey": rng.integers(0, 25, n_su).astype(np.int64),
        "s_phone": np.asarray([f"{rng.integers(10,35)}-{i:07d}"
                               for i in range(n_su)], dtype=object),
        "s_acctbal": np.round(rng.uniform(-999, 9999, n_su), 2),
        "s_comment": _pick(rng, ["reliable", "Customer Complaints pending",
                                 "quick", "slow"], n_su),
    }, {"s_suppkey": D.INT64, "s_name": D.VARCHAR, "s_address": D.VARCHAR,
        "s_nationkey": D.INT64, "s_phone": D.VARCHAR,
        "s_acctbal": D.DECIMAL, "s_comment": D.VARCHAR},
        {"s_acctbal": 2})

    out["customer"] = ({
        "c_custkey": np.arange(n_cu, dtype=np.int64),
        "c_name": np.asarray([f"Customer#{i:09d}" for i in range(n_cu)],
                             dtype=object),
        "c_address": np.asarray([f"caddr{i}" for i in range(n_cu)],
                                dtype=object),
        "c_nationkey": rng.integers(0, 25, n_cu).astype(np.int64),
        "c_phone": np.asarray([f"{rng.integers(10,35)}-{i:07d}"
                               for i in range(n_cu)], dtype=object),
        "c_acctbal": np.round(rng.uniform(-999, 9999, n_cu), 2),
        "c_mktsegment": _pick(rng, SEGMENTS, n_cu),
        "c_comment": _pick(rng, ["loyal", "new", "angry"], n_cu),
    }, {"c_custkey": D.INT64, "c_name": D.VARCHAR, "c_address": D.VARCHAR,
        "c_nationkey": D.INT64, "c_phone": D.VARCHAR,
        "c_acctbal": D.DECIMAL, "c_mktsegment": D.VARCHAR,
        "c_comment": D.VARCHAR}, {"c_acctbal": 2})

    out["part"] = ({
        "p_partkey": np.arange(n_pa, dtype=np.int64),
        "p_name": _pick(rng, ["ivory azure", "blanched chiffon",
                              "forest green", "ghost lavender",
                              "antique metallic"], n_pa),
        "p_mfgr": np.asarray([f"Manufacturer#{rng.integers(1,6)}"
                              for _ in range(n_pa)], dtype=object),
        "p_brand": _pick(rng, BRANDS, n_pa),
        "p_type": _pick(rng, TYPES, n_pa),
        "p_size": rng.integers(1, 51, n_pa).astype(np.int64),
        "p_container": _pick(rng, CONTAINERS, n_pa),
        "p_retailprice": np.round(rng.uniform(900, 2000, n_pa), 2),
        "p_comment": _pick(rng, ["fine", "regular", "special"], n_pa),
    }, {"p_partkey": D.INT64, "p_name": D.VARCHAR, "p_mfgr": D.VARCHAR,
        "p_brand": D.VARCHAR, "p_type": D.VARCHAR, "p_size": D.INT64,
        "p_container": D.VARCHAR, "p_retailprice": D.DECIMAL,
        "p_comment": D.VARCHAR}, {"p_retailprice": 2})

    out["partsupp"] = ({
        "ps_partkey": rng.integers(0, n_pa, n_ps).astype(np.int64),
        "ps_suppkey": rng.integers(0, n_su, n_ps).astype(np.int64),
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1, 1000, n_ps), 2),
        "ps_comment": _pick(rng, ["stocked", "backordered"], n_ps),
    }, {"ps_partkey": D.INT64, "ps_suppkey": D.INT64,
        "ps_availqty": D.INT64, "ps_supplycost": D.DECIMAL,
        "ps_comment": D.VARCHAR}, {"ps_supplycost": 2})

    odate = rng.integers(DATE0, DATE1 - 151, n_or).astype(np.int32)
    out["orders"] = ({
        "o_orderkey": np.arange(n_or, dtype=np.int64),
        "o_custkey": rng.integers(0, n_cu, n_or).astype(np.int64),
        "o_orderstatus": _pick(rng, ["F", "O", "P"], n_or),
        "o_totalprice": np.round(rng.uniform(850, 500000, n_or), 2),
        "o_orderdate": odate,
        "o_orderpriority": _pick(rng, PRIORITIES, n_or),
        "o_clerk": np.asarray([f"Clerk#{rng.integers(0,1000):09d}"
                               for _ in range(n_or)], dtype=object),
        "o_shippriority": np.zeros(n_or, dtype=np.int64),
        "o_comment": _pick(rng, ["rush", "normal", "special requests"],
                           n_or),
    }, {"o_orderkey": D.INT64, "o_custkey": D.INT64,
        "o_orderstatus": D.VARCHAR, "o_totalprice": D.DECIMAL,
        "o_orderdate": D.DATE, "o_orderpriority": D.VARCHAR,
        "o_clerk": D.VARCHAR, "o_shippriority": D.INT64,
        "o_comment": D.VARCHAR}, {"o_totalprice": 2})

    okey = rng.integers(0, n_or, n_li).astype(np.int64)
    ship = odate[okey] + rng.integers(1, 122, n_li).astype(np.int32)
    commit = ship + rng.integers(-30, 31, n_li).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n_li).astype(np.int32)
    out["lineitem"] = ({
        "l_orderkey": okey,
        "l_partkey": rng.integers(0, n_pa, n_li).astype(np.int64),
        "l_suppkey": rng.integers(0, n_su, n_li).astype(np.int64),
        "l_linenumber": rng.integers(1, 8, n_li).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n_li), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.10, n_li), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2),
        "l_returnflag": _pick(rng, ["A", "N", "R"], n_li),
        "l_linestatus": _pick(rng, ["F", "O"], n_li),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": _pick(rng, INSTRUCTS, n_li),
        "l_shipmode": _pick(rng, SHIPMODES, n_li),
        "l_comment": _pick(rng, ["quick", "slow", "deposits"], n_li),
    }, {"l_orderkey": D.INT64, "l_partkey": D.INT64, "l_suppkey": D.INT64,
        "l_linenumber": D.INT64, "l_quantity": D.FLOAT64,
        "l_extendedprice": D.DECIMAL, "l_discount": D.FLOAT64,
        "l_tax": D.FLOAT64, "l_returnflag": D.VARCHAR,
        "l_linestatus": D.VARCHAR, "l_shipdate": D.DATE,
        "l_commitdate": D.DATE, "l_receiptdate": D.DATE,
        "l_shipinstruct": D.VARCHAR, "l_shipmode": D.VARCHAR,
        "l_comment": D.VARCHAR},
        {"l_extendedprice": 2})
    return out
