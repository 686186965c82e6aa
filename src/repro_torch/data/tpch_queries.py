"""TPC-H queries ported so far, as builder queries: Q1 (pricing summary
report) and Q6 (forecasting revenue change), the two filter→aggregate
scans of the paper's Table 1 that run on the device scan-agg tier, and Q3
(shipping priority), the customer ⋈ orders ⋈ lineitem join that runs on
the device join tier.  Each ``q<i>(db)`` returns a relalg ``Query``."""

from __future__ import annotations

from ..core.expression import Col, DateLit
from ..core.relalg import Query


def q1(db) -> Query:
    l = db.scan("lineitem")
    disc_price = Col("l_extendedprice") * (1 - Col("l_discount"))
    charge = disc_price * (1 + Col("l_tax"))
    return (l.filter(Col("l_shipdate") <= DateLit("1998-09-02"))
            .group_by("l_returnflag", "l_linestatus")
            .agg(sum_qty=("sum", Col("l_quantity")),
                 sum_base_price=("sum", Col("l_extendedprice")),
                 sum_disc_price=("sum", disc_price),
                 sum_charge=("sum", charge),
                 avg_qty=("avg", Col("l_quantity")),
                 avg_price=("avg", Col("l_extendedprice")),
                 avg_disc=("avg", Col("l_discount")),
                 count_order=("count", None))
            .order_by("l_returnflag", "l_linestatus"))


def q3(db) -> Query:
    revenue = Col("l_extendedprice") * (1 - Col("l_discount"))
    return (db.scan("customer").filter(Col("c_mktsegment") == "BUILDING")
            .join(db.scan("orders"), left_on="c_custkey",
                  right_on="o_custkey")
            .filter(Col("o_orderdate") < DateLit("1995-03-15"))
            .join(db.scan("lineitem"), left_on="o_orderkey",
                  right_on="l_orderkey")
            .filter(Col("l_shipdate") > DateLit("1995-03-15"))
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(revenue=("sum", revenue))
            .order_by(("revenue", True), "o_orderdate", limit=10))


def q6(db) -> Query:
    return (db.scan("lineitem")
            .filter((Col("l_shipdate") >= DateLit("1994-01-01"))
                    & (Col("l_shipdate") < DateLit("1995-01-01"))
                    & (Col("l_discount") >= 0.05)
                    & (Col("l_discount") <= 0.07)
                    & (Col("l_quantity") < 24))
            .agg(revenue=("sum", Col("l_extendedprice")
                          * Col("l_discount"))))


ALL_QUERIES = {"q1": q1, "q3": q3, "q6": q6}
