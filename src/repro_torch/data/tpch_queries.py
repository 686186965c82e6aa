"""TPC-H queries of this slice, as builder queries: Q1 (pricing summary
report) and Q6 (forecasting revenue change), the two filter→aggregate
scans of the paper's Table 1 that run on the device scan-agg tier.  Each
``q<i>(db)`` returns a relalg ``Query``."""

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


def q6(db) -> Query:
    return (db.scan("lineitem")
            .filter((Col("l_shipdate") >= DateLit("1994-01-01"))
                    & (Col("l_shipdate") < DateLit("1995-01-01"))
                    & (Col("l_discount") >= 0.05)
                    & (Col("l_discount") <= 0.07)
                    & (Col("l_quantity") < 24))
            .agg(revenue=("sum", Col("l_extendedprice")
                          * Col("l_discount"))))


ALL_QUERIES = {"q1": q1, "q6": q6}
