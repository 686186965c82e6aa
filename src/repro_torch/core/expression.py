"""Scalar expression AST, evaluated column-at-a-time.

Expressions are compiled per-column (whole-column vector ops), matching the
MAL execution model: one ``eval`` call processes the full column before the
next operator runs.  Evaluation is backend-agnostic — the context carries the
array namespace (``numpy`` on the host tier, a ``TorchNamespace`` over one
torch device inside the device tier's batch step), and all null handling is
expressed with ``where`` (branch-free) rather than item assignment.  Dtype
casts go through ``_astype`` so one expression tree serves numpy arrays and
torch tensors; on numpy arrays it is exactly ``ndarray.astype``.

SQL three-valued logic: every result carries an optional boolean null mask;
comparisons yield NULL when either side is NULL; ``Filter`` later treats
NULL as false.  VARCHAR predicates run on dictionary codes (order-preserving
heap, column.py), including LIKE which is evaluated once per *heap entry*
then mapped through the codes — the dictionary fast path MonetDB uses.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .column import StringHeap
from .types import DBType, NULL_SENTINEL, common_type, is_float

# ---------------------------------------------------------------------------
# array namespaces: numpy (host tier) and torch (device tier)
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of a torch dtype, unchanged)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def _astype(v, dtype):
    """``v.astype(dtype)`` for numpy arrays, ``v.to(...)`` for tensors."""
    if isinstance(v, torch.Tensor):
        return v.to(torch_dtype(dtype))
    return v.astype(dtype)


def descale(f, scale: int):
    """``f / 10**scale`` with IEEE division, numpy's arithmetic.  torch on
    CUDA turns division by a Python scalar into multiplication by its
    reciprocal, which can differ from the quotient in the last bit; a
    divisor tensor on ``f``'s device keeps the division."""
    if isinstance(f, torch.Tensor):
        return f / f.new_full((), 10 ** scale)
    return f / (10 ** scale)


class TorchNamespace:
    """The ``xp`` namespace over torch tensors on one device: the subset of
    numpy's functions the expression tree calls, with numpy's argument
    conventions (numpy dtypes, numpy scalars as fill values)."""

    float64 = torch.float64

    def __init__(self, device):
        self.device = torch.device(device)

    def isnan(self, v):
        return torch.isnan(v)

    def zeros(self, shape, dtype=np.float64):
        return torch.zeros(shape, dtype=torch_dtype(dtype),
                           device=self.device)

    def ones(self, shape, dtype=np.float64):
        return torch.ones(shape, dtype=torch_dtype(dtype),
                          device=self.device)

    def full(self, shape, value):
        a = np.asarray(value)
        return torch.full(shape, a.item(), dtype=torch_dtype(a.dtype),
                          device=self.device)

    def asarray(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(torch_dtype(dtype))
        return torch.as_tensor(np.asarray(x, dtype=dtype),
                               device=self.device)

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    def maximum(self, a, b):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp_min(a, b)

    def sqrt(self, v):
        return torch.sqrt(v)

    def abs(self, v):
        return torch.abs(v)

    def floor(self, v):
        return torch.floor(v)

    def ceil(self, v):
        return torch.ceil(v)

    def round(self, v):
        return torch.round(v)

    def log(self, v):
        return torch.log(v)

    def exp(self, v):
        return torch.exp(v)


# ---------------------------------------------------------------------------
# evaluation result + context
# ---------------------------------------------------------------------------


@dataclass
class ExprResult:
    values: Any                       # np array / tensor (storage repr)
    dbtype: DBType
    null: Any = None                  # bool array or None (= no nulls)
    heap: Optional[StringHeap] = None
    scale: int = 0

    def null_or_false(self, xp):
        return self.null if self.null is not None else xp.zeros(
            self.values.shape, dtype=bool)

    def as_float(self, xp):
        """Numeric decode to float64 (DECIMAL -> scaled float)."""
        v = self.values
        if self.dbtype == DBType.DECIMAL:
            return descale(_astype(v, np.float64), self.scale)
        return _astype(v, np.float64)


class EvalContext:
    """Resolves column references against a chunk of columns.

    ``arrays``: {name: array} storage-repr values.
    ``meta``:   {name: (DBType, heap, scale)}.
    ``xp``:     numpy or a ``TorchNamespace``.  Non-numpy namespaces keep
                an all-false null mask instead of dropping it (testing it
                would synchronize with the device).
    """

    def __init__(self, arrays: dict, meta: dict, xp=np):
        self.arrays = arrays
        self.meta = meta
        self.xp = xp
        n = 0
        for a in arrays.values():
            n = a.shape[0]
            break
        self.num_rows = n

    def resolve(self, name: str) -> ExprResult:
        if name not in self.arrays:
            raise KeyError(f"unknown column {name!r}; have {list(self.arrays)}")
        t, heap, scale = self.meta[name]
        v = self.arrays[name]
        xp = self.xp
        if is_float(t):
            nullm = xp.isnan(v)
        else:
            nullm = v == NULL_SENTINEL[t]
        if hasattr(nullm, "any") and self.xp is np and not nullm.any():
            nullm = None
        return ExprResult(v, t, nullm, heap, scale)


# ---------------------------------------------------------------------------
# AST nodes
# ---------------------------------------------------------------------------


class Expr:
    def eval(self, ctx: EvalContext) -> ExprResult:  # pragma: no cover
        raise NotImplementedError

    def columns(self) -> set[str]:
        """Free column references (for projection pushdown)."""
        return set()

    # operator sugar so tests/examples read naturally -----------------------
    def __add__(self, o): return BinOp("+", self, _lit(o))
    def __radd__(self, o): return BinOp("+", _lit(o), self)
    def __sub__(self, o): return BinOp("-", self, _lit(o))
    def __rsub__(self, o): return BinOp("-", _lit(o), self)
    def __mul__(self, o): return BinOp("*", self, _lit(o))
    def __rmul__(self, o): return BinOp("*", _lit(o), self)
    def __truediv__(self, o): return BinOp("/", self, _lit(o))
    def __eq__(self, o): return BinOp("=", self, _lit(o))   # type: ignore
    def __ne__(self, o): return BinOp("<>", self, _lit(o))  # type: ignore
    def __lt__(self, o): return BinOp("<", self, _lit(o))
    def __le__(self, o): return BinOp("<=", self, _lit(o))
    def __gt__(self, o): return BinOp(">", self, _lit(o))
    def __ge__(self, o): return BinOp(">=", self, _lit(o))
    def __and__(self, o): return BinOp("and", self, _lit(o))
    def __or__(self, o): return BinOp("or", self, _lit(o))
    def __invert__(self): return Not(self)
    def __hash__(self):
        return hash(repr(self))

    def isnull(self): return IsNull(self)
    def between(self, lo, hi):
        return BinOp("and", BinOp(">=", self, _lit(lo)),
                     BinOp("<=", self, _lit(hi)))
    def isin(self, values): return InList(self, list(values))
    def like(self, pattern: str): return Like(self, pattern)


def _lit(x) -> Expr:
    return x if isinstance(x, Expr) else Lit(x)


@dataclass(eq=False)
class Col(Expr):
    name: str

    def eval(self, ctx):
        return ctx.resolve(self.name)

    def columns(self):
        return {self.name}

    def __repr__(self):
        return f"Col({self.name})"


@dataclass(eq=False)
class Lit(Expr):
    value: Any
    dbtype: Optional[DBType] = None

    def eval(self, ctx):
        xp = ctx.xp
        v = self.value
        t = self.dbtype
        if t is None:
            if isinstance(v, bool):
                t = DBType.BOOL
            elif isinstance(v, (int, np.integer)):
                t = DBType.INT64
            elif isinstance(v, (float, np.floating)):
                t = DBType.FLOAT64
            elif isinstance(v, str):
                t = DBType.VARCHAR
            elif v is None:
                t = DBType.INT64
            else:
                raise TypeError(f"literal {v!r}")
        if v is None:
            arr = xp.full((ctx.num_rows,), NULL_SENTINEL[t])
            return ExprResult(arr, t, xp.ones((ctx.num_rows,), bool))
        if t == DBType.VARCHAR:
            # scalar string literal: kept as python str; comparisons against
            # a VARCHAR column translate it to heap codes.
            return ExprResult(v, t, None, None)
        if t == DBType.BOOL:
            arr = xp.full((ctx.num_rows,), np.int8(bool(v)))
            return ExprResult(arr, t, None)
        dtype = {DBType.INT64: np.int64, DBType.FLOAT64: np.float64,
                 DBType.INT32: np.int32, DBType.FLOAT32: np.float32,
                 DBType.DATE: np.int32, DBType.DECIMAL: np.int64}[t]
        arr = xp.full((ctx.num_rows,), dtype(v))
        return ExprResult(arr, t, None)

    def __repr__(self):
        return f"Lit({self.value!r})"


@dataclass(eq=False)
class DateLit(Expr):
    """DATE literal from 'YYYY-MM-DD'."""
    text: str

    def eval(self, ctx):
        from .types import date_from_string
        d = int(date_from_string(self.text))
        return ExprResult(ctx.xp.full((ctx.num_rows,), np.int32(d)),
                          DBType.DATE, None)

    def __repr__(self):
        return f"DateLit({self.text})"


_CMP = {"=", "<>", "<", "<=", ">", ">="}
_ARITH = {"+", "-", "*", "/", "%"}
_LOGIC = {"and", "or"}


@dataclass(eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def columns(self):
        return self.left.columns() | self.right.columns()

    def eval(self, ctx):
        xp = ctx.xp
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        op = self.op

        if op in _LOGIC:
            lv = l.values != 0 if l.dbtype == DBType.BOOL else l.values
            rv = r.values != 0 if r.dbtype == DBType.BOOL else r.values
            ln, rn = l.null_or_false(xp), r.null_or_false(xp)
            lv = xp.asarray(lv, dtype=bool) & ~ln
            rv = xp.asarray(rv, dtype=bool) & ~rn
            if op == "and":
                out = lv & rv
                # NULL only when undetermined: (NULL and TRUE-ish)
                nl = (ln & (rv | rn)) | (rn & (lv | ln))
            else:
                out = lv | rv
                nl = (ln | rn) & ~out
            return ExprResult(_astype(out, np.int8), DBType.BOOL,
                              nl if _any(nl) else None)

        # VARCHAR comparisons on dictionary codes --------------------------
        if l.dbtype == DBType.VARCHAR or r.dbtype == DBType.VARCHAR:
            return _varchar_cmp(op, l, r, ctx)

        if op in _CMP:
            lf, rf = l.as_float(xp), r.as_float(xp)
            out = {"=": lf == rf, "<>": lf != rf, "<": lf < rf,
                   "<=": lf <= rf, ">": lf > rf, ">=": lf >= rf}[op]
            nl = l.null_or_false(xp) | r.null_or_false(xp)
            out = out & ~nl
            return ExprResult(_astype(out, np.int8), DBType.BOOL,
                              nl if _any(nl) else None)

        if op in _ARITH:
            t = common_type(l.dbtype, r.dbtype)
            nl = l.null_or_false(xp) | r.null_or_false(xp)
            nl = nl if _any(nl) else None
            if t == DBType.DECIMAL or is_float(t) or op == "/":
                lf, rf = l.as_float(xp), r.as_float(xp)
                if op == "/":
                    out = lf / xp.where(rf == 0, 1.0, rf)
                    zero = rf == 0
                    nl2 = zero if nl is None else (nl | zero)
                    return ExprResult(out, DBType.FLOAT64,
                                      nl2 if _any(nl2) else None)
                out = {"+": lf + rf, "-": lf - rf, "*": lf * rf,
                       "%": lf % xp.where(rf == 0, 1.0, rf)}[op]
                return ExprResult(out, DBType.FLOAT64, nl)
            lv = _astype(l.values, np.int64)
            rv = _astype(r.values, np.int64)
            out = {"+": lv + rv, "-": lv - rv, "*": lv * rv,
                   "%": lv % xp.where(rv == 0, 1, rv)}[op]
            return ExprResult(out, DBType.INT64, nl)

        raise ValueError(f"unknown op {op}")

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _any(m) -> bool:
    if m is None:
        return False
    if isinstance(m, np.ndarray):
        return bool(m.any())
    return True  # device tensor: keep the mask (no host sync)


def _varchar_cmp(op: str, l: ExprResult, r: ExprResult, ctx) -> ExprResult:
    xp = ctx.xp
    # column vs string literal: compare codes via the order-preserving heap
    if isinstance(r.values, str) or isinstance(l.values, str):
        if isinstance(l.values, str):
            # normalize to column-op-literal with flipped op
            flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
                    "=": "=", "<>": "<>"}
            return _varchar_cmp(flip[op], r, l, ctx)
        heap: StringHeap = l.heap
        s = r.values
        codes = l.values
        nl = codes == 0
        if op in ("=", "<>"):
            c = heap.code_of(s)
            out = (codes == c) if op == "=" else ((codes != c) & ~nl)
        elif op == "<":
            out = (codes < heap.lower_bound(s)) & ~nl
        elif op == "<=":
            out = (codes < heap.upper_bound(s)) & ~nl
        elif op == ">":
            out = codes >= heap.upper_bound(s)
        elif op == ">=":
            out = codes >= heap.lower_bound(s)
        else:
            raise ValueError(op)
        out = out & ~nl
        return ExprResult(_astype(out, np.int8), DBType.BOOL,
                          nl if _any(nl) else None)
    # column vs column: only valid when they share a heap (same table scan)
    if l.heap is r.heap:
        out = {"=": l.values == r.values, "<>": l.values != r.values,
               "<": l.values < r.values, "<=": l.values <= r.values,
               ">": l.values > r.values, ">=": l.values >= r.values}[op]
        nl = (l.values == 0) | (r.values == 0)
        out = out & ~nl
        return ExprResult(_astype(out, np.int8), DBType.BOOL,
                          nl if _any(nl) else None)
    # cross-heap: decode (rare; host path only)
    ls = l.heap.decode(np.asarray(l.values)).astype(str)
    rs = r.heap.decode(np.asarray(r.values)).astype(str)
    out = {"=": ls == rs, "<>": ls != rs, "<": ls < rs, "<=": ls <= rs,
           ">": ls > rs, ">=": ls >= rs}[op]
    nl = (np.asarray(l.values) == 0) | (np.asarray(r.values) == 0)
    return ExprResult((out & ~nl).astype(np.int8), DBType.BOOL,
                      nl if nl.any() else None)


@dataclass(eq=False)
class Not(Expr):
    child: Expr

    def columns(self):
        return self.child.columns()

    def eval(self, ctx):
        c = self.child.eval(ctx)
        out = _astype(c.values == 0, np.int8)
        return ExprResult(out, DBType.BOOL, c.null)

    def __repr__(self):
        return f"Not({self.child!r})"


@dataclass(eq=False)
class IsNull(Expr):
    child: Expr
    negate: bool = False

    def columns(self):
        return self.child.columns()

    def eval(self, ctx):
        c = self.child.eval(ctx)
        m = c.null_or_false(ctx.xp)
        if self.negate:
            m = ~m
        return ExprResult(_astype(m, np.int8), DBType.BOOL, None)

    def __repr__(self):
        return f"IsNull({self.child!r}, neg={self.negate})"


@dataclass(eq=False)
class InList(Expr):
    child: Expr
    values: list

    def columns(self):
        return self.child.columns()

    def eval(self, ctx):
        xp = ctx.xp
        c = self.child.eval(ctx)
        if c.dbtype == DBType.VARCHAR:
            codes = [c.heap.code_of(v) for v in self.values]
            out = xp.zeros(c.values.shape, dtype=bool)
            for code in codes:
                out = out | (c.values == code)
            nl = c.values == 0
        else:
            out = xp.zeros(c.values.shape, dtype=bool)
            for v in self.values:
                out = out | (c.as_float(xp) == float(v))
            nl = c.null_or_false(xp)
        out = out & ~nl
        return ExprResult(_astype(out, np.int8), DBType.BOOL,
                          nl if _any(nl) else None)

    def __repr__(self):
        return f"InList({self.child!r}, {self.values})"


@dataclass(eq=False)
class Like(Expr):
    """SQL LIKE via the dictionary fast path: evaluate the pattern once per
    distinct heap entry (tiny), then gather through the codes.  This is our
    PCRE-free LIKE (paper §3.4 'Dependencies')."""
    child: Expr
    pattern: str

    def columns(self):
        return self.child.columns()

    def eval(self, ctx):
        c = self.child.eval(ctx)
        if c.dbtype != DBType.VARCHAR:
            raise TypeError("LIKE requires VARCHAR")
        pat = self.pattern.replace("%", "*").replace("_", "?")
        heap_match = np.array(
            [False] + [fnmatch.fnmatchcase(str(v), pat)
                       for v in c.heap.values[1:]], dtype=bool)
        hm = ctx.xp.asarray(heap_match)
        out = hm[c.values]
        nl = c.values == 0
        return ExprResult(_astype(out, np.int8), DBType.BOOL,
                          nl if _any(nl) else None)

    def __repr__(self):
        return f"Like({self.child!r}, {self.pattern!r})"


@dataclass(eq=False)
class Func(Expr):
    """Scalar functions: sqrt, abs, year, floor, ceil, round, log, exp."""
    name: str
    args: tuple

    def __init__(self, name: str, *args):
        self.name = name
        self.args = tuple(_lit(a) for a in args)

    def columns(self):
        s = set()
        for a in self.args:
            s |= a.columns()
        return s

    def eval(self, ctx):
        xp = ctx.xp
        name = self.name.lower()
        a = self.args[0].eval(ctx)
        if name == "year":
            if xp is np:
                from .types import date_year
                out = date_year(a.values)
            else:
                # branch-free approximate civil-calendar year (exact for the
                # proleptic Gregorian calendar, days>=0): shift to era days.
                z = _astype(a.values, np.int64) + 719468
                era = xp.where(z >= 0, z, z - 146096) // 146097
                doe = z - era * 146097
                yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
                y = yoe + era * 400
                doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
                mp = (5 * doy + 2) // 153
                out = _astype(y + (mp >= 10), np.int32)
            return ExprResult(out, DBType.INT32, a.null)
        v = a.as_float(xp)
        if name == "sqrt":
            out = xp.sqrt(xp.maximum(v, 0.0))
        elif name == "abs":
            out = xp.abs(v)
        elif name == "floor":
            out = xp.floor(v)
        elif name == "ceil":
            out = xp.ceil(v)
        elif name == "round":
            nd = int(self.args[1].value) if len(self.args) > 1 else 0
            out = xp.round(v, nd) if xp is np else xp.round(v * 10**nd) / 10**nd
        elif name == "log":
            out = xp.log(xp.maximum(v, 1e-300))
        elif name == "exp":
            out = xp.exp(v)
        else:
            raise ValueError(f"unknown function {self.name}")
        return ExprResult(out, DBType.FLOAT64, a.null)

    def __repr__(self):
        return f"Func({self.name}, {self.args!r})"


@dataclass(eq=False)
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE e END"""
    branches: Sequence[tuple[Expr, Expr]]
    default: Expr

    def columns(self):
        s = self.default.columns()
        for c, v in self.branches:
            s |= c.columns() | v.columns()
        return s

    def eval(self, ctx):
        xp = ctx.xp
        out_r = self.default.eval(ctx)
        out = out_r.as_float(xp)
        nl = out_r.null_or_false(xp)
        for cond, val in reversed(list(self.branches)):
            c = cond.eval(ctx)
            v = val.eval(ctx)
            takec = (c.values != 0) & ~c.null_or_false(xp)
            out = xp.where(takec, v.as_float(xp), out)
            nl = xp.where(takec, v.null_or_false(xp), nl)
        return ExprResult(out, DBType.FLOAT64, nl if _any(nl) else None)

    def __repr__(self):
        return f"Case({self.branches!r}, {self.default!r})"


@dataclass(eq=False)
class Cast(Expr):
    child: Expr
    to: DBType

    def columns(self):
        return self.child.columns()

    def eval(self, ctx):
        xp = ctx.xp
        c = self.child.eval(ctx)
        if self.to == c.dbtype:
            return c
        v = c.as_float(xp)
        from .types import STORAGE_DTYPE
        out = _astype(v, STORAGE_DTYPE[self.to])
        return ExprResult(out, self.to, c.null)

    def __repr__(self):
        return f"Cast({self.child!r} as {self.to})"
