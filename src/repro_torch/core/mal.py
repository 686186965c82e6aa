"""MAL-style physical programs: linear column-at-a-time instruction lists.

The relational tree compiles into a ``MALProgram`` — a sequence of
instructions over named column registers, mirroring MonetDB's Monet Assembly
Language (paper §3.1).  Every instruction processes *whole columns*; each is
marked ``parallelizable`` or ``blocking`` exactly like the paper's Fig. 2:
the chunked/distributed executor (parallel.py) maps parallelizable prefixes
over shards and merges at blocking instructions.

Instruction set
---------------
load   t.c            -> r          [par]  pull a base column (page-in)
expr   {col->reg}, E  -> r          [par]  vectorized scalar expression
select {col->reg}, P  -> m          [par]  predicate -> bool selection mask
mand   m1, m2         -> m          [par]  mask conjunction
fetch  r, idx         -> r'         [par]  positional gather (join output)
join   lkeys, rkeys, lm, rm, how -> (lidx, ridx)       [blocking]
group  keys, m        -> (gid, n, repidx)              [blocking]
agg    fn, val, gid, m, n -> r (len n_groups)          [blocking; partial-izable]
sort   keys, descs, limit -> idx                        [blocking]
take   r, idx         -> r'         [par]
result names, regs                                      [blocking]
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

PARALLELIZABLE = {"load", "expr", "select", "mand", "fetch", "take"}
BLOCKING = {"join", "group", "agg", "sort", "result"}


@dataclass
class Instr:
    op: str
    out: tuple[str, ...]            # output register name(s)
    args: tuple[str, ...]           # input register names
    payload: Any = None             # op-specific static data

    @property
    def parallelizable(self) -> bool:
        # 'agg' is algebraically partial-izable (sum/count/min/max partials
        # merge associatively); the distributed executor exploits that, the
        # sequential one treats it as blocking.
        return self.op in PARALLELIZABLE

    def signature(self) -> tuple:
        return (self.op, self.args, repr(self.payload))

    def __repr__(self):
        outs = ",".join(self.out)
        args = ",".join(self.args)
        p = f" {self.payload!r}" if self.payload is not None else ""
        flag = "P" if self.parallelizable else "B"
        return f"[{flag}] {outs} := {self.op}({args}){p}"


@dataclass
class MALProgram:
    instrs: list[Instr] = field(default_factory=list)
    result_names: list[str] = field(default_factory=list)
    _cse: dict = field(default_factory=dict)
    _ctr: int = 0

    def fresh(self, hint: str = "r") -> str:
        self._ctr += 1
        return f"{hint}{self._ctr}"

    def emit(self, op: str, args: tuple[str, ...], payload=None,
             n_out: int = 1, hint: str = "r") -> tuple[str, ...]:
        """Append an instruction with MAL-level CSE (paper optimization
        level 2): identical (op, args, payload) reuse the existing output."""
        ins = Instr(op, (), tuple(args), payload)
        sig = ins.signature()
        if sig in self._cse and op != "result":
            return self._cse[sig]
        outs = tuple(self.fresh(hint) for _ in range(n_out))
        ins.out = outs
        self.instrs.append(ins)
        self._cse[sig] = outs
        return outs

    def listing(self) -> str:
        return "\n".join(repr(i) for i in self.instrs)

    def __len__(self):
        return len(self.instrs)
