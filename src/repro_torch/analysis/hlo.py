"""Parse collective-communication bytes out of compiled HLO text.

The port's copy of ``repro.analysis.hlo``, unchanged in behaviour (pure
Python, no JAX), so that the port's ``report`` reads the reference's
dry-run artifacts too; the port's own dry run records its collectives
with ``analysis.trace`` in the same form (``CollectiveStats``).

``compiled.cost_analysis()`` has no collective term, so — per the assignment —
we sum operand sizes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute op in the (post-SPMD, per-device) module.

Byte convention (documented because parsers differ): for every collective we
count the bytes of the op's *result* shape(s) on one device — for all-gather
that is the gathered output (what crosses links, up to the (n-1)/n factor the
roofline model treats as ~1), for all-reduce/reduce-scatter/all-to-all/
permute the result equals the participating buffer. ``-done`` halves of
async pairs are skipped so nothing is double-counted.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["CollectiveStats", "parse_collectives", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")

# e.g.  %all-gather.1 = f32[256,128]{1,0} all-gather(...)
#       %ar = (f32[8], f32[16]) all-reduce-start(...)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_LINE_RE = re.compile(
    r"=\s*(?P<shapes>\([^)]*\)|\S+)\s+(?P<op>" + "|".join(_OPS) +
    r")(?P<suffix>[-\w.]*)\(")


@dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int] = field(default_factory=dict)
    count_by_op: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def to_json(self) -> dict:
        return {"bytes_by_op": self.bytes_by_op,
                "count_by_op": self.count_by_op,
                "total_bytes": self.total_bytes,
                "total_count": self.total_count}


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


def parse_collectives(hlo_text: str) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _LINE_RE.search(line)
        if not m:
            continue
        if m.group("suffix").startswith("-done"):
            continue                      # async pair: count the -start only
        op = m.group("op")
        nbytes = _shape_bytes(m.group("shapes"))
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + nbytes
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
    return stats
