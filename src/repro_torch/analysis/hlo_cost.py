"""Trip-count-aware cost model over optimized HLO text.

The port's copy of ``repro.analysis.hlo_cost``, unchanged in behaviour
(pure Python, no JAX): it reads HLO text that the reference's dry run
wrote.  The port's own dry run has no HLO; ``analysis.trace`` counts its
steps instead.

``compiled.cost_analysis()`` counts every ``while`` body ONCE — for
scan-over-layers models that undercounts FLOPs/bytes/collectives by the
layer count x microbatch count (observed 100-366x on the baseline table).
This module re-derives the three roofline inputs from the optimized HLO:

  * computations are parsed (name -> instructions, shapes);
  * ``while`` trip counts are read from the loop condition's
    ``compare(.., constant(N)), direction=LT`` pattern (jax scans lower to
    exactly this; unknown conditions conservatively count as 1 and are
    reported);
  * a DFS from ENTRY accumulates, per instruction, multiplier-weighted:
      - dot FLOPs (2 x output elements x contraction size) — MXU flops,
        including dots inside fusion subcomputations (XLA's own convention);
      - bytes accessed at fusion boundaries (output + operands of top-level
        ops; ops fused into a computation don't touch HBM — again XLA's
        convention);
      - collective bytes by op kind.

Validated in tests against hand-computable modules (scan of matmuls).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["HloCost", "analyze_hlo"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# instruction line:  %name = TYPE opcode(operands...), attrs
# NOTE: tuple types contain /*index=N*/ comments (with '='), so the tuple
# branch matches anything up to the first ')' that closes it — tuple types in
# HLO never nest parens.
_INSTR_RE = re.compile(
    r"^\s*(?P<root>ROOT\s+)?%([\w.\-]+)\s*=\s*((?:\([^()]*\))|(?:[\w\[\],{}\/\* ]+?))\s+"
    r"([\w\-]+)\((.*?)\)(.*)$")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\((.*?)\)\s*->")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_elems(type_str: str) -> int:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return 0
    n = 1
    for d in m.group(2).split(","):
        if d:
            n *= int(d)
    return n


@dataclass
class _Instr:
    name: str
    type_str: str
    opcode: str
    operands: list[str]
    attrs: str
    raw_operands: str = ""
    is_root: bool = False


@dataclass
class _Computation:
    name: str
    instrs: list[_Instr] = field(default_factory=list)


@dataclass
class HloCost:
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=dict)
    collective_counts: dict[str, float] = field(default_factory=dict)
    unknown_trip_loops: int = 0
    bytes_by_op: dict[str, float] = field(default_factory=dict)

    def _add_bytes(self, op: str, n: float) -> None:
        self.bytes_accessed += n
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + n

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "bytes_accessed": self.bytes_accessed,
                "bytes_by_op": {k: round(v) for k, v in sorted(
                    self.bytes_by_op.items(), key=lambda kv: -kv[1])},
                "collective_bytes": self.collective_bytes,
                "collective_counts": self.collective_counts,
                "total_collective_bytes": self.total_collective_bytes,
                "unknown_trip_loops": self.unknown_trip_loops}


def _parse_module(text: str):
    comps: dict[str, _Computation] = {}
    types: dict[str, str] = {}
    entry: str | None = None
    cur: _Computation | None = None

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if (("->" in line) and line.endswith("{")
                and (line.startswith("%") or line.startswith("ENTRY"))):
            m = _COMP_HDR_RE.match(line)
            if m:
                cur = _Computation(m.group(1))
                comps[cur.name] = cur
                if line.startswith("ENTRY"):
                    entry = cur.name
                # parameters: "name: type, name: type"
                params = m.group(2)
                for pm in re.finditer(r"([\w.\-]+)\s*:\s*((?:\([^()]*\))|[^,]+)",
                                      params):
                    types[pm.group(1)] = pm.group(2)
                continue
        if line == "}":
            continue
        if cur is None:
            continue
        im = _INSTR_RE.match(line)
        if not im:
            continue
        root, name, type_str, opcode, operand_str, attrs = im.groups()
        operands = _OPERAND_RE.findall(operand_str)
        cur.instrs.append(_Instr(name, type_str.strip(), opcode, operands,
                                 attrs, operand_str, is_root=bool(root)))
        types[name] = type_str.strip()
    return comps, types, entry


def _trip_count(cond: _Computation) -> int | None:
    """jax scan conditions: compare(counter, constant(N)), direction=LT.

    Constants print as ``%c = s32[] constant(24)`` — the literal lands in the
    operand field of the parsed instruction line.
    """
    consts: dict[str, int] = {}
    for ins in cond.instrs:
        if ins.opcode == "constant":
            blob = ins.raw_operands + " " + ins.attrs
            mm = re.search(r"(-?\d+)", blob)
            if mm:
                consts[ins.name] = int(mm.group(1))
    for ins in cond.instrs:
        if ins.opcode == "compare" and "direction=LT" in ins.attrs:
            for op in ins.operands:
                if op in consts:
                    return consts[op]
    return None


def _dot_flops(ins: _Instr, types: dict[str, str]) -> float:
    out_elems = _shape_elems(ins.type_str)
    # contraction size from lhs operand shape + lhs_contracting_dims
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.attrs)
    if not m or not ins.operands:
        return 2.0 * out_elems  # degenerate
    lhs_type = types.get(ins.operands[0], "")
    sm = _SHAPE_RE.search(lhs_type)
    if not sm:
        return 2.0 * out_elems
    dims = [int(d) for d in sm.group(2).split(",") if d]
    csize = 1
    for idx in (int(i) for i in m.group(1).split(",") if i):
        if idx < len(dims):
            csize *= dims[idx]
    return 2.0 * out_elems * csize


_SKIP_BYTES = {"parameter", "constant", "tuple", "get-tuple-element",
               "bitcast", "while", "call", "conditional", "after-all",
               "iota", "broadcast"}

_SLICE_OPS = {"dynamic-slice", "slice"}


def _fusion_bytes(ins: _Instr, comps: dict, types: dict,
                  called: str | None) -> float:
    """Bytes at a fusion boundary with XLA's in-place conventions:

    * an operand whose only in-fusion consumers are (dynamic-)slices is
      charged those slices' outputs, not the whole buffer (loop-carried KV
      caches are read one layer-slice at a time);
    * a fusion whose root is dynamic-update-slice updates in place: charge
      the update bytes rather than the whole result.
    """
    out_bytes = _shape_bytes(ins.type_str)
    opnd_bytes = sum(_shape_bytes(types.get(o, "")) for o in ins.operands)
    comp = comps.get(called) if called else None
    if comp is None or not comp.instrs:
        return out_bytes + opnd_bytes

    local_types = {i.name: i.type_str for i in comp.instrs}
    root = next((i for i in comp.instrs if i.is_root), comp.instrs[-1])
    dus_root = root.opcode == "dynamic-update-slice"
    dus_target = root.operands[0] if dus_root and root.operands else None
    # parameter index -> instruction name
    param_name: dict[int, str] = {}
    for i in comp.instrs:
        if i.opcode == "parameter":
            mm = re.search(r"parameter\((\d+)\)",
                           f"parameter({i.raw_operands})")
            if mm:
                param_name[int(mm.group(1))] = i.name

    opnd_bytes = 0.0
    for idx, o in enumerate(ins.operands):
        pname = param_name.get(idx)
        full = _shape_bytes(types.get(o, ""))
        if pname is None:
            opnd_bytes += full
            continue
        consumers = [i for i in comp.instrs if pname in i.operands]
        if dus_root and dus_target is not None and consumers == [root] \
                and pname == dus_target:
            continue  # in-place DUS target: aliased, not re-read
        if consumers and all(i.opcode in _SLICE_OPS for i in consumers):
            opnd_bytes += sum(_shape_bytes(i.type_str) for i in consumers)
        else:
            opnd_bytes += full

    if dus_root and len(root.operands) > 1:
        upd = _shape_bytes(local_types.get(root.operands[1], ""))
        out_bytes = 2 * upd
    return out_bytes + opnd_bytes


def analyze_hlo(text: str) -> HloCost:
    comps, types, entry = _parse_module(text)
    cost = HloCost()
    if entry is None:
        return cost

    # constant parse for while conditions happens lazily per computation.
    def walk(comp_name: str, mult: float, seen: tuple):
        comp = comps.get(comp_name)
        if comp is None or comp_name in seen:
            return
        seen = seen + (comp_name,)
        for ins in comp.instrs:
            op = ins.opcode
            if op == "while":
                body = re.search(r"body=%?([\w.\-]+)", ins.attrs)
                cond = re.search(r"condition=%?([\w.\-]+)", ins.attrs)
                trips = None
                tc = re.search(r'"known_trip_count":\{"n":"(\d+)"\}', ins.attrs)
                if tc:
                    trips = int(tc.group(1))
                elif cond and cond.group(1) in comps:
                    trips = _trip_count(comps[cond.group(1)])
                if trips is None:
                    trips = 1
                    cost.unknown_trip_loops += 1
                if body:
                    walk(body.group(1), mult * trips, seen)
                continue
            if op == "fusion":
                fc = re.search(r"calls=%?([\w.\-]+)", ins.attrs)
                if fc:
                    _flops_only(fc.group(1), mult, seen)
                cost._add_bytes("fusion",
                                mult * _fusion_bytes(ins, comps, types,
                                                     fc.group(1) if fc else None))
                continue
            if op in ("call", "conditional"):
                for target in re.findall(
                        r"(?:to_apply|calls|branch_computations=\{)[=%]*([\w.\-]+)",
                        ins.attrs):
                    walk(target, mult, seen)
                continue
            if op == "dot":
                cost.dot_flops += mult * _dot_flops(ins, types)
            if op in _COLLECTIVES or any(
                    op == c + "-start" for c in _COLLECTIVES):
                base = op[:-6] if op.endswith("-start") else op
                nbytes = mult * _shape_bytes(ins.type_str)
                cost.collective_bytes[base] = \
                    cost.collective_bytes.get(base, 0.0) + nbytes
                cost.collective_counts[base] = \
                    cost.collective_counts.get(base, 0.0) + mult
            if op.endswith("-done"):
                continue
            if op in _SKIP_BYTES:
                continue
            if op in ("dynamic-slice", "slice"):
                # XLA's HloCostAnalysis convention: a slice reads only the
                # sliced bytes, not the whole operand buffer.
                cost._add_bytes(op, mult * 2 * _shape_bytes(ins.type_str))
                continue
            if op == "dynamic-update-slice":
                # In-place update: read+write of the update operand only.
                upd = (_shape_bytes(types.get(ins.operands[1], ""))
                       if len(ins.operands) > 1 else 0)
                cost._add_bytes(op, mult * 2 * upd)
                continue
            if op == "gather":
                idx = (_shape_bytes(types.get(ins.operands[1], ""))
                       if len(ins.operands) > 1 else 0)
                cost._add_bytes(op, mult * (2 * _shape_bytes(ins.type_str)
                                            + idx))
                continue
            cost._add_bytes(op, mult * (
                _shape_bytes(ins.type_str)
                + sum(_shape_bytes(types.get(o, "")) for o in ins.operands)))

    def _flops_only(comp_name: str, mult: float, seen: tuple):
        comp = comps.get(comp_name)
        if comp is None or comp_name in seen:
            return
        seen = seen + (comp_name,)
        for ins in comp.instrs:
            if ins.opcode == "dot":
                cost.dot_flops += mult * _dot_flops(ins, types)
            elif ins.opcode == "fusion":
                fc = re.search(r"calls=%?([\w.\-]+)", ins.attrs)
                if fc:
                    _flops_only(fc.group(1), mult, seen)

    walk(entry, 1.0, ())
    return cost
