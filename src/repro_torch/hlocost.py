"""Trip-count-aware cost extraction from optimised XLA HLO text.

The port's own copy of the reference's jax-free parser
(``src/repro/hlocost.py``), kept so that the port reads HLO text (a
reference dry run's, or any XLA module's) without importing the JAX
package: the same functions, the same counts.

``Compiled.cost_analysis()`` counts every while-loop body ONCE — for a
94-layer scan that under-counts FLOPs by ~94×. This parser walks the HLO
computation graph, multiplies loop bodies by their ``known_trip_count``, and
accounts:

- **flops**: 2 × |result| × |contracting dims| for every ``dot`` (dots are
  >99 % of model FLOPs in these architectures);
- **bytes**: operands + result of every top-level op (fusion internals are
  free — they live in registers/VMEM; dots inside fusions still count flops);
- **collectives**: result bytes per collective kind.

Costs are per device (the module is one SPMD partition's program).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

#: ops whose operand/result bytes do not represent HBM traffic. Besides the
#: no-op bookkeeping ops, plain elementwise/broadcast ops are excluded: the
#: TPU backend fuses them into neighbouring kernels (the CPU backend leaves
#: many at top level, which would overstate HBM traffic ~40x). Bytes are
#: counted for dots, fusions, copies, slices/updates, reduces, collectives —
#: the ops that necessarily move HBM data on TPU.
_FREE_BYTES = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "partition-id", "replica-id", "iota",
    # fused-on-TPU elementwise / shape ops
    "add", "subtract", "multiply", "divide", "negate", "abs", "sign",
    "select", "compare", "convert", "and", "or", "not", "xor",
    "exponential", "exponential-minus-one", "tanh", "log", "log-plus-one",
    "sqrt", "rsqrt", "cbrt", "power", "maximum", "minimum", "clamp",
    "broadcast", "reshape", "floor", "ceil", "round-nearest-afz", "is-finite",
    "cosine", "sine", "logistic", "shift-left", "shift-right-logical",
    "shift-right-arithmetic", "remainder",
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_info(type_str: str) -> Tuple[int, Tuple[int, ...]]:
    """bytes, dims of a (possibly tuple) type string."""
    total, dims = 0, ()
    for m in _SHAPE_RE.finditer(type_str):
        dt, ds = m.group(1), m.group(2)
        n = 1
        for d in ds.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
        dims = tuple(int(d) for d in ds.split(",") if d)
    return total, dims


@dataclasses.dataclass
class Op:
    name: str
    type_str: str
    opcode: str
    operands: List[str]
    attrs: str


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.coll is None:
            self.coll = {k: 0.0 for k in _COLLECTIVES}

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k in self.coll:
            self.coll[k] += o.coll[k]
        return self

    def scaled(self, f: float) -> "Cost":
        return Cost(self.flops * f, self.bytes * f,
                    {k: v * f for k, v in self.coll.items()})

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


_NAME_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*")
_OPCODE_RE = re.compile(r"\s*([\w\-]+)\(")
_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{")


def _scan_type(s: str, i: int) -> int:
    """Return end index of the type string starting at s[i] (handles nested
    tuple types like ((s32[], bf16[2,3]{1,0}), f32[4]))."""
    if s[i] == "(":
        depth = 0
        while i < len(s):
            if s[i] == "(":
                depth += 1
            elif s[i] == ")":
                depth -= 1
                if depth == 0:
                    return i + 1
            i += 1
        return i
    m = re.match(r"\w+\[[\d,]*\](?:\{[^}]*\})?\S*", s[i:])
    return i + (m.end() if m else 0)


def _split_operands(s: str) -> List[str]:
    """Top-level comma split of the operand segment."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def parse_computations(text: str) -> Dict[str, List[Op]]:
    comps: Dict[str, List[Op]] = {}
    cur: Optional[str] = None
    entry: Optional[str] = None
    for line in text.splitlines():
        st = line.strip()
        hm = _HEADER_RE.match(st)
        if hm and st.endswith("{"):
            cur = hm.group(1)
            comps[cur] = []
            if st.startswith("ENTRY"):
                entry = cur
            continue
        if st.startswith("}"):
            continue
        nm = _NAME_RE.match(st)
        if nm and cur is not None:
            name = nm.group(1)
            tend = _scan_type(st, nm.end())
            if tend <= nm.end():
                continue
            type_str = st[nm.end():tend]
            om = _OPCODE_RE.match(st[tend:])
            if not om:
                continue
            opcode = om.group(1)
            rest = st[tend + om.end():]
            # operand segment: balance parens from here
            depth, i = 1, 0
            while i < len(rest) and depth:
                if rest[i] in "([{":
                    depth += 1
                elif rest[i] in ")]}":
                    depth -= 1
                i += 1
            operands = _split_operands(rest[:i - 1])
            attrs = rest[i:]
            comps[cur].append(Op(name, type_str, opcode, operands, attrs))
    comps["__entry__"] = comps.get(entry, [])
    if entry:
        comps.setdefault(entry, [])
        comps["__entry_name__"] = entry  # type: ignore
    return comps


def _dot_flops(op: Op, symtab: Dict[str, str]) -> float:
    rbytes, rdims = _shape_info(op.type_str)
    del rbytes
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
    cdims = [int(x) for x in m.group(1).split(",") if x] if m else []
    lhs = op.operands[0] if op.operands else ""
    if "[" in lhs:        # inline-typed operand: "f32[128,128]{1,0} %name"
        _, ldims = _shape_info(lhs)
    else:
        _, ldims = _shape_info(symtab.get(lhs.lstrip("%"), ""))
    k = 1
    for c in cdims:
        if c < len(ldims):
            k *= ldims[c]
    n = 1
    for d in rdims:
        n *= d
    return 2.0 * n * k


def _trip_count(op: Op) -> float:
    m = re.search(r'known_trip_count[^0-9]*(\d+)', op.attrs)
    return float(m.group(1)) if m else 1.0


def _called(op: Op) -> List[Tuple[str, float]]:
    """(computation name, multiplier) pairs invoked by this op."""
    out = []
    if op.opcode == "while":
        t = _trip_count(op)
        for key in ("body", "condition"):
            m = re.search(key + r"=%([\w.\-]+)", op.attrs)
            if m:
                out.append((m.group(1), t))
    elif op.opcode in ("fusion", "call", "async-start"):
        for key in ("calls", "to_apply", "called_computation"):
            m = re.search(key + r"=%([\w.\-]+)", op.attrs)
            if m:
                out.append((m.group(1), 1.0))
    elif op.opcode == "conditional":
        m = re.search(r"branch_computations=\{([^}]*)\}", op.attrs)
        if m:
            names = [x.strip().lstrip("%") for x in m.group(1).split(",")]
            # conservative: every branch once (usually tiny)
            out += [(n, 1.0) for n in names]
        for key in ("true_computation", "false_computation"):
            m = re.search(key + r"=%([\w.\-]+)", op.attrs)
            if m:
                out.append((m.group(1), 1.0))
    return out


def module_cost(text: str) -> Cost:
    comps = parse_computations(text)
    entry = comps.pop("__entry_name__", None)  # type: ignore
    comps.pop("__entry__", None)
    memo: Dict[str, Cost] = {}

    def cost_of(name: str) -> Cost:
        if name in memo:
            return memo[name]
        memo[name] = Cost()  # cycle guard
        total = Cost()
        ops = comps.get(name, [])
        symtab = {o.name: o.type_str for o in ops}
        for op in ops:
            if op.opcode == "dot":
                total.flops += _dot_flops(op, symtab)
            base = op.opcode.replace("-start", "").replace("-done", "")
            if base in _COLLECTIVES and not op.opcode.endswith("-done"):
                b, _ = _shape_info(op.type_str)
                total.coll[base] += b
            if op.opcode not in _FREE_BYTES:
                b, _ = _shape_info(op.type_str)
                if op.opcode in ("dynamic-slice", "slice", "gather"):
                    # reads only the addressed window, writes the result
                    total.bytes += 2 * b
                elif op.opcode in ("dynamic-update-slice", "scatter"):
                    # in-place: traffic = the update operand (read + write)
                    ub = 0
                    if len(op.operands) > 1:
                        ref = op.operands[1].lstrip("%")
                        if ref in symtab:
                            ub, _ = _shape_info(symtab[ref])
                    total.bytes += 2 * (ub or b)
                else:
                    ob = 0
                    for o in op.operands:
                        ref = o.lstrip("%")
                        if ref in symtab:
                            x, _ = _shape_info(symtab[ref])
                            ob += x
                        elif "[" in o:  # inline-typed operand
                            x, _ = _shape_info(o)
                            ob += x
                    total.bytes += b + ob
            for cname, mult in _called(op):
                total += cost_of(cname).scaled(mult)
        memo[name] = total
        return total

    if entry is None:
        # fall back: the computation that nothing else calls
        called = set()
        for ops in comps.values():
            for op in ops:
                called.update(n for n, _ in _called(op))
        roots = [n for n in comps if n not in called]
        entry = roots[-1] if roots else next(iter(comps))
    return cost_of(entry)
