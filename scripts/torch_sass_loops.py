#!/usr/bin/env python3
"""Compile kernel sources of one tree with ``nvcc -cubin -Xptxas -v`` and
summarise their SASS (``cuobjdump -sass``): registers, stack and spills
per kernel, every innermost loop (a backward branch and the instructions
it jumps back over) with its memory operations in order and its
arithmetic counts, and per kernel the tensor-core products (``HMMA``) and
matrix loads (``LDSM``) it holds, by full opcode. It answers questions
such as whether a row loop's loads move past its stores, or whether a
kernel runs on the tensor cores.

Usage, on a machine with the CUDA toolkit (nvcc and cuobjdump on PATH or
under /usr/local/cuda/bin), from the root of a checkout::

    python3 scripts/torch_sass_loops.py <root of the tree> <out dir> \\
        arena_stream_roll.cu arena_pool.cu

Each source is ``<root>/src/repro_torch/kernels/csrc/<name>``; the SASS and
the ptxas report are written to ``<out dir>/<name>.sass`` and
``<out dir>/<name>.ptxas.txt``, and one JSON line per source is printed.
"""
import json
import pathlib
import re
import shutil
import subprocess
import sys

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin", "-Xptxas", "-v"]
MEM = re.compile(r"^(LDG|STG|LDS|STS|LD|ST|LDL|STL|ATOMG|RED|LDGSTS)\b")
#: opcodes counted over a whole kernel, by their full name (the tensor-core
#: products and the shared-memory matrix loads that feed them)
WHOLE = ("HMMA", "LDSM")
ARITH = ("FFMA", "FMUL", "FADD", "IMAD", "IADD3", "FMNMX", "IMNMX",
         "VIMNMX") + WHOLE


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(path).exists():
        raise SystemExit(f"{name} not found")
    return path


def _functions(sass: str):
    """(function name, [(address, instruction)]) per kernel of the SASS."""
    funcs, name, body = [], None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                funcs.append((name, body))
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            body.append((int(m.group(1), 16), m.group(2)))
    if name:
        funcs.append((name, body))
    return funcs


def _opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins.split() else ""


def _loops(body):
    """Innermost loops: a branch back to an earlier address with no other
    backward branch between its target and itself."""
    idx = {a: i for i, (a, _) in enumerate(body)}
    back = []
    for i, (addr, ins) in enumerate(body):
        op = _opcode(ins)
        m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", ins)
        if op == "BRA" and m and m.group(1):
            tgt = int(m.group(1), 16)
            if tgt < addr and tgt in idx:
                back.append((idx[tgt], i))
    inner = [(s, e) for s, e in back
             if not any(s < s2 and e2 < e for s2, e2 in back)]
    out = []
    for s, e in inner:
        ops = [_opcode(ins) for _, ins in body[s:e + 1]]
        mem = [op for op in ops if MEM.match(op)]
        out.append({
            "start": hex(body[s][0]), "instructions": len(ops),
            "memory_in_order": " ".join(mem),
            "arith": {a: sum(op.startswith(a) for op in ops) for a in ARITH
                      if any(op.startswith(a) for op in ops)},
            "barriers": sum(op.startswith("BAR") for op in ops)})
    return out


def _whole(body) -> dict:
    """Counts of the :data:`WHOLE` opcodes over a kernel, by full opcode
    (``HMMA.16816.F32.BF16``: bf16 in, f32 accumulate)."""
    counts = {}
    for _, ins in body:
        op = _opcode(ins)
        if op.startswith(WHOLE):
            counts[op] = counts.get(op, 0) + 1
    return counts


def main() -> int:
    root, out = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
    out.mkdir(parents=True, exist_ok=True)
    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    for name in sys.argv[3:]:
        src = root / "src" / "repro_torch" / "kernels" / "csrc" / name
        cubin = out / (name + ".cubin")
        p = subprocess.run([nvcc, *FLAGS, "-o", str(cubin), str(src)],
                           capture_output=True, text=True)
        (out / (name + ".ptxas.txt")).write_text(p.stdout + p.stderr)
        if p.returncode:
            print(json.dumps({"source": name, "nvcc_rc": p.returncode}))
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        (out / (name + ".sass")).write_text(sass)
        ptxas = {}
        for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                             r"registers", p.stdout + p.stderr, re.S):
            ptxas[m.group(1)] = int(m.group(2))
        spills = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads",
                            p.stdout + p.stderr)
        print(json.dumps({
            "source": name, "registers": ptxas,
            "stack_spill_stores_loads": spills,
            "kernels": {fn: _loops(body) for fn, body in _functions(sass)},
            "whole": {fn: _whole(body) for fn, body in _functions(sass)}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
