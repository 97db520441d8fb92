"""Build and load the hand-written sm_90a kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface (loaded with :mod:`ctypes`; no PyTorch headers, so a
build takes seconds, not minutes). All sources compile in parallel, at first
use, into ``build/repro_torch/<hash>/`` at the root of the checkout, where
``<hash>`` covers every source and header and the flags: an edited kernel
rebuilds, an unchanged one loads what is there. ``nvcc``'s ``-Xptxas -v``
register and shared-memory report is kept beside each library
(:func:`ptxas_report`).

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

from repro_torch import trace

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: ``build/repro_torch`` at the root of the checkout (``src/repro_torch/
#: kernels/build.py`` -> three levels up), listed in ``.gitignore``.
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last :func:`load` spent compiling (0.0 when it found the
#: libraries built)
LAST_BUILD_S = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: One kernel per source ``csrc/<name>.cu``, whose C entry point is
#: ``<name>`` and returns cudaGetLastError() after its launch. Every
#: pointer and the stream pass as c_void_p, so ctypes never truncates them
#: to 32 bits.
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
#: The arena kernels, every one over the whole card (the row tiles of
#: csrc/conv_tiles.cuh, the elementwise, concat, mean and pad chunk walks
#: of csrc/ew_tiles.cuh, the softmax rows of csrc/softmax_tiles.cuh, the
#: fully connected and matmul grid of csrc/fc_tiles.cuh, the fused chains'
#: levels of csrc/chain_tiles.cuh; and the empty launch_floor), take
#: (arena, descriptor, weights or null, global workspace or null, dynamic
#: shared bytes, the CTAs to launch at most, the CTAs (tiles) that must
#: run at once (one output row's tiles; every CTA of an order-2 chunk
#: walk, softmax, FC or matmul op, or of a chain; else 0), the bytes of
#: the counters at the workspace's start, stream).
GRID_ARGTYPES = {name: [_P, _P, _P, _P, _I, _I, _I, _I, _P]
                 for name in ("arena_conv", "arena_pool", "arena_stream_roll",
                              "arena_elementwise", "arena_concat",
                              "arena_mean", "arena_pad",
                              "arena_fully_connected", "arena_matmul",
                              "arena_softmax", "arena_stream_stage",
                              "arena_fused_chain", "arena_stream_fused",
                              "launch_floor")}
#: Entry points beside a kernel's own, by name: the library they live in
#: (``launch_floor``: an empty grid kernel through the arena kernels'
#: launcher; ``wkv_chunk_bwd_occupancy``: each WKV backward launch's CTAs
#: an SM and threads a CTA; instruments that port nothing).
EXTRA_ENTRIES = {"launch_floor": "arena_softmax",
                 "wkv_chunk_bwd_occupancy": "wkv_chunk_bwd"}
#: Their signatures where they are not :data:`GRID_ARGTYPES`' (an int
#: array of 8 to fill)
EXTRA_ARGTYPES = {"wkv_chunk_bwd_occupancy": [_P]}
#: The standalone kernels' own signatures, by entry point; every other
#: entry takes its :data:`GRID_ARGTYPES`.
ARGTYPES_OF = {
    # (x, r, g f32, n, d, bf16, eps, stream)
    "rmsnorm_inplace": [_P, _P, _P, _I, _I, _I, _F, _P],
    # (q, k, v, out, lse or null, s, t, h, d, causal, bf16, stream)
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (q, k, v, out, dout, lse, workspace, dq, dk, dv, s, t, h, d, causal,
    # bf16, stream)
    "flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_P],
    # (r, k, v, logw, u, y, state, workspace, b, s, h, d, q, stream)
    "wkv_chunk": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (r, k, v, logw, u, dy, dstate or null, the forward's workspace,
    # workspace, dr, dk, dv, dlogw, du, b, s, h, d, q, stream)
    "wkv_chunk_bwd": [_P] * 14 + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _digest() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / _digest()


def _compile_all(out: pathlib.Path) -> None:
    """One nvcc per source, all started together; raises with the
    compiler's output if any fails."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in KERNELS:
        tmp = out / f"lib{name}.so.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.ptxas.txt").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n"
                          + log.decode(errors="replace"))
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out / f"lib{name}.so")  # atomic for parallel users
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns name ->
    CDLL with ``argtypes``/``restype`` set. The first load is the span
    ``repro/kernels/load``; the sources it compiles add to the counter
    ``kernels.compiled``."""
    global LAST_BUILD_S
    with _LOCK:
        if _LIBS:
            return _LIBS
        with trace.span("repro/kernels/load"):
            out = build_dir()
            t0 = time.perf_counter()
            if not all((out / f"lib{n}.so").exists() for n in KERNELS):
                _compile_all(out)
                trace.count("kernels.compiled", len(KERNELS))
            LAST_BUILD_S = time.perf_counter() - t0
            for name in KERNELS:
                lib = ctypes.CDLL(str(out / f"lib{name}.so"))
                fn = getattr(lib, name)
                fn.argtypes = ARGTYPES_OF.get(name) or GRID_ARGTYPES[name]
                fn.restype = ctypes.c_int
                _LIBS[name] = lib
            for name, lib in EXTRA_ENTRIES.items():
                fn = getattr(_LIBS[lib], name)
                fn.argtypes = EXTRA_ARGTYPES.get(name) or GRID_ARGTYPES[name]
                fn.restype = ctypes.c_int
            return _LIBS


def entry(name: str):
    """The ctypes function of one kernel's C entry point (or of an
    :data:`EXTRA_ENTRIES` entry, in its library)."""
    return getattr(load()[EXTRA_ENTRIES.get(name, name)], name)


def ptxas_report() -> str:
    """nvcc's output of the last build with ``-Xptxas -v``: registers,
    shared memory, stack frame and spills, one block per kernel."""
    out = build_dir()
    parts = []
    for name in KERNELS:
        p = out / f"{name}.ptxas.txt"
        if p.exists():
            lines = [ln.strip() for ln in
                     p.read_text(errors="replace").splitlines()
                     if ln.strip()]
            parts.append(f"[{name}]\n" + "\n".join(lines))
    return "\n".join(parts)


def ptxas_resources(name: str) -> Dict[str, Dict[str, int]]:
    """Per entry function of ``csrc/<name>.cu`` in the last build, from
    its ``-Xptxas -v`` report: registers, stack frame bytes and spill
    store and load bytes."""
    text = (build_dir() / f"{name}.ptxas.txt").read_text(errors="replace")
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        fn = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", part)
        out[fn] = {"registers": int(regs.group(1)) if regs else -1,
                   **dict(zip(("stack", "spill_stores", "spill_loads"),
                              (int(g) for g in frame.groups())
                              if frame else (-1, -1, -1)))}
    return out


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

