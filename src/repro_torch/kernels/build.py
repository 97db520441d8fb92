"""Build and load the hand-written sm_90a arena kernels.

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
import shutil
import subprocess
import threading
import time
from typing import Dict

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
#: C entry points: name -> argtypes (every pointer and the stream are
#: c_void_p so ctypes never truncates them to 32 bits). Each returns
#: cudaGetLastError() after its launch.
SIGNATURES = {
    "arena_conv": [_P, _P, _P, _P],
    "arena_mean": [_P, _P, _P, _I, _P],
    "arena_fully_connected": [_P, _P, _P, _P, _I, _P],
    "arena_softmax": [_P, _P, _P, _I, _P],
    "arena_fused_chain": [_P, _P, _P, _P, _P, _I, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the arena kernels need the CUDA "
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
    for name in SIGNATURES:
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
    CDLL with ``argtypes``/``restype`` set."""
    global LAST_BUILD_S
    with _LOCK:
        if _LIBS:
            return _LIBS
        out = build_dir()
        t0 = time.perf_counter()
        if not all((out / f"lib{n}.so").exists() for n in SIGNATURES):
            _compile_all(out)
        LAST_BUILD_S = time.perf_counter() - t0
        for name, argtypes in SIGNATURES.items():
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def entry(name: str):
    """The ctypes function of one kernel's C entry point."""
    return getattr(load()[name], name)


def ptxas_report() -> str:
    """nvcc's output of the last build with ``-Xptxas -v``: registers,
    shared memory, stack frame and spills, one block per kernel."""
    out = build_dir()
    parts = []
    for name in SIGNATURES:
        p = out / f"{name}.ptxas.txt"
        if p.exists():
            lines = [ln.strip() for ln in
                     p.read_text(errors="replace").splitlines()
                     if ln.strip()]
            parts.append(f"[{name}]\n" + "\n".join(lines))
    return "\n".join(parts)


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

