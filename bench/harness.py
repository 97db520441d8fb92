"""What every cell shares: finding the parts by name, the run's record,
timing, the trace's reduction, the guard against JAX and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``, whose
``run(ctx)`` drives the port and fills the :class:`Run`). The per-layer
metrics are ``metrics/<metric>.py``, each a reader of the run's spans,
calls and trace; the end-to-end metrics ``end_to_end/<metric>.json``."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names a run may not hold once its window has closed:
#: JAX and the JAX package, which the port sits beside
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def names(kind: str, suffix: str, bench: pathlib.Path = BENCH) -> List[str]:
    """The names of the files ``<kind>/<name><suffix>``, sorted."""
    return sorted(p.name[:-len(suffix)] for p in (bench / kind).glob(
        "*" + suffix) if not p.name.startswith("_"))


def config(name: str, bench: pathlib.Path = BENCH) -> dict:
    return load_json(bench / "configs" / f"{name}.json")


def workload(name: str, bench: pathlib.Path = BENCH) -> dict:
    return load_json(bench / "workloads" / f"{name}.json")


def end_to_end(name: str, bench: pathlib.Path = BENCH) -> dict:
    return load_json(bench / "end_to_end" / f"{name}.json")


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench: pathlib.Path = BENCH):
    """The per-layer metric's module: ``LAYER``, ``UNIT``, ``BETTER``,
    ``SOURCE``, ``MOVES``, ``WORKLOADS`` and ``read(run)``, which returns
    the value or None where the run holds nothing to read."""
    return _module(bench / "metrics" / f"{name}.py", f"bench_metric_{name}")


def driver(name: str, bench: pathlib.Path = BENCH):
    return _module(bench / "drivers" / f"{name}.py", f"bench_driver_{name}")


def discover(bench: pathlib.Path = BENCH) -> dict:
    """Every configuration, cell, end-to-end and per-layer metric found
    under ``bench``, by name."""
    return {"configs": {n: config(n, bench)
                        for n in names("configs", ".json", bench)},
            "workloads": {n: workload(n, bench)
                          for n in names("workloads", ".json", bench)},
            "end_to_end": {n: end_to_end(n, bench)
                           for n in names("end_to_end", ".json", bench)},
            "per_layer": {n: metric(n, bench)
                          for n in names("metrics", ".py", bench)}}


def cell_metrics(cell: str, found: dict) -> tuple:
    """(end-to-end names, per-layer names) that ``cell`` reports."""
    e2e = [n for n, m in found["end_to_end"].items()
           if "workloads" not in m or cell in m["workloads"]]
    per = [n for n, m in found["per_layer"].items() if cell in m.WORKLOADS]
    return e2e, per


def port_config(c: dict):
    """The port's ``ArchConfig`` as a configuration file's ``port`` block
    states it: the named arch with every field the block gives."""
    from repro_torch.configs import get_arch
    p = dict(c["port"])
    return dataclasses.replace(get_arch(p.pop("arch")), **p)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` passes and
    ``repro.core`` does not."""
    mods = sys.modules if modules is None else modules
    return sorted(n for n in mods if n.split(".", 1)[0] in FORBIDDEN)


def cache_dirs(root: pathlib.Path = ROOT) -> None:
    """Fixed build and kernel-cache directories inside the checkout (the
    port's nvcc builds go to ``build/repro_torch`` by themselves)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = root / "build" / "bench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver saw, and the result."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    #: host seconds from the process's start to the window's
    setup_s: float = 0.0
    window_s: float = 0.0
    #: end-to-end metrics, name -> value
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: per call of a wrapped entry: name -> [record dicts]
    calls: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    #: the reduced profiler trace: busy_s, window_s, device_ops, idle_gaps
    profile: Optional[dict] = None
    #: numbers compared for ``correct``: name -> (value, limit)
    checks: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    #: anything else a metric reads
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def add(self, name: str, **rec) -> None:
        self.calls.setdefault(name, []).append(rec)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Events:
    """CUDA events around calls, read once the window has closed."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.on = torch.device(device).type == "cuda"

    def start(self):
        if not self.on:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b) -> float:
        if not self.on:
            return b - a
        return a.elapsed_time(b) / 1e3


def wrap(obj, attr: str, make: Callable):
    """Replace ``obj.attr`` by ``make(real)``; returns a function that puts
    the real one back."""
    real = getattr(obj, attr)
    setattr(obj, attr, make(real))
    return lambda: setattr(obj, attr, real)


def quantile(values: List[float], q: float) -> float:
    """The ``q``-quantile (0 < q < 1) of ``values``, Python's inclusive
    method."""
    if len(values) == 1:
        return values[0]
    n = 100
    return statistics.quantiles(values, n=n, method="inclusive")[
        round(q * n) - 1]


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------


def profile(fn: Callable[[], None], device) -> Optional[dict]:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and
    reduce the trace: the seconds in which a kernel, copy or set ran on the
    card (overlaps counted once), the traced window's length (the
    ``bench/window`` span that wraps ``fn``), the ten device operations
    that took most time, and the window's idle time by the innermost
    ``bench/...`` span the host was in at each gap's middle. None where the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function("bench/window"):
            fn()
            sync(device)
    return reduce_trace(_kineto_events(prof))


def _kineto_events(prof) -> List[tuple]:
    """(on_device, name, start_ns, end_ns) of every event of the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            t0, dur = e.start_ns(), e.duration_ns()
        else:
            t0, dur = e.start_us() * 1000, e.duration_us() * 1000
        on_dev = "CUDA" in str(e.device_type())
        out.append((on_dev, e.name(), t0, t0 + dur))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: List[tuple]) -> Optional[dict]:
    """:func:`profile`'s reduction of (on_device, name, start_ns, end_ns)
    events."""
    spans = [(n, a, b) for dev, n, a, b in events
             if not dev and n.startswith("bench/")]
    win = [(a, b) for n, a, b in spans if n == "bench/window"]
    ops = [(n, a, b) for dev, n, a, b in events
           if dev and not n.startswith("bench/") and b > a]
    if not win or not ops:
        return None
    w0, w1 = win[0]
    busy = _union([(max(a, w0), min(b, w1)) for _, a, b in ops
                   if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    if busy_ns <= 0:
        return None
    by_op: Dict[str, int] = {}
    for n, a, b in ops:
        by_op[n] = by_op.get(n, 0) + (b - a)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    by_host: Dict[str, int] = {}
    inner = sorted(spans, key=lambda s: s[2] - s[1])
    for a, b in gaps:
        mid = (a + b) // 2
        label = next((n for n, s0, s1 in inner if s0 <= mid < s1),
                     "bench/window")
        by_host[label] = by_host.get(label, 0) + (b - a)

    def top(d):
        return [[n[:120], v / 1e9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": top(by_op), "idle_gaps": top(by_host)}


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


def result(run: Run, found: dict, device_info: dict) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or
    its per-layer ones (``--trace 1``), and the numbers compared, last."""
    e2e, per = cell_metrics(run.cell, found)
    metrics = {}
    if run.trace:
        for n in per:
            v = found["per_layer"][n].read(run)
            if v is not None:
                metrics[n] = {"value": float(v),
                              "unit": found["per_layer"][n].UNIT}
    else:
        for n in e2e:
            if n in run.e2e:
                metrics[n] = {"value": float(run.e2e[n]),
                              "unit": found["end_to_end"][n]["unit"]}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device_info}
    if run.trace and run.profile:
        out["device"] = {**device_info, "busy_s": run.profile["busy_s"],
                         "window_s": run.profile["window_s"]}
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in run.checks.items()}
    return out


def check_lines(run: Run) -> List[str]:
    return [f"check {n}: {v!r} (limit {lim!r})"
            for n, (v, lim) in run.checks.items()]
