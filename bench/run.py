"""Run one cell of the port's benchmark once, on the card it is started on.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device`` and, traced,
``breakdown``; the numbers compared for ``correct`` come last there and
last on standard error. Exits non-zero, with no result, without enough
CUDA cards, without the port beside the benchmark, or when JAX or the JAX
package has been loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def fail(msg: str, code: int = 2) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"the port (src/repro_torch) is not in {ROOT}")
    cells = harness.names("workloads", ".json")
    if a.workload not in cells:
        return fail(f"no cell {a.workload!r}; cells: {cells}")
    harness.cache_dirs()
    wl = harness.workload(a.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA card")
    if torch.cuda.device_count() < wl["chips"]:
        return fail(f"{a.workload} needs {wl['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    found = harness.discover()
    run = harness.Run(cell=a.workload, workload=wl,
                      config=harness.config(wl["config"]), seed=a.seed,
                      seconds=a.seconds, trace=bool(a.trace),
                      t_start=T_START)
    harness.driver(wl["driver"]).run(run)
    from repro_torch.kernels import build
    print(f"bench: setup_s {run.setup_s:.3f} (kernel build "
          f"{build.LAST_BUILD_S:.1f} s), window_s {run.window_s:.3f}, "
          f"check_s {run.extra.get('check_s', 0):.1f}, "
          f"total_s {time.perf_counter() - T_START:.1f}", file=sys.stderr)
    if "leaves_kept" in run.extra:
        print(f"bench: leaves kept {run.extra['leaves_kept']}",
              file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package were loaded: {bad}",
                    3)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": wl["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    out = harness.result(run, found, info)
    for line in harness.check_lines(run):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
