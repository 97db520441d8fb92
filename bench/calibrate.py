"""Readings that the limits of ``correct`` are set from, at a cell's own
size, one process for many seeds:

    python bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed it runs the cell's driver with a short window and prints
one JSON line: the numbers the run compares, and the control's: for a
served cell the widest gap of the token that the reference computed with
float8 products puts first; for a training cell the reference trained with
TF32 products in the port's place, and the reference on half of each
batch (a fault). The benchmark's own runs never compute these."""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device="cuda",
             wl=None, config=None) -> dict:
    wl = wl or harness.workload(cell)
    r = harness.Run(cell=cell, workload=wl,
                    config=config or harness.config(wl["config"]),
                    seed=seed, seconds=seconds, trace=False,
                    t_start=time.perf_counter(), device=device)
    r.extra["control"] = True
    harness.driver(wl["driver"]).run(r)
    out = {"seed": seed, "checks": {n: v for n, (v, _) in r.checks.items()},
           "attempted": r.attempted, "check_s": r.extra.get("check_s")}
    for k in ("check", "control_check", "half_batch_check"):
        if k in r.extra:
            out[k] = r.extra[k]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    a = ap.parse_args()
    harness.cache_dirs()
    for s in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(s), a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
