"""Print ``BENCHMARK.json`` from what the harness finds under ``bench/``:

    python bench/describe.py > BENCHMARK.json
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402

RUN_SECONDS = 51


def describe(bench: pathlib.Path = harness.BENCH) -> dict:
    found = harness.discover(bench)
    cells = found["workloads"]
    used = {w["config"] for w in cells.values()}
    configs = [{"name": n, "source": c["source"],
                "file": f"bench/configs/{n}.json",
                "reduced": c["reduced"],
                "why": c.get("why", "")}
               for n, c in found["configs"].items() if n in used]
    e2e = []
    for n, m in found["end_to_end"].items():
        e = {k: m[k] for k in ("name", "unit", "better", "bound", "source")}
        if "workloads" in m:
            e["workloads"] = m["workloads"]
        e2e.append(e)
    per = [{"name": n, "unit": m.UNIT, "better": m.BETTER,
            "source": m.SOURCE, "layer": m.LAYER, "moves": m.MOVES,
            "workloads": list(m.WORKLOADS)}
           for n, m in found["per_layer"].items()]
    return {"command": ["python3", "bench/run.py"], "paths": ["bench"],
            "run_seconds": RUN_SECONDS, "configs": configs,
            "workloads": [{k: w[k] for k in ("name", "config", "traffic",
                                             "chips", "why")}
                          for w in cells.values()],
            "end_to_end": e2e, "per_layer": per}


if __name__ == "__main__":
    print(json.dumps(describe(), indent=2))
