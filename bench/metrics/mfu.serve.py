"""Model FLOPs of every prompt prefilled and every token decoded in the
window (``costs/<family>.py``: the prefill's tokens and its last
position's head, each decode step's active slots at their positions) over
the window's seconds, as a share of the peak of the configuration's type
(``costs/peaks.py``)."""
import importlib

from bench.costs import peaks

LAYER = "device (one H100, the whole step)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "req_s"
WORKLOADS = ["qwen2.5-3b.serve-long"]


def read(run):
    if not run.calls.get("decode") or not run.window_s:
        return None
    c = run.config
    fam = importlib.import_module(f"bench.costs.{c['family']}")
    flops = sum(fam.prefill_flops(c, p["tokens"])
                for p in run.calls.get("prefill", []))
    flops += sum(fam.decode_flops(c, pos) for d in run.calls["decode"]
                 for pos in d["positions"])
    return 100.0 * flops / run.window_s / peaks.FLOPS_BY_DTYPE[
        c["torch_dtype"]]
