"""Synchronised host wall of the window's decode steps
(``models/transformer.py::decode_step`` through ``serve/engine.py::
make_decode``, every slot at once) over their count."""
LAYER = "model: decode (models/transformer.py::decode_step)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "req_s"
WORKLOADS = ["qwen2.5-3b.serve-long"]


def read(run):
    calls = run.calls.get("decode")
    return 1e3 * sum(c["s"] for c in calls) / len(calls) if calls else None
