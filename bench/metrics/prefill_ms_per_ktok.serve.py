"""Synchronised host wall of every prefill of the window
(``models/transformer.py::prefill`` through ``serve/engine.py::
make_prefill``) over its prompt tokens, in ms a thousand tokens."""
LAYER = "model: prefill (models/transformer.py::prefill)"
UNIT = "ms/ktok"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "ttft_p90_ms"
WORKLOADS = ["qwen2.5-3b.serve-long"]


def read(run):
    calls = run.calls.get("prefill")
    if not calls:
        return None
    return 1e6 * sum(c["s"] for c in calls) / sum(c["tokens"] for c in calls)
