"""Mean wait of a request from its submission to the start of its
prefill in ``ContinuousEngine._admit`` (the engine's prefill call), on
the host clock, over the requests whose first token came in the window."""
LAYER = "engine (serve/continuous.py::ContinuousEngine)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "ttft_p90_ms"
WORKLOADS = ["qwen2.5-3b.serve-long"]


def read(run):
    w = run.extra.get("queue_wait_s")
    return 1e3 * sum(w) / len(w) if w else None
