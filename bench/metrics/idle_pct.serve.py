"""Share of the traced window in which no kernel, copy or set ran on the
card (``torch.profiler``, CUDA activity), the loop run on past the
window for the cell's ``profile_seconds``."""
LAYER = "device (one H100, the whole step)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "req_s"
WORKLOADS = ["qwen2.5-3b.serve-long"]


def read(run):
    p = run.profile
    return 100.0 * (1 - p["busy_s"] / p["window_s"]) if p else None
