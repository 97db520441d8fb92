"""The flash forward's share of its roofline over every call of the
window (``kernels/ops.py::flash_attention``, ``csrc/flash_attention.cu``):
the sum of each call's bound (``costs/flash.py``, from the model's heads)
over the sum of its CUDA-event time."""
LAYER = "kernels (src/repro_torch/kernels)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "req_s"
WORKLOADS = ["qwen2.5-3b.serve-long"]


def read(run):
    calls = run.extra.get("flash_bound_s")
    if not calls:
        return None
    return 100.0 * sum(b for _, b in calls) / sum(t for t, _ in calls)
