"""Planning core: graphs, overlap, serialisation, planner, passes and the
arena executors."""
