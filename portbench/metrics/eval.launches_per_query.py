"""CUDA kernel launches per query, counted in the profiler's trace of the
window's first passes of ``eval/harness.py::rank_all`` (the harness's group
and batch loops and ``eval/ranking.py``'s per-batch ops; copies and sets
left out)."""

UNIT = "launches/query"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    if rec.trace is None or rec.trace.kernels == 0:
        return None
    return rec.trace.kernels / (rec.trace.steps * rec.units_per_step)
