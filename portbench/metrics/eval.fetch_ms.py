"""Milliseconds a pass of ``eval/harness.py::rank_all`` spends fetching its
ranks: the program's span ``kb2e.eval.fetch`` (the ranks' ``.cpu()``, which
waits for the device to drain, and the mask), over the traced passes."""

from portbench import program_spans

UNIT = "ms"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    return program_spans.per_root("kb2e.eval.rank_all", "kb2e.eval.fetch", "total_s", 1e3)
