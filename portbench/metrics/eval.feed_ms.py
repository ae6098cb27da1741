"""Milliseconds a pass of ``eval/harness.py::rank_all`` spends making its feed:
the program's span ``kb2e.eval.feed`` (the query list, the grouping, the
feed's upload and ``kmax``), over the traced passes."""

from portbench import program_spans

UNIT = "ms"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    return program_spans.per_root("kb2e.eval.rank_all", "kb2e.eval.feed", "total_s", 1e3)
