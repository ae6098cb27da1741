"""Milliseconds a pass of ``eval/harness.py::rank_all`` spends in its group loop
outside the batches: the self time of the program's span ``kb2e.eval.group``
(each group's tables, projection, aligned transpose and squared norms or
CTransR's u), summed over a pass's groups, over the traced passes."""

from portbench import program_spans

UNIT = "ms"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    return program_spans.per_root("kb2e.eval.rank_all", "kb2e.eval.group", "self_s", 1e3)
