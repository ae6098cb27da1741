"""Milliseconds a pass of ``eval/harness.py::rank_all`` spends building its
filter index: the program's span ``kb2e.eval.filter_index`` (both
``_FilterIndex`` argsorts over the known triples and the four lookups), over
the traced passes."""

from portbench import program_spans

UNIT = "ms"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    return program_spans.per_root("kb2e.eval.rank_all", "kb2e.eval.filter_index", "total_s", 1e3)
