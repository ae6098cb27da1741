"""Microseconds of host time a batch of ``eval/harness.py::rank_all`` takes:
the program's span ``kb2e.eval.batch`` (``eval/ranking.py::rank_feed_queries``
or the sharded or clustered call, which launch without waiting), mean over
the traced passes' batches."""

from portbench import program_spans

UNIT = "us"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    return program_spans.per_call("kb2e.eval.rank_all", "kb2e.eval.batch", 1e6)
