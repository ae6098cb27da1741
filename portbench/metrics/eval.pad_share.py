"""The share of the feed's slots that rank no query: every group of
``eval/harness.py::rank_all`` is padded to whole batches.  The program's
counters ``eval.slots`` and ``eval.queries`` over the traced passes."""

from portbench import program_spans

UNIT = "%"
LAYER = "harness: eval/harness.py::rank_all, eval/ranking.py"
MOVES = "eval_queries_per_s"


def read(rec):
    c = program_spans.counters("kb2e.eval.rank_all")
    if not c or not c.get("eval.slots"):
        return None
    return 100.0 * (c["eval.slots"] - c["eval.queries"]) / c["eval.slots"]
