"""The whole eval pass's share of the H100's roofline: the least time of a
pass over its measured time.

The least time is the larger of the pass's fp32 operations at 67 TFLOP/s
and its bytes at 3.35 TB/s: the scoring of every query against every entity
(``roofline.rank_count_work``) and, for TransR, the projection of every
entity per relation group (``reference/<model>.py::projection_work``).  The
measured time is the window's median pass."""

from portbench import roofline

UNIT = "%"
LAYER = "whole eval pass: eval/harness.py::rank_all"
MOVES = "eval_queries_per_s"


def read(rec):
    if not rec.on_card or not rec.work or not rec.step_s:
        return None
    ops = sum(w[0] for w in rec.work[0])
    nbytes = sum(w[1] for w in rec.work[0])
    return 100.0 * roofline.least_seconds(ops, nbytes) / rec.median_step_s()
