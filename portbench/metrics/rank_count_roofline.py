"""The rank-count kernel's share of its roofline (K1, L1; K2, L2:
``ops/rank_count.py`` over ``csrc/rank_count.cu``).

The least time of the ranking work a pass needs, counted from its queries,
entities and k whatever the port's batching (``roofline.rank_count_work``,
``chip_smoke.py::bound_ms``'s count summed over the pass's groups), over the
kernel's device time in the profiler's trace, per traced pass."""

from portbench import roofline

UNIT = "%"
LAYER = "kernel: ops/rank_count.py, csrc/rank_count.cu"
MOVES = "eval_queries_per_s"


def read(rec):
    if not rec.on_card or rec.trace is None or not rec.work:
        return None
    seconds = sum(s for name, (_, s) in rec.trace.ops.items() if "rank_count" in name)
    if seconds == 0:
        return None
    least = roofline.least_seconds(*roofline.rank_count_work(rec.l1, rec.k, rec.n_entities, rec.group_queries))
    return 100.0 * least * rec.trace.steps / seconds
