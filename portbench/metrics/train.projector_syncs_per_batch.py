"""Host syncs a batch of TransH's projector: the program's counter
``transh.project_syncs`` (the trips of ``ops/projections.py::orthogonality_project``,
each ending in a ``bool`` of the device's active rows) over the batches of the
traced epochs (the spans ``kb2e.train.batch``).  Two calls a batch: 2 where
every pair holds at the first check, up to 32 where a row runs to the cap."""

from portbench import program_spans

UNIT = "syncs/batch"
LAYER = "update: models/transh.py::batch_update, ops/projections.py::orthogonality_project"
MOVES = "train_triples_per_s"


def read(rec):
    snap = program_spans.snapshot()
    if snap is None or not snap["spans"].get("kb2e.train.apply", {}).get("count"):
        return None
    syncs = snap["counters"].get("transh.project_syncs")
    batches = snap["spans"].get("kb2e.train.batch", {}).get("count", 0)
    return None if syncs is None or not batches else syncs / batches
