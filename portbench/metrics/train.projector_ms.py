"""Milliseconds an epoch spends in TransH's orthogonality projector: the
program's span ``kb2e.transh.project`` (both of ``models/transh.py::batch_update``'s
calls of ``ops/projections.py::orthogonality_project``, their host syncs
included) summed over the traced epochs, per ``kb2e.train.apply``."""

from portbench import program_spans

UNIT = "ms"
LAYER = "update: models/transh.py::batch_update, ops/projections.py::orthogonality_project"
MOVES = "train_triples_per_s"


def read(rec):
    return program_spans.per_root("kb2e.train.apply", "kb2e.transh.project", "total_s", 1e3)
