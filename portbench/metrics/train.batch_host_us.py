"""Microseconds of host time a batch of ``train/step.py::EpochRunner.apply``
takes: the program's span ``kb2e.train.batch`` (one fused update, or one
``batch_update`` call on a chunk), mean over the traced epochs' batches."""

from portbench import program_spans

UNIT = "us"
LAYER = "update: train/step.py::EpochRunner.apply over models/<model>.py"
MOVES = "train_triples_per_s"


def read(rec):
    return program_spans.per_call("kb2e.train.apply", "kb2e.train.batch", 1e6)
