"""The share of the batches of ``train/step.py::EpochRunner.apply``'s fused
loop that ran as the model's hand-written batch kernels (TransE's
``ops/transe_fast.py``): the program's counters ``train.batches_kernel`` and
``train.batches``, over the traced epochs."""

from portbench import program_spans

UNIT = "%"
LAYER = "update: train/step.py::EpochRunner.apply over models/<model>.py"
MOVES = "train_triples_per_s"


def read(rec):
    c = program_spans.counters("kb2e.train.apply")
    if not c or not c.get("train.batches"):
        return None
    return 100.0 * c.get("train.batches_kernel", 0) / c["train.batches"]
