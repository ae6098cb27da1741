"""The share of the chunks of ``train/step.py::EpochRunner.apply`` that ran
as a replay of the chunk's CUDA graph: the program's counters
``train.chunks_replayed`` and ``train.chunks``, over the traced epochs."""

from portbench import program_spans

UNIT = "%"
LAYER = "update: train/step.py::EpochRunner.apply over models/<model>.py"
MOVES = "train_triples_per_s"


def read(rec):
    c = program_spans.counters("kb2e.train.apply")
    if not c or not c.get("train.chunks"):
        return None
    return 100.0 * c.get("train.chunks_replayed", 0) / c["train.chunks"]
