"""The share of the chunks of ``train/step.py::EpochRunner.apply`` that ran
as the model's hand-written chunk kernels (TransR's
``ops/transr_fast.py``): the program's counters ``train.chunks_kernel`` and
``train.chunks``, over the traced epochs.  A program without the kernel's
counter (one older than it) reads nothing."""

from portbench import program_spans

UNIT = "%"
LAYER = "update: train/step.py::EpochRunner.apply over models/<model>.py"
MOVES = "train_triples_per_s"


def read(rec):
    c = program_spans.counters("kb2e.train.apply")
    if not c or not c.get("train.chunks") or "train.chunks_kernel" not in c:
        return None
    return 100.0 * c["train.chunks_kernel"] / c["train.chunks"]
