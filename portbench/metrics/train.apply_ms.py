"""Milliseconds an epoch spends in the update: the benchmark's span around
``train/step.py::EpochRunner.apply`` (TransE's ``fused_table_update``,
TransR's chunked ``batch_update``), mean over the window's epochs."""

import statistics

UNIT = "ms"
LAYER = "update: train/step.py::EpochRunner.apply over models/<model>.py"
MOVES = "train_triples_per_s"


def read(rec):
    spans = rec.spans.get("apply")
    return statistics.fmean(spans) * 1e3 if spans else None
