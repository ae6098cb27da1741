"""Milliseconds an epoch spends in the sampler: the benchmark's span around
``train/step.py::EpochRunner.sample`` (``sampling/corruption.py`` over the
``sampling/cuckoo.py`` probe), mean over the window's epochs."""

import statistics

UNIT = "ms"
LAYER = "sampler: sampling/corruption.py, sampling/cuckoo.py"
MOVES = "train_triples_per_s"


def read(rec):
    spans = rec.spans.get("sample")
    return statistics.fmean(spans) * 1e3 if spans else None
