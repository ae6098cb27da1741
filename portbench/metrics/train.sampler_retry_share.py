"""The share of the sampler's slots whose first candidate is a known triple,
which the reference's rejection loop draws again: the program's counters
``sampler.retried`` (on the device) and ``sampler.slots`` from
``sampling/corruption.py::sample_batch``, over the traced epochs."""

from portbench import program_spans

UNIT = "%"
LAYER = "sampler: sampling/corruption.py, sampling/cuckoo.py"
MOVES = "train_triples_per_s"


def read(rec):
    c = program_spans.counters("kb2e.train.sample")
    if not c or not c.get("sampler.slots"):
        return None
    return 100.0 * c.get("sampler.retried", 0) / c["sampler.slots"]
