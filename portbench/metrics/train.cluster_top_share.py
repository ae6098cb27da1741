"""The share of CTransR's routed samples that went to their relation's
most-used cluster: the program's counters ``ctransr.routed_top`` and
``ctransr.routed`` (on the device, from ``models/ctransr.py``'s chunk as
``train/step.py::EpochRunner.apply`` replays it), over the traced epochs.
100/C where the routing spreads evenly over the C clusters, 100 where every
sample takes one cluster (TransR with the clusters' work done for nothing)."""

from portbench import program_spans

UNIT = "%"
LAYER = "update: models/ctransr.py routing in train/step.py::EpochRunner.apply"
MOVES = "train_triples_per_s"


def read(rec):
    c = program_spans.counters("kb2e.train.apply")
    if not c or not c.get("ctransr.routed"):
        return None
    return 100.0 * c.get("ctransr.routed_top", 0) / c["ctransr.routed"]
