"""The whole training step's share of the H100's roofline: the least time of
an epoch over its measured time.

The least time is summed over the epoch's batches (TransR: its chunks), each
the larger of its fp32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s,
counted from the batch's shapes and distinct rows by the model's reference
(``reference/<model>.py::update_work``): a batch reads what the one before
wrote, so no two share their bytes.  KGE training at k <= 100 is bound by
bytes, so a share of the FLOP peak alone would read about 0.01 % and bound
nothing.  The measured time is the window's median epoch."""

import statistics

from portbench import roofline

UNIT = "%"
LAYER = "whole training step: train/step.py::EpochRunner"
MOVES = "train_triples_per_s"


def read(rec):
    if not rec.on_card or not rec.work or not rec.step_s:
        return None
    least = statistics.fmean(roofline.least_seconds_sum(epoch) for epoch in rec.work)
    return 100.0 * least / rec.median_step_s()
