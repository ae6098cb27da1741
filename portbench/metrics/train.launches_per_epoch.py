"""CUDA kernel launches per epoch, counted in the profiler's trace of the
window's first epochs (copies and sets left out): the host launch loop of
``train/step.py`` that fast training waits on."""

UNIT = "launches"
LAYER = "epoch loop: train/step.py host launches"
MOVES = "train_triples_per_s"


def read(rec):
    if rec.trace is None or rec.trace.kernels == 0:
        return None
    return rec.trace.kernels / rec.trace.steps
