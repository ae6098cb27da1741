"""The share of the traced epochs in which no operation ran on the card: one
less the union of the device intervals over the traced window."""

UNIT = "%"
LAYER = "device: H100"
MOVES = "train_triples_per_s"


def read(rec):
    if rec.trace is None or rec.trace.busy_s == 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
