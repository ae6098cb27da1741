"""Faults planted in the program's timed path, to show that the check fails.

Each is a context manager that patches the program while it is open; the
benchmark's own runs never open one.  ``control.py`` reads them on the card
at a cell's size, and ``tests/test_portbench_faults.py`` on the CPU.

* ``unchanged_state``: an epoch returns the tables it was given (its loss
  as computed).
* ``half_batch``: every batch of an epoch leaves out its second half, and
  the loss is doubled as if it were the mean over the rest; in eval every
  rank-count launch leaves every other query uncounted (a relation group
  rarely fills the second half of its batch).
* ``altered_answer``: the sampler's first row of each batch gets the
  positive triple itself as its corruption; in eval every count of the
  rank-count launch is one more than it should be.
* ``flipped_coins``: the sampler's bern coin is read the wrong way round:
  each row's corrupted side is swapped, keeping the drawn entity.
* ``stale_epoch``: the sampler returns the first epoch it drew again on
  every later call (a cache that is never refreshed).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FAULTS = ("unchanged_state", "half_batch", "altered_answer", "flipped_coins", "stale_epoch")


@contextlib.contextmanager
def _patch(owner, name: str, wrap) -> Iterator[None]:
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _half_rows(batches):
    out = dict(batches)
    valid = out["valid"].clone()
    valid[..., valid.shape[-1] // 2:] = False
    out["valid"] = valid
    return out


def _positive_as_corruption(batches):
    out = {key: v.clone() for key, v in batches.items()}
    out["nh"][..., 0], out["nt"][..., 0], out["valid"][..., 0] = out["ph"][..., 0], out["pt"][..., 0], True
    return out


def _swap_sides(batches):
    out = dict(batches)
    tail = batches["nh"] == batches["ph"]  # the tail was corrupted
    drawn = torch.where(tail, batches["nt"], batches["nh"])
    out["nh"] = torch.where(tail, drawn, batches["ph"])
    out["nt"] = torch.where(tail, batches["pt"], drawn)
    return out


def plant(fault: str):
    """A context manager that plants ``fault`` (one of :data:`FAULTS`)."""
    from kb2e_tpu_torch.ops import rank_count
    from kb2e_tpu_torch.train.step import EpochRunner

    if fault == "unchanged_state":
        return _patch(EpochRunner, "apply", lambda f: lambda self, params, batches, n: (params, f(
            self, params, batches, n)[1]))
    if fault == "half_batch":
        stack = contextlib.ExitStack()

        def apply(f):
            def go(self, params, batches, n):
                params, loss = f(self, params, _half_rows(batches), n)
                return params, 2 * loss
            return go

        def counts(f):
            def go(*args, **kw):
                out = f(*args, **kw)
                out[1::2] = 0
                return out
            return go

        stack.enter_context(_patch(EpochRunner, "apply", apply))
        stack.enter_context(_patch(rank_count, "rank_counts", counts))
        return stack
    if fault == "altered_answer":
        stack = contextlib.ExitStack()
        stack.enter_context(_patch(EpochRunner, "sample", lambda f: lambda self, gen, data: _positive_as_corruption(
            f(self, gen, data))))
        stack.enter_context(_patch(rank_count, "rank_counts", lambda f: lambda *a, **kw: f(*a, **kw) + 1))
        return stack
    if fault == "flipped_coins":
        return _patch(EpochRunner, "sample", lambda f: lambda self, gen, data: _swap_sides(f(self, gen, data)))
    if fault == "stale_epoch":
        first = []

        def sample(f):
            def go(self, gen, data):
                out = f(self, gen, data)
                if not first:
                    first.append(out)
                return first[0]
            return go

        return _patch(EpochRunner, "sample", sample)
    raise ValueError(f"fault {fault!r}; expected one of {FAULTS}")
