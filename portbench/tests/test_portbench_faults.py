"""A run with its timed path broken underneath comes out not correct."""

import pytest

from portbench import cell, faults, spec

CASES = [(c, f) for c in ("transe-fb15k.train", "transr-fb15k.train") for f in faults.FAULTS]
CASES += [(c, f) for c in ("transe-fb15k.eval", "transr-fb15k.eval") for f in ("half_batch", "altered_answer")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_fails_the_check(tiny, name, fault):
    c = spec.load(name, tiny)
    with faults.plant(fault):
        out = cell.run(c, 2**31 + 21, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]
    assert cell.run(c, 2**31 + 21, 0.2, False, device="cpu")["correct"]  # the patch is gone again


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="fault"):
        faults.plant("nothing")


@pytest.mark.parametrize("name", ["transe-fb15k.train", "transr-fb15k.train"])
def test_a_fault_of_the_epoch_sized_call_alone_fails_the_check(tiny, name, monkeypatch):
    """An ``apply`` that leaves the tables unchanged only when it is fed more
    than one batch, as the window feeds it and set-up's steps do not."""
    from kb2e_tpu_torch.train.step import EpochRunner

    original = EpochRunner.apply

    def apply(self, params, batches, n):
        out, loss = original(self, params, batches, n)
        return (params if batches["ph"].shape[0] > 1 else out), loss

    monkeypatch.setattr(EpochRunner, "apply", apply)
    out = cell.run(spec.load(name, tiny), 2**31 + 23, 0.2, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["change3_gap"]["value"] <= out["checks"]["change3_gap"]["limit"]  # the start passes
    assert out["checks"]["window_change_gap"]["value"] > out["checks"]["window_change_gap"]["limit"]
