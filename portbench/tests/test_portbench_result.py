"""The result line: its keys, in order, and what each holds."""

import json

import pytest
import torch

from portbench import cell, run, spec


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["transe-fb15k.train", "transr-fb15k.eval"])
def test_the_last_line_has_the_result_keys_in_order(tiny, name, trace):
    c = spec.load(name, tiny)
    out = json.loads(json.dumps(cell.run(c, 2**31 + 3, 0.2, trace, device="cpu")))
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for entry in out["checks"].values():
        assert set(entry) == {"value", "limit"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"} and out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"} and len(out["breakdown"]["idle_gaps"]) <= 10
        allowed = {m["name"] for m in c.per_layer}
        assert set(out["metrics"]) <= allowed
        # On the CPU no device metric reads anything.
        assert not {"train_mfu", "eval_mfu", "rank_count_roofline", "train.device_idle"} & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
        for m in out["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "transe-fb15k.train", "--seed", "1", "--seconds", "1"]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA" in captured.err
