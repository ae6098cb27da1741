"""Roofline and work counts against hand-worked values, and the readers that use them."""

import pytest
import torch

from portbench import cell, roofline, spec, trace
from portbench.reference import transe, transr


def test_least_seconds_takes_the_bound_that_binds():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(1e6, 1e6) == pytest.approx(1e6 / 3.35e12)
    assert roofline.least_seconds_sum([(67e12, 0), (0, 3.35e12)]) == pytest.approx(2.0)


def test_rank_count_work_is_bound_ms_count_summed_over_groups():
    # chip_smoke.py's bound for B 256, N 14,951, k 100 (L1): 0.0229 ms of operations.
    ops, nbytes = roofline.rank_count_work(True, 100, 14951, [256])
    assert ops == 4 * 256 * 14951 * 100 and nbytes == 4 * (100 * 14951 + 100 * 256 + 512) + 4 * 256
    assert roofline.least_seconds(ops, nbytes) * 1e3 == pytest.approx(0.02285, abs=1e-5)
    ops2, nbytes2 = roofline.rank_count_work(False, 100, 14951, [100, 156])
    assert ops2 == ops / 2 and nbytes2 == nbytes + 4 * 100 * 14951


def _batch(**ids):
    return {key: torch.tensor([v], dtype=torch.int32) for key, v in ids.items()}


def test_update_work_of_a_two_row_batch():
    b = _batch(ph=[0, 1], pt=[2, 3], nh=[0, 4], nt=[5, 3], r=[0, 0])
    # TransE: 6 distinct entities + 1 relation; 19 instructions a row-coordinate, 2 a touched row's.
    assert transe.update_work(4, b) == [(2 * (19 * 2 * 4 + 2 * 7 * 4), 2 * 4 * 4 * 7 + 21 * 2)]
    ops, nbytes = transr.update_work(4, b)[0]
    assert ops == 2 * (23 * 2 * 16 + 20 * 2 * 4 + 2 * 4 * 7 + 2 * 16) and nbytes == 8 * (6 * 4 + 4 + 16) + 42
    assert transr.projection_work(50, 14951, [3, 4]) == (2 * 14951 * 2500 * 2, 0.0)


def _record(**kw):
    fields = dict(kind="train", on_card=True, k=100, l1=True, n_entities=14951, model=transe, spans={},
                  step_s=[0.1, 0.1, 0.3], units_per_step=1000, trace=None, work=[], group_queries=[])
    fields.update(kw)
    return cell.Record(**fields)


def test_readers_against_hand_worked_records():
    tr = trace.Trace(window_s=2.0, steps=4, busy_s=0.5, ops={"rank_count_kernel<false>": (8, 0.004),
                                                           "Memcpy HtoD": (4, 0.1)}, kernels=8, gaps={})
    c = spec.load("transe-fb15k.eval")
    read = lambda name, rec: c.reader(name).read(rec)  # noqa: E731
    rec = _record(kind="eval", trace=tr, group_queries=[256], units_per_step=256,
                  work=[[roofline.rank_count_work(True, 100, 14951, [256]), (0.0, 0.0)]])
    assert read("eval.device_idle", rec) == pytest.approx(75.0)
    assert read("eval.launches_per_query", rec) == pytest.approx(8 / (4 * 256))
    least = roofline.least_seconds(*roofline.rank_count_work(True, 100, 14951, [256]))
    assert read("rank_count_roofline", rec) == pytest.approx(100 * least * 4 / 0.004)
    assert read("eval_mfu", rec) == pytest.approx(100 * least / 0.1)
    assert read("eval_mfu", _record(on_card=False, work=rec.work)) is None
    assert read("rank_count_roofline", _record(trace=None, work=rec.work)) is None

    t = spec.load("transe-fb15k.train")
    rec = _record(work=[[(67e12 * 1e-3, 0.0)], [(0.0, 3.35e12 * 1e-3)]], spans={"sample": [0.002, 0.004]}, trace=tr)
    assert t.reader("train_mfu").read(rec) == pytest.approx(1.0)  # 1 ms of a 100 ms epoch
    assert t.reader("train.sample_ms").read(rec) == pytest.approx(3.0)
    assert t.reader("train.launches_per_epoch").read(rec) == pytest.approx(2.0)
    assert t.reader("train.apply_ms").read(rec) is None
