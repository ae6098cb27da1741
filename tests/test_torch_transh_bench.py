"""TransH in the benchmark, on the CPU: the plain reference
(``portbench/reference/transh.py``) against the port's fast epoch and its
projector, and tiny runs of the two cells added with it.

The reference and the port compute in float32 and add each row's terms in
the same order here (``index_add`` is sequential on the CPU), so they agree
bit for bit; the tolerances below leave room for float32 sums taken in
another order, and are still far under what bfloat16 tables give.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.data.triples import TripleSet
from kb2e_tpu_torch.ops import projections
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling
from portbench import cell, spec
from portbench.data import graph as graph_lib
from portbench.reference import transh

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N, R, K, BATCHES = 64, 8, 16, 3
LR = 0.01  # ten times the cell's, so that the projector fires within three batches

# A table's gap is its largest difference from the reference over the
# reference's largest change of it.  A change is a sum of at most a few
# hundred float32 steps, each rounded to 2^-24 of itself: another order of
# those sums moves a table by about 1e-7 of its change.  A bfloat16 table is
# rounded to 2^-9 of each value, about 1e-3 of a row of norm 0.25, as much as
# three batches change it.
TABLE_GAP = 1e-5
# The loss: a sum over the batch's rows of float32 energies, each a sum of
# k terms; another order moves it by about 1e-7 of itself.
LOSS_GAP = 1e-6


@pytest.fixture(autouse=True)
def _fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def epoch():
    """(the runner, the reference's start tables, three sampled batches) on a seeded graph."""
    spec_ = {"n_entities": N, "n_relations": R, "n_train": 600, "n_valid": 50, "n_test": 50, "zipf_alpha": 0.8,
             "fan": 6, "type_mix": [0.15, 0.25, 0.30, 0.30]}
    graph = graph_lib.generate(spec_, 3)
    ts = TripleSet.from_arrays(*graph["train"], N, R)
    cfg = EmbeddingConfig(embedding_size=K, num_batches=BATCHES, learning_rate=LR, seed=1)
    runner = step_lib.EpochRunner(get_model("transh"), cfg, step_lib.batch_size_for(ts.num_triples, BATCHES),
                                  BATCHES)
    start = transh.init_tables(torch.Generator().manual_seed(2), N, R, K, "train")
    batches = runner.sample(torch.Generator().manual_seed(3), step_lib.DeviceData.from_triple_set(ts, "cpu"))
    return runner, start, batches


def _bf16_reference(start, batches):
    """The reference with its tables stored in bfloat16 after every batch (the
    cell's ``bf16_reference`` control)."""
    tables, loss = {key: v.bfloat16().float() for key, v in start.items()}, 0.0
    for i in range(batches["ph"].shape[0]):
        tables, part = transh.fast_epoch(tables, {key: v[i:i + 1] for key, v in batches.items()}, LR, 1.0, True)
        tables, loss = {key: v.bfloat16().float() for key, v in tables.items()}, loss + part
    return tables, loss


@pytest.mark.parametrize("side", ["port", "bf16_reference"])
def test_the_reference_epoch_follows_the_port_and_bfloat16_does_not(epoch, side):
    runner, start, batches = epoch
    want, want_loss = transh.fast_epoch(start, batches, LR, 1.0, True)
    if side == "port":
        with profile(activities=[ProfilerActivity.CPU]):
            got, got_loss = runner.apply({key: v.clone() for key, v in start.items()}, batches, N)
        syncs = profiling.snapshot()["counters"]["transh.project_syncs"]
        assert syncs > 2 * BATCHES  # some call ran more than one trip: the projector fired
    else:
        got, got_loss = _bf16_reference(start, batches)
    gaps = {leaf: float((got[leaf] - want[leaf]).abs().max() / (want[leaf] - start[leaf]).abs().max())
            for leaf in transh.LEAVES}
    loss_gap = abs(float(got_loss) - want_loss) / abs(want_loss)
    within = max(gaps.values()) <= TABLE_GAP and loss_gap <= LOSS_GAP
    assert within == (side == "port"), (gaps, loss_gap)


def _projector_rows(seed, k=K):
    """Row pairs (a, b): a third nearly orthogonal (they stop at the first
    check), a third with a·b̂ just above 0.1 (a few trips), a third at 1 (at
    the cell's rate they run to the cap of 16)."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(30, k)).astype(np.float32)
    a = rng.normal(size=(30, k)).astype(np.float32) * 0.01
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    a[10:20] += 0.15 * bn[10:20]
    a[20:] += bn[20:]
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("cap, rows", [(1, 30), (2, 30), (16, 30), (16, 20)])
def test_the_fixed_trip_projector_equals_the_early_exit_bit_for_bit(cap, rows):
    # Without the last third, every row stops before 16 trips and the port's loop leaves early.
    a, b = (x[:rows] for x in _projector_rows(cap))
    with profile(activities=[ProfilerActivity.CPU]):
        got_a, got_b = projections.orthogonality_project(a, b, 0.001, cap)
    want_a, want_b = transh.orthogonalize(a, b, 0.001, cap)
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    # Rows still firing at the cap are those whose last trip moved a.
    fewer_a, _ = transh.orthogonalize(a, b, 0.001, cap - 1)
    at_cap = int((fewer_a != want_a).any(-1).sum())
    assert (at_cap >= 10) == (rows == 30) and at_cap < rows
    counters = profiling.snapshot()["counters"]
    assert counters["transh.project_capped"] == at_cap and counters["transh.project_calls"] == 1
    assert (counters["transh.project_syncs"] == cap) == (at_cap > 0) and counters["transh.project_syncs"] <= cap


def _tiny_root(tmp: Path) -> Path:
    """The benchmark cut to a CPU test's size (``portbench/tests/conftest.py::tiny_root``)."""
    path = REPO / "portbench" / "tests" / "conftest.py"
    module_spec = importlib.util.spec_from_file_location("portbench_tests_conftest", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.tiny_root(tmp)


@pytest.mark.parametrize("name", ["transh-fb15k.train", "transe-fb15k.eval-l2"])
def test_a_tiny_run_of_each_new_cell_is_correct(tmp_path, name):
    out = cell.run(spec.load(name, _tiny_root(tmp_path)), 2**31 + 11, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
