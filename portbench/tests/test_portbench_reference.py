"""The plain reference against the port on a tiny graph on the CPU."""

import numpy as np
import pytest
import torch

from conftest import TINY_GRAPH
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.data.triples import Dataset, TripleSet, bern_tail_probability
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.models.base import get_model
from kb2e_tpu_torch.train import step as step_lib
from portbench import cell, checks, spec
from portbench.data import graph as graph_lib
from portbench.reference import facts, ranks, sampler, transe, transr

SPEC = {**TINY_GRAPH, "zipf_alpha": 0.8, "fan": 6, "type_mix": [0.15, 0.25, 0.30, 0.30]}
N, R = TINY_GRAPH["n_entities"], TINY_GRAPH["n_relations"]


@pytest.fixture(scope="module")
def graph():
    return graph_lib.generate(SPEC, 3)


def test_bern_worked_out_again_equals_the_port(graph):
    h, t, r = graph["train"]
    np.testing.assert_allclose(facts.bern_tail_probability(h, t, r, R), bern_tail_probability(h, t, r, R))


@pytest.mark.parametrize("name,ref", [("transe", transe), ("transr", transr)])
def test_the_reference_epoch_follows_the_port(graph, name, ref):
    cfg = EmbeddingConfig(embedding_size=8, num_batches=4, seed=1)
    ts = TripleSet.from_arrays(*graph["train"], N, R)
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    runner = step_lib.EpochRunner(get_model(name), cfg, step_lib.batch_size_for(ts.num_triples, 4), 4)
    start = ref.init_tables(torch.Generator().manual_seed(2), N, R, 8, "train")
    batches = runner.sample(torch.Generator().manual_seed(3), data)
    params, loss = runner.apply({k: v.clone() for k, v in start.items()}, batches, N)
    tables, ref_loss = ref.fast_epoch(start, batches, cfg.learning_rate, cfg.margin, True)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for leaf in ref.LEAVES:
        torch.testing.assert_close(params[leaf], tables[leaf], rtol=1e-5, atol=1e-6)
        assert not torch.equal(tables[leaf], start[leaf])
    rows = runner.rows * 4
    assert sampler.judge([batches], graph["train"], N, R, 1, rows, "cpu")["bad_negatives"] == 0
    bad = {k: v.clone() for k, v in batches.items()}
    bad["nt"].view(-1)[0], bad["nh"].view(-1)[0] = bad["pt"].view(-1)[0], bad["ph"].view(-1)[0]
    bad["valid"].view(-1)[0] = True
    assert sampler.judge([bad], graph["train"], N, R, 1, rows, "cpu")["bad_negatives"] == 1


@pytest.mark.parametrize("name,ref", [("transe", transe), ("transr", transr)])
def test_reference_ranks_equal_the_harness(graph, name, ref):
    tables = ref.init_tables(torch.Generator().manual_seed(4), N, R, 8, "eval")
    names = {str(i): i for i in range(N)}
    dataset = Dataset(entity2id=names, relation2id={str(i): i for i in range(R)},
                      train=TripleSet.from_arrays(*graph["train"], N, R), valid=graph["valid"], test=graph["test"])
    cfg = EmbeddingConfig(embedding_size=8)
    raw, filt, _ = harness.rank_all(get_model(name), tables, dataset, cfg, device="cpu")
    assert checks.eval_numbers(ref, tables, graph, [(raw, filt)], N, R, True, "cpu") == {"rank_mismatch": 0.0}
    ref_raw, ref_filt = ranks.ranks(ref, tables, graph, N, R, True, "cpu")
    assert (ref_filt <= ref_raw).all() and (ref_filt >= 1).all() and (ref_filt < ref_raw).any()
    assert checks.eval_numbers(ref, tables, graph, [(raw + 1, filt)], N, R, True, "cpu")["rank_mismatch"] == 1.0


@pytest.mark.parametrize("name", [w for w in ("transe-fb15k.train", "transr-fb15k.train", "transe-fb15k.eval",
                                               "transr-fb15k.eval")])
def test_a_tiny_run_of_each_cell_is_correct(tiny, name):
    out = cell.run(spec.load(name, tiny), 2**31 + 9, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
