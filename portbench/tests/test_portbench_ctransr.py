"""CTransR in the benchmark, on the CPU: its plain reference against the
port's epoch, tiny runs of the two cells added with it, and the reader of
``train.cluster_top_share``."""

import json

import pytest
import torch

from conftest import REPO, TINY_GRAPH
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.data.triples import TripleSet
from kb2e_tpu_torch.models.base import get_model
from kb2e_tpu_torch.train import step as step_lib
from portbench import cell, spec
from portbench.data import graph as graph_lib
from portbench.reference import ctransr, transr

SPEC = {**TINY_GRAPH, "zipf_alpha": 0.8, "fan": 6, "type_mix": [0.15, 0.25, 0.30, 0.30]}
N, R = TINY_GRAPH["n_entities"], TINY_GRAPH["n_relations"]


@pytest.fixture(scope="module")
def graph():
    return graph_lib.generate(SPEC, 3)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_the_reference_epoch_follows_the_port(graph, distance):
    cfg = EmbeddingConfig(embedding_size=8, num_batches=4, seed=1, distance=int(distance))
    ts = TripleSet.from_arrays(*graph["train"], N, R)
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    runner = step_lib.EpochRunner(get_model("ctransr"), cfg, step_lib.batch_size_for(ts.num_triples, 4), 4)
    start = ctransr.init_tables(torch.Generator().manual_seed(2), N, R, 8, "train")
    assert {key: tuple(v.shape) for key, v in start.items()} == {
        "entity": (N, 8), "relation": (R, 8), "proj": (R, 8, 8), "relation_c": (R, 4, 8), "centers": (R, 4, 8)}
    batches = runner.sample(torch.Generator().manual_seed(3), data)
    assert batches["ph"].shape[0] > 1  # several chunks, each from the one before
    params, loss = runner.apply({k: v.clone() for k, v in start.items()}, batches, N)
    tables, ref_loss = ctransr.fast_epoch(start, batches, cfg.learning_rate, cfg.margin, distance == Distance.L1)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for leaf in ctransr.LEAVES:
        torch.testing.assert_close(params[leaf], tables[leaf], rtol=1e-5, atol=1e-6)
        assert not torch.equal(tables[leaf], start[leaf]), leaf
    assert torch.equal(params["centers"], start["centers"])
    # The samples spread over the clusters: the cell measures the routing.
    ent, cen = start["entity"], start["centers"]
    h, t, r = (batches[key].reshape(-1).long() for key in ("ph", "pt", "r"))
    cluster = (((ent[t] - ent[h])[:, None, :] - cen[r]) ** 2).sum(-1).argmin(1)
    assert len(torch.unique(cluster)) == ctransr.N_CLUSTERS


def test_the_reference_takes_its_work_from_the_ids():
    batches = {key: torch.tensor([[0, 1, 2, 2]]) for key in ("ph", "pt", "nh", "nt", "r")}
    (ops, nbytes), = ctransr.update_work(8, batches)
    (tr_ops, tr_bytes), = transr.update_work(8, batches)
    assert 0 < ops < tr_ops and nbytes > tr_bytes  # three descent pairs, not four; cluster rows and centers
    with pytest.raises(NotImplementedError, match="cluster"):
        ctransr.project({}, 0)


@pytest.mark.parametrize("name", ["ctransr-fb15k.train", "transe-fb15k.train-k8"])
def test_a_tiny_run_of_each_new_cell_is_correct(tiny, name):
    out = cell.run(spec.load(name, tiny), 2**31 + 11, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1


def test_the_k8_cell_draws_eight_corruptions_a_positive(tiny):
    c = spec.load("transe-fb15k.train-k8", tiny)
    assert c.traffic["embedding"] == {"num_negatives": 8}
    assert {m["name"] for m in c.end_to_end} == {"train_triples_per_s", "setup_s"}
    assert c.limits["control"] == spec.load("transe-fb15k.train", tiny).limits["control"]


def _read(monkeypatch, snap):
    from kb2e_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return spec.load("ctransr-fb15k.train", REPO).reader("train.cluster_top_share").read(None)


def _snap(counters):
    return {"spans": {"kb2e.train.apply": {"count": 2, "total_s": 1.0, "self_s": 0.1}}, "counters": counters}


@pytest.mark.parametrize("counters, want", [
    ({"ctransr.routed": 1000, "ctransr.routed_top": 250}, 25.0),  # even over four clusters
    ({"ctransr.routed": 1000, "ctransr.routed_top": 1000}, 100.0),  # one cluster takes all
    ({"ctransr.routed": 400, "ctransr.routed_top": 130}, 32.5),
])
def test_the_top_share_is_the_top_clusters_over_the_routed_samples(monkeypatch, counters, want):
    assert _read(monkeypatch, _snap({"train.chunks": 10, **counters})) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    _snap({"train.chunks": 10, "train.chunks_replayed": 10}),  # a program without the counters: the parent's
    _snap({"ctransr.routed": 0, "ctransr.routed_top": 0}),
    {"spans": {}, "counters": {"ctransr.routed": 4, "ctransr.routed_top": 4}},  # no epoch closed
])
def test_without_the_counters_the_top_share_reads_nothing(monkeypatch, snap):
    assert _read(monkeypatch, snap) is None


def test_the_top_share_entry_and_reader_agree():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["train.cluster_top_share"]
    reader = spec.load("ctransr-fb15k.train", REPO).reader("train.cluster_top_share")
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    assert entry["workloads"] == ["ctransr-fb15k.train"] and entry["source"] == "program_counter"
    assert entry["better"] == "lower"
