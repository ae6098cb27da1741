"""The seeded graph: FB15k's counts, determinism by seed, its skew."""

import numpy as np

from portbench.data import graph

FB15K = {"n_entities": 14951, "n_relations": 1345, "n_train": 483142, "n_valid": 50000, "n_test": 59071,
         "zipf_alpha": 0.8, "fan": 6, "type_mix": [0.15, 0.25, 0.30, 0.30]}


def _keys(g, split):
    h, t, r = g[split]
    return (h.astype(np.int64) * 1345 + r) * 14951 + t


def test_fb15k_counts_distinct_triples_and_skew():
    g = graph.generate(FB15K, 2**31 + 5)
    assert [g[s][0].shape[0] for s in ("train", "valid", "test")] == [483142, 50000, 59071]
    every = np.concatenate([_keys(g, s) for s in ("train", "valid", "test")])
    assert np.unique(every).shape[0] == every.shape[0]  # no triple twice, in a split or across
    for h, t, r in g.values():
        assert h.dtype == np.int32 and h.max() < 14951 and t.max() < 14951 and r.max() < 1345 and h.min() >= 0
    stats = graph.statistics(g, 14951, 1345)
    assert 50 <= stats["relation_size_min"] <= 300 and 150 <= stats["relation_size_median"] <= 250
    assert 20000 <= stats["relation_size_max"] <= 50000 and stats["top_entity_degree"] >= 20000


def test_the_same_seed_gives_the_same_graph_and_another_seed_another():
    spec = {**FB15K, "n_entities": 500, "n_relations": 20, "n_train": 4000, "n_valid": 300, "n_test": 300}
    a, b, c = graph.generate(spec, 7), graph.generate(spec, 7), graph.generate(spec, 8)
    for split in a:
        assert all(np.array_equal(x, y) for x, y in zip(a[split], b[split]))
    assert not np.array_equal(a["train"][0], c["train"][0])
