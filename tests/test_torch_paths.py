"""kb2e_tpu_torch's PCRA path stores and compositional KG against kb2e_tpu's.

The port keeps its own copy of ``data/paths.py`` (host numpy and Python), so
its pair paths and padded stores must equal the JAX package's exactly: on
the hand graphs of tests/test_ptranse.py and on small ``random_kg`` graphs,
at 2 and 3 hops, with ``max_branch``, with ``query_pairs`` and with
``pair_paths`` injected.  Its native extractor is ``native/path_extract.cpp``
built with the JAX package's flags into ``build/native/``, so its stores
equal the JAX package's native ones bit for bit and the port's Python store
(ids exact, confidences within 1e-6: the two sum resources in other orders).
``compositional_kg`` is seeded numpy: the same arrays.
"""

import numpy as np
import pytest
import torch

from kb2e_tpu.data import native_paths as jax_native_paths
from kb2e_tpu.data import paths as jax_paths
from kb2e_tpu.data import synthetic as jax_synthetic
from kb2e_tpu_torch.data import native, native_paths, paths, synthetic

torch.set_num_threads(1)

# tests/test_ptranse.py's hand graphs: (heads, tails, rels), 2 relations.
HAND = {
    "three edges": ([0, 0, 1], [1, 2, 2], [0, 0, 1]),
    "two paths a pair": ([0, 0, 1, 0, 3], [1, 2, 2, 3, 2], [0, 0, 1, 1, 1]),
}


def _hand(name):
    return tuple(np.asarray(a, np.int32) for a in HAND[name])


def _random(seed, n_ent=60, n_rel=6, n=500):
    return tuple(a.astype(np.int32) for a in synthetic.random_kg(n_ent, n_rel, n, seed=seed))


def _path_set(store, i):
    """Triple i's paths as {hops: conf}."""
    return {tuple(x for x in store.rels[i, p].tolist() if x >= 0): float(store.conf[i, p])
            for p in range(store.rels.shape[1]) if store.conf[i, p] > 0}


def _assert_stores_equal(got, want):
    assert got.rels.dtype == want.rels.dtype == np.int32 and got.conf.dtype == want.conf.dtype == np.float32
    np.testing.assert_array_equal(got.rels, want.rels)
    np.testing.assert_array_equal(got.conf, want.conf)
    assert got.coverage() == want.coverage()


@pytest.mark.parametrize("name", sorted(HAND))
@pytest.mark.parametrize("max_len", [2, 3])
def test_pair_paths_equal_jax_on_the_hand_graphs(name, max_len):
    h, t, r = _hand(name)
    got = paths.extract_pair_paths(h, t, r, n_relations=2, max_len=max_len)
    assert got == jax_paths.extract_pair_paths(h, t, r, n_relations=2, max_len=max_len)
    if name == "two paths a pair" and max_len == 2:  # R(p)/Z with Z = 1.5, the larger first
        assert [p for p, _ in got[(0, 2)][:2]] == [(1, 1), (0, 1)]
        assert got[(0, 2)][0][1] == pytest.approx(2 / 3)


@pytest.mark.parametrize("max_len,max_branch,min_conf", [(2, 0, 0.01), (3, 0, 0.01), (2, 5, 0.0), (3, 4, 0.02)])
def test_pair_paths_and_stores_equal_jax_on_random_kg(max_len, max_branch, min_conf):
    h, t, r = _random(11 + max_len + max_branch)
    kw = dict(max_len=max_len, min_conf=min_conf, max_branch=max_branch)
    got = paths.extract_pair_paths(h, t, r, 6, **kw)
    assert got == jax_paths.extract_pair_paths(h, t, r, 6, **kw)
    assert len(got) > 100
    for max_paths in (4, 16):
        store = paths.build_path_store(h, t, r, 6, max_paths=max_paths, use_native=False, **kw)
        _assert_stores_equal(store, jax_paths.build_path_store(h, t, r, 6, max_paths=max_paths, use_native=False,
                                                               **kw))
        assert store.rels.shape == (h.shape[0], max_paths, max_len) and store.max_paths == max_paths
        assert 0 < store.coverage() <= 1


def test_query_pairs_and_injected_pair_paths_equal_jax():
    h, t, r = _random(3)
    rng = np.random.default_rng(4)
    qh, qt = (rng.integers(0, 60, 90).astype(np.int32) for _ in range(2))
    qh[:10], qt[:10] = h[:10], t[:10]  # some query pairs are train pairs
    kw = dict(max_len=2, max_paths=8, use_native=False, query_pairs=(qh, qt))
    store = paths.build_path_store(h, t, r, 6, **kw)
    _assert_stores_equal(store, jax_paths.build_path_store(h, t, r, 6, **kw))
    assert store.rels.shape[0] == 90
    injected = {(int(qh[0]), int(qt[0])): [((3, 7), 0.75), ((1,), 0.25)]}
    kw["pair_paths"] = injected
    store = paths.build_path_store(h, t, r, 6, **kw)
    _assert_stores_equal(store, jax_paths.build_path_store(h, t, r, 6, **kw))
    np.testing.assert_array_equal(store.rels[0, :2], [[3, 7], [1, -1]])
    assert store.conf[0, :2].tolist() == [0.75, 0.25] and store.coverage() == pytest.approx(1 / 90)


@pytest.mark.parametrize("max_len,max_branch,query", [(2, 0, False), (3, 0, False), (2, 5, False), (2, 0, True)])
def test_native_store_equals_jax_native_bit_for_bit_and_the_python_store(max_len, max_branch, query):
    assert native_paths.available() and jax_native_paths.available()
    h, t, r = _random(11)
    rng = np.random.default_rng(5)
    q = (rng.integers(0, 60, 70).astype(np.int32), rng.integers(0, 60, 70).astype(np.int32)) if query else None
    # min_conf off the lattice of exact rational confidences, as
    # tests/test_ptranse_native.py sets it: a tie at the threshold may round
    # to either side in another summation order.
    kw = dict(max_len=max_len, max_paths=128, min_conf=0.0213, max_branch=max_branch, query_pairs=q)
    got = paths.build_path_store(h, t, r, 6, use_native=True, n_entities=60, **kw)
    _assert_stores_equal(got, jax_paths.build_path_store(h, t, r, 6, use_native=True, n_entities=60, **kw))
    # Paths of equal confidence may come in either order (the two sum a
    # path's resource in other orders), so a triple's paths compare as a set.
    py = paths.build_path_store(h, t, r, 6, use_native=False, **kw)
    for i in range(got.rels.shape[0]):
        g, p = _path_set(got, i), _path_set(py, i)
        assert g.keys() == p.keys()
        assert all(abs(g[key] - p[key]) <= 1e-6 for key in g)
    assert got.coverage() == py.coverage() > 0.5


def test_native_store_equals_the_python_store_in_order_on_distinct_confidences():
    h, t, r = _hand("two paths a pair")
    got = paths.build_path_store(h, t, r, 2, max_len=2, max_paths=4, use_native=True, n_entities=4)
    py = paths.build_path_store(h, t, r, 2, max_len=2, max_paths=4, use_native=False)
    np.testing.assert_array_equal(got.rels, py.rels)
    np.testing.assert_allclose(got.conf, py.conf, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.rels[1, :2], [[1, 1], [0, 1]])


def test_native_library_lands_in_build_native_under_a_hashed_name():
    lib = native.library_path(native_paths.SOURCE, native.BUILD_DIR, "libkb2e_paths")
    assert native_paths.available() and lib.exists()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libkb2e_paths_")
    assert native_paths.SOURCE.name == "path_extract.cpp" and native_paths.SOURCE.parent.name == "native"
    assert not list((native.ROOT / "kb2e_tpu_torch").rglob("*.so"))


def test_auto_picks_native_above_20000_triples_and_true_raises_without_it(monkeypatch):
    calls = []

    def fake(h, t, r, n_entities, n_relations, max_len, min_conf, max_paths, max_branch, query_pairs):
        calls.append((h.shape[0], n_entities, query_pairs[0].shape[0]))
        return np.full((query_pairs[0].shape[0], max_paths, max_len), -1, np.int32), \
            np.zeros((query_pairs[0].shape[0], max_paths), np.float32)

    monkeypatch.setattr(native_paths, "extract_path_arrays", fake)
    big = tuple(np.arange(20_001, dtype=np.int32) % m for m in (97, 89, 5))
    store = paths.build_path_store(*big, 5)
    assert calls == [(20_001, 97, 20_001)] and store.rels.shape == (20_001, 8, 2)
    small = tuple(a[:50] for a in big)
    paths.build_path_store(*small, 5)
    assert len(calls) == 1  # at or below 20,000 triples: the Python extractor
    monkeypatch.setattr(native_paths, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native path extractor requested but unavailable"):
        paths.build_path_store(*small, 5, use_native=True)


def test_a_failed_native_build_says_why_once(monkeypatch, capsys):
    def fail(*args, **kwargs):
        raise OSError("g++: not found")

    monkeypatch.setattr(native, "build", fail)
    native_paths._library.cache_clear()
    try:
        assert not native_paths.available() and not native_paths.available()
        err = capsys.readouterr().err
        assert err.count("kb2e_paths: native extractor unavailable (g++: not found)") == 1
        with pytest.raises(RuntimeError, match="unavailable"):
            native_paths.extract_path_arrays(*_hand("three edges"), 3, 2)
    finally:
        native_paths._library.cache_clear()


@pytest.mark.parametrize("kw", [{}, dict(n_entities=300, n_base_relations=6, n_composed=3, n_chains=900,
                                         n_extra_base=700, seed=3, direct_frac=0.2)])
def test_compositional_kg_equals_jax(kw):
    got, want = synthetic.compositional_kg(**kw), jax_synthetic.compositional_kg(**kw)
    for split in ("train", "valid", "test"):
        for a, b in zip(getattr(got, split), getattr(want, split)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.comp_pairs, want.comp_pairs)
    assert (got.n_entities, got.n_base_relations, got.n_composed, got.n_relations) == \
        (want.n_entities, want.n_base_relations, want.n_composed, want.n_relations)
