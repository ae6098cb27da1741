"""kb2e_tpu_torch's membership indices and sampler against kb2e_tpu's.

The cuckoo index is built on the host by the same NumPy code in both
packages, so its table, fingerprints, size and salt must be equal; the
device probes hash in uint32 (JAX) and in int64 masked to 32 bits (torch),
and must give the same slots, fingerprints and booleans, bit for bit.  The
samplers draw from different generators, so they are held to what a sample
must satisfy, and ``batch_from_streams`` to JAX's on injected streams.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu.constants import Method as JMethod
from kb2e_tpu.data import synthetic as jax_synthetic
from kb2e_tpu.data import triples as jax_triples
from kb2e_tpu.sampling import corruption as jax_corruption
from kb2e_tpu.sampling import cuckoo as jax_cuckoo
from kb2e_tpu.sampling import membership as jax_membership
from kb2e_tpu_torch.constants import Method
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.sampling import corruption, cuckoo, membership
from kb2e_tpu_torch.train import step as step_lib

torch.set_num_threads(1)


def _random_triple_sets(n_ent=500, n_rel=7, n=3000, seed=3):
    h, t, r = jax_synthetic.random_kg(n_ent, n_rel, n, seed=seed)
    return (
        jax_triples.TripleSet.from_arrays(h, t, r, n_ent, n_rel),
        triples.TripleSet.from_arrays(h, t, r, n_ent, n_rel),
    )


def _build(ts):
    return cuckoo.build(ts.sorted_h, ts.sorted_r, ts.sorted_t, ts.n_relations)


def _assert_same_index(jts, ts):
    idx = _build(ts)
    np.testing.assert_array_equal(idx.table, jts.cuckoo_table)
    np.testing.assert_array_equal(idx.fp, jts.cuckoo_fp)
    assert (idx.m, idx.salt) == (jts.cuckoo_m, jts.cuckoo_salt)
    # The trainer's device data carries the same index.
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    np.testing.assert_array_equal(data.cuckoo_table.numpy(), jts.cuckoo_table)
    np.testing.assert_array_equal(data.cuckoo_fp.numpy(), jts.cuckoo_fp)
    assert (data.cuckoo_m, data.cuckoo_salt) == (jts.cuckoo_m, jts.cuckoo_salt)


def test_cuckoo_build_equals_jax_on_tiny_kg(tiny_kg_dir, tiny_dataset):
    ts = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test")).train
    # Built by the trainer, not when the set is loaded.
    assert not any(f.name.startswith("cuckoo") for f in dataclasses.fields(ts))
    _assert_same_index(tiny_dataset.train, ts)


def test_cuckoo_build_equals_jax_on_random_kg():
    jts, ts = _random_triple_sets()
    assert ts.num_triples > 2900
    _assert_same_index(jts, ts)
    # The build is seeded: a second one gives the same index.
    a, b = _build(ts), _build(ts)
    np.testing.assert_array_equal(a.table, b.table)
    assert (a.m, a.salt) == (b.m, b.salt)


def test_cuckoo_build_overflow_leaves_the_binary_search():
    big = 2**21  # g = h·R + r reaches 2^32 − 1: past int32
    ts = triples.TripleSet.from_arrays(
        np.array([big - 1, 3], np.int32), np.array([0, 1], np.int32), np.array([2047, 1], np.int32), big, 2048
    )
    with pytest.raises(OverflowError):
        _build(ts)
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    assert data.cuckoo_table is None and data.cuckoo_fp is None


def _ids(rng, n):
    """Random int32 ids over the whole range, with some at and near 2^31 − 1."""
    g = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    t = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    g[:8] = 2**31 - 1 - np.arange(8)
    t[4:12] = 2**31 - 1 - np.arange(8)
    return g, t


@pytest.mark.parametrize("m", [2**20, 1_000_003, 8])
def test_hashes_are_bit_equal_to_jax_and_numpy(m):
    rng = np.random.default_rng(m)
    g, t = _ids(rng, 4096)
    for salt in (0, 12345, 2**31 - 1, int(rng.integers(0, 2**31))):
        with np.errstate(over="ignore"):
            fp_np = jax_cuckoo._fingerprint(np, g, t, salt)
            np.testing.assert_array_equal(cuckoo._fingerprint(g, t, salt), fp_np)
        fp_jax = np.asarray(jax_cuckoo._fingerprint(jnp, jnp.asarray(g), jnp.asarray(t), salt))
        fp_t = cuckoo.fingerprint(torch.from_numpy(g), torch.from_numpy(t), salt)
        assert fp_t.dtype == torch.int32
        np.testing.assert_array_equal(fp_t.numpy(), fp_jax)
        np.testing.assert_array_equal(fp_jax, fp_np)
        assert not (fp_np == 0).any()
        for table in (0, 1):
            with np.errstate(over="ignore"):
                h_np = jax_cuckoo._hash(g, t, salt, table, m)
                np.testing.assert_array_equal(cuckoo._hash(g, t, salt, table, m), h_np)
            h_jax = np.asarray(jax_cuckoo._hash_jnp(jnp.asarray(g), jnp.asarray(t), salt, table, m))
            h_t = cuckoo.hash_slots(torch.from_numpy(g), torch.from_numpy(t), salt, table, m)
            np.testing.assert_array_equal(h_t.numpy(), h_jax)
            np.testing.assert_array_equal(h_jax, h_np)
            assert h_t.min() >= 0 and h_t.max() < m


def _queries(ts, rng, shape):
    """Every member, then random (h, r, t) queries of the given shape."""
    members = (ts.sorted_h, ts.sorted_r, ts.sorted_t)
    rand = (
        rng.integers(0, ts.n_entities, shape).astype(np.int32),
        rng.integers(0, ts.n_relations, shape).astype(np.int32),
        rng.integers(0, ts.n_entities, shape).astype(np.int32),
    )
    return members, rand


def test_membership_probes_equal_jax_bit_for_bit():
    jts, ts = _random_triple_sets(n_ent=300, n_rel=5, n=4000, seed=8)
    idx = _build(ts)
    rng = np.random.default_rng(0)
    members, rand = _queries(ts, rng, (64, 2, 4))
    # Random queries that hit members too: copy a few members in.
    pick = rng.integers(0, ts.sorted_h.shape[0], 40)
    for q, s in zip(rand, members):
        q.reshape(-1)[:40] = s[pick]
    j_args = (jnp.asarray(jts.cuckoo_table), jts.cuckoo_m, jts.cuckoo_salt, jts.n_relations)
    j_fp = (jnp.asarray(jts.cuckoo_fp), jts.cuckoo_m, jts.cuckoo_salt, jts.n_relations)
    t_args = (torch.from_numpy(idx.table), idx.m, idx.salt, ts.n_relations)
    t_fp = (torch.from_numpy(idx.fp), idx.m, idx.salt, ts.n_relations)
    j_sorted = tuple(jnp.asarray(a) for a in (jts.sorted_h, jts.sorted_r, jts.sorted_t))
    t_sorted = tuple(torch.from_numpy(a) for a in (ts.sorted_h, ts.sorted_r, ts.sorted_t))
    for qs, all_members in ((members, True), (rand, False)):
        jq, tq = tuple(jnp.asarray(a) for a in qs), tuple(torch.from_numpy(a) for a in qs)
        want = np.asarray(jax_membership.contains(*j_sorted, *jq))
        assert want.all() if all_members else (0 < want.sum() < want.size)
        for got, jax_want in (
            (cuckoo.contains(*t_args, *tq), jax_cuckoo.contains(*j_args, *jq)),
            (cuckoo.contains_fp(*t_fp, *tq), jax_cuckoo.contains_fp(*j_fp, *jq)),
            (membership.contains(*t_sorted, *tq), want),
        ):
            assert got.dtype == torch.bool and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_want))
            np.testing.assert_array_equal(got.numpy(), want)


def test_membership_binary_search_on_an_empty_set():
    empty = torch.zeros(0, dtype=torch.int32)
    q = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert not membership.contains(empty, empty, empty, q, q, q).any()


def _device_data(ts, use_cuckoo=True):
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    if not use_cuckoo:
        data.cuckoo_table = data.cuckoo_fp = None
    return data


def _draw(data, method, batch_size, num_negatives=1, seed=0, rounds=4):
    return corruption.sample_batch(
        torch.Generator().manual_seed(seed), data.heads, data.tails, data.rels, data.bern_pr_tail,
        data.sorted_h, data.sorted_r, data.sorted_t, n_entities=data.n_entities, batch_size=batch_size,
        method=method, resample_rounds=rounds, cuckoo_table=data.cuckoo_table, cuckoo_m=data.cuckoo_m,
        cuckoo_salt=data.cuckoo_salt, cuckoo_fp=data.cuckoo_fp, n_relations=data.n_relations,
        num_negatives=num_negatives,
    )


@pytest.mark.parametrize("probe", ["fingerprint", "keys", "binary_search"])
def test_sampled_negatives_are_never_members(tiny_dataset, probe):
    ts = triples.TripleSet.from_arrays(
        tiny_dataset.train.heads, tiny_dataset.train.tails, tiny_dataset.train.rels,
        tiny_dataset.n_entities, tiny_dataset.n_relations,
    )
    data = _device_data(ts, use_cuckoo=probe != "binary_search")
    if probe == "keys":
        data.cuckoo_fp = None
    known = set(zip(ts.heads.tolist(), ts.rels.tolist(), ts.tails.tolist()))
    # 64 entities and a dense graph: one candidate round leaves some invalid.
    for rounds in (1, 4):
        b = _draw(data, Method.BERN, 3000, rounds=rounds)
        for key in ("ph", "pt", "r", "nh", "nt"):
            assert b[key].dtype == torch.int32 and b[key].shape == (3000,)
        valid = b["valid"]
        negs = zip(b["nh"][valid].tolist(), b["r"][valid].tolist(), b["nt"][valid].tolist())
        assert not [n for n in negs if n in known]
        assert all(p in known for p in zip(b["ph"].tolist(), b["r"].tolist(), b["pt"].tolist()))
        # One side only is corrupted.
        assert bool(((b["nh"] == b["ph"]) | (b["nt"] == b["pt"])).all())
        if rounds == 4:
            assert valid.float().mean() > 0.97


def test_sampler_with_k_negatives_is_sample_major(tiny_dataset):
    data = _device_data(triples.TripleSet.from_arrays(
        tiny_dataset.train.heads, tiny_dataset.train.tails, tiny_dataset.train.rels,
        tiny_dataset.n_entities, tiny_dataset.n_relations,
    ))
    k, bsz = 4, 500
    b = _draw(data, Method.BERN, bsz, num_negatives=k, seed=3)
    assert all(v.shape == (bsz * k,) for v in b.values())
    for key in ("ph", "pt", "r"):
        rows = b[key].reshape(bsz, k)
        assert bool((rows == rows[:, :1]).all())
    # One coin per sample: its K negatives corrupt the same side.
    tail_side = (b["nh"] == b["ph"]).reshape(bsz, k)
    head_side = (b["nt"] == b["pt"]).reshape(bsz, k)
    assert bool((tail_side.all(1) | head_side.all(1)).all())
    # K = 1 draws the same positives and coins as the first of K = 4.
    one = _draw(data, Method.BERN, bsz, num_negatives=1, seed=3)
    for key in ("ph", "pt", "r"):
        assert torch.equal(one[key], b[key].reshape(bsz, k)[:, 0])


def test_bern_coin_frequency_follows_bern_pr_tail(tiny_dataset):
    ts = triples.TripleSet.from_arrays(
        tiny_dataset.train.heads, tiny_dataset.train.tails, tiny_dataset.train.rels,
        tiny_dataset.n_entities, tiny_dataset.n_relations,
    )
    data = _device_data(ts)
    n = 20000
    for method in (Method.BERN, Method.UNIF):
        b = _draw(data, method, n, seed=5)
        v = b["valid"]
        tail = (b["nt"] != b["pt"])[v].double().mean().item()
        want = ts.bern_pr_tail[b["r"][v].numpy()].mean() if method == Method.BERN else 0.5
        # The binomial standard error at n = 20000 is below 0.004.
        assert abs(tail - want) < 0.02, (method, tail, want)


def test_batch_from_streams_equals_jax():
    rng = np.random.default_rng(11)
    heads, tails, rels = (rng.integers(0, 50, 200).astype(np.int32) for _ in range(3))
    idx = rng.integers(0, 200, 64).astype(np.int32)
    cand = rng.integers(0, 50, 64).astype(np.int32)
    coin = rng.random(64) < 0.5
    want = jax_corruption.batch_from_streams(*(jnp.asarray(a) for a in (idx, cand, coin, heads, tails, rels)))
    got = corruption.batch_from_streams(*(torch.from_numpy(a) for a in (idx, cand, coin, heads, tails, rels)))
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert JMethod.BERN == Method.BERN
