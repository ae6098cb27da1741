"""kb2e_tpu_torch's TransE training against kb2e_tpu's.

The same numpy-seeded tables and injected batches go through both packages:
the scatter-adds, the fast update (``batch_update``, ``fused_table_update``
and the epoch runner, whose one-device loop equals every model's
``batch_update`` batch by batch) and the parity update, whose plain version (the CPU
side of the CUDA kernel K3) is held against JAX's scan path, against JAX's
Pallas kernel in interpret mode and against the NumPy oracle.  Then the
loop and the CLI train on ``tiny_kg_dir`` on the CPU.

Tolerances: float32 tables atol 1e-5 and losses rel 1e-5, as
tests/test_pallas_update.py holds the Pallas kernel to the scan path (sums
over k and over the batch are taken in another order); atol 3e-5 against
the oracle over 3 batches, as tests/test_parity.py; bfloat16 tables of the
fast update to one bf16 step of the values (2^-8 relative), since the row
norms are summed in another order before the division is rounded to bf16.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu.cli import eval_transe as jax_eval_transe
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu.models.base import Batch as JBatch
from kb2e_tpu.ops import pallas_update as jax_pallas_update
from kb2e_tpu.ops import scatter as jax_scatter
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval_transe, train_transe
from kb2e_tpu_torch.cli import train as train_cli
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.io import checkpoint
from kb2e_tpu_torch.models import base
from kb2e_tpu_torch.ops import cuda_build, scatter, transe_update
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling

from oracle import TransEOracle

torch.set_num_threads(1)

N_ENT, N_REL = 40, 6


def _tables(seed, k, n=N_ENT, n_rel=N_REL, scale=0.4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) * scale).astype(np.float32), (rng.normal(size=(n_rel, k)) * scale).astype(np.float32)


def _batch_arrays(seed, b, n=N_ENT, n_rel=N_REL, self_loops=False, k_neg=1):
    """ph pt r nh nt valid; with ``k_neg`` > 1 the positives repeat sample-major."""
    rng = np.random.default_rng(seed)
    ph, pt = (np.repeat(rng.integers(0, n, b // k_neg), k_neg).astype(np.int32) for _ in range(2))
    r = np.repeat(rng.integers(0, n_rel, b // k_neg), k_neg).astype(np.int32)
    if self_loops:
        pt[: b // 2] = ph[: b // 2]
    nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(2))
    valid = rng.random(b) > 0.1
    return ph, pt, r, nh, nt, valid


def _jax_batch(arrays):
    return JBatch(zip(("ph", "pt", "r", "nh", "nt", "valid"), (jnp.asarray(a) for a in arrays)))


def _torch_batch(arrays):
    return dict(zip(("ph", "pt", "r", "nh", "nt", "valid"), (torch.from_numpy(a) for a in arrays)))


def _close(got, want, dtype=torch.float32, atol=1e-5):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2**-8, atol=2**-8)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# --- scatter ---------------------------------------------------------------


@pytest.mark.parametrize("trailing", [(12,), (5, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_adds_equal_jax_with_duplicate_indices(trailing, dtype):
    rng = np.random.default_rng(len(trailing))
    idx = rng.integers(0, 30, 90).astype(np.int32)
    idx[:20] = 7  # a long run of one row
    if dtype == torch.float32:
        table = rng.normal(size=(30, *trailing)).astype(np.float32)
        delta = rng.normal(size=(90, *trailing)).astype(np.float32)
    else:
        # Small integers: every partial sum, the dedup path's running sums
        # over all 90 rows included, is exact in bf16, so the order of the
        # additions cannot matter and both packages must give the exact sums.
        table = rng.integers(-4, 5, size=(30, *trailing)).astype(np.float32)
        delta = rng.integers(-1, 2, size=(90, *trailing)).astype(np.float32)
    exact = table.copy()
    np.add.at(exact, idx, delta)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jt, jd = jnp.asarray(table, jdt), jnp.asarray(delta, jdt)
    tt, td = torch.from_numpy(table).to(dtype), torch.from_numpy(delta).to(dtype)
    for name in ("direct", "dedup"):
        want = jax_scatter.scatter_add(jt, jnp.asarray(idx), jd, name)
        got = scatter.scatter_add(tt, torch.from_numpy(idx), td, name)
        assert got.dtype == dtype and got.shape == tt.shape
        _close(got, want)
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.float().numpy(), exact)
    assert torch.equal(tt, torch.from_numpy(table).to(dtype))  # out of place


# --- fast update ----------------------------------------------------------


def _cfgs(distance, k, **kw):
    common = dict(embedding_size=k, learning_rate=0.05, margin=1.0, **kw)
    return JConfig(distance=JDistance(int(distance)), **common), EmbeddingConfig(distance=distance, **common)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("k_neg", [1, 4])
@pytest.mark.parametrize("scatter_mode", ["direct", "dedup"])
def test_fast_updates_equal_jax(distance, k_neg, scatter_mode):
    k = 12
    ent, rel = _tables(1, k)
    arrays = _batch_arrays(2 + k_neg, 48, k_neg=k_neg)
    jcfg, cfg = _cfgs(distance, k, scatter_mode=scatter_mode)
    jm, m = jax_get_model("transe"), get_model("transe")
    jparams = {"entity": jnp.asarray(ent), "relation": jnp.asarray(rel)}
    tparams = {"entity": torch.from_numpy(ent), "relation": torch.from_numpy(rel)}

    want, want_loss = jm.batch_update(jparams, _jax_batch(arrays), jcfg)
    got, loss = m.batch_update(tparams, _torch_batch(arrays), cfg)
    for key in ("entity", "relation"):
        _close(got[key], want[key])
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)

    want_t, want_loss = jm.fused_table_update(jm.fuse_params(jparams), N_ENT, _jax_batch(arrays), jcfg)
    got_t, loss = m.fused_table_update(base.fuse(tparams), N_ENT, _torch_batch(arrays), cfg)
    _close(got_t, want_t)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    # The fused table is the two tables of batch_update.
    for key, part in base.unfuse(got_t, N_ENT).items():
        _close(part, want[key])


def test_fast_update_bf16_tables_equal_jax():
    k = 16
    ent, rel = _tables(3, k)
    arrays = _batch_arrays(4, 64)
    jcfg, cfg = _cfgs(Distance.L1, k, param_dtype="bfloat16")
    want, _ = jax_get_model("transe").batch_update(
        {"entity": jnp.asarray(ent, jnp.bfloat16), "relation": jnp.asarray(rel, jnp.bfloat16)}, _jax_batch(arrays), jcfg
    )
    got, _ = get_model("transe").batch_update(
        {"entity": torch.from_numpy(ent).bfloat16(), "relation": torch.from_numpy(rel).bfloat16()},
        _torch_batch(arrays), cfg,
    )
    for key in ("entity", "relation"):
        assert got[key].dtype == torch.bfloat16
        _close(got[key], want[key], torch.bfloat16)


def test_l1_direction_at_a_zero_residual_is_minus_one():
    # h == t and r == 0: the residual is exactly 0, so L1's x is −1 per
    # coordinate (torch.sign would give 0 and leave the rows alone).
    k = 8
    ent, rel = _tables(5, k, scale=0.05)  # e_neg < margin: the sample violates
    rel[0] = 0.0
    arrays = (np.array([3], np.int32), np.array([3], np.int32), np.array([0], np.int32),
              np.array([4], np.int32), np.array([9], np.int32), np.array([True]))
    jcfg, cfg = _cfgs(Distance.L1, k)
    want, _ = jax_get_model("transe").batch_update(
        {"entity": jnp.asarray(ent), "relation": jnp.asarray(rel)}, _jax_batch(arrays), jcfg
    )
    got, _ = get_model("transe").batch_update(
        {"entity": torch.from_numpy(ent), "relation": torch.from_numpy(rel)}, _torch_batch(arrays), cfg
    )
    _close(got["relation"], want["relation"])
    _close(got["entity"], want["entity"])
    # r moved by lr·x_pos − lr·x_neg, with x_pos = −1 everywhere.
    assert not torch.equal(got["relation"][0], torch.zeros(k))


# --- parity update (K3's plain version) ---------------------------------------


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("self_loops", [False, True])
def test_parity_plain_version_equals_jax_scan_and_pallas_kernel(distance, self_loops):
    # tests/test_pallas_update.py's cases: k = 16, lr 0.05, a quarter of
    # the samples h == t when self_loops.
    k, l1 = 16, distance == Distance.L1
    ent, rel = _tables(3 if self_loops else 1, k)
    arrays = _batch_arrays(7, 32, self_loops=self_loops)
    jcfg, cfg = _cfgs(distance, k, update_mode="parity", parity_impl="scan")
    jparams = {"entity": jnp.asarray(ent), "relation": jnp.asarray(rel)}
    want, want_loss = jax_get_model("transe").sequential_update(jparams, _jax_batch(arrays), jcfg)
    jb = _jax_batch(arrays)
    k_ent, k_rel, k_loss = jax_pallas_update.transe_sequential_update(
        jparams["entity"], jparams["relation"], jb["ph"], jb["pt"], jb["r"], jb["nh"], jb["nt"], jb["valid"],
        learning_rate=0.05, margin=1.0, l1=l1, interpret=True,
    )
    t = [torch.from_numpy(a) for a in (ent, rel, *arrays)]
    got_ent, got_rel, loss, viol = transe_update.transe_sequential_update_reference(
        *t, learning_rate=0.05, margin=1.0, l1=l1
    )
    assert 0 < int(viol.sum()) < 32
    for w_ent, w_rel, w_loss in ((want["entity"], want["relation"], want_loss), (k_ent, k_rel, k_loss)):
        _close(got_ent, w_ent)
        _close(got_rel, w_rel)
        assert float(loss) == pytest.approx(float(w_loss), rel=1e-5)
    # The wrapper takes the plain version for CPU tensors and counts no launch;
    # the model's sequential_update reaches it through the wrapper under every
    # parity_impl.
    cuda_build.reset_launch_counts()
    via_wrapper = transe_update.transe_sequential_update(*t, learning_rate=0.05, margin=1.0, l1=l1)
    assert sum(cuda_build.launch_counts.values()) == 0
    assert torch.equal(via_wrapper[3], viol)
    for impl in ("auto", "pallas", "scan"):
        p, l_ = get_model("transe").sequential_update(
            {"entity": t[0], "relation": t[1]}, _torch_batch(arrays), cfg.replace(parity_impl=impl)
        )
        assert torch.equal(p["entity"], via_wrapper[0]) and torch.equal(p["relation"], via_wrapper[1])
        assert float(l_) == float(via_wrapper[2])


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_parity_plain_version_follows_the_oracle_over_three_batches(distance):
    # tests/test_parity.py's setting: 24 entities, 4 relations, k = 8, B = 32.
    rng = np.random.default_rng(5)
    n, n_rel, k, b = 24, 4, 8, 32
    ent = rng.normal(size=(n, k)).astype(np.float32) * 0.3
    rel = rng.normal(size=(n_rel, k)).astype(np.float32) * 0.3
    for tab in (ent, rel):
        norm = np.linalg.norm(tab, axis=1, keepdims=True)
        np.divide(tab, norm, out=tab, where=norm > 1)
    l1 = distance == Distance.L1
    oracle = TransEOracle(ent, rel, 0.05, 1.0, l1=l1)
    params = {"entity": torch.from_numpy(ent), "relation": torch.from_numpy(rel)}
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=0.05, margin=1.0, distance=distance, update_mode="parity")
    for _ in range(3):
        ph, pt, r = rng.integers(0, n, b), rng.integers(0, n, b), rng.integers(0, n_rel, b)
        corrupt_tail, j = rng.random(b) < 0.5, rng.integers(0, n, b)
        nh, nt = np.where(corrupt_tail, ph, j), np.where(corrupt_tail, j, pt)
        arrays = tuple(a.astype(np.int32) for a in (ph, pt, r, nh, nt)) + (np.ones(b, bool),)
        params, loss = get_model("transe").sequential_update(params, _torch_batch(arrays), cfg)
        oloss = oracle.run_batch(zip(ph, pt, r, nh, nt))
        np.testing.assert_allclose(params["entity"].numpy(), oracle.ent, atol=3e-5)
        np.testing.assert_allclose(params["relation"].numpy(), oracle.rel, atol=3e-5)
        assert float(loss) == pytest.approx(float(oloss), rel=1e-5)


def test_update_kernel_builds_through_the_shared_nvcc_helper(tmp_path, monkeypatch):
    # A stand-in nvcc that writes the file after -o: each kernel gets its own
    # library, named after its source, and a wrapper off the CPU and CUDA raises.
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    (bin_dir / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(transe_update, "BUILD_DIR", tmp_path / "kernels")
    so = transe_update.build()
    assert so.parent == tmp_path / "kernels" and so.name.startswith("transe_update_") and so.suffix == ".so"
    assert so.read_text() == "built\n"
    t = [torch.zeros(4, 8, device="meta"), torch.zeros(2, 8, device="meta")]
    t += [torch.zeros(3, dtype=torch.int32, device="meta")] * 5 + [torch.ones(3, dtype=torch.bool, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        transe_update.transe_sequential_update(*t, learning_rate=0.1, margin=1.0, l1=True)


def test_parity_all_invalid_batch_changes_nothing():
    ent, rel = _tables(9, 16)
    arrays = _batch_arrays(9, 32, self_loops=True)[:5] + (np.zeros(32, bool),)
    t = [torch.from_numpy(a) for a in (ent, rel, *arrays)]
    got_ent, got_rel, loss, viol = transe_update.transe_sequential_update(*t, learning_rate=0.05, margin=1.0, l1=True)
    assert torch.equal(got_ent, t[0]) and torch.equal(got_rel, t[1]) and float(loss) == 0.0
    assert not viol.any()


def test_parity_mode_moves_bf16_tables_to_float32():
    ent, rel = _tables(10, 8)
    cfg = EmbeddingConfig(embedding_size=8, learning_rate=0.05, update_mode="parity", param_dtype="bfloat16")
    params = {"entity": torch.from_numpy(ent).bfloat16(), "relation": torch.from_numpy(rel).bfloat16()}
    out, _ = get_model("transe").sequential_update(params, _torch_batch(_batch_arrays(1, 16)), cfg)
    assert out["entity"].dtype == out["relation"].dtype == torch.float32
    with pytest.raises(ValueError, match="parity_impl"):
        get_model("transe").sequential_update(params, _torch_batch(_batch_arrays(1, 16)), cfg.replace(parity_impl="x"))
    # Off the CPU 'scan' is refused, not run as the per-sample plain loop.
    meta = {key: v.to("meta") for key, v in params.items()}
    meta_batch = {key: v.to("meta") for key, v in _torch_batch(_batch_arrays(1, 16)).items()}
    with pytest.raises(ValueError, match="parity_impl='scan'"):
        get_model("transe").sequential_update(meta, meta_batch, cfg.replace(parity_impl="scan"))


# --- epoch runner -------------------------------------------------------------


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_epoch_runner_on_injected_batches_equals_a_jax_scan(distance):
    # Five batches of 24 through the port's runner (its fused table) and
    # through TransE.batch_update batch by batch, and through a lax.scan of
    # kb2e_tpu's fused_table_update: the same atol 1e-5.
    k, n_batches, rows = 12, 5, 24
    ent, rel = _tables(12, k)
    per = [_batch_arrays(20 + i, rows) for i in range(n_batches)]
    stacked = tuple(np.stack([p[j] for p in per]) for j in range(6))
    jcfg, cfg = _cfgs(distance, k)
    jm = jax_get_model("transe")
    table, losses = jax.lax.scan(
        lambda tbl, b: jm.fused_table_update(tbl, N_ENT, b, jcfg),
        jm.fuse_params({"entity": jnp.asarray(ent), "relation": jnp.asarray(rel)}), _jax_batch(stacked),
    )
    want = jm.unfuse_params(table, N_ENT)
    params, feed = {"entity": torch.from_numpy(ent), "relation": torch.from_numpy(rel)}, _torch_batch(stacked)
    runner = step_lib.EpochRunner(get_model("transe"), cfg, rows, n_batches)
    by_batch = _batch_by_batch(get_model("transe"), params, feed, cfg)
    for got, loss in (runner.apply(params, feed, N_ENT), by_batch):
        for key in ("entity", "relation"):
            _close(got[key], want[key])
        assert float(loss) == pytest.approx(float(losses.sum()), rel=1e-5)


def test_epoch_runner_samples_whole_epochs(tiny_dataset):
    from kb2e_tpu_torch.data import triples

    ts = triples.TripleSet.from_arrays(
        tiny_dataset.train.heads, tiny_dataset.train.tails, tiny_dataset.train.rels,
        tiny_dataset.n_entities, tiny_dataset.n_relations,
    )
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    cfg = EmbeddingConfig(embedding_size=8, num_negatives=2)
    runner = step_lib.EpochRunner(get_model("transe"), cfg, 30, 4)
    batches = runner.sample(torch.Generator().manual_seed(0), data)
    assert all(v.shape == (4, 60) for v in batches.values())


def _batch_by_batch(model, params, feed, cfg):
    """``model.batch_update`` over the feed's [n, rows] batches in turn."""
    losses = []
    for i in range(feed["ph"].shape[0]):
        params, loss = model.batch_update(params, {key: v[i] for key, v in feed.items()}, cfg)
        losses.append(loss)
    return params, torch.stack(losses).sum()


@pytest.mark.parametrize("n_batches", [1, 3])
@pytest.mark.parametrize("name", ["transe", "transh", "transr", "ctransr", "ptranse"])
def test_the_one_device_loop_equals_batch_update_batch_by_batch(tiny_kg_dir, name, n_batches):
    # The runner's own feed (a chunked model's: its chunks) through its
    # one-device loop, and through the model's batch_update a batch (a
    # chunk) at a time: the same float32 tables and loss, bit for bit.
    from kb2e_tpu_torch.data import paths, triples

    ts, model = triples.load_dataset(tiny_kg_dir).train, get_model(name)
    store = (paths.build_path_store(ts.heads, ts.tails, ts.rels, ts.n_relations, max_paths=4, use_native=False)
             if model.uses_paths else None)
    data = step_lib.DeviceData.from_triple_set(ts, "cpu", path_store=store)
    cfg = EmbeddingConfig(embedding_size=8, learning_rate=0.05, num_batches=n_batches)
    runner = step_lib.EpochRunner(model, cfg, step_lib.batch_size_for(ts.num_triples, n_batches), n_batches)
    feed = runner.sample(torch.Generator().manual_seed(n_batches), data)
    params = model.init_params(torch.Generator().manual_seed(4), ts.n_entities, ts.n_relations, cfg, "cpu")
    if model.cluster_aware:
        params["centers"] = torch.randn(params["centers"].shape, generator=torch.Generator().manual_seed(5)) / 4
    got, loss = runner.apply(params, feed, ts.n_entities)
    want, want_loss = _batch_by_batch(model, params, feed, cfg)
    assert sorted(got) == sorted(params)
    for key in params:
        assert got[key].dtype == torch.float32 and torch.equal(got[key], want[key]), key
    assert torch.equal(loss, want_loss) and float(loss) > 0


def _runner_case(name, mesh=None):
    """A runner of ``name`` over batches of 16 rows (TransR's: chunks of
    16), its CPU tables and an injected feed of three of them."""
    model, rows = get_model(name), 16
    cfg = EmbeddingConfig(embedding_size=8, learning_rate=0.05)
    params = model.init_params(torch.Generator().manual_seed(3), N_ENT, N_REL, cfg, "cpu")
    per = [_batch_arrays(40 + i, rows) for i in range(3)]
    feed = _torch_batch(tuple(np.stack([p[j] for p in per]) for j in range(6)))
    return step_lib.EpochRunner(model, cfg, rows, 3, mesh=mesh), params, feed


@pytest.mark.parametrize("name", ["transe", "transr", "ctransr"])
def test_epoch_runner_apply_writes_none_of_its_inputs(name):
    runner, params, feed = _runner_case(name)
    before = {key: v.clone() for key, v in {**params, **feed}.items()}
    out, _ = runner.apply(params, feed, N_ENT)
    assert all(torch.equal(v, before[key]) for key, v in {**params, **feed}.items())
    assert any(not torch.equal(out[key], params[key]) for key in params)


@pytest.mark.parametrize("name", ["transe", "transr"])
def test_two_apply_calls_return_tables_that_share_no_memory(name):
    runner, params, feed = _runner_case(name)
    first, _ = runner.apply(params, feed, N_ENT)
    kept = {key: v.clone() for key, v in first.items()}
    second, _ = runner.apply(params, feed, N_ENT)
    for key in params:
        assert torch.equal(second[key], first[key])  # the same inputs, the same update
        second[key].add_(1.0)
        assert torch.equal(first[key], kept[key])


@pytest.mark.parametrize("mesh", [False, True])
def test_a_cpu_runner_counts_its_chunks_and_replays_none(mesh):
    from torch.profiler import ProfilerActivity, profile

    from kb2e_tpu_torch.parallel import mesh as mesh_lib

    runner, params, feed = _runner_case("transr", mesh_lib.single_device_mesh("cpu") if mesh else None)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            runner.apply(params, feed, N_ENT)
            runner.apply(params, {key: v[:1] for key, v in feed.items()}, N_ENT)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert counters["train.chunks"] == 4 and counters["train.chunks_replayed"] == 0


def test_ctransr_runner_goes_through_its_own_batch_update(monkeypatch):
    # On the CPU the chunks run eagerly, as CTransR's batch_update runs
    # them: CTransR's own in-place chunk (three pair groups, the clusters)
    # once a chunk, never TransR's four-group one.
    from kb2e_tpu_torch.models import ctransr, transr

    runner, params, feed = _runner_case("ctransr")
    chunks = []
    chunk = ctransr.CTransR.chunk_update_

    def spy_chunk(self, fused, tables, n_entities, one, cfg):
        chunks.append((one["ph"].shape[0], sorted(tables)))
        return chunk(self, fused, tables, n_entities, one, cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("CTransR went through TransR's chunk body")

    monkeypatch.setattr(ctransr.CTransR, "chunk_update_", spy_chunk)
    monkeypatch.setattr(transr.TransR, "chunk_update_", refuse)
    out, loss = runner.apply(params, feed, N_ENT)
    assert chunks == [(16, ["centers", "proj", "relation_c"])] * 3
    assert sorted(out) == sorted(params) and out["centers"] is params["centers"]
    want, want_loss = _batch_by_batch(runner.model, params, feed, runner.cfg)
    assert len(chunks) == 6
    for key in params:
        assert torch.equal(out[key], want[key]), key
    assert torch.equal(loss, want_loss)


# --- loop and CLI -----------------------------------------------------------------


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def _train_argv(data_dir, out_dir, *extra):
    return ["--datadir", data_dir, "--outdir", out_dir, "--size", "16", "--rate", "0.02", "--method", "1",
            "--batches", "4", "--seed", "7", "--device", "cpu", *extra]


def _epoch_losses(out):
    return [float(line.split("Loss: ")[1]) for line in out.splitlines() if line.startswith("Epoch: ")]


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_train_transe_cli_trains_and_its_files_score_alike_in_both_evals(tiny_kg_dir, tiny_dataset, tmp_path, mode):
    out_dir, metrics = str(tmp_path / "out"), str(tmp_path / "m.jsonl")
    out, params = _run(train_transe.main, _train_argv(
        tiny_kg_dir, out_dir, "--epochs", "6", "--update-mode", mode, "--metrics-jsonl", metrics
    ))
    lines = out.splitlines()
    assert lines[0].startswith("Options: [datadir: ") and "epochs: 6" in lines[0] and "seed: 7]" in lines[0]
    assert lines[1:3] == ["Number of Relations: 8", "Number of Entities: 64"]
    losses = _epoch_losses(out)
    assert len(losses) == 6 and losses[-1] < 0.8 * losses[0]
    assert [line.split(",")[0] for line in lines[3:9]] == [f"Epoch: {i}" for i in range(6)]
    records = [json.loads(line) for line in open(metrics, encoding="utf-8")]
    assert [r["epoch"] for r in records] == list(range(6))
    assert {"loss", "wall_s", "triples_per_s", "batch_size", "ts"} <= set(records[0])
    assert records[0]["loss"] == pytest.approx(losses[0], rel=1e-6)
    assert records[0]["batch_size"] == tiny_dataset.train.num_triples // 4
    assert all(v.dtype == torch.float32 for v in params.values())

    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "16", "--method", "1",
              "--eval-batch", "64", "--eval-block", "32"]
    want = [line for line in _run(jax_eval_transe.main, common)[0].splitlines() if "-- " in line]
    got = [line for line in _run(eval_transe.main, common + ["--device", "cpu"])[0].splitlines() if "-- " in line]
    assert len(want) == 4 and got == want


def test_checkpoint_resume_equals_an_uninterrupted_run(tiny_kg_dir, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    for mode in ("fast", "parity"):
        _, whole = _run(train_transe.main, _train_argv(tiny_kg_dir, str(tmp_path / "a"), "--epochs", "4",
                                                       "--update-mode", mode))
        first, _ = _run(train_transe.main, _train_argv(
            tiny_kg_dir, str(tmp_path / "b"), "--epochs", "2", "--update-mode", mode,
            "--checkpoint-dir", ckpt + mode, "--checkpoint-every", "2",
        ))
        assert checkpoint.latest_in(ckpt + mode).endswith("ckpt_2")
        out, resumed = _run(train_transe.main, _train_argv(
            tiny_kg_dir, str(tmp_path / "b"), "--epochs", "4", "--update-mode", mode,
            "--checkpoint-dir", ckpt + mode, "--resume",
        ))
        assert "Resumed from" in out and "at epoch 2" in out
        assert [line[:8] for line in out.splitlines() if line.startswith("Epoch")] == ["Epoch: 2", "Epoch: 3"]
        for key in ("entity", "relation"):
            assert torch.equal(resumed[key], whole[key]), (mode, key)


def test_checkpoint_round_trip_and_latest(tmp_path):
    params = {"entity": torch.arange(6.0).reshape(2, 3), "relation": torch.ones(1, 3)}
    gen = torch.Generator().manual_seed(3)
    for step in (2, 10, 4):
        checkpoint.save(str(tmp_path / f"ckpt_{step}"), params, step=step, extra={"generator_state": gen.get_state()})
    (tmp_path / "ckpt_x").write_text("not a checkpoint")
    latest = checkpoint.latest_in(str(tmp_path))
    assert latest.endswith("ckpt_10")
    got, step, meta = checkpoint.restore(latest)
    assert step == 10 and all(torch.equal(got[k], v) for k, v in params.items())
    assert torch.equal(meta["generator_state"], gen.get_state())
    assert checkpoint.latest_in(str(tmp_path / "none")) is None


def test_eval_every_runs_the_port_eval_inside_training(tiny_kg_dir, tmp_path):
    # The records fan out to the JSONL file and to TensorBoard.
    metrics, tb = str(tmp_path / "m.jsonl"), tmp_path / "tb"
    out, _ = _run(train_transe.main, _train_argv(tiny_kg_dir, str(tmp_path / "o"), "--epochs", "2",
                                                 "--eval-every", "1", "--eval-batch", "64",
                                                 "--metrics-jsonl", metrics, "--tensorboard-dir", str(tb)))
    assert out.count("[valid @ epoch") == 2
    valid = [json.loads(line) for line in open(metrics, encoding="utf-8") if "valid_filtered_hits10" in line]
    assert [r["epoch"] for r in valid] == [0, 1]
    assert list(tb.glob("events.out.tfevents.*"))


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    with profiling.capture_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    with profiling.capture_trace(None):
        pass


def test_training_without_cuda_raises_unless_the_cpu_is_asked_for(tiny_kg_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "4", "--epochs", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_transe.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(argv + ["--model", "ptranse"])
