"""kb2e_tpu_torch's TransR against kb2e_tpu's.

The same numpy-seeded tables and injected batches go through both packages:
the ball projector ``transRNorm`` (exact-sequential), the energy and the eval
projection, the chunk-sequential fast update (``batch_update``) and the
chunked epoch runner, the parity update, whose plain version (the CPU side
of the CUDA kernel K5) is held against JAX's scan path, JAX's Pallas kernel
in interpret mode and the NumPy oracle, and the TransE warm start.  Then the
projected eval, and the CLI trains and scores on ``tiny_kg_dir`` on the CPU.

Tolerances: float32 tables atol 1e-5 and losses rel 1e-5, as
tests/test_pallas_update.py holds the Pallas kernel to the scan path (sums
over k and over the batch are taken in another order).  The eval metrics are
exact on dyadic tables, where every product and sum of the projection and
the energies is exact in float32.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu.cli import eval_transr as jax_eval_transr
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.constants import Method as JMethod
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.io import text as jax_text
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu.models import transr as jax_transr
from kb2e_tpu.models.base import Batch as JBatch
from kb2e_tpu.ops import pallas_update as jax_pallas_update
from kb2e_tpu.ops import projections as jax_projections
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval as eval_cli
from kb2e_tpu_torch.cli import eval_transr, train_transr
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.convert import params_from_numpy, params_to_numpy
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.ops import cuda_build, transr_update
from kb2e_tpu_torch.train import step as step_lib

import oracle

torch.set_num_threads(1)

N_ENT, N_REL = 40, 6
KEYS = ("entity", "relation", "proj")
IDX_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")


def _tables(seed, k, n=N_ENT, n_rel=N_REL, noise=0.15):
    """Unit-sphere entity and relation rows and W = I + noise: the warm-start
    regime, with enough noise that the ball projector fires."""
    rng = np.random.default_rng(seed)
    ent, rel = rng.normal(size=(n, k)), rng.normal(size=(n_rel, k))
    ent /= np.linalg.norm(ent, axis=1, keepdims=True)
    rel /= np.linalg.norm(rel, axis=1, keepdims=True)
    w = np.eye(k) + rng.normal(size=(n_rel, k, k)) * noise
    return ent.astype(np.float32), rel.astype(np.float32), w.astype(np.float32)


def _batch_arrays(seed, b, n=N_ENT, n_rel=N_REL, self_loops=False, k_neg=1):
    """ph pt r nh nt valid; with ``k_neg`` > 1 the positives repeat sample-major."""
    rng = np.random.default_rng(seed)
    ph, pt = (np.repeat(rng.integers(0, n, b // k_neg), k_neg).astype(np.int32) for _ in range(2))
    r = np.repeat(rng.integers(0, n_rel, b // k_neg), k_neg).astype(np.int32)
    if self_loops:
        pt[: b // 4] = ph[: b // 4]
    # Corrupt one side, as the sampler does: nh == ph or nt == pt.
    nh, nt = ph.copy(), pt.copy()
    side = rng.random(b) < 0.5
    nh[side] = rng.integers(0, n, int(side.sum()))
    nt[~side] = rng.integers(0, n, int((~side).sum()))
    if self_loops:
        nt[b // 4 : b // 2] = nh[b // 4 : b // 2]
    valid = rng.random(b) > 0.1
    return ph, pt, r, nh, nt, valid


def _jax_batch(arrays):
    return JBatch(zip(IDX_KEYS, (jnp.asarray(a) for a in arrays)))


def _torch_batch(arrays):
    return dict(zip(IDX_KEYS, (torch.from_numpy(a) for a in arrays)))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _cfgs(k, **kw):
    common = dict(embedding_size=k, learning_rate=0.05, margin=1.0, **kw)
    return JConfig(**common), EmbeddingConfig(**common)


def _host(ent, rel, w):
    return {"entity": ent, "relation": rel, "proj": w}


# --- init and the ball projector ------------------------------------------------


def test_init_params_ball_norm_the_rows_and_start_w_at_identity():
    cfg = EmbeddingConfig(embedding_size=8)
    params = get_model("transr").init_params(torch.Generator().manual_seed(3), 50, 7, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {"entity": (50, 8), "relation": (7, 8),
                                                              "proj": (7, 8, 8)}
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in params.values())
    for key in ("entity", "relation"):
        assert float(params[key].norm(dim=1).max()) <= 1.0 + 1e-6
    assert torch.equal(params["proj"], torch.eye(8).expand(7, 8, 8))
    jparams = jax_get_model("transr").init_params(jax.random.PRNGKey(0), 50, 7, JConfig(embedding_size=8))
    np.testing.assert_array_equal(np.asarray(jparams["proj"]), params["proj"].numpy())


def _ball_rows(seed, k=12, n=24):
    """Unit rows a and row-normed W near identity: ‖a·W‖² spreads around 1,
    so some rows start inside the ball and some fire for several trips."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, k))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    a[: n // 3] *= 0.8  # inside the ball at once
    a[2 * n // 3 :] *= 1.6  # far outside: run to the cap
    w = np.eye(k) + rng.normal(size=(n, k, k)) * 0.2
    w /= np.linalg.norm(w, axis=2, keepdims=True)
    return a.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("max_iters", [1, 2, 16])
@pytest.mark.parametrize("k", [12, 33])  # within one warp; a ragged last warp
def test_transr_ball_project_equals_jax_exact_sequential_and_the_oracle(max_iters, k):
    n = 12
    a, w = _ball_rows(max_iters + k, k=k, n=n)
    w_in = w.copy()
    lr = 0.01  # a trip shrinks ‖a·W‖² by about 8 lr: the far rows take about a dozen
    ja, jw = jax.vmap(
        lambda x, y: jax_projections.transr_ball_project(x, y, lr, max_iters, exact_sequential=True)
    )(jnp.asarray(a), jnp.asarray(w))

    def run(cap):
        out = [transr_update.transr_ball_project(torch.from_numpy(a[i]), torch.from_numpy(w[i]), lr, cap)
               for i in range(n)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]), np.array([o[2] for o in out])

    ta, tw, fired = run(max_iters)
    assert np.array_equal(w, w_in)  # the input matrix is not written
    _close(ta, ja)
    _close(tw, jw)
    oa, ow = zip(*(oracle.transr_ball_project(a[i], w[i], lr, max_iters) for i in range(n)))
    _close(ta, np.stack(oa))
    _close(tw, np.stack(ow))
    n2 = np.sum(np.einsum("bj,bji->bi", a, w) ** 2, axis=1)
    # Rows inside the ball fire no trip and are left alone; the others moved.
    assert (fired[n2 <= 1] == 0).all() and (fired[n2 > 1] > 0).all()
    assert np.array_equal(ta.numpy()[n2 <= 1], a[n2 <= 1]) and np.array_equal(tw.numpy()[n2 <= 1], w[n2 <= 1])
    assert not np.allclose(ta.numpy()[n2 > 1], a[n2 > 1])
    # Caps of 1 and 2 stop some far rows short of where a far higher cap ends.
    _, _, uncapped = run(10_000)
    np.testing.assert_array_equal(fired, np.minimum(uncapped, max_iters))
    assert (uncapped > max_iters).any() == (max_iters < 16)


def test_energy_and_eval_projection_equal_jax():
    k = 12
    ent, rel, w = _tables(1, k)
    rng = np.random.default_rng(2)
    h, t, r = (rng.integers(0, n, 25) for n in (N_ENT, N_ENT, N_REL))
    jparams = {key: jnp.asarray(v) for key, v in _host(ent, rel, w).items()}
    params = params_from_numpy(_host(ent, rel, w), "cpu")
    jm, m = jax_get_model("transr"), get_model("transr")
    assert m.uses_distance_flag and m.needs_projection and m.chunk_size == jm.chunk_size == 256
    for d in (Distance.L1, Distance.L2):
        got = m.energy(params, *(torch.from_numpy(x) for x in (h, t, r)), d)
        want = jm.energy(jparams, jnp.asarray(h), jnp.asarray(t), jnp.asarray(r), JDistance(int(d)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for rel_id in (0, 5):
        _close(m.project_entities(params, rel_id), jm.project_entities(jparams, rel_id), atol=1e-6)


def test_models_declare_their_weights_table_chunk_and_warm_start():
    # What the CLI and the epoch runner read off the model, for every ported model.
    names = ("transe", "transh", "transr")
    got = {name: (get_model(name).weights_key, get_model(name).weights_shape(5, 3), get_model(name).chunk_size,
                  get_model(name).has_warm_start) for name in names}
    assert got == {"transe": (None, None, None, False), "transh": ("norm", (5, 3), None, False),
                   "transr": ("proj", (5, 3, 3), 256, True)}
    with pytest.raises(NotImplementedError, match="no warm start"):
        get_model("transh").warm_start_params({}, None, None)


def test_jax_transr_params_carry_across_unchanged():
    # kb2e_tpu's TransR params (entity, relation, proj) as the port's, through
    # params_to_numpy / params_from_numpy with no renaming.
    jparams = jax_get_model("transr").init_params(jax.random.PRNGKey(0), 30, 5, JConfig(embedding_size=8))
    params = params_from_numpy({k: np.array(v) for k, v in jparams.items()}, "cpu")
    assert set(params) == set(KEYS) and params["proj"].shape == (5, 8, 8)
    back = params_to_numpy(params)
    for key in KEYS:
        np.testing.assert_array_equal(back[key], np.asarray(jparams[key]))
    h = t = r = np.arange(5)
    got = get_model("transr").energy(params, *(torch.from_numpy(x) for x in (h, t + 3, r)), Distance.L2)
    want = jax_get_model("transr").energy(jparams, jnp.asarray(h), jnp.asarray(t + 3), jnp.asarray(r), JDistance.L2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_warm_start_equals_jax():
    k = 8
    ent, rel, w = _tables(3, k)
    rng = np.random.default_rng(4)
    seed_e, seed_r = rng.normal(size=(N_ENT, k)) * 0.3, rng.normal(size=(N_REL, k)) * 0.3
    jparams = {key: jnp.asarray(v) for key, v in _host(ent, rel, w).items()}
    want = jax_transr.warm_start_params(jparams, seed_e, seed_r)
    got = get_model("transr").warm_start_params(params_from_numpy(_host(ent, rel, w), "cpu"), seed_e, seed_r)
    for key in KEYS:
        assert got[key].dtype == torch.float32
        _close(got[key], want[key], atol=1e-6)
    np.testing.assert_allclose(got["entity"].norm(dim=1).numpy(), 1.0, atol=1e-6)
    assert torch.equal(got["proj"], torch.from_numpy(w))


# --- fast update ----------------------------------------------------------------


@pytest.mark.parametrize("b,chunk_size", [(48, 256), (48, 16), (40, 16)])  # one chunk, three, a padded last
@pytest.mark.parametrize("k_neg", [1, 4])
@pytest.mark.parametrize("scatter_mode", ["direct", "dedup"])
def test_batch_update_equals_jax(b, chunk_size, k_neg, scatter_mode, monkeypatch):
    k = 8
    jm, m = jax_get_model("transr"), get_model("transr")
    monkeypatch.setattr(jm, "chunk_size", chunk_size)
    monkeypatch.setattr(m, "chunk_size", chunk_size)
    ent, rel, w = _tables(5, k)
    arrays = _batch_arrays(6 + k_neg + b, b, k_neg=k_neg)
    for distance in (Distance.L1, Distance.L2):
        jcfg, cfg = _cfgs(k, scatter_mode=scatter_mode, num_negatives=k_neg, distance=int(distance))
        jparams = {key: jnp.asarray(v) for key, v in _host(ent, rel, w).items()}
        tparams = params_from_numpy(_host(ent, rel, w), "cpu")
        want, want_loss = jm.batch_update(jparams, _jax_batch(arrays), jcfg)
        got, loss = m.batch_update(tparams, _torch_batch(arrays), cfg)
        for key in KEYS:
            _close(got[key], want[key])
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        assert 0 < float(loss)
        assert all(torch.equal(tparams[key], torch.from_numpy(v)) for key, v in zip(KEYS, (ent, rel, w)))


@pytest.mark.parametrize("b,chunk_size,k_neg", [(48, 256, 1), (40, 16, 1), (48, 16, 4)])
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("scatter_mode", ["direct", "dedup"])
def test_in_place_chunks_on_dyadic_tables_equal_jax(b, chunk_size, k_neg, distance, scatter_mode, monkeypatch):
    # Dyadic tables and lr 1/16: every sum before the first sphere norm is
    # exact, so one chunk's loss (40 entities for 48 rows: duplicate rows)
    # equals JAX's to the last bit.  The roots of the norms and the sums
    # after them round in other orders in XLA and in torch: the tables of
    # one chunk, of three with a padded last, and of K = 4 stay within 1e-6
    # (at most 4.6e-7 measured), ten times tighter than the test above.
    k = 8
    jm, m = jax_get_model("transr"), get_model("transr")
    monkeypatch.setattr(jm, "chunk_size", chunk_size)
    monkeypatch.setattr(m, "chunk_size", chunk_size)
    host = _dyadic_transr(N_ENT, N_REL, k, seed=b + chunk_size + k_neg)
    arrays = _batch_arrays(30 + b + k_neg, b, k_neg=k_neg)
    knobs = dict(embedding_size=k, learning_rate=1 / 16, margin=1.0, num_negatives=k_neg, distance=int(distance),
                 scatter_mode=scatter_mode)
    want, want_loss = jm.batch_update({key: jnp.asarray(v) for key, v in host.items()}, _jax_batch(arrays),
                                      JConfig(**knobs))
    tparams = params_from_numpy(host, "cpu")
    got, loss = m.batch_update(tparams, _torch_batch(arrays), EmbeddingConfig(**knobs))
    for key in KEYS:
        _close(got[key], want[key], atol=1e-6)
        assert torch.equal(tparams[key], torch.from_numpy(host[key]))
    if chunk_size >= b:
        assert float(loss) == float(want_loss)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6) and float(loss) > 0


def test_chunked_epoch_runner_applies_the_chunks_in_order_as_jax(monkeypatch):
    # 3 batches of 20 rows in chunks of 16: 60 samples padded to 4 chunks.
    k, chunk = 8, 16
    jm, m = jax_get_model("transr"), get_model("transr")
    monkeypatch.setattr(jm, "chunk_size", chunk)
    monkeypatch.setattr(m, "chunk_size", chunk)
    ent, rel, w = _tables(7, k)
    jcfg, cfg = _cfgs(k)
    runner = step_lib.EpochRunner(m, cfg, 20, 3)
    assert runner.chunk == chunk
    arrays = _batch_arrays(8, 60)
    padded = [np.concatenate([a, np.zeros(4, a.dtype)]).reshape(4, chunk) for a in arrays]
    got, loss = runner.apply(params_from_numpy(_host(ent, rel, w), "cpu"),
                             dict(zip(IDX_KEYS, (torch.from_numpy(a) for a in padded))), N_ENT)
    jparams, losses = {key: jnp.asarray(v) for key, v in _host(ent, rel, w).items()}, []
    for i in range(4):
        jparams, jl = jm.batch_update(jparams, _jax_batch([a[i] for a in padded]), jcfg)
        losses.append(float(jl))
    for key in KEYS:
        _close(got[key], jparams[key])
    assert float(loss) == pytest.approx(sum(losses), rel=1e-5)
    # A runner never chunks coarser than the batch.
    assert step_lib.EpochRunner(get_model("transr"), cfg.replace(num_negatives=2), 5, 3).chunk == 10


def test_chunked_epoch_runner_samples_whole_chunks_with_invalid_padding(tiny_kg_dir):
    ts = triples.load_dataset(tiny_kg_dir).train
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    cfg = EmbeddingConfig(embedding_size=8, num_batches=3)
    batch_size = step_lib.batch_size_for(ts.num_triples, 3)
    runner = step_lib.EpochRunner(get_model("transr"), cfg, batch_size, 3)
    batches = runner.sample(torch.Generator().manual_seed(0), data)
    total, chunk = 3 * batch_size, min(256, batch_size)
    n_chunks = -(-total // chunk)
    assert all(tuple(v.shape) == (n_chunks, chunk) for v in batches.values())
    flat = {key: v.reshape(-1) for key, v in batches.items()}
    assert not flat["valid"][total:].any() and all(not flat[key][total:].any() for key in IDX_KEYS[:5])
    params, loss = runner(get_model("transr").init_params(torch.Generator().manual_seed(1), ts.n_entities,
                                                          ts.n_relations, cfg, "cpu"),
                          torch.Generator().manual_seed(2), data)
    assert np.isfinite(float(loss)) and float(loss) > 0


# --- parity update (K5's plain version) ---------------------------------------


@pytest.mark.parametrize("l1", [True, False])
@pytest.mark.parametrize("self_loops", [False, True])
def test_parity_plain_version_equals_jax_scan_pallas_kernel_and_oracle(l1, self_loops):
    # Two batches of 24 at k = 8, lr 0.05, W = I + noise (so the projector
    # fires); with self_loops a quarter of the positives have h == t and the
    # next quarter of the corrupted triples h' == t'.  Each batch starts every
    # implementation from the port's tables after the batch before.
    k, lr, cap = 8, 0.05, 16
    ent, rel, w = _tables(11 + self_loops + 2 * l1, k)
    jcfg, cfg = _cfgs(k, update_mode="parity", parity_impl="scan", distance=0 if l1 else 1)
    params = params_from_numpy(_host(ent, rel, w), "cpu")
    for step in range(2):
        arrays = _batch_arrays(20 + step, 24, self_loops=self_loops)
        host = params_to_numpy(params)
        jparams = {key: jnp.asarray(v) for key, v in host.items()}
        scan, scan_loss = jax_get_model("transr").sequential_update(jparams, _jax_batch(arrays), jcfg)
        jb = _jax_batch(arrays)
        kern = jax_pallas_update.transr_sequential_update(
            *(jparams[key] for key in KEYS), *(jb[key] for key in IDX_KEYS),
            learning_rate=lr, margin=1.0, l1=l1, max_iters=cap, interpret=True,
        )
        orc = oracle.TransROracle(host["entity"], host["relation"], host["proj"], lr, 1.0, l1=l1, max_iters=cap)
        orc_loss = orc.run_batch(zip(*(a[arrays[5]] for a in arrays[:5])))

        got = transr_update.transr_sequential_update_reference(
            *(params[key] for key in KEYS), *(torch.from_numpy(a) for a in arrays),
            learning_rate=lr, margin=1.0, l1=l1, max_iters=cap,
        )
        assert 0 < int(got[4].sum()) < 24 and int(got[5][:, 0].sum()) > 0
        assert not got[4][~torch.from_numpy(arrays[5])].any() and not got[5][~got[4]].any()
        refs = (
            ((scan[key] for key in KEYS), scan_loss),
            (kern[:3], kern[3]),
            ((orc.ent, orc.rel, orc.w), orc_loss),
        )
        for tables, ref_loss in refs:
            for table, want in zip(got[:3], tables):
                _close(table, want)
            assert float(got[3]) == pytest.approx(float(ref_loss), rel=1e-5)
        params = dict(zip(KEYS, got[:3]))


def test_parity_update_goes_through_the_wrapper_under_every_impl():
    k = 6
    ent, rel, w = _tables(12, k)
    arrays = _batch_arrays(13, 16, self_loops=True)
    t = [torch.from_numpy(a) for a in (ent, rel, w, *arrays)]
    cuda_build.reset_launch_counts()
    via_wrapper = transr_update.transr_sequential_update(*t, learning_rate=0.05, margin=1.0, l1=False,
                                                         max_iters=16)
    assert sum(cuda_build.launch_counts.values()) == 0  # CPU tensors: the plain version
    params = dict(zip(KEYS, t[:3]))
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=0.05, margin=1.0, update_mode="parity", distance=1)
    for impl in ("auto", "pallas", "scan"):
        out, loss = get_model("transr").sequential_update(params, _torch_batch(arrays), cfg.replace(parity_impl=impl))
        assert all(torch.equal(out[key], table) for key, table in zip(KEYS, via_wrapper[:3]))
        assert float(loss) == float(via_wrapper[3])
    with pytest.raises(ValueError, match="parity_impl"):
        get_model("transr").sequential_update(params, _torch_batch(arrays), cfg.replace(parity_impl="x"))
    # Off the CPU 'scan' is refused, and a device without a kernel raises.
    meta = {key: v.to("meta") for key, v in params.items()}
    meta_batch = {key: v.to("meta") for key, v in _torch_batch(arrays).items()}
    with pytest.raises(ValueError, match="parity_impl='scan'"):
        get_model("transr").sequential_update(meta, meta_batch, cfg.replace(parity_impl="scan"))
    with pytest.raises(ValueError, match="no kernel"):
        get_model("transr").sequential_update(meta, meta_batch, cfg)


@pytest.mark.parametrize("l1", [True, False])
def test_parity_all_invalid_batch_changes_nothing(l1):
    ent, rel, w = _tables(14, 8)
    arrays = _batch_arrays(15, 24, self_loops=True)[:5] + (np.zeros(24, bool),)
    t = [torch.from_numpy(a) for a in (ent, rel, w, *arrays)]
    got = transr_update.transr_sequential_update(*t, learning_rate=0.05, margin=1.0, l1=l1, max_iters=16)
    assert all(torch.equal(g, x) for g, x in zip(got[:3], t[:3])) and float(got[3]) == 0.0
    assert not got[4].any() and not got[5].any()


def test_serial_sums_run_in_index_order():
    rng = np.random.default_rng(16)
    a = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 5, 5)).astype(np.float32))
    got = transr_update.row_times_matrix(a, w).numpy()
    for b in range(3):
        for i in range(5):
            acc = np.float32(0.0)
            for j in range(5):
                acc = np.float32(acc + np.float32(a[b, j] * w[b, j, i]))
            assert got[b, i] == acc


# --- eval -----------------------------------------------------------------------


def _dyadic_transr(n_ent, n_rel, k, seed):
    """Multiples of 1/8 in [-1, 1] for entities, relations and W: every
    product and sum of the projection and both energies is exact in float32,
    in any order."""
    rng = np.random.default_rng(seed)

    def dy(shape):
        return np.clip(np.round(rng.normal(size=shape) * 3) / 8, -1, 1).astype(np.float32)

    return {"entity": dy((n_ent, k)), "relation": dy((n_rel, k)), "proj": dy((n_rel, k, k))}


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_projected_eval_metrics_equal_jax_exactly(tiny_kg_dir, tiny_dataset, distance):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic_transr(dataset.n_entities, dataset.n_relations, 8, seed=3 + int(distance))
    knobs = dict(embedding_size=8, eval_batch_size=64, eval_block_size=24, distance=int(distance))
    want = jax_harness.evaluate(
        jax_get_model("transr"), {k: jnp.asarray(v) for k, v in host.items()}, tiny_dataset, JConfig(**knobs)
    )
    got = harness.evaluate(get_model("transr"), params_from_numpy(host, "cpu"), dataset, EmbeddingConfig(**knobs),
                           device="cpu")
    assert got == want  # every metric, MRR included, to the last bit
    assert got["num_corruptions"] == 2 * dataset.test[0].shape[0]
    assert got["filtered_mean_rank"] < got["raw_mean_rank"]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def _metric_lines(out: str):
    return [line for line in out.splitlines() if "-- " in line]


def test_eval_transr_cli_prints_jax_lines_on_jax_written_files(tiny_kg_dir, tmp_path):
    out_dir = str(tmp_path / "out")
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic_transr(dataset.n_entities, dataset.n_relations, 8, seed=9)
    jax_text.write_embeddings(out_dir, JMethod.BERN, host["entity"], host["relation"], weights=host["proj"],
                              model_name="transr")
    for distance in ("0", "1"):
        common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--method", "1",
                  "--distance", distance, "--eval-batch", "64", "--eval-block", "32"]
        want = _metric_lines(_run(jax_eval_transr.main, common)[0])
        got = _metric_lines(_run(eval_transr.main, common + ["--device", "cpu"])[0])
        assert len(want) == 4 and got == want
        # The unified entry point takes --model transr alike.
        assert _metric_lines(_run(eval_cli.main, common + ["--model", "transr", "--device", "cpu"])[0]) == want


# --- training through the CLI -------------------------------------------------------


def _write_transe_seed(seed_dir, dataset, k):
    rng = np.random.default_rng(17)
    ent = rng.normal(size=(dataset.n_entities, k)) * 0.3
    rel = rng.normal(size=(dataset.n_relations, k)) * 0.3
    jax_text.write_embeddings(seed_dir, JMethod.UNIF, ent, rel, model_name="transe")
    return jax_text.read_matrix(os.path.join(seed_dir, "entity2vec.unif"), *ent.shape), \
        jax_text.read_matrix(os.path.join(seed_dir, "relation2vec.unif"), *rel.shape)


@pytest.mark.parametrize("mode,epochs", [("fast", 5), ("parity", 2)])
def test_train_transr_cli_warm_starts_trains_and_its_files_score_alike_in_both_evals(tiny_kg_dir, tmp_path,
                                                                                       mode, epochs, capsys):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    seed_dir, out_dir, metrics = str(tmp_path / "seed"), str(tmp_path / "out"), str(tmp_path / "m.jsonl")
    seed_e, seed_r = _write_transe_seed(seed_dir, dataset, 8)
    out, params = _run(train_transr.main, [
        "--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--rate", "0.01", "--method", "1",
        "--batches", "4", "--seed", "7", "--device", "cpu", "--epochs", str(epochs), "--update-mode", mode,
        "--seeddatadir", seed_dir, "--seedmethod", "0", "--metrics-jsonl", metrics,
    ])
    assert "Warning: seed files not found" not in capsys.readouterr().err
    losses = [float(line.split("Loss: ")[1]) for line in out.splitlines() if line.startswith("Epoch: ")]
    assert len(losses) == epochs and losses[-1] < losses[0]
    assert [json.loads(line)["epoch"] for line in open(metrics, encoding="utf-8")] == list(range(epochs))
    assert set(params) == set(KEYS) and all(v.dtype == torch.float32 for v in params.values())
    # Trained from the warm start: nearer the sphere-normed seed rows than the random init.
    seed_unit = seed_e / np.linalg.norm(seed_e, axis=1, keepdims=True)
    init = get_model("transr").init_params(torch.Generator().manual_seed(7 ^ 0x5EED), dataset.n_entities,
                                           dataset.n_relations, EmbeddingConfig(embedding_size=8), "cpu")
    trained = params["entity"].numpy()
    assert np.abs(trained - seed_unit).mean() < 0.5 * np.abs(trained - init["entity"].numpy()).mean()
    for name in ("entity2vec.bern", "relation2vec.bern", "weights.bern", "embedding_meta.json"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "embedding_meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["model"] == "transr" and meta["weights_shape"] == [8, 8, 8]

    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--method", "1",
              "--eval-batch", "64", "--eval-block", "32"]
    want = _metric_lines(_run(jax_eval_transr.main, common)[0])
    got = _metric_lines(_run(eval_transr.main, common + ["--device", "cpu"])[0])
    assert len(want) == 4 and got == want


def test_warm_start_without_seed_files_warns_and_starts_from_the_random_init(tiny_kg_dir, tmp_path, capsys):
    from kb2e_tpu_torch.cli import train as train_cli

    ts = triples.load_dataset(tiny_kg_dir).train
    cfg = EmbeddingConfig(embedding_size=8, seed=7, seed_data_dir=str(tmp_path / "none"))
    model = get_model("transr")
    params = train_cli._maybe_warm_start(model, cfg, ts, torch.device("cpu"))
    assert "Warning: seed files not found" in capsys.readouterr().err
    # The init tables of the warm-start generator (seed ^ 0x5EED).
    want = model.init_params(torch.Generator().manual_seed(7 ^ 0x5EED), ts.n_entities, ts.n_relations, cfg, "cpu")
    assert all(torch.equal(params[key], want[key]) for key in KEYS)
    # With the files: entities sphere-normed, relations as written, W identity.
    seed_e, seed_r = _write_transe_seed(str(tmp_path / "seed"), triples.load_dataset(tiny_kg_dir), 8)
    warm = train_cli._maybe_warm_start(model, cfg.replace(seed_data_dir=str(tmp_path / "seed"), seed_method=0),
                                       ts, torch.device("cpu"))
    assert capsys.readouterr().err == ""
    _close(warm["relation"], seed_r.astype(np.float32), atol=0)
    _close(warm["entity"], seed_e / np.linalg.norm(seed_e, axis=1, keepdims=True), atol=1e-6)
    assert torch.equal(warm["proj"], want["proj"])


def test_transr_entry_points_raise_without_cuda_unless_the_cpu_is_asked_for(tiny_kg_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "4", "--epochs", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_transr.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_transr.main(argv[:6])
