"""kb2e_tpu_torch's CTransR against kb2e_tpu's.

The same numpy-seeded tables and injected batches go through both packages:
the k-means centers (exact), the cluster assignment and the energy (exact on
dyadic tables), the chunk-sequential fast update, which is also CTransR's
parity mode, the cluster-routed rank sweep and the harness's CTransR metrics
(exact on dyadic tables), the TransE warm start with its centers, and the
CLI on ``tiny_kg_dir`` on the CPU.

Tolerances: float32 tables atol 1e-5 and losses rel 1e-5, as
tests/test_torch_transr.py holds TransR's fast update (sums over k and over
the batch are taken in another order).  Ranks and metrics are exact on
dyadic tables, where every product and sum of the projection, the routing
scores and both energies is exact in float32.
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

from kb2e_tpu.cli import eval_ctransr as jax_eval_ctransr
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.eval import ranking as jax_ranking
from kb2e_tpu.eval import ranking_cluster as jax_ranking_cluster
from kb2e_tpu.models import ctransr as jax_ctransr
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu.models.base import Batch as JBatch
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval as eval_cli
from kb2e_tpu_torch.cli import eval_ctransr, train_ctransr
from kb2e_tpu_torch.cli import train as train_cli
from kb2e_tpu_torch.constants import Distance, Method
from kb2e_tpu_torch.convert import params_from_numpy, params_to_numpy
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness, ranking_cluster
from kb2e_tpu_torch.io import text
from kb2e_tpu_torch.models import ctransr
from kb2e_tpu_torch.ops import cuda_build, transr_update
from kb2e_tpu_torch.train import loop

torch.set_num_threads(1)

N_ENT, N_REL, N_CLUSTERS = 40, 6, 4
KEYS = ("entity", "relation", "relation_c", "proj", "centers")
IDX_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")


def _tables(seed, k, n=N_ENT, n_rel=N_REL):
    """Unit entity and relation rows, W = I + noise, cluster vectors near
    their relation and centers spread like offsets: the warm-start regime,
    with enough noise that the ‖e·W‖ ≤ 1 step fires."""
    rng = np.random.default_rng(seed)
    ent, rel = rng.normal(size=(n, k)), rng.normal(size=(n_rel, k))
    ent /= np.linalg.norm(ent, axis=1, keepdims=True)
    rel /= np.linalg.norm(rel, axis=1, keepdims=True)
    return {
        "entity": ent, "relation": rel,
        "relation_c": rel[:, None, :] + rng.normal(size=(n_rel, N_CLUSTERS, k)) * 0.2,
        "proj": np.eye(k) + rng.normal(size=(n_rel, k, k)) * 0.15,
        "centers": rng.normal(size=(n_rel, N_CLUSTERS, k)) * 0.6,
    }


def _f32(host):
    return {key: np.asarray(v, np.float32) for key, v in host.items()}


def _dyadic(n_ent, n_rel, k, seed):
    """Multiples of 1/8 in [-1, 1] for every table: the projections, the
    routing scores and both energies are exact in float32, in any order."""
    rng = np.random.default_rng(seed)

    def dy(*shape):
        return np.clip(np.round(rng.normal(size=shape) * 3) / 8, -1, 1).astype(np.float32)

    return {"entity": dy(n_ent, k), "relation": dy(n_rel, k), "relation_c": dy(n_rel, N_CLUSTERS, k),
            "proj": dy(n_rel, k, k), "centers": dy(n_rel, N_CLUSTERS, k)}


def _batch_arrays(seed, b, n=N_ENT, n_rel=N_REL):
    rng = np.random.default_rng(seed)
    ph, pt = (rng.integers(0, n, b).astype(np.int32) for _ in range(2))
    r = rng.integers(0, n_rel, b).astype(np.int32)
    nh, nt = ph.copy(), pt.copy()
    side = rng.random(b) < 0.5
    nh[side] = rng.integers(0, n, int(side.sum()))
    nt[~side] = rng.integers(0, n, int((~side).sum()))
    return ph, pt, r, nh, nt, rng.random(b) > 0.1


def _jax(host):
    return {key: jnp.asarray(v) for key, v in host.items()}


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


# --- centers and assignment -------------------------------------------------------


def test_build_centers_equals_jax_exactly_with_degenerate_relations():
    rng = np.random.default_rng(0)
    n, n_rel, k = 30, 7, 6
    seed_e = rng.normal(size=(n, k)).astype(np.float32)
    # Relation 5 has 2 triples (fewer than the 4 clusters), relation 6 none.
    rels = np.concatenate([rng.integers(0, 5, 200), [5, 5]]).astype(np.int32)
    rng.shuffle(rels)
    heads, tails = (rng.integers(0, n, rels.shape[0]).astype(np.int32) for _ in range(2))
    for seed in (0, 13):
        got = ctransr.build_centers(seed_e, heads, tails, rels, n_rel, N_CLUSTERS, seed=seed)
        want = jax_ctransr.build_centers(seed_e, heads, tails, rels, n_rel, N_CLUSTERS, seed=seed)
        assert got.dtype == want.dtype == np.float32 and got.shape == (n_rel, N_CLUSTERS, k)
        np.testing.assert_array_equal(got, want)
    offsets_5 = seed_e[tails[rels == 5]] - seed_e[heads[rels == 5]]
    np.testing.assert_array_equal(got[5, 2], offsets_5.mean(0))  # the mean fills the missing centers
    assert not got[6].any()  # no offsets: zero centers
    np.testing.assert_array_equal(ctransr.assign_clusters(seed_e, got, heads, tails, rels),
                                  jax_ctransr.assign_clusters(seed_e, got, heads, tails, rels))


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_assignment_and_energy_equal_jax_on_dyadic_tables(distance):
    host = _dyadic(N_ENT, N_REL, 8, seed=1)
    rng = np.random.default_rng(2)
    h, t, r = (rng.integers(0, n, 60) for n in (N_ENT, N_ENT, N_REL))
    params, jparams = params_from_numpy(host, "cpu"), _jax(host)
    got = ctransr.assign_clusters_device(params["entity"], params["centers"][3], torch.from_numpy(h),
                                         torch.from_numpy(t))
    want = jax_ctransr.assign_clusters_device(jparams["entity"], jparams["centers"][3], jnp.asarray(h), jnp.asarray(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m, jm = get_model("ctransr"), jax_get_model("ctransr")
    got = m.energy(params, *(torch.from_numpy(x) for x in (h, t, r)), distance)
    want = jm.energy(jparams, jnp.asarray(h), jnp.asarray(t), jnp.asarray(r), JDistance(int(distance)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_model_declares_its_tables_chunk_warm_start_and_no_parity_mode():
    m = get_model("ctransr")
    assert (m.weights_key, m.weights_shape(5, 3), m.chunk_size, m.has_warm_start) == ("proj", (5, 3, 3), 256, True)
    assert m.cluster_aware and not m.has_parity_mode and m.needs_projection
    assert m.file_extras == {"relation_clusters": "relation_c", "cluster_centers": "centers"}
    assert (m.n_clusters, m.alpha) == (jax_get_model("ctransr").n_clusters, jax_get_model("ctransr").alpha)
    assert all(not get_model(name).cluster_aware and get_model(name).file_extras == {}
               for name in ("transe", "transh", "transr"))


def test_init_broadcasts_the_relation_table_and_jax_params_carry_across():
    cfg = EmbeddingConfig(embedding_size=8)
    params = get_model("ctransr").init_params(torch.Generator().manual_seed(3), 50, 7, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "entity": (50, 8), "relation": (7, 8), "proj": (7, 8, 8), "relation_c": (7, 4, 8), "centers": (7, 4, 8)}
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in params.values())
    assert torch.equal(params["relation_c"], params["relation"][:, None, :].expand(7, 4, 8))
    assert not params["centers"].any()
    # params_from_numpy / params_to_numpy already carry kb2e_tpu's CTransR
    # params (the five tables) across, names and bits unchanged.
    jparams = jax_get_model("ctransr").init_params(jax.random.PRNGKey(0), 30, 5, JConfig(embedding_size=8))
    got = params_from_numpy({k: np.array(v) for k, v in jparams.items()}, "cpu")
    assert set(got) == set(KEYS)
    back = params_to_numpy(got)
    for key in KEYS:
        np.testing.assert_array_equal(back[key], np.asarray(jparams[key]))


# --- the fast update (and parity mode) ------------------------------------------------


@pytest.mark.parametrize("b,chunk_size", [(48, 256), (48, 16), (40, 16)])  # one chunk, three, a padded last
@pytest.mark.parametrize("scatter_mode", ["direct", "dedup"])
def test_batch_update_equals_jax(b, chunk_size, scatter_mode, monkeypatch):
    k = 8
    jm, m = jax_get_model("ctransr"), get_model("ctransr")
    monkeypatch.setattr(jm, "chunk_size", chunk_size)
    monkeypatch.setattr(m, "chunk_size", chunk_size)
    host = _f32(_tables(5, k))
    arrays = _batch_arrays(6 + b, b)
    # Duplicate (relation, cluster) pairs inside a chunk: their cluster-vector
    # deltas must add up.
    pairs = arrays[2] * N_CLUSTERS + np.asarray(jax_ctransr.assign_clusters(
        host["entity"], host["centers"], arrays[0], arrays[1], arrays[2]))
    assert len(np.unique(pairs[:min(b, chunk_size)])) < min(b, chunk_size)
    for distance in (Distance.L1, Distance.L2):
        common = dict(embedding_size=k, learning_rate=0.05, margin=1.0, scatter_mode=scatter_mode,
                      distance=int(distance))
        want, want_loss = jm.batch_update(_jax(host), JBatch(zip(IDX_KEYS, map(jnp.asarray, arrays))), JConfig(**common))
        params = params_from_numpy(host, "cpu")
        got, loss = m.batch_update(params, dict(zip(IDX_KEYS, map(torch.from_numpy, arrays))), EmbeddingConfig(**common))
        for key in KEYS:
            _close(got[key], want[key])
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5) and float(loss) > 0
        assert all(torch.equal(params[key], torch.from_numpy(v)) for key, v in host.items())  # inputs untouched
        assert not torch.equal(got["relation_c"], params["relation_c"])


def _out_of_place_batch_update(m, params, batch, cfg):
    """CTransR's fast update as it was before its chunk ran in place on
    TransR's stages: a copy of every table a scatter, the chunks in order."""
    from kb2e_tpu_torch.models import base, transr
    from kb2e_tpu_torch.ops import distances, projections, scatter

    lr, dist = cfg.learning_rate, m.effective_distance(Distance.from_any(cfg.distance))
    chunk = min(m.chunk_size, batch["ph"].shape[0])
    chunks = base.pad_to_chunks({key: batch[key] for key in IDX_KEYS}, chunk)
    ent, rel, rel_c, proj, centers = (params[key] for key in KEYS)
    n_rel, n_clusters, k = rel_c.shape
    losses = []
    for phi, pti, ri, nhi, nti, vi in zip(*(chunks[key] for key in IDX_KEYS)):
        he, te, ne_h, ne_t = ent[phi], ent[pti], ent[nhi], ent[nti]
        flat = ri * n_clusters + ctransr._nearest(te - he, centers[ri])
        w = proj[ri]
        rv = rel_c.reshape(-1, k)[flat]
        res_pos = transr._project(te, w) - transr._project(he, w) - rv
        res_neg = transr._project(ne_t, w) - transr._project(ne_h, w) - rv
        e_pos = distances.residual_energy(res_pos, dist)
        e_neg = distances.residual_energy(res_neg, dist)
        viol = (e_pos + cfg.margin > e_neg) & vi
        losses.append(torch.sum(torch.where(viol, cfg.margin + e_pos - e_neg, 0.0)))
        m_ = viol.to(res_pos.dtype)[:, None]

        def xs(res):
            x = 2.0 * res
            if dist == Distance.L1:
                x = torch.where(x > 0, 1.0, -1.0)
            return x * m_

        x_pos, x_neg = xs(res_pos), xs(res_neg)
        wx_pos = torch.einsum("bji,bi->bj", w, x_pos)
        wx_neg = torch.einsum("bji,bi->bj", w, x_neg)
        idx = torch.cat([phi, pti, nhi, nti])
        d_w = lr * (torch.einsum("bj,bi->bji", he - te, x_pos) - torch.einsum("bj,bi->bji", ne_h - ne_t, x_neg))
        proj = scatter.scatter_add(proj, ri, d_w, cfg.scatter_mode)
        delta = torch.cat([lr * wx_pos, -lr * wx_pos, -lr * wx_neg, lr * wx_neg])
        ent = scatter.scatter_add(ent, idx, delta, cfg.scatter_mode)
        reg = 2.0 * m.alpha * (rv - rel[ri]) * m_
        rel_c = scatter.scatter_add(rel_c.reshape(-1, k), flat, lr * (x_pos - x_neg) - lr * reg)
        rel = scatter.scatter_add(rel, ri, lr * reg)
        e_rows, r_rows, c_rows = scatter.touched(idx), scatter.touched(ri), scatter.touched(flat)
        ent[e_rows] = projections.sphere_norm(ent[e_rows])
        rel[r_rows] = projections.ball_norm(rel[r_rows])
        rel_c[c_rows] = projections.sphere_norm(rel_c[c_rows])
        rel_c = rel_c.reshape(n_rel, n_clusters, k)
        proj[r_rows] = projections.sphere_norm(proj[r_rows])
        corrupted = torch.where(nhi != phi, nhi, nti)
        pair_e = torch.cat([phi, pti, corrupted])
        e3 = ent[pair_e].reshape(3, chunk, k)
        w_upd = proj[ri]
        p3 = torch.einsum("sbj,bji->sbi", e3, w_upd)
        act = (torch.sum(torch.square(p3), dim=-1, keepdim=True) > 1.0) & viol.repeat(3).reshape(3, chunk, 1)
        tmp3 = torch.where(act, 2.0 * p3, 0.0)
        d_w = -lr * torch.einsum("sbj,sbi->bji", e3, tmp3)
        proj = scatter.scatter_add(proj, ri, d_w, cfg.scatter_mode)
        e_new = e3 - lr * torch.einsum("bji,sbi->sbj", w_upd + d_w, tmp3)
        ent = scatter.scatter_add(ent, pair_e, (e_new - e3).reshape(3 * chunk, k), cfg.scatter_mode)
    out = {"entity": ent, "relation": rel, "relation_c": rel_c, "proj": proj, "centers": centers}
    return out, torch.stack(losses).sum()


@pytest.mark.parametrize("b", [48, 40])  # three whole chunks of 16; a padded last chunk
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_in_place_chunk_equals_the_out_of_place_body_bit_for_bit(b, distance, monkeypatch):
    m = get_model("ctransr")
    monkeypatch.setattr(m, "chunk_size", 16)
    host = _dyadic(N_ENT, N_REL, 8, seed=50 + int(distance))
    arrays = _batch_arrays(51 + b, b)
    batch = dict(zip(IDX_KEYS, map(torch.from_numpy, arrays)))
    cfg = EmbeddingConfig(embedding_size=8, learning_rate=1 / 16, margin=1.0, distance=int(distance))
    # Duplicate entity rows and (relation, cluster) pairs inside a chunk.
    assert len(np.unique(arrays[0][:16])) < 16 and len(np.unique(arrays[2][:16])) < 16
    got, loss = m.batch_update(params_from_numpy(host, "cpu"), batch, cfg)
    want, want_loss = _out_of_place_batch_update(m, params_from_numpy(host, "cpu"), batch, cfg)
    for key in KEYS:
        assert torch.equal(got[key], want[key]), key
        assert key == "centers" or not torch.equal(got[key], torch.from_numpy(host[key])), key
    assert torch.equal(loss, want_loss) and float(loss) > 0


def test_the_chunk_counts_each_valid_sample_at_its_cluster():
    m = get_model("ctransr")
    host = _f32(_tables(60, 8))
    arrays = _batch_arrays(61, 40)
    params = params_from_numpy(host, "cpu")
    tables = {"proj": params["proj"].clone(), "relation_c": params["relation_c"].clone(),
              "centers": params["centers"], "counts": m.chunk_counts(params)}
    assert tables["counts"].shape == (N_REL * N_CLUSTERS,) and tables["counts"].dtype == torch.int64
    fused = torch.cat([params["entity"], params["relation"]])
    m.chunk_update_(fused, tables, N_ENT, dict(zip(IDX_KEYS, map(torch.from_numpy, arrays))),
                    EmbeddingConfig(embedding_size=8, learning_rate=0.05))
    ph, pt, r, _, _, valid = arrays
    flat = r * N_CLUSTERS + ctransr.assign_clusters(host["entity"], host["centers"], ph, pt, r)
    want = np.bincount(flat[valid], minlength=N_REL * N_CLUSTERS)
    np.testing.assert_array_equal(tables["counts"].numpy(), want)
    read = m.read_chunk_counts(tables["counts"])
    assert int(read["ctransr.routed"]) == int(valid.sum())
    assert int(read["ctransr.routed_top"]) == int(want.reshape(N_REL, N_CLUSTERS).max(1).sum())
    assert m.chunk_counters == tuple(read)


def test_parity_mode_is_the_fast_update_and_never_reaches_a_kernel(monkeypatch, tiny_kg_dir):
    def refuse(*args, **kwargs):
        raise AssertionError("CTransR's parity mode reached TransR's sequential-update wrapper")

    monkeypatch.setattr(transr_update, "transr_sequential_update", refuse)
    host = _f32(_tables(9, 8))
    arrays = dict(zip(IDX_KEYS, map(torch.from_numpy, _batch_arrays(10, 40))))
    cfg = EmbeddingConfig(embedding_size=8, learning_rate=0.05, update_mode="parity")
    m = get_model("ctransr")
    cuda_build.reset_launch_counts()
    got, loss = m.sequential_update(params_from_numpy(host, "cpu"), arrays, cfg)
    want, want_loss = m.batch_update(params_from_numpy(host, "cpu"), arrays, cfg)
    assert all(torch.equal(got[key], want[key]) for key in KEYS) and torch.equal(loss, want_loss)
    # The loop warns with the JAX package's text, and trains; no kernel launch.
    ts = triples.load_dataset(tiny_kg_dir).train
    with pytest.warns(UserWarning, match="--update-mode parity has no effect for ctransr: no reference binary"):
        params = loop.train(m, cfg.replace(num_batches=4, max_epochs=1, seed=3), ts, device="cpu")
    assert set(params) == set(KEYS)
    assert not cuda_build.launch_counts


# --- the cluster-routed sweep and the harness -------------------------------------------


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_rank_queries_clustered_equals_jax_exactly(distance):
    n, k, b, block = 50, 8, 24, 16
    host = _dyadic(n, 1, k, seed=20 + int(distance))
    rng = np.random.default_rng(21)
    ent, vecs, centers = host["entity"], host["relation_c"][0], host["centers"][0]
    proj = ent @ host["proj"][0]  # dyadic: exact
    anchor = rng.integers(0, n, b)
    sign = rng.choice([-1.0, 1.0], b).astype(np.float32)
    true_idx = rng.integers(0, n, b).astype(np.int32)
    cands = np.where(rng.random((b, 8)) < 0.6, rng.integers(0, n, (b, 8)), -1).astype(np.int32)
    cands[:4, 0] = true_idx[:4]  # the true entity in its own list is never subtracted
    pad = lambda x: jax_ranking.pad_entities(jnp.asarray(x), block)  # noqa: E731 (JAX pads to whole blocks)
    want = jax_ranking_cluster.rank_queries_clustered(
        pad(proj), pad(ent), jnp.asarray(proj[anchor]), jnp.asarray(ent[anchor]), jnp.asarray(sign),
        jnp.asarray(vecs), jnp.asarray(centers), jnp.asarray(true_idx), jnp.asarray(cands), JDistance(int(distance)),
        block,
    )
    t = torch.from_numpy
    for u in (None, t(ent) @ t(centers).T):
        got = ranking_cluster.rank_queries_clustered(
            t(proj), t(ent), t(proj[anchor]), t(ent[anchor]), t(sign), t(vecs), t(centers), t(true_idx), t(cands),
            distance, block, u=u,
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[1]) < np.asarray(want[0])).any()


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("batch,block", [(64, 24), (16, 64)])  # groups of one batch or several; ragged blocks or one
def test_harness_ctransr_metrics_equal_jax_exactly(tiny_kg_dir, tiny_dataset, distance, batch, block):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic(dataset.n_entities, dataset.n_relations, 8, seed=30 + int(distance))
    knobs = dict(embedding_size=8, eval_batch_size=batch, eval_block_size=block, distance=int(distance))
    want = jax_harness.evaluate(jax_get_model("ctransr"), _jax(host), tiny_dataset, JConfig(**knobs))
    cuda_build.reset_launch_counts()
    raw, filt, sizes = harness.rank_all(get_model("ctransr"), params_from_numpy(host, "cpu"), dataset,
                                        EmbeddingConfig(**knobs), device="cpu")
    assert harness.metrics_from_ranks(raw, filt, sizes) == want  # every metric, MRR included, to the last bit
    # 8 relation groups of 18-30 queries: one batch each at 64, two at 16.
    groups = np.bincount(dataset.test[2]) * 2
    assert sizes == [min(batch, n - s) for n in groups for s in range(0, n, batch)]
    assert (len(sizes) > dataset.n_relations) == (batch < groups.max())
    assert want["filtered_mean_rank"] < want["raw_mean_rank"]


# --- warm start and CLI ------------------------------------------------------------------


def _write_transe_seed(seed_dir, dataset, k):
    rng = np.random.default_rng(17)
    ent = rng.normal(size=(dataset.n_entities, k)) * 0.3
    rel = rng.normal(size=(dataset.n_relations, k)) * 0.3
    text.write_embeddings(seed_dir, Method.UNIF, ent, rel, model_name="transe")
    return (text.read_matrix(os.path.join(seed_dir, "entity2vec.unif"), *ent.shape),
            text.read_matrix(os.path.join(seed_dir, "relation2vec.unif"), *rel.shape))


def test_warm_start_builds_jax_centers_and_keeps_relation_c_at_the_init_broadcast(tiny_kg_dir, tmp_path):
    ts = triples.load_dataset(tiny_kg_dir).train
    seed_e, seed_r = _write_transe_seed(str(tmp_path / "seed"), triples.load_dataset(tiny_kg_dir), 8)
    cfg = EmbeddingConfig(embedding_size=8, seed=7, seed_data_dir=str(tmp_path / "seed"), seed_method=0)
    m = get_model("ctransr")
    params = train_cli._maybe_warm_start(m, cfg, ts, torch.device("cpu"))
    init = m.init_params(torch.Generator().manual_seed(7 ^ 0x5EED), ts.n_entities, ts.n_relations, cfg, "cpu")
    # The JAX package's quirk, kept: relation_c is the random init's relation
    # table broadcast, not the TransE seed's.
    assert torch.equal(params["relation_c"], init["relation_c"])
    assert torch.equal(params["relation"], torch.from_numpy(seed_r.astype(np.float32)))
    want = jax_ctransr.build_centers(params["entity"].numpy(), ts.heads, ts.tails, ts.rels, ts.n_relations,
                                     N_CLUSTERS, seed=7)
    np.testing.assert_array_equal(params["centers"].numpy(), want)
    assert want.any()


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def _metric_lines(out: str):
    return [line for line in out.splitlines() if "-- " in line]


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_train_ctransr_then_eval_ctransr_on_the_cpu(tiny_kg_dir, tmp_path, mode):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    seed_dir, out_dir = str(tmp_path / "seed"), str(tmp_path / "out")
    _write_transe_seed(seed_dir, dataset, 8)
    argv = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--rate", "0.01", "--method", "1",
            "--batches", "4", "--epochs", "4", "--seed", "7", "--device", "cpu", "--update-mode", mode,
            "--seeddatadir", seed_dir, "--seedmethod", "0"]
    with contextlib.ExitStack() as stack:
        if mode == "parity":
            stack.enter_context(pytest.warns(UserWarning, match="has no effect for ctransr"))
        out, params = _run(train_ctransr.main, argv)
    losses = [float(line.split("Loss: ")[1]) for line in out.splitlines() if line.startswith("Epoch: ")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert set(params) == set(KEYS)
    for name in ("entity2vec.bern", "relation2vec.bern", "weights.bern", "relation_clusters.bern",
                 "cluster_centers.bern"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "embedding_meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["model"] == "ctransr" and meta["extras"] == {"relation_clusters": [8, 4, 8],
                                                             "cluster_centers": [8, 4, 8]}
    got, metrics = _run(eval_ctransr.main, ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8",
                                            "--method", "1", "--eval-batch", "64", "--device", "cpu"])
    assert len(_metric_lines(got)) == 4 and np.isfinite(metrics["filtered_mean_rank"])


def test_jax_eval_ctransr_prints_the_port_lines_on_port_written_dyadic_files(tiny_kg_dir, tmp_path):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic(dataset.n_entities, dataset.n_relations, 8, seed=40)
    out_dir = str(tmp_path / "out")
    # The port's writer, with the extras the port's train_ctransr writes.
    text.write_embeddings(out_dir, Method.BERN, host["entity"], host["relation"], weights=host["proj"],
                          model_name="ctransr",
                          extras={"relation_clusters": host["relation_c"], "cluster_centers": host["centers"]})
    for extra in (["--distance", "0"], ["--distance", "1"], ["--task", "relation"]):
        common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--method", "1",
                  "--eval-batch", "64", "--eval-block", "32", *extra]
        want = _metric_lines(_run(jax_eval_ctransr.main, common)[0])
        got = _metric_lines(_run(eval_ctransr.main, common + ["--device", "cpu"])[0])
        assert len(want) == (2 if "--task" in extra else 4) and got == want
        assert _metric_lines(_run(eval_cli.main, common + ["--model", "ctransr", "--device", "cpu"])[0]) == want


def test_ctransr_entry_points_raise_without_cuda_unless_the_cpu_is_asked_for(tiny_kg_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "4", "--epochs", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ctransr.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_ctransr.main(argv[:6])
