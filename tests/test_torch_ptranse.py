"""kb2e_tpu_torch's PTransE against kb2e_tpu's.

The same numpy-seeded tables and injected batches (ph, pt, r, nh, nt, valid,
paths, conf, nr, nr_valid: torch's generator never draws what threefry
draws) go through both packages: the path compositions, the update with its
autograd path loss, the warm start, the relation negatives, the epoch
runner's path data, entity eval and relation prediction with and without
path evidence, and the CLI on ``tiny_kg_dir`` on the CPU.

Tolerances: compositions allclose 1e-6 (ADD and MUL exact on dyadic
inputs); tables atol 1e-5 and losses rel 1e-5, as the other models' fast
updates are held (sums over k, P and the batch are taken in other orders).
On dyadic tables with exact zeros in comp(p) − r and an exact tie at the
path hinge the update must equal JAX's to the last bit: that pins the
gradient conventions at the kinks (|x|' = +1 at 0, the hinge's 0.5).
Ranks and metrics are exact on dyadic tables.
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

from kb2e_tpu.cli import eval_ptranse as jax_eval_ptranse
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Method as JMethod
from kb2e_tpu.data import paths as jax_paths
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.io import text as jax_text
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu.models import ptranse as jax_ptranse
from kb2e_tpu.models.base import Batch as JBatch
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval as eval_cli
from kb2e_tpu_torch.cli import eval_ptranse, train_ptranse
from kb2e_tpu_torch.cli import train as train_cli
from kb2e_tpu_torch.constants import Distance, Method
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import paths, triples
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.io import text
from kb2e_tpu_torch.models import ptranse
from kb2e_tpu_torch.ops import projections, rank_count, transe_update, transh_update, transr_update
from kb2e_tpu_torch.sampling import corruption
from kb2e_tpu_torch.train import loop, step
from kb2e_tpu_torch.utils import prng

torch.set_num_threads(1)

N_ENT, N_REL = 30, 5
KERNEL_MODULES = (rank_count, transe_update, transh_update, transr_update)
BATCH_KEYS = ("ph", "pt", "r", "nh", "nt", "valid", "paths", "conf", "nr", "nr_valid")


def _dy(rng, *shape, scale=3):
    """Multiples of 1/8 in [-1, 1], many of them 0."""
    return np.clip(np.round(rng.normal(size=shape) * scale) / 8, -1, 1).astype(np.float32)


def _tables(seed, k, comp, dyadic=False, n_ent=N_ENT, n_rel=N_REL):
    rng = np.random.default_rng(seed)
    if dyadic:
        host = {"entity": _dy(rng, n_ent, k), "relation": _dy(rng, n_rel, k), "relation_inv": _dy(rng, n_rel, k)}
    else:
        host = {name: (rng.normal(size=(n, k)) * 0.3).astype(np.float32)
                for name, n in (("entity", n_ent), ("relation", n_rel), ("relation_inv", n_rel))}
    if comp == "rnn":
        host["comp_w"] = (np.concatenate([np.eye(k), np.eye(k)]) * 0.5 + rng.normal(size=(2 * k, k)) * 0.1
                          ).astype(np.float32)
    return host


def _batch(seed, b, p=4, length=2, n_ent=N_ENT, n_rel=N_REL, conf=None):
    rng = np.random.default_rng(seed)
    ph, pt, nh, nt = (rng.integers(0, n_ent, b).astype(np.int32) for _ in range(4))
    r, nr = (rng.integers(0, n_rel, b).astype(np.int32) for _ in range(2))
    hops = rng.integers(0, 2 * n_rel, (b, p, length)).astype(np.int32)
    hops[rng.random((b, p, length)) < 0.2] = -1
    c = rng.random((b, p)).astype(np.float32) if conf is None else conf(rng, (b, p))
    c[rng.random((b, p)) < 0.3] = 0.0
    return dict(ph=ph, pt=pt, r=r, nh=nh, nt=nt, valid=rng.random(b) > 0.1, paths=hops, conf=c, nr=nr,
                nr_valid=rng.random(b) > 0.1)


def _jax(host):
    return {key: jnp.asarray(v) for key, v in host.items()}


def _torch(host):
    return {key: torch.from_numpy(np.asarray(v)) for key, v in host.items()}


def _update_both(host, arrays, **knobs):
    want, want_loss = jax_get_model("ptranse").batch_update(_jax(host), JBatch(_jax(arrays)), JConfig(**knobs))
    got, loss = get_model("ptranse").batch_update(_torch(host), _torch(arrays), EmbeddingConfig(**knobs))
    assert set(got) == set(want) == set(host)
    return got, loss, want, want_loss


# --- compositions and the update -------------------------------------------------------


@pytest.mark.parametrize("comp", ["add", "mul", "rnn"])
@pytest.mark.parametrize("dyadic", [False, True])
def test_compose_paths_equals_jax(comp, dyadic):
    rng = np.random.default_rng(1)
    k, n_rel = 8, N_REL
    rel_all = _dy(rng, 2 * n_rel, k) if dyadic else rng.normal(size=(2 * n_rel, k)).astype(np.float32)
    hops = rng.integers(0, 2 * n_rel, (12, 5, 3)).astype(np.int32)
    hops[rng.random(hops.shape) < 0.3] = -1
    hops[0, 0] = [-1, -1, -1]  # an empty slot: the composition's identity
    w = (np.concatenate([np.eye(k), np.eye(k)]) * 0.5 + rng.normal(size=(2 * k, k)) * 0.1).astype(np.float32)
    want = np.asarray(jax_ptranse.compose_paths(jnp.asarray(rel_all), jnp.asarray(hops), comp, jnp.asarray(w)))
    got = ptranse.compose_paths(torch.from_numpy(rel_all), torch.from_numpy(hops), comp, torch.from_numpy(w)).numpy()
    assert got.shape == (12, 5, k)
    if dyadic and comp != "rnn":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, 0], {"add": 0.0, "mul": 1.0, "rnn": 0.0}[comp])
    with pytest.raises(ValueError, match="requires comp_w"):
        ptranse.compose_paths(torch.from_numpy(rel_all), torch.from_numpy(hops), "rnn")


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("comp", ["add", "mul", "rnn"])
def test_batch_update_equals_jax(comp, distance):
    k = 8
    host = _tables(3, k, comp)
    arrays = _batch(4, 48)
    knobs = dict(embedding_size=k, learning_rate=0.05, margin=1.0, distance=int(distance), path_composition=comp)
    got, loss, want, want_loss = _update_both(host, arrays, **knobs)
    for key in host:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5)
        assert not np.array_equal(got[key].numpy(), host[key]), key  # every table moves
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    # The path term alone: path weight 0 leaves relation_inv and comp_w where
    # they were (up to relation_inv's ball norm), and lowers the loss.
    got0, loss0, want0, want_loss0 = _update_both(host, arrays, **knobs, path_weight=0.0)
    assert float(loss0) == pytest.approx(float(want_loss0), rel=1e-5) and float(loss0) < float(loss)
    if comp == "rnn":
        assert torch.equal(got0["comp_w"], torch.from_numpy(host["comp_w"]))


@pytest.mark.parametrize("comp", ["add", "mul"])
@pytest.mark.parametrize("scatter_mode", ["direct", "dedup"])
def test_dyadic_ties_at_zero_and_at_the_hinge_equal_jax_to_the_last_bit(comp, scatter_mode, monkeypatch):
    """relation_inv = −relation makes a path (a, a⁻¹) compose to exactly 0
    under ADD; dyadic tables with many zeros give exact zeros in
    comp(p) − r; the path margin is set so that one path sits exactly on the
    hinge.  JAX's gradient there: |x|' = +1 at 0 and 0.5 at the hinge."""
    k = 8
    host = _tables(5, k, comp, dyadic=True)
    host["relation_inv"] = -host["relation"]
    arrays = _batch(6, 40, conf=lambda rng, shape: (rng.integers(1, 8, shape) / 8).astype(np.float32))
    arrays["paths"][:8, 0] = np.stack([np.arange(8) % N_REL, np.arange(8) % N_REL + N_REL], axis=1)
    arrays["valid"][0] = arrays["nr_valid"][0] = True
    arrays["conf"][0, 0] = 0.5
    all_rel = np.concatenate([host["relation"], host["relation_inv"]])
    pv = np.asarray(jax_ptranse.compose_paths(jnp.asarray(all_rel), jnp.asarray(arrays["paths"]), comp))
    res = pv - host["relation"][arrays["r"]][:, None, :]
    assert (res == 0).sum() > 20  # exact zeros in comp(p) − r
    e_pos = np.abs(res[0, 0]).sum()
    e_neg = np.abs(pv[0, 0] - host["relation"][arrays["nr"][0]]).sum()
    margin = float(e_neg - e_pos)  # exact: sample 0's first path on the hinge
    knobs = dict(embedding_size=k, learning_rate=0.125, margin=1.0, path_composition=comp, path_margin=margin,
                 scatter_mode=scatter_mode)
    got, loss, want, want_loss = _update_both(host, arrays, **knobs)
    for key in host:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert float(loss) == float(want_loss)
    # torch.abs's gradient (0 at 0) moves the relation tables off JAX's.
    monkeypatch.setattr(ptranse, "l1_rows", lambda x: torch.abs(x).sum(-1))
    off, _ = get_model("ptranse").batch_update(_torch(host), _torch(arrays), EmbeddingConfig(**knobs))
    assert not np.array_equal(off["relation"].numpy(), np.asarray(want["relation"]))


def test_model_flags_init_and_warm_start_equal_jax():
    m = get_model("ptranse")
    assert isinstance(m, ptranse.PTransE) and m.uses_paths and m.has_warm_start
    assert not m.supports_fused_table and not m.has_parity_mode and m.weights_key is None
    assert m.file_extras == {"relation_inv": "relation_inv", "comp_w": "comp_w"}
    assert all(not get_model(name).uses_paths for name in ("transe", "transh", "transr", "ctransr"))
    for comp in ("add", "rnn"):
        cfg = EmbeddingConfig(embedding_size=8, path_composition=comp, param_dtype="bfloat16")
        params = m.init_params(torch.Generator().manual_seed(3), 20, 4, cfg, "cpu")
        assert set(params) == {"entity", "relation", "relation_inv"} | ({"comp_w"} if comp == "rnn" else set())
        assert all(v.dtype == torch.float32 for v in params.values())
        # TransE's tables, then relation_inv from the same generator.
        gen = torch.Generator().manual_seed(3)
        transe = get_model("transe").init_params(gen, 20, 4, cfg, "cpu")
        assert torch.equal(params["entity"], transe["entity"].float())
        assert torch.equal(params["relation_inv"], projections.ball_norm(prng.transe_init(gen, (4, 8), 8, "cpu")))
    half = torch.eye(8) * 0.5
    assert torch.equal(params["comp_w"], torch.cat([half, half]))
    jparams = jax_get_model("ptranse").init_params(jax.random.PRNGKey(0), 20, 4, JConfig(embedding_size=8,
                                                                                          path_composition="rnn"))
    np.testing.assert_array_equal(params["comp_w"].numpy(), np.asarray(jparams["comp_w"]))
    rng = np.random.default_rng(0)
    ent, rel = rng.normal(size=(20, 8)) * 0.6, rng.normal(size=(4, 8)) * 0.6
    want = jax_ptranse.warm_start_params(_jax({k: np.asarray(v) for k, v in params.items()}), ent, rel)
    got = m.warm_start_params(params, ent, rel)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
    assert torch.equal(got["relation_inv"], -got["relation"]) and torch.equal(got["comp_w"], params["comp_w"])


# --- sampling and the epoch runner ---------------------------------------------------


def _known(ts):
    return set(zip(ts.heads.tolist(), ts.rels.tolist(), ts.tails.tolist()))


def test_relation_negatives_are_certified_and_the_three_probes_agree(tiny_kg_dir):
    ts = triples.load_dataset(tiny_kg_dir).train
    data = step.DeviceData.from_triple_set(ts, "cpu")
    rng = np.random.default_rng(0)
    pick = torch.from_numpy(rng.integers(0, ts.num_triples, 300))
    ph, pt, r = data.heads[pick], data.tails[pick], data.rels[pick]
    index = dict(sorted_h=data.sorted_h, sorted_r=data.sorted_r, sorted_t=data.sorted_t)
    probes = {"fingerprint": dict(cuckoo_fp=data.cuckoo_fp, cuckoo_m=data.cuckoo_m, cuckoo_salt=data.cuckoo_salt),
              "cuckoo": dict(cuckoo_table=data.cuckoo_table, cuckoo_m=data.cuckoo_m, cuckoo_salt=data.cuckoo_salt),
              "binary search": {}}
    out = {name: corruption.sample_relation_negatives(torch.Generator().manual_seed(1), ph, pt, r, ts.n_relations,
                                                      **index, resample_rounds=3, **kw)
           for name, kw in probes.items()}
    nr, valid = out["binary search"]
    for name in probes:
        assert torch.equal(out[name][0], nr) and torch.equal(out[name][1], valid), name
    # The candidates [300, 3] the generator gave: the first not known wins.
    cands = torch.randint(0, ts.n_relations, (300, 3), generator=torch.Generator().manual_seed(1)).numpy()
    known = _known(ts)
    for i in range(300):
        free = [c for c in cands[i] if (int(ph[i]), int(c), int(pt[i])) not in known]
        assert bool(valid[i]) == bool(free) and (not free or int(nr[i]) == free[0])
        if valid[i]:
            assert int(nr[i]) != int(r[i])
    assert nr.dtype == torch.int32 and 0.5 < float(valid.float().mean()) < 1.0


@pytest.mark.parametrize("kneg", [1, 3])
def test_sample_batch_returns_the_triple_index_sample_major(tiny_kg_dir, kneg):
    ts = triples.load_dataset(tiny_kg_dir).train
    data = step.DeviceData.from_triple_set(ts, "cpu")
    cfg = EmbeddingConfig(num_negatives=kneg)
    kw = dict(n_entities=data.n_entities, batch_size=50, method=Method.BERN, resample_rounds=4,
              cuckoo_fp=data.cuckoo_fp, cuckoo_m=data.cuckoo_m, cuckoo_salt=data.cuckoo_salt,
              n_relations=data.n_relations, num_negatives=cfg.num_negatives)
    args = (data.heads, data.tails, data.rels, data.bern_pr_tail, data.sorted_h, data.sorted_r, data.sorted_t)
    with_idx = corruption.sample_batch(torch.Generator().manual_seed(2), *args, **kw, return_idx=True)
    plain = corruption.sample_batch(torch.Generator().manual_seed(2), *args, **kw)
    assert set(with_idx) == set(plain) | {"idx"} and all(torch.equal(with_idx[k], plain[k]) for k in plain)
    idx = with_idx["idx"]
    assert idx.shape == (50 * kneg,) and torch.equal(idx.reshape(50, kneg), idx[::kneg, None].expand(50, kneg))
    for key, table in (("ph", data.heads), ("pt", data.tails), ("r", data.rels)):
        assert torch.equal(table[idx], with_idx[key])


def _store_row(ts, store):
    """Each train triple's row of the store: (h, r, t) → row."""
    return {trip: i for i, trip in enumerate(zip(ts.heads.tolist(), ts.rels.tolist(), ts.tails.tolist()))}


def test_epoch_runner_attaches_its_draws_path_data_and_never_takes_the_fused_path(tiny_kg_dir, monkeypatch):
    ts = triples.load_dataset(tiny_kg_dir).train
    store = paths.build_path_store(ts.heads, ts.tails, ts.rels, ts.n_relations, max_paths=4, use_native=False)
    data = step.DeviceData.from_triple_set(ts, "cpu", path_store=store)
    assert data.paths.dtype == torch.int32 and data.path_conf.dtype == torch.float32
    cfg = EmbeddingConfig(embedding_size=8, num_batches=4, learning_rate=0.02)
    m = get_model("ptranse")
    runner = step.make_epoch_runner(m, cfg, ts.num_triples // 4, 4)
    assert not runner.fused and runner.chunk is None
    batches = runner.sample(torch.Generator().manual_seed(5), data)
    assert set(batches) == set(BATCH_KEYS)
    assert batches["paths"].shape == (4, ts.num_triples // 4, 4, 2) and batches["conf"].shape[2] == 4
    rows, known = _store_row(ts, store), _known(ts)
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batches.items()}
    for i in range(flat["ph"].shape[0]):
        row = rows[(int(flat["ph"][i]), int(flat["r"][i]), int(flat["pt"][i]))]
        assert np.array_equal(flat["paths"][i].numpy(), store.rels[row])
        assert np.array_equal(flat["conf"][i].numpy(), store.conf[row])
        if flat["nr_valid"][i]:
            assert (int(flat["ph"][i]), int(flat["nr"][i]), int(flat["pt"][i])) not in known
    # The runner applies batch_update once a batch, never the fused update.
    calls = []
    real = ptranse.PTransE.batch_update

    def counted(self, params, batch, cfg):
        calls.append(set(batch))
        return real(self, params, batch, cfg)

    monkeypatch.setattr(ptranse.PTransE, "batch_update", counted)
    monkeypatch.setattr(ptranse.PTransE, "fused_table_update", lambda *a, **k: pytest.fail("fused path taken"))
    params = m.init_params(torch.Generator().manual_seed(1), ts.n_entities, ts.n_relations, cfg, "cpu")
    out, loss = runner(params, torch.Generator().manual_seed(5), data)
    assert calls == [set(BATCH_KEYS)] * 4 and torch.isfinite(loss) and set(out) == set(params)
    with pytest.raises(ValueError, match="no fused-table update"):
        step.make_epoch_runner(m, cfg, 10, 4, fused=True)


def test_parity_mode_steps_carry_path_data_and_launch_no_kernel(tiny_kg_dir):
    ts = triples.load_dataset(tiny_kg_dir).train
    store = paths.build_path_store(ts.heads, ts.tails, ts.rels, ts.n_relations, max_paths=4, use_native=False)
    m = get_model("ptranse")
    cfg = EmbeddingConfig(embedding_size=8, num_batches=4, max_epochs=2, learning_rate=0.02, seed=3,
                          update_mode="parity")
    data = step.DeviceData.from_triple_set(ts, "cpu", path_store=store)
    batch = step.sample_batch(torch.Generator().manual_seed(1), data, cfg, 16)
    assert set(batch) == set(BATCH_KEYS)
    for module in KERNEL_MODULES:
        module.reset_launch_counts()
    losses = []
    with pytest.warns(UserWarning, match="--update-mode parity has no effect for ptranse"):
        loop.train(m, cfg, ts, path_store=store, metrics_fn=lambda r: losses.append(r["loss"]), device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(not module.launch_counts for module in KERNEL_MODULES)


def test_loop_trains_ptranse_and_the_loss_falls(tiny_kg_dir):
    ts = triples.load_dataset(tiny_kg_dir).train
    store = paths.build_path_store(ts.heads, ts.tails, ts.rels, ts.n_relations, max_paths=4, use_native=False)
    cfg = EmbeddingConfig(embedding_size=16, learning_rate=0.02, num_batches=8, max_epochs=6, seed=3,
                          path_composition="rnn")
    losses = []
    params = loop.train(get_model("ptranse"), cfg, ts, path_store=store,
                        metrics_fn=lambda r: losses.append(r["loss"]), device="cpu")
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    for name in ("entity", "relation", "relation_inv"):
        assert (params[name].norm(dim=1) <= 1 + 1e-5).all(), name
    assert torch.isfinite(params["comp_w"]).all()


# --- eval ------------------------------------------------------------------------------


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_entity_eval_equals_jax_exactly_through_one_group(tiny_kg_dir, tiny_dataset, distance, monkeypatch):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _tables(7, 8, "add", dyadic=True, n_ent=dataset.n_entities, n_rel=dataset.n_relations)
    knobs = dict(embedding_size=8, eval_batch_size=64, eval_block_size=24, distance=int(distance))
    want = jax_harness.evaluate(jax_get_model("ptranse"), _jax(host), tiny_dataset, JConfig(**knobs))
    calls = []
    counts = rank_count.rank_counts
    monkeypatch.setattr(rank_count, "rank_counts", lambda *a, **k: calls.append(1) or counts(*a, **k))
    got = harness.evaluate(get_model("ptranse"), params_from_numpy(host, "cpu"), dataset, EmbeddingConfig(**knobs),
                           device="cpu")
    assert got == want
    assert len(calls) == -(-2 * dataset.test[0].shape[0] // 64)  # one rank count a batch of one group


def _test_store(dataset, max_paths=4, max_len=2):
    train = dataset.train
    return paths.build_path_store(train.heads, train.tails, train.rels, train.n_relations, max_len=max_len,
                                  max_paths=max_paths, use_native=False, n_entities=dataset.n_entities,
                                  query_pairs=(dataset.test[0], dataset.test[1]))


@pytest.mark.parametrize("comp", ["add", "mul"])
@pytest.mark.parametrize("evidence", [False, True])
def test_relation_prediction_with_and_without_evidence_equals_jax_exactly(tiny_kg_dir, tiny_dataset, comp,
                                                                          evidence, monkeypatch):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _tables(8, 8, comp, dyadic=True, n_ent=dataset.n_entities, n_rel=dataset.n_relations)
    store = _test_store(dataset) if evidence else None
    knobs = dict(embedding_size=8, eval_batch_size=48, path_composition=comp)  # 120 triples: the last batch short
    want = jax_harness.evaluate_relation_prediction(jax_get_model("ptranse"), _jax(host), tiny_dataset,
                                                    JConfig(**knobs), path_store=store)
    got = harness.evaluate_relation_prediction(get_model("ptranse"), params_from_numpy(host, "cpu"), dataset,
                                               EmbeddingConfig(**knobs), path_store=store, device="cpu")
    assert got == want  # every metric, MRR and Hits@1 included, to the last bit
    # R in slices of 3 relations ([48, P 4, 3, k 8] float32 temporaries): the same.
    monkeypatch.setattr(harness, "RELATION_SLICE_BYTES", 48 * 4 * 3 * 8 * 4)
    assert harness.evaluate_relation_prediction(get_model("ptranse"), params_from_numpy(host, "cpu"), dataset,
                                                EmbeddingConfig(**knobs), path_store=store, device="cpu") == want
    if evidence:  # the evidence moves the ranks; without relation_inv it is ignored
        plain = harness.evaluate_relation_prediction(get_model("ptranse"), params_from_numpy(host, "cpu"), dataset,
                                                     EmbeddingConfig(**knobs), device="cpu")
        assert plain != got
        no_inv = {k: v for k, v in host.items() if k != "relation_inv"}
        assert harness.evaluate_relation_prediction(get_model("ptranse"), params_from_numpy(no_inv, "cpu"), dataset,
                                                    EmbeddingConfig(**knobs), path_store=store,
                                                    device="cpu") == plain


def test_relation_evidence_with_rnn_equals_jax(tiny_kg_dir, tiny_dataset):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _tables(9, 8, "rnn", n_ent=dataset.n_entities, n_rel=dataset.n_relations)
    store = _test_store(dataset, max_paths=6, max_len=3)
    knobs = dict(embedding_size=8, eval_batch_size=64, path_composition="rnn")
    want = jax_harness.evaluate_relation_prediction(jax_get_model("ptranse"), _jax(host), tiny_dataset,
                                                    JConfig(**knobs), path_store=store)
    raw, filt, sizes = harness.relation_ranks(get_model("ptranse"), params_from_numpy(host, "cpu"), dataset,
                                              EmbeddingConfig(**knobs), path_store=store, device="cpu")
    got = harness.metrics_from_ranks(raw, filt, sizes)
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-6), key


# --- warm start and CLI ------------------------------------------------------------------


def _write_transe_seed(seed_dir, dataset, k):
    rng = np.random.default_rng(17)
    ent = rng.normal(size=(dataset.n_entities, k)) * 0.3
    rel = rng.normal(size=(dataset.n_relations, k)) * 0.3
    text.write_embeddings(seed_dir, Method.UNIF, ent, rel, model_name="transe")
    return (text.read_matrix(os.path.join(seed_dir, "entity2vec.unif"), *ent.shape),
            text.read_matrix(os.path.join(seed_dir, "relation2vec.unif"), *rel.shape))


def test_cli_warm_start_seeds_the_init_with_5eed_and_negates_the_relations(tiny_kg_dir, tmp_path):
    ts = triples.load_dataset(tiny_kg_dir).train
    seed_e, seed_r = _write_transe_seed(str(tmp_path / "seed"), triples.load_dataset(tiny_kg_dir), 8)
    cfg = EmbeddingConfig(embedding_size=8, seed=7, seed_data_dir=str(tmp_path / "seed"), seed_method=0,
                          path_composition="rnn")
    m = get_model("ptranse")
    params = train_cli._maybe_warm_start(m, cfg, ts, torch.device("cpu"))
    init = m.init_params(torch.Generator().manual_seed(7 ^ 0x5EED), ts.n_entities, ts.n_relations, cfg, "cpu")
    want = jax_ptranse.warm_start_params(_jax({k: v.numpy() for k, v in init.items()}), seed_e, seed_r)
    assert set(params) == set(want) == {"entity", "relation", "relation_inv", "comp_w"}
    for key in want:
        np.testing.assert_allclose(params[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
    assert torch.equal(params["relation_inv"], -params["relation"])


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def _metric_lines(out: str):
    return [line for line in out.splitlines() if "-- " in line]


@pytest.mark.parametrize("comp", ["add", "rnn"])
def test_train_ptranse_writes_jax_format_files_and_eval_ptranse_reads_them(tiny_kg_dir, tmp_path, comp):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    seed_dir, out_dir = str(tmp_path / "seed"), str(tmp_path / "out")
    _write_transe_seed(seed_dir, dataset, 8)
    argv = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--rate", "0.02", "--method", "1",
            "--batches", "4", "--epochs", "4", "--seed", "7", "--device", "cpu", "--path-comp", comp,
            "--max-paths", "4", "--seeddatadir", seed_dir, "--seedmethod", "0"]
    out, params = _run(train_ptranse.main, argv)
    losses = [float(line.split("Loss: ")[1]) for line in out.splitlines() if line.startswith("Epoch: ")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    # The JAX package's PCRA line, its coverage equal to the JAX store's.
    train = dataset.train
    cov = jax_paths.build_path_store(train.heads, train.tails, train.rels, train.n_relations, max_paths=4).coverage()
    line = next(line for line in out.splitlines() if line.startswith("PCRA paths: "))
    assert line.startswith(f"PCRA paths: {cov * 100:.1f}% of triples have ≥1 path (≤2 hops, top 4; ")
    extras = ["relation_inv"] + (["comp_w"] if comp == "rnn" else [])
    with open(os.path.join(out_dir, "embedding_meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["model"] == "ptranse" and list(meta["extras"]) == extras
    # The JAX writer on the same tables gives the same bytes, file by file.
    host = {k: v.numpy() for k, v in params.items()}
    jax_text.write_embeddings(str(tmp_path / "jax"), JMethod.BERN, host["entity"], host["relation"],
                              model_name="ptranse", extras={name: host[name] for name in extras})
    names = sorted(os.listdir(out_dir))
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(
        ["embedding_meta.json", "entity2vec.bern", "relation2vec.bern"] + [f"{name}.bern" for name in extras])
    for name in names:
        assert (tmp_path / "out" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--method", "1", "--eval-batch", "64",
              "--path-comp", comp, "--max-paths", "4", "--device", "cpu"]
    got, metrics = _run(eval_ptranse.main, common)
    assert len(_metric_lines(got)) == 4 and np.isfinite(metrics["filtered_mean_rank"])
    got, metrics = _run(eval_ptranse.main, common + ["--task", "relation"])
    assert len(_metric_lines(got)) == 2 and metrics["num_corruptions"] == dataset.test[0].shape[0]


def test_jax_eval_ptranse_prints_the_port_lines_on_port_written_dyadic_files(tiny_kg_dir, tmp_path):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _tables(10, 8, "add", dyadic=True, n_ent=dataset.n_entities, n_rel=dataset.n_relations)
    out_dir = str(tmp_path / "out")
    text.write_embeddings(out_dir, Method.BERN, host["entity"], host["relation"], model_name="ptranse",
                          extras={"relation_inv": host["relation_inv"]})
    for extra in (["--distance", "0"], ["--distance", "1"], ["--task", "relation"]):
        common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--method", "1",
                  "--eval-batch", "64", "--max-paths", "4", *extra]
        want = _metric_lines(_run(jax_eval_ptranse.main, common)[0])
        got = _metric_lines(_run(eval_ptranse.main, common + ["--device", "cpu"])[0])
        assert len(want) == (2 if "--task" in extra else 4) and got == want
        assert _metric_lines(_run(eval_cli.main, common + ["--model", "ptranse", "--device", "cpu"])[0]) == want


def test_ptranse_entry_points_raise_without_cuda_unless_the_cpu_is_asked_for(tiny_kg_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "4", "--epochs", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ptranse.main(argv)
    for task in ("entity", "relation"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eval_ptranse.main(argv[:6] + ["--task", task])
