"""kb2e_tpu_torch's TransH against kb2e_tpu's.

The same numpy-seeded tables and injected batches go through both packages:
the init distribution, ``sphere_norm`` and the batched orthogonality
projector, the energy and the eval projection, the fast update
(``batch_update``) and the parity update, whose plain version (the CPU side
of the CUDA kernel K4) is held against JAX's scan path, JAX's Pallas kernel
in interpret mode and the NumPy oracle.  Then the projected eval, and the
CLI trains and scores on ``tiny_kg_dir`` on the CPU.

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

from kb2e_tpu.cli import eval_transh as jax_eval_transh
from kb2e_tpu.cli import train_transh as jax_train_transh
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu.models.base import Batch as JBatch
from kb2e_tpu.ops import pallas_update as jax_pallas_update
from kb2e_tpu.ops import projections as jax_projections
from kb2e_tpu.utils import prng as jax_prng
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval as eval_cli
from kb2e_tpu_torch.cli import eval_transh, train_transh
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.convert import params_from_numpy, params_to_numpy
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.ops import cuda_build, projections, transh_update
from kb2e_tpu_torch.utils import prng

import oracle

torch.set_num_threads(1)

N_ENT, N_REL = 40, 6
KEYS = ("entity", "relation", "norm")


def _tables(seed, k, n=N_ENT, n_rel=N_REL, scale=0.4):
    """Entity and relation rows of about ``scale`` per coordinate, unit normals."""
    rng = np.random.default_rng(seed)
    ent = (rng.normal(size=(n, k)) * scale).astype(np.float32)
    rel = (rng.normal(size=(n_rel, k)) * scale).astype(np.float32)
    w = rng.normal(size=(n_rel, k)).astype(np.float32)
    return ent, rel, (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


def _batch_arrays(seed, b, n=N_ENT, n_rel=N_REL, self_loops=False, k_neg=1):
    """ph pt r nh nt valid; with ``k_neg`` > 1 the positives repeat sample-major."""
    rng = np.random.default_rng(seed)
    ph, pt = (np.repeat(rng.integers(0, n, b // k_neg), k_neg).astype(np.int32) for _ in range(2))
    r = np.repeat(rng.integers(0, n_rel, b // k_neg), k_neg).astype(np.int32)
    if self_loops:
        pt[: b // 4] = ph[: b // 4]
    nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(2))
    if self_loops:
        nt[b // 4 : b // 2] = nh[b // 4 : b // 2]
    valid = rng.random(b) > 0.1
    return ph, pt, r, nh, nt, valid


def _jax_batch(arrays):
    return JBatch(zip(("ph", "pt", "r", "nh", "nt", "valid"), (jnp.asarray(a) for a in arrays)))


def _torch_batch(arrays):
    return dict(zip(("ph", "pt", "r", "nh", "nt", "valid"), (torch.from_numpy(a) for a in arrays)))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _cfgs(k, **kw):
    common = dict(embedding_size=k, learning_rate=0.05, margin=1.0, **kw)
    return JConfig(**common), EmbeddingConfig(**common)


# --- init and projections ----------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_unit_bounded_init_has_jax_distribution(k):
    # randn(0, 1/k) truncated to [-1, 1]: at k = 1 the cut removes a third of
    # the normal's mass, at k = 4 almost none.  The bits differ (D5); the
    # moments agree within 5 standard errors of 40,000 draws.
    n = 40_000
    got = prng.unit_bounded_init(torch.Generator().manual_seed(0), (n,), k, "cpu").numpy()
    want = np.asarray(jax_prng.unit_bounded_init(jax.random.PRNGKey(0), (n,), k))
    assert got.dtype == np.float32 and got.min() >= -1.0 and got.max() <= 1.0
    se = want.std() / np.sqrt(n)
    assert abs(got.mean() - want.mean()) < 5 * se * np.sqrt(2)
    assert abs(got.std() - want.std()) < 5 * se
    assert abs(np.abs(got).mean() - np.abs(want).mean()) < 5 * se


def test_init_params_ball_and_sphere_norm_the_tables():
    cfg = EmbeddingConfig(embedding_size=16)
    params = get_model("transh").init_params(torch.Generator().manual_seed(3), 200, 30, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {"entity": (200, 16), "relation": (30, 16),
                                                              "norm": (30, 16)}
    assert all(v.dtype == torch.float32 for v in params.values())
    for key in ("entity", "relation"):
        assert float(params[key].norm(dim=1).max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(params["norm"].norm(dim=1).numpy(), 1.0, atol=1e-6)
    # The same seed gives the same tables.
    again = get_model("transh").init_params(torch.Generator().manual_seed(3), 200, 30, cfg, "cpu")
    assert all(torch.equal(params[k], again[k]) for k in KEYS)


def test_sphere_norm_equals_jax():
    x = np.random.default_rng(4).normal(size=(30, 12)).astype(np.float32) * 3
    _close(projections.sphere_norm(torch.from_numpy(x)), jax_projections.sphere_norm(jnp.asarray(x)), atol=1e-6)


def _projector_rows(seed, k=16):
    """Row pairs (a, b): a third nearly orthogonal (converge at the first
    check), a third with a·b̂ just above 0.1 (a few trips), a third far above
    (they run to the cap)."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(30, k)).astype(np.float32)
    a = rng.normal(size=(30, k)).astype(np.float32) * 0.01
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    a[10:20] += 0.2 * bn[10:20]
    a[20:] += 3.0 * bn[20:]
    return a, b


@pytest.mark.parametrize("max_iters", [1, 2, 16])
def test_orthogonality_project_equals_vmapped_jax_and_the_oracle(max_iters):
    a, b = _projector_rows(max_iters)
    lr = 0.05
    ja, jb = jax.vmap(lambda x, y: jax_projections.orthogonality_project(x, y, lr, max_iters))(
        jnp.asarray(a), jnp.asarray(b)
    )
    ta, tb = projections.orthogonality_project(torch.from_numpy(a), torch.from_numpy(b), lr, max_iters)
    _close(ta, ja)
    _close(tb, jb)
    oa, ob = zip(*(oracle.orthogonality_project(a[i], b[i], lr, max_iters) for i in range(a.shape[0])))
    _close(ta, np.stack(oa))
    _close(tb, np.stack(ob))
    # Against the oracle's loop with a far higher cap: the first third
    # converges at once (a unchanged), and caps of 1 and 2 cut the last third.
    ua, _ = zip(*(oracle.orthogonality_project(a[i], b[i], lr, 10_000) for i in range(a.shape[0])))
    assert np.array_equal(ta.numpy()[:10], a[:10])
    capped = [i for i in range(a.shape[0]) if not np.array_equal(ua[i], oa[i])]
    if max_iters < 16:
        assert set(range(20, 30)) <= set(capped)


def test_energy_and_eval_projection_equal_jax():
    k = 12
    ent, rel, w = _tables(1, k)
    rng = np.random.default_rng(2)
    h, t, r = (rng.integers(0, n, 25) for n in (N_ENT, N_ENT, N_REL))
    host = {"entity": ent, "relation": rel, "norm": w}
    jparams = {key: jnp.asarray(v) for key, v in host.items()}
    params = params_from_numpy(host, "cpu")
    jm, m = jax_get_model("transh"), get_model("transh")
    assert not m.uses_distance_flag and m.needs_projection and m.effective_distance(Distance.L2) == Distance.L1
    for d in (Distance.L1, Distance.L2):  # --distance is ignored (quirk B5)
        got = m.energy(params, *(torch.from_numpy(x) for x in (h, t, r)), d)
        want = jm.energy(jparams, jnp.asarray(h), jnp.asarray(t), jnp.asarray(r), JDistance(int(d)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for rel_id in (0, 5):
        _close(m.project_entities(params, rel_id), jm.project_entities(jparams, rel_id), atol=1e-6)


def test_jax_transh_params_carry_across_unchanged():
    # kb2e_tpu's TransH params (entity, relation, norm) as the port's, through
    # params_to_numpy / params_from_numpy with no renaming.
    jparams = jax_get_model("transh").init_params(jax.random.PRNGKey(0), 30, 5, JConfig(embedding_size=8))
    params = params_from_numpy({k: np.array(v) for k, v in jparams.items()}, "cpu")
    assert set(params) == set(KEYS)
    back = params_to_numpy(params)
    for key in KEYS:
        np.testing.assert_array_equal(back[key], np.asarray(jparams[key]))
    h = t = r = np.arange(5)
    got = get_model("transh").energy(params, *(torch.from_numpy(x) for x in (h, t + 3, r)), Distance.L1)
    want = jax_get_model("transh").energy(jparams, jnp.asarray(h), jnp.asarray(t + 3), jnp.asarray(r), JDistance.L1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --- fast update --------------------------------------------------------------


@pytest.mark.parametrize("k_neg", [1, 4])
@pytest.mark.parametrize("scatter_mode", ["direct", "dedup"])
def test_batch_update_equals_jax(k_neg, scatter_mode):
    k = 12
    ent, rel, w = _tables(5, k)
    arrays = _batch_arrays(6 + k_neg, 48, k_neg=k_neg)
    jcfg, cfg = _cfgs(k, scatter_mode=scatter_mode, num_negatives=k_neg)
    jparams = {"entity": jnp.asarray(ent), "relation": jnp.asarray(rel), "norm": jnp.asarray(w)}
    tparams = params_from_numpy({"entity": ent, "relation": rel, "norm": w}, "cpu")
    want, want_loss = jax_get_model("transh").batch_update(jparams, _jax_batch(arrays), jcfg)
    got, loss = get_model("transh").batch_update(tparams, _torch_batch(arrays), cfg)
    for key in KEYS:
        _close(got[key], want[key])
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert 0 < float(loss)
    assert all(torch.equal(tparams[key], torch.from_numpy(v)) for key, v in zip(KEYS, (ent, rel, w)))


# --- parity update (K4's plain version) ---------------------------------------


@pytest.mark.parametrize("self_loops", [False, True])
def test_parity_plain_version_equals_jax_scan_pallas_kernel_and_oracle(self_loops):
    # Three batches of 32 at k = 16, lr 0.05 (tests/test_pallas_update.py's
    # setting); with self_loops a quarter of the positives have h == t and the
    # next quarter of the corrupted triples h' == t'.  Each batch starts every
    # implementation from the port's tables after the batch before.
    k, lr, cap = 16, 0.05, 16
    ent, rel, w = _tables(11 if self_loops else 9, k)
    jcfg, cfg = _cfgs(k, update_mode="parity", parity_impl="scan")
    params = params_from_numpy({"entity": ent, "relation": rel, "norm": w}, "cpu")
    for step in range(3):
        arrays = _batch_arrays(20 + step, 32, self_loops=self_loops)
        host = params_to_numpy(params)
        jparams = {key: jnp.asarray(v) for key, v in host.items()}
        scan, scan_loss = jax_get_model("transh").sequential_update(jparams, _jax_batch(arrays), jcfg)
        jb = _jax_batch(arrays)
        kern = jax_pallas_update.transh_sequential_update(
            *(jparams[key] for key in KEYS), jb["ph"], jb["pt"], jb["r"], jb["nh"], jb["nt"], jb["valid"],
            learning_rate=lr, margin=1.0, max_iters=cap, interpret=True,
        )
        orc = oracle.TransHOracle(host["entity"], host["relation"], host["norm"], lr, 1.0, max_iters=cap)
        orc_loss = orc.run_batch(zip(*(a[arrays[5]] for a in arrays[:5])))

        got = transh_update.transh_sequential_update_reference(
            *(params[key] for key in KEYS), *(torch.from_numpy(a) for a in arrays),
            learning_rate=lr, margin=1.0, max_iters=cap,
        )
        assert 0 < int(got[4].sum()) < 32 and int(got[5].sum()) > 0
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
    k = 8
    ent, rel, w = _tables(12, k)
    arrays = _batch_arrays(13, 24, self_loops=True)
    t = [torch.from_numpy(a) for a in (ent, rel, w, *arrays)]
    cuda_build.reset_launch_counts()
    via_wrapper = transh_update.transh_sequential_update(*t, learning_rate=0.05, margin=1.0, max_iters=16)
    assert sum(cuda_build.launch_counts.values()) == 0  # CPU tensors: the plain version
    params = dict(zip(KEYS, t[:3]))
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=0.05, margin=1.0, update_mode="parity")
    for impl in ("auto", "pallas", "scan"):
        out, loss = get_model("transh").sequential_update(params, _torch_batch(arrays), cfg.replace(parity_impl=impl))
        assert all(torch.equal(out[key], table) for key, table in zip(KEYS, via_wrapper[:3]))
        assert float(loss) == float(via_wrapper[3])
    with pytest.raises(ValueError, match="parity_impl"):
        get_model("transh").sequential_update(params, _torch_batch(arrays), cfg.replace(parity_impl="x"))
    # Off the CPU 'scan' is refused, and a device without a kernel raises.
    meta = {key: v.to("meta") for key, v in params.items()}
    meta_batch = {key: v.to("meta") for key, v in _torch_batch(arrays).items()}
    with pytest.raises(ValueError, match="parity_impl='scan'"):
        get_model("transh").sequential_update(meta, meta_batch, cfg.replace(parity_impl="scan"))
    with pytest.raises(ValueError, match="no kernel"):
        get_model("transh").sequential_update(meta, meta_batch, cfg)


def test_parity_all_invalid_batch_changes_nothing():
    ent, rel, w = _tables(14, 16)
    arrays = _batch_arrays(15, 32, self_loops=True)[:5] + (np.zeros(32, bool),)
    t = [torch.from_numpy(a) for a in (ent, rel, w, *arrays)]
    got = transh_update.transh_sequential_update(*t, learning_rate=0.05, margin=1.0, max_iters=16)
    assert all(torch.equal(g, x) for g, x in zip(got[:3], t[:3])) and float(got[3]) == 0.0
    assert not got[4].any() and not got[5].any()


def test_kernel_order_sum_is_the_block_reduction_order():
    # 40 coordinates: warp 0 holds 32, warp 1 holds 8 and 24 zeros.
    x = torch.from_numpy(np.random.default_rng(16).normal(size=(3, 40)).astype(np.float32))
    want = []
    for row in x.numpy():
        padded = np.concatenate([row, np.zeros(24, np.float32)]).reshape(2, 32)
        for off in (16, 8, 4, 2, 1):
            padded = np.array([[np.float32(w[i] + w[i + off]) for i in range(off)] for w in padded])
        want.append(np.float32(padded[0, 0] + padded[1, 0]))
    assert np.array_equal(transh_update.kernel_order_sum(x).numpy(), np.array(want, np.float32))


# --- eval -----------------------------------------------------------------------


def _dyadic_transh(n_ent, n_rel, k, seed):
    """Multiples of 1/8 in [-2, 2] for entities, relations and the (non-unit)
    normals: every product and sum of the projection and the L1 energies is
    exact in float32, in any order."""
    rng = np.random.default_rng(seed)
    return {
        key: np.clip(np.round(rng.normal(size=(n, k)) * 4) / 8, -2, 2).astype(np.float32)
        for key, n in (("entity", n_ent), ("relation", n_rel), ("norm", n_rel))
    }


def test_projected_eval_metrics_equal_jax_exactly(tiny_kg_dir, tiny_dataset):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic_transh(dataset.n_entities, dataset.n_relations, 12, seed=3)
    assert not np.allclose(np.linalg.norm(host["norm"], axis=1), 1.0)
    # Groups of up to 64 queries per relation, one batch each or two; 64
    # entities in blocks of 24.
    knobs = dict(embedding_size=12, eval_batch_size=64, eval_block_size=24)
    want = jax_harness.evaluate(
        jax_get_model("transh"), {k: jnp.asarray(v) for k, v in host.items()}, tiny_dataset, JConfig(**knobs)
    )
    cfg = EmbeddingConfig(**knobs)
    got = harness.evaluate(get_model("transh"), params_from_numpy(host, "cpu"), dataset, cfg, device="cpu")
    assert got == want  # every metric, MRR included, to the last bit
    assert got["num_corruptions"] == 2 * dataset.test[0].shape[0]
    assert got["filtered_mean_rank"] < got["raw_mean_rank"]
    # One group per relation, each padded to whole batches of 64.
    raw, _, sizes = harness.rank_all(get_model("transh"), params_from_numpy(host, "cpu"), dataset, cfg, device="cpu")
    n_g = np.bincount(dataset.test[2], minlength=dataset.n_relations)
    assert len(sizes) == sum(-(-2 * n // 64) for n in n_g) and sum(sizes) == raw.shape[0]
    # --distance is ignored: L2 gives the same metrics.
    assert harness.evaluate(get_model("transh"), params_from_numpy(host, "cpu"), dataset,
                            cfg.replace(distance=Distance.L2), device="cpu") == got


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def _metric_lines(out: str):
    return [line for line in out.splitlines() if "-- " in line]


def test_eval_transh_cli_prints_jax_lines_on_jax_trained_files(tiny_kg_dir, tmp_path):
    out_dir = str(tmp_path / "out")
    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "16", "--method", "1",
              "--seed", "7", "--eval-batch", "64", "--eval-block", "32"]
    _run(jax_train_transh.main, common + ["--rate", "0.02", "--batches", "4", "--epochs", "3"])
    assert os.path.exists(os.path.join(out_dir, "weights.bern"))
    want = _metric_lines(_run(jax_eval_transh.main, common)[0])
    got = _metric_lines(_run(eval_transh.main, common + ["--device", "cpu"])[0])
    assert len(want) == 4 and got == want
    # The unified entry point takes --model transh alike.
    assert _metric_lines(_run(eval_cli.main, common + ["--model", "transh", "--device", "cpu"])[0]) == want


# --- training through the CLI -------------------------------------------------------


@pytest.mark.parametrize("mode,epochs", [("fast", 6), ("parity", 3)])
def test_train_transh_cli_trains_and_its_files_score_alike_in_both_evals(tiny_kg_dir, tmp_path, mode, epochs):
    out_dir, metrics = str(tmp_path / "out"), str(tmp_path / "m.jsonl")
    out, params = _run(train_transh.main, [
        "--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "16", "--rate", "0.02", "--method", "1",
        "--batches", "4", "--seed", "7", "--device", "cpu", "--epochs", str(epochs), "--update-mode", mode,
        "--metrics-jsonl", metrics,
    ])
    losses = [float(line.split("Loss: ")[1]) for line in out.splitlines() if line.startswith("Epoch: ")]
    assert len(losses) == epochs and losses[-1] < 0.8 * losses[0]
    assert [json.loads(line)["epoch"] for line in open(metrics, encoding="utf-8")] == list(range(epochs))
    assert set(params) == set(KEYS) and all(v.dtype == torch.float32 for v in params.values())
    assert float(params["entity"].norm(dim=1).max()) <= 1.0 + 1e-5
    np.testing.assert_allclose(params["norm"].norm(dim=1).numpy(), 1.0, atol=1e-5)
    for name in ("entity2vec.bern", "relation2vec.bern", "weights.bern", "embedding_meta.json"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "embedding_meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["model"] == "transh" and meta["weights_shape"] == [8, 16]

    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "16", "--method", "1",
              "--eval-batch", "64", "--eval-block", "32"]
    want = _metric_lines(_run(jax_eval_transh.main, common)[0])
    got = _metric_lines(_run(eval_transh.main, common + ["--device", "cpu"])[0])
    assert len(want) == 4 and got == want


def test_transh_entry_points_raise_without_cuda_unless_the_cpu_is_asked_for(tiny_kg_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "4", "--epochs", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_transh.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_transh.main(argv[:6])
