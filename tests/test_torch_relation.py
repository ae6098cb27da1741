"""kb2e_tpu_torch's relation prediction against kb2e_tpu's.

``harness.evaluate_relation_prediction`` ranks each test triple's relation
among all R by E(h, r′, t) (``Model.relation_scores``), with the filter over
train ∪ valid ∪ test.  On dyadic tables every score is exact in float32 in
both packages, so the ranks and every metric, MRR included, must be equal to
the last bit, for each ported model.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu.cli import eval_transe as jax_eval_transe
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.constants import Method as JMethod
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.io import text as jax_text
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval as eval_cli
from kb2e_tpu_torch.cli import eval_transe
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness

torch.set_num_threads(1)

MODELS = ("transe", "transh", "transr", "ctransr")


def _dyadic(model, n_ent, n_rel, k, seed):
    """The model's tables as multiples of 1/8 in [-1, 1]: every score is exact
    in float32, in any order."""
    rng = np.random.default_rng(seed)

    def dy(*shape):
        return np.clip(np.round(rng.normal(size=shape) * 3) / 8, -1, 1).astype(np.float32)

    host = {"entity": dy(n_ent, k), "relation": dy(n_rel, k)}
    if model == "transh":
        host["norm"] = dy(n_rel, k)
    if model in ("transr", "ctransr"):
        host["proj"] = dy(n_rel, k, k)
    if model == "ctransr":
        host["relation_c"], host["centers"] = dy(n_rel, 4, k), dy(n_rel, 4, k)
    return host


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("model", MODELS)
def test_relation_prediction_equals_jax_exactly(tiny_kg_dir, tiny_dataset, model, distance):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic(model, dataset.n_entities, dataset.n_relations, 8, seed=3 + int(distance))
    knobs = dict(embedding_size=8, eval_batch_size=48, distance=int(distance))  # 120 triples: the last batch short
    want = jax_harness.evaluate_relation_prediction(
        jax_get_model(model), {k: jnp.asarray(v) for k, v in host.items()}, tiny_dataset, JConfig(**knobs))
    got = harness.evaluate_relation_prediction(get_model(model), params_from_numpy(host, "cpu"), dataset,
                                               EmbeddingConfig(**knobs), device="cpu")
    assert got == want  # every metric, MRR and Hits@1 included, to the last bit
    assert got["num_corruptions"] == dataset.test[0].shape[0]
    assert got["filtered_mean_rank"] <= got["raw_mean_rank"]


@pytest.mark.parametrize("model", MODELS)
def test_relation_scores_equal_jax_energy_per_pair_and_relation(model):
    # The scores of every (pair, r') in slices of R, against the JAX
    # package's energy on the repeated rows; slices of one and of three
    # relations give the same scores as all at once.
    n_ent, n_rel, k = 30, 7, 8
    host = _dyadic(model, n_ent, n_rel, k, seed=11)
    rng = np.random.default_rng(12)
    h, t = rng.integers(0, n_ent, 9), rng.integers(0, n_ent, 9)
    want = jax_get_model(model).energy({key: jnp.asarray(v) for key, v in host.items()}, jnp.repeat(h, n_rel),
                                       jnp.repeat(t, n_rel), jnp.tile(jnp.arange(n_rel), 9), JDistance.L2)
    m, params = get_model(model), params_from_numpy(host, "cpu")
    for width in (n_rel, 3, 1):
        got = torch.cat([m.relation_scores(params, torch.from_numpy(h), torch.from_numpy(t), slice(r0, r0 + width),
                                           Distance.L2) for r0 in range(0, n_rel, width)], dim=1)
        assert got.shape == (9, n_rel)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(9, n_rel))


def test_relation_prediction_in_slices_of_r_gives_the_same_metrics(tiny_kg_dir, monkeypatch):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic("transr", dataset.n_entities, dataset.n_relations, 8, seed=5)
    cfg = EmbeddingConfig(embedding_size=8, eval_batch_size=48)
    whole = harness.evaluate_relation_prediction(get_model("transr"), params_from_numpy(host, "cpu"), dataset, cfg,
                                                 device="cpu")
    # Slices of 3 relations: 48 queries x 3 relations x k 8 x 4 bytes.
    monkeypatch.setattr(harness, "RELATION_SLICE_BYTES", 48 * 3 * 8 * 4)
    assert harness.evaluate_relation_prediction(get_model("transr"), params_from_numpy(host, "cpu"), dataset, cfg,
                                                device="cpu") == whole


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def test_eval_transe_task_relation_prints_jax_lines(tiny_kg_dir, tmp_path):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic("transe", dataset.n_entities, dataset.n_relations, 8, seed=7)
    out_dir = str(tmp_path / "out")
    jax_text.write_embeddings(out_dir, JMethod.BERN, host["entity"], host["relation"], model_name="transe")
    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--method", "1", "--task", "relation"]
    want = [line for line in _run(jax_eval_transe.main, common).splitlines() if line.startswith("Relation ")]
    got = [line for line in _run(eval_transe.main, common + ["--device", "cpu"]).splitlines()
           if line.startswith("Relation ")]
    assert len(want) == 3 and got == want  # the progress line and the two metric lines
    assert got[1].startswith("Relation Raw      -- Rank: ") and ", Hits@1: " in got[2]


def test_ptranse_raises_naming_its_queue_item(tiny_kg_dir, tmp_path):
    """PTransE's queue item (ROADMAP.md Queue 1 item 5) is done: ``--model
    ptranse`` no longer raises, and both tasks run on TransE-format files
    (no relation_inv: relation prediction then scores without evidence)."""
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic("transe", dataset.n_entities, dataset.n_relations, 4, seed=9)
    jax_text.write_embeddings(str(tmp_path), JMethod.BERN, host["entity"], host["relation"], model_name="transe")
    # A fixed seed: the default is the wall clock, and the two outputs
    # compared whole both print it in their Options line.
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "4", "--seed", "3", "--device", "cpu"]
    for task in ("relation", "entity"):
        got = _run(eval_cli.main, argv + ["--model", "ptranse", "--task", task])
        want = _run(eval_cli.main, argv + ["--model", "transe", "--task", task])
        assert got == want and "-- Rank: " in got
    metrics = eval_cli.run_eval("ptranse", EmbeddingConfig(data_dir=tiny_kg_dir, output_dir=str(tmp_path),
                                                           embedding_size=4), task="relation", device="cpu")
    assert metrics["num_corruptions"] == dataset.test[0].shape[0]
