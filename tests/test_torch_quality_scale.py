"""The scale-quality recipe through both packages on the CPU, at a reduced scale.

``chip_smoke.py --quality-scale`` runs ``benchmarks/quality_fb15k_scale.py``'s
protocol on the port at FB15k's shape.  Here the same recipe (TransE, bern,
L1, K = 1 at lr 0.02 and K = 8 at lr 0.02 / 8) runs at QUALITY.md's size: a
planted KG of 600 entities, 24 relations and 20,000 drawn triples, k 32, 16
batches, EPOCHS epochs.  kb2e_tpu trains with ``train_loop.train`` and scores
with ``harness.evaluate``; the port through ``cli.train_transe`` and
``cli.eval_transe --device cpu`` on the written files.

The two packages draw differently (ROADMAP D5), so their metrics agree only
within a tolerance.  At 5 epochs, seeds 5 and 6 gave filtered Hits@10 of
0.3552 / 0.3694 and 0.3658 / 0.3699 at K = 1 and 0.5432 / 0.5337 and
0.5562 / 0.5478 at K = 8 (kb2e_tpu / port): at most 0.0142 apart, so
HITS_TOL = 0.04 is near three times the largest gap.  K = 8 led K = 1 by
0.16-0.19 in both packages; the test asks for more than 0.1 at each
seed.  Chance is 10 / 600.
"""

import contextlib
import io

import pytest
import torch

from kb2e_tpu.config import EmbeddingConfig as JaxConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.constants import Method as JMethod
from kb2e_tpu.data import triples as jax_triples
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu.train import loop as jax_loop
from kb2e_tpu_torch.cli import eval as eval_cli
from kb2e_tpu_torch.cli import train as train_cli
from kb2e_tpu_torch.data import synthetic

torch.set_num_threads(1)

KG = (600, 24, 20_000, 11)
SIZE, BATCHES, EPOCHS = 32, 16, 5
SEEDS = (5, 6)
RECIPES = {1: 0.02, 8: 0.02 / 8}  # negatives K -> learning rate
HITS_TOL = 0.04
CHANCE = 10 / KG[0]


def _port(kg: str, out: str, k_neg: int, seed: int) -> dict:
    flags = ["--datadir", kg, "--outdir", out, "--size", str(SIZE), "--method", "1", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main([*flags, "--rate", str(RECIPES[k_neg]), "--margin", "1", "--batches", str(BATCHES),
                        "--epochs", str(EPOCHS), "--seed", str(seed), "--negatives", str(k_neg)], model_name="transe")
        return eval_cli.main(flags, model_name="transe")


def _jax(dataset, k_neg: int, seed: int) -> dict:
    cfg = JaxConfig(embedding_size=SIZE, learning_rate=RECIPES[k_neg], margin=1.0, method=JMethod.BERN,
                    num_batches=BATCHES, max_epochs=EPOCHS, distance=JDistance.L1, seed=seed, num_negatives=k_neg)
    model = jax_get_model("transe")
    params = jax_loop.train(model, cfg, dataset.train, verbose=False)
    return jax_harness.evaluate(model, params, dataset, cfg)


@pytest.fixture(scope="module")
def hits(tmp_path_factory):
    """Filtered Hits@10 by (package, K, seed)."""
    n_ent, n_rel, n_triples, seed = KG
    kg = str(tmp_path_factory.mktemp("planted"))
    synthetic.write_kg_dir(kg, synthetic.planted_kg(n_ent, n_rel, n_triples, seed=seed), n_ent, n_rel, seed=seed)
    dataset = jax_triples.load_dataset(kg, splits=("train", "valid", "test"), use_native=False)
    out = {}
    for s in SEEDS:
        for k_neg in RECIPES:
            out["jax", k_neg, s] = _jax(dataset, k_neg, s)["filtered_hits10"]
            out["port", k_neg, s] = _port(kg, str(tmp_path_factory.mktemp(f"port_{k_neg}_{s}")), k_neg, s)[
                "filtered_hits10"]
    return out


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("seed", SEEDS)
def test_eight_negatives_land_far_above_chance(hits, package, seed):
    assert hits[package, 8, seed] > 20 * CHANCE


@pytest.mark.parametrize("k_neg", list(RECIPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_port_lands_within_the_tolerance_of_jax(hits, k_neg, seed):
    assert abs(hits["port", k_neg, seed] - hits["jax", k_neg, seed]) <= HITS_TOL


@pytest.mark.parametrize("package", ["jax", "port"])
def test_eight_negatives_beat_one_in_both_packages(hits, package):
    gains = [hits[package, 8, s] - hits[package, 1, s] for s in SEEDS]
    assert min(gains) > 0.1, gains
