"""kb2e_tpu_torch's link-prediction eval against kb2e_tpu's.

The same parameters go through both harnesses: dyadic tables (every float sum
exact) for ``evaluate``, and files written by kb2e_tpu's ``train_transe`` for
the ``eval_transe`` command lines.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu.cli import eval_transe as jax_eval_transe
from kb2e_tpu.cli import train_transe as jax_train_transe
from kb2e_tpu.config import EmbeddingConfig as JConfig
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.eval import harness as jax_harness
from kb2e_tpu.models import get_model as jax_get_model
from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval_transe
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness

torch.set_num_threads(1)


def _dyadic_params(n_ent, n_rel, k, seed):
    rng = np.random.default_rng(seed)
    return {
        "entity": (np.round(rng.normal(size=(n_ent, k)) * 4) / 8).astype(np.float32),
        "relation": (np.round(rng.normal(size=(n_rel, k)) * 4) / 8).astype(np.float32),
    }


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_evaluate_metrics_equal_jax(tiny_kg_dir, tiny_dataset, distance):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    host = _dyadic_params(dataset.n_entities, dataset.n_relations, 12, seed=int(distance) + 3)
    # 240 queries in batches of 64 (the last short); 64 entities in blocks of 24.
    knobs = dict(embedding_size=12, eval_batch_size=64, eval_block_size=24)
    want = jax_harness.evaluate(
        jax_get_model("transe"), {k: jnp.asarray(v) for k, v in host.items()}, tiny_dataset,
        JConfig(distance=JDistance(int(distance)), **knobs),
    )
    got = harness.evaluate(
        get_model("transe"), params_from_numpy(host, "cpu"), dataset,
        EmbeddingConfig(distance=distance, **knobs), device="cpu",
    )
    assert got == want  # every metric, to the last bit
    assert got["num_corruptions"] == 2 * dataset.test[0].shape[0]
    assert got["filtered_mean_rank"] < got["raw_mean_rank"]  # the filter does remove some


def _stdout_of(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _metric_lines(out: str):
    return [line for line in out.splitlines() if "-- " in line]


@pytest.mark.parametrize("distance", ["0", "1"])
def test_eval_transe_cli_prints_jax_lines_on_jax_trained_files(tiny_kg_dir, tmp_path, distance):
    out_dir = str(tmp_path / "out")
    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "16", "--method", "1",
              "--distance", distance, "--seed", "7", "--eval-batch", "64", "--eval-block", "32"]
    _stdout_of(jax_train_transe.main, common + ["--rate", "0.02", "--batches", "4", "--epochs", "3"])
    want = _metric_lines(_stdout_of(jax_eval_transe.main, common))
    got = _metric_lines(_stdout_of(eval_transe.main, common + ["--device", "cpu"]))
    assert [line.split(" --")[0] for line in want] == [
        "Raw     ", "Filtered", "Raw extended", "Filtered extended"
    ]
    assert got == want


def test_default_device_raises_without_cuda(tiny_kg_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    params = params_from_numpy(_dyadic_params(dataset.n_entities, dataset.n_relations, 4, seed=0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.evaluate(get_model("transe"), params, dataset, EmbeddingConfig(embedding_size=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_transe.main(["--datadir", tiny_kg_dir, "--outdir", "unused", "--size", "4"])
