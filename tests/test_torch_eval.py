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
from kb2e_tpu_torch.ops import distances, rank_count

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


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_rank_all_computes_e_sq_once_per_group_and_equals_jax(tiny_kg_dir, tiny_dataset, distance, monkeypatch):
    # TransR ranks in one group per relation, through the distance flag.
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    rng = np.random.default_rng(12 + int(distance))
    k = 8

    def dy(shape):  # multiples of 1/8 in [-1, 1]: the projection and both energies are exact
        return np.clip(np.round(rng.normal(size=shape) * 3) / 8, -1, 1).astype(np.float32)

    host = {"entity": dy((dataset.n_entities, k)), "relation": dy((dataset.n_relations, k)),
            "proj": dy((dataset.n_relations, k, k))}
    knobs = dict(embedding_size=k, eval_batch_size=16, eval_block_size=24, distance=int(distance))
    calls = []
    counts = rank_count.rank_counts

    def spy(proj_t, queries_t, e_true, true_idx, dist, block_size=4096, e_sq=None):
        calls.append((proj_t, e_sq))
        return counts(proj_t, queries_t, e_true, true_idx, dist, block_size, e_sq=e_sq)

    monkeypatch.setattr(rank_count, "rank_counts", spy)
    got = harness.evaluate(get_model("transr"), params_from_numpy(host, "cpu"), dataset, EmbeddingConfig(**knobs),
                           device="cpu")
    want = jax_harness.evaluate(
        jax_get_model("transr"), {name: jnp.asarray(v) for name, v in host.items()}, tiny_dataset, JConfig(**knobs)
    )
    assert got == want  # every metric, to the last bit
    rels = np.bincount(dataset.test[2])
    assert len(calls) == int(sum(-(-2 * int(c) // 16) for c in rels))
    tables = {id(proj_t): e_sq for proj_t, e_sq in calls}
    assert len(tables) == int((rels > 0).sum()) > 1  # one table per group, several groups
    for proj_t, e_sq in calls:
        assert rank_count.kernel_takes(proj_t)
        if distance == Distance.L1:
            assert e_sq is None
        else:  # the group's one ‖e‖², passed to each of its batches
            assert e_sq is tables[id(proj_t)] and torch.equal(e_sq, distances.squared_norms(proj_t.contiguous()))


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
