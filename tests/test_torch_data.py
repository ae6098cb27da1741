"""kb2e_tpu_torch against kb2e_tpu: data, text IO, config, ops, init, imports.

Inputs are made with numpy from a seed and handed to both packages.
"""

import ast
import dataclasses
import filecmp
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu import config as jax_config
from kb2e_tpu.cli import common as jax_common
from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.data import synthetic as jax_synthetic
from kb2e_tpu.data import triples as jax_triples
from kb2e_tpu.io import text as jax_text
from kb2e_tpu.ops import distances as jax_distances
from kb2e_tpu.ops import projections as jax_projections
from kb2e_tpu_torch import get_model
from kb2e_tpu_torch.cli import common as port_common
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance, Method
from kb2e_tpu_torch.convert import params_from_numpy, params_to_numpy
from kb2e_tpu_torch.data import synthetic as port_synthetic
from kb2e_tpu_torch.data import triples as port_triples
from kb2e_tpu_torch.io import text as port_text
from kb2e_tpu_torch.ops import distances, projections

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_dataset_loads_alike(tiny_kg_dir):
    j = jax_triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"), use_native=False)
    p = port_triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    assert p.entity2id == j.entity2id and p.relation2id == j.relation2id
    for name in ("heads", "tails", "rels", "sorted_h", "sorted_r", "sorted_t", "bern_pr_tail"):
        np.testing.assert_array_equal(getattr(p.train, name), getattr(j.train, name), err_msg=name)
    for split in ("valid", "test"):
        for a, b in zip(getattr(p, split), getattr(j, split)):
            np.testing.assert_array_equal(a, b)
    # The eval filter index (train + valid + test) is sorted and deduplicated alike.
    jf = jax_triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"),
                                  filter_with_eval_splits=True, use_native=False)
    pf = port_triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"), filter_with_eval_splits=True)
    for name in ("sorted_h", "sorted_r", "sorted_t"):
        np.testing.assert_array_equal(getattr(pf.train, name), getattr(jf.train, name))


def test_synthetic_directory_is_byte_identical(tmp_path):
    triples = port_synthetic.random_kg(50, 6, 400, seed=3)
    for a, b in zip(triples, jax_synthetic.random_kg(50, 6, 400, seed=3)):
        np.testing.assert_array_equal(a, b)
    port_synthetic.write_kg_dir(str(tmp_path / "p"), triples, 50, 6, seed=3)
    jax_synthetic.write_kg_dir(str(tmp_path / "j"), triples, 50, 6, seed=3)
    names = ["entity2id.txt", "relation2id.txt", "train.txt", "valid.txt", "test.txt"]
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "p", tmp_path / "j", names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_embedding_files_byte_identical_and_cross_load(tmp_path, writer):
    rng = np.random.default_rng(5)
    ent = rng.normal(size=(30, 7)).astype(np.float32)
    rel = rng.normal(size=(4, 7)).astype(np.float32)
    # The port writes host copies of its tensors; kb2e_tpu its jax arrays.
    host = params_to_numpy(params_from_numpy({"entity": ent, "relation": rel}, "cpu"))
    port_text.write_embeddings(str(tmp_path / "p"), Method.BERN, host["entity"], host["relation"], model_name="transe")
    jax_text.write_embeddings(str(tmp_path / "j"), 1, np.asarray(jnp.asarray(ent)), np.asarray(jnp.asarray(rel)),
                              model_name="transe")
    names = ["entity2vec.bern", "relation2vec.bern", "embedding_meta.json"]
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "p", tmp_path / "j", names, shallow=False)
    assert not mismatch and not errors

    src = tmp_path / ("p" if writer == "port" else "j")
    back_port = port_text.read_embeddings(str(src), Method.BERN, 30, 4, 7)
    back_jax = jax_text.read_embeddings(str(src), 1, 30, 4, 7)
    for name in ("entity", "relation"):
        np.testing.assert_array_equal(back_port[name], back_jax[name])
    np.testing.assert_allclose(back_port["entity"], ent, atol=1e-6)
    with pytest.raises(ValueError, match="--size"):
        port_text.read_embeddings(str(src), Method.BERN, 30, 4, 8)
    assert port_text.entity_norm_warnings(back_port["entity"]) == jax_text.entity_norm_warnings(back_jax["entity"])


def test_flags_parse_to_the_same_config():
    argv = ["--datadir", "d", "--outdir", "o", "--size", "16", "-rate", "0.02", "--margin", "2",
            "--method", "unif", "--batches", "8", "--epochs", "3", "--distance", "1", "--seed", "7",
            "--eval-batch", "64", "--eval-block", "16", "--negatives", "2", "--dtype", "bfloat16",
            "--path-comp", "rnn", "--max-paths", "4"]
    p_args = port_common.build_parser("p", "").parse_args(argv + ["--device", "cpu"])
    j_args = jax_common.build_parser("j", "").parse_args(argv)
    assert p_args.device == "cpu"
    port_cfg = dataclasses.asdict(port_common.config_from_args(p_args))
    jax_cfg = dataclasses.asdict(jax_common.config_from_args(j_args))
    assert port_cfg == jax_cfg
    assert [f.name for f in dataclasses.fields(EmbeddingConfig)] == [
        f.name for f in dataclasses.fields(jax_config.EmbeddingConfig)
    ]
    assert port_common.build_parser("p", "").parse_args([]).device == "cuda"


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_distances_and_projections_match_jax(distance):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(40, 9)) * 0.6).astype(np.float32)
    np.testing.assert_allclose(
        projections.row_norms(torch.from_numpy(x)).numpy(), np.asarray(jax_projections.row_norms(jnp.asarray(x))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        projections.ball_norm(torch.from_numpy(x)).numpy(), np.asarray(jax_projections.ball_norm(jnp.asarray(x))),
        rtol=1e-6,
    )
    res = rng.normal(size=(13, 9)).astype(np.float32)
    np.testing.assert_allclose(
        distances.residual_energy(torch.from_numpy(res), distance).numpy(),
        np.asarray(jax_distances.residual_energy(jnp.asarray(res), JDistance(int(distance)))),
        rtol=1e-6,
    )
    # Dyadic inputs: exact whatever the summation order.
    ent = (np.round(rng.normal(size=(50, 9)) * 8) / 8).astype(np.float32)
    q = (np.round(rng.normal(size=(6, 9)) * 8) / 8).astype(np.float32)
    np.testing.assert_array_equal(
        distances.pairwise_energy(torch.from_numpy(ent), torch.from_numpy(q), distance).numpy(),
        np.asarray(jax_distances.pairwise_energy(jnp.asarray(ent), jnp.asarray(q), JDistance(int(distance)))),
    )


def test_transe_init_is_seeded_and_ball_normed():
    model = get_model("transe")
    cfg = EmbeddingConfig(embedding_size=16)
    a = model.init_params(torch.Generator().manual_seed(3), 500, 7, cfg, "cpu")
    b = model.init_params(torch.Generator().manual_seed(3), 500, 7, cfg, "cpu")
    c = model.init_params(torch.Generator().manual_seed(4), 500, 7, cfg, "cpu")
    assert a["entity"].shape == (500, 16) and a["relation"].shape == (7, 16)
    assert torch.equal(a["entity"], b["entity"]) and not torch.equal(a["entity"], c["entity"])
    assert float(projections.row_norms(a["entity"]).max()) <= 1.0 + 1e-6
    # randn(0, 1/k, ±6/√k): at k = 16 the bound is 24σ away, so a plain normal.
    std = float(a["entity"].std())
    assert abs(std - 1 / 16) < 0.005, std
    bf = model.init_params(torch.Generator().manual_seed(3), 5, 2, cfg.replace(param_dtype="bfloat16"), "cpu")
    assert bf["entity"].dtype == torch.bfloat16


def test_transe_energy_matches_jax():
    from kb2e_tpu.models import get_model as jax_get_model

    rng = np.random.default_rng(2)
    ent = rng.normal(size=(20, 6)).astype(np.float32)
    rel = rng.normal(size=(3, 6)).astype(np.float32)
    h, t, r = (rng.integers(0, n, 15) for n in (20, 20, 3))
    for d in (Distance.L1, Distance.L2):
        got = get_model("transe").energy(params_from_numpy({"entity": ent, "relation": rel}, "cpu"),
                                         torch.from_numpy(h), torch.from_numpy(t), torch.from_numpy(r), d)
        want = jax_get_model("transe").energy({"entity": jnp.asarray(ent), "relation": jnp.asarray(rel)},
                                              jnp.asarray(h), jnp.asarray(t), jnp.asarray(r), JDistance(int(d)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_convert_round_trip_keeps_dtype():
    arrays = {"entity": np.arange(6, dtype=np.float32).reshape(2, 3), "ids": np.arange(4, dtype=np.int32)}
    tensors = params_from_numpy(arrays, "cpu")
    assert tensors["ids"].dtype == torch.int32
    back = params_to_numpy(tensors)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_kb2e_tpu():
    files = sorted((ROOT / "kb2e_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "kb2e_tpu")
    ]
    assert not bad, bad
