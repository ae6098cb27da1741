"""kb2e_tpu_torch against kb2e_tpu: data, text IO, config, ops, init, imports.

Inputs are made with numpy from a seed and handed to both packages.
"""

import ast
import concurrent.futures
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
from kb2e_tpu_torch.data import native as port_native
from kb2e_tpu_torch.data import synthetic as port_synthetic
from kb2e_tpu_torch.data import triples as port_triples
from kb2e_tpu_torch.data import vocab as port_vocab
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


def test_native_loader_gives_the_python_loaders_arrays(tiny_kg_dir):
    # g++ is on this machine: a failed build here is a fault, not a skip.
    assert port_native.available()
    e2i = port_vocab.load_id_file(str(pathlib.Path(tiny_kg_dir) / "entity2id.txt"))
    r2i = port_vocab.load_id_file(str(pathlib.Path(tiny_kg_dir) / "relation2id.txt"))
    for split in ("train", "valid", "test"):
        path = str(pathlib.Path(tiny_kg_dir) / f"{split}.txt")
        for got, want in zip(port_native.load_triple_file(path, e2i, r2i),
                             port_triples.load_triple_file(path, e2i, r2i)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    native = port_triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))
    python = port_triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"), use_native=False)
    for name in ("heads", "tails", "rels", "sorted_h", "sorted_r", "sorted_t", "bern_pr_tail"):
        np.testing.assert_array_equal(getattr(native.train, name), getattr(python.train, name), err_msg=name)
    for split in ("valid", "test"):
        for a, b in zip(getattr(native, split), getattr(python, split)):
            np.testing.assert_array_equal(a, b)


def test_native_loader_skips_unknown_names(tmp_path, capfd):
    (tmp_path / "entity2id.txt").write_text("a\t0\nb\t1\n")
    (tmp_path / "relation2id.txt").write_text("likes\t0\n")
    (tmp_path / "train.txt").write_text("a\tb\tlikes\nzzz\tb\tlikes\nb\ta\tknows\n")
    h, t, r = port_native.load_triple_file(str(tmp_path / "train.txt"), {"a": 0, "b": 1}, {"likes": 0})
    assert h.tolist() == [0] and t.tolist() == [1] and r.tolist() == [0]
    err = capfd.readouterr().err
    assert "not found in the identity file: zzz" in err and "not found in the identity file: knows" in err
    (tmp_path / "empty.txt").write_text("")
    assert [a.shape for a in port_native.load_triple_file(str(tmp_path / "empty.txt"), {}, {})] == [(0,)] * 3


def test_native_builds_land_whole_under_a_hashed_name(tmp_path):
    # Processes that build at the same moment each compile to a file of their
    # own and move it into place: every caller gets a whole library.
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        paths = list(pool.map(lambda _: port_native.build(build_dir=tmp_path), range(3)))
    assert len(set(paths)) == 1 and paths[0] == port_native.library_path(build_dir=tmp_path)
    assert paths[0].name.startswith("libkb2e_io_") and [p.name for p in tmp_path.iterdir()] == [paths[0].name]


def test_a_failed_native_build_says_why_once_and_falls_back(tiny_kg_dir, monkeypatch, capsys):
    def fail(*args, **kwargs):
        raise OSError("g++: not found")

    monkeypatch.setattr(port_native, "build", fail)
    port_native._library.cache_clear()
    try:
        got = [port_triples.load_dataset(tiny_kg_dir, splits=("train", "test")) for _ in range(2)]
        assert not port_native.available()
    finally:
        port_native._library.cache_clear()
    err = capsys.readouterr().err
    assert err.count("kb2e_io: native loader unavailable (g++: not found); using the Python loader") == 1
    want = port_triples.load_dataset(tiny_kg_dir, splits=("train", "test"), use_native=False)
    for ds in got:
        for a, b in zip(ds.test, want.test):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ds.train.heads, want.train.heads)


def test_synthetic_directory_is_byte_identical(tmp_path):
    triples = port_synthetic.random_kg(50, 6, 400, seed=3)
    for a, b in zip(triples, jax_synthetic.random_kg(50, 6, 400, seed=3)):
        np.testing.assert_array_equal(a, b)
    port_synthetic.write_kg_dir(str(tmp_path / "p"), triples, 50, 6, seed=3)
    jax_synthetic.write_kg_dir(str(tmp_path / "j"), triples, 50, 6, seed=3)
    names = ["entity2id.txt", "relation2id.txt", "train.txt", "valid.txt", "test.txt"]
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "p", tmp_path / "j", names, shallow=False)
    assert not mismatch and not errors


def test_skewed_kg_equals_jax_for_one_seed():
    # tests/test_data.py's size: the port keeps its own copy of the generator.
    got = port_synthetic.skewed_kg(2000, 24, 12000, seed=3)
    want = jax_synthetic.skewed_kg(2000, 24, 12000, seed=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    n = got[2].shape[0]
    assert n > 6000 and np.bincount(got[2]).max() > 2 * n / 24  # the top relation is far above the mean


# planted_kg's two branches: the float64 norm below 4,001 entities
# (QUALITY.md's graph), the float32 matmul expansion above (FB15k's 14,951
# entities in chip_smoke.py's scale protocol; here five chunks of 2,048
# triples, searched on threads).
@pytest.mark.parametrize("shape", [(600, 24, 4_000, 11), (4_500, 40, 9_000, 11)], ids=["small", "float32 large"])
def test_planted_kg_equals_jax_bit_for_bit(shape):
    n_ent, n_rel, n_triples, seed = shape
    got = port_synthetic.planted_kg(n_ent, n_rel, n_triples, seed=seed)
    want = jax_synthetic.planted_kg(n_ent, n_rel, n_triples, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] > 0.9 * n_triples


@pytest.mark.parametrize("n", [4_000, 482_426, 21])
def test_split_in_order_is_the_scale_scripts_slicing(n):
    # benchmarks/quality_fb15k_scale.py:56-73, restated: n_test = int(n * 0.05),
    # n_valid = n_test; train the first n - n_valid - n_test triples, then
    # valid, then test.
    h, t, r = (np.arange(n, dtype=np.int32) + off for off in (0, 7, 11))
    n_test = int(n * 0.05)
    n_valid = n_test
    want = ((h[: n - n_valid - n_test], t[: n - n_valid - n_test], r[: n - n_valid - n_test]),
            (h[n - n_valid - n_test : n - n_test], t[n - n_valid - n_test : n - n_test],
             r[n - n_valid - n_test : n - n_test]),
            (h[n - n_test :], t[n - n_test :], r[n - n_test :]))
    got = port_synthetic.split_in_order((h, t, r), test_frac=0.05)
    for got_split, want_split in zip(got, want):
        for a, b in zip(got_split, want_split):
            np.testing.assert_array_equal(a, b)


def test_split_directory_loads_as_the_scale_scripts_dataset(tmp_path):
    triples = port_synthetic.planted_kg(600, 24, 4_000, seed=11)
    train, valid, test = port_synthetic.split_in_order(triples)
    port_synthetic.write_split_dir(str(tmp_path), train, valid, test, 600, 24)
    ds = jax_triples.load_dataset(str(tmp_path), splits=("train", "valid", "test"), use_native=False)
    assert (ds.n_entities, ds.n_relations) == (600, 24)
    for name, split in (("valid", valid), ("test", test)):
        for a, b in zip(getattr(ds, name), split):
            np.testing.assert_array_equal(a, b)
    for a, b in zip((ds.train.heads, ds.train.tails, ds.train.rels), train):
        np.testing.assert_array_equal(a, b)


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
