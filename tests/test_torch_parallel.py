"""kb2e_tpu_torch's distributed step and entity-sharded eval against one rank and against kb2e_tpu's mesh.

One gloo world of four CPU ranks starts once for the module: four
subprocesses that run this file's ``_rank_main`` (it imports no JAX) under one
deadline, killed when it runs out.  They compute every multi-rank case and
pickle what each rank got; the tests then hold it, in this process, against

* the port's one-rank function on the same inputs: the sharded eval's ranks
  and metrics exactly (model axes 2 and 3, so the shards are uneven; TransR's
  and CTransR's per-relation tables cut as placed, 8 relations over 3 ranks
  included); the distributed step (meshes (2, 1) and (1, 2) for every model,
  (2, 2) for TransE) bit for bit for one step on dyadic tables with a dyadic
  learning rate, and within atol 2e-6 (loss rel 1e-5) on init tables and over
  a 4-batch epoch of the runner: ``tests/test_parallel.py``'s bounds; the
  whole tables ``gather_params`` assembles; a (1, 2) run resumed from its
  checkpoint; the eval CLI's lines at model axes 2 and 4;
* kb2e_tpu's ``harness.evaluate(mesh=...)`` over a mesh of the same shape,
  and its multihost merge, exactly.
"""

import contextlib
import io
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.constants import Distance, Method
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import paths as paths_lib
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.io import checkpoint as ckpt_lib
from kb2e_tpu_torch.io import text
from kb2e_tpu_torch.models import ctransr
from kb2e_tpu_torch.ops import distances, rank_count
from kb2e_tpu_torch.parallel import eval as par_eval
from kb2e_tpu_torch.parallel import mesh as mesh_lib
from kb2e_tpu_torch.parallel import multihost, sharding
from kb2e_tpu_torch.train import loop
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DEADLINE_S = 240
N_ENT, N_REL, K, B = 64, 8, 16, 32
LR = 1.0 / 64
MODELS = ("transe", "transh", "transr", "ctransr", "ptranse")
STEP_CASES = [(m, mesh) for m in MODELS for mesh in ((2, 1), (1, 2))] + [("transe", (2, 2))]
# (model, distance): PTransE's entity eval is TransE's; TransH ignores the flag.
EVAL_CASES = [("transe", 0), ("transe", 1), ("transh", 0), ("transr", 0), ("transr", 1), ("ctransr", 0),
              ("ctransr", 1), ("ptranse", 0)]
EVAL_AXES = (2, 3)
CUT_MODELS = ("transr", "ctransr")  # the models with relation-cut tables
# (model axis, distance) of the eval CLI over the world: meshes (2, 2) and (1, 4).
CLI_CASES = ((2, 0), (4, 1))
EVAL_KNOBS = dict(embedding_size=K, eval_batch_size=64, eval_block_size=24)
# The shard-boundary case: 24 entities over a model axis of 3 (rows 0-7,
# 8-15, 16-23); rows TIED share one vector, so each query's true entity
# ties exactly with rows below and above it, on its own rank and on others.
TIE_N, TIED, TIE_TRUE = 24, (2, 5, 11, 13, 17, 20), (2, 11, 20, 13)


# --- inputs, made the same way in the ranks and here ----------------------------

def _triple_set():
    rng = np.random.default_rng(0)
    h, t, r = (rng.integers(0, n, 400).astype(np.int32) for n in (N_ENT, N_ENT, N_REL))
    return triples.TripleSet.from_arrays(h, t, r, n_entities=N_ENT, n_relations=N_REL)


def _cfg(**kw):
    return EmbeddingConfig(**{**dict(embedding_size=K, learning_rate=LR, margin=1.0, method=Method.BERN,
                                     distance=Distance.L1, seed=0), **kw})


def _path_store(ts):
    """A PCRA store of ``ts`` with its confidences rounded to eighths: every
    path term and gradient is then exact."""
    store = paths_lib.build_path_store(ts.heads, ts.tails, ts.rels, ts.n_relations, max_paths=4, use_native=False)
    return store._replace(conf=(np.round(store.conf * 8) / 8).astype(np.float32))


def _data(model, ts):
    return step_lib.DeviceData.from_triple_set(ts, "cpu", path_store=_path_store(ts) if model.uses_paths else None)


def _dyadic_tables(model_name, n_ent, n_rel, seed):
    """Multiples of 1/16: entity rows of norm at most 1 (so the ball norm of a
    row the batch does not touch is the identity), relation-space tables
    small, TransR's matrices near the identity."""
    rng = np.random.default_rng(seed)

    def dy(*shape, lim=0.25):
        return np.clip(np.round(rng.normal(size=shape) * 2) / 16, -lim, lim).astype(np.float32)

    host = {"entity": dy(n_ent, K), "relation": dy(n_rel, K)}
    if model_name == "transh":
        host["norm"] = dy(n_rel, K)
    if model_name in ("transr", "ctransr"):
        host["proj"] = (np.eye(K, dtype=np.float32) + dy(n_rel, K, K, lim=0.125)).astype(np.float32)
    if model_name == "ctransr":
        host["relation_c"] = dy(n_rel, ctransr.DEFAULT_NUM_CLUSTERS, K)
        host["centers"] = dy(n_rel, ctransr.DEFAULT_NUM_CLUSTERS, K, lim=0.5)
    if model_name == "ptranse":
        host["relation_inv"] = dy(n_rel, K)
    return host


def _init_tables(model_name, ts):
    model = get_model(model_name)
    params = model.init_params(torch.Generator().manual_seed(1), N_ENT, N_REL, _cfg(), "cpu")
    if model.cluster_aware:
        centers = ctransr.build_centers(params["entity"].numpy(), ts.heads, ts.tails, ts.rels, N_REL,
                                        model.n_clusters, seed=0)
        params = model.with_centers(params, centers)
    return {k: v.numpy() for k, v in params.items()}


def _step_inputs(kind, model_name, ts):
    """(tables, cfg) of a step case: 'dyadic' and 'init' run one step,
    'epoch' a 4-batch epoch of the runner on init tables."""
    if kind == "dyadic":
        return _dyadic_tables(model_name, N_ENT, N_REL, seed=MODELS.index(model_name)), _cfg()
    return _init_tables(model_name, ts), _cfg(learning_rate=0.02, num_batches=4)


def _single_step(kind, model_name, ts):
    """The port's one-device result of a step case: (tables, loss)."""
    model = get_model(model_name)
    host, cfg = _step_inputs(kind, model_name, ts)
    params, gen, data = params_from_numpy(host, "cpu"), torch.Generator().manual_seed(5), _data(model, ts)
    if kind == "epoch":
        out, loss = step_lib.make_epoch_runner(model, cfg, B, 4)(params, gen, data)
    else:
        out, loss = step_lib.make_train_step(model, cfg, B)(params, gen, data)
    return {k: v.numpy() for k, v in out.items()}, float(loss)


def _tie_inputs():
    rng = np.random.default_rng(9)
    ent = (np.round(rng.normal(size=(TIE_N, K)) * 8) / 8).astype(np.float32)
    ent[list(TIED)] = ent[TIED[0]]
    true_idx = np.array(TIE_TRUE, np.int32)
    queries = ent[true_idx] + (np.round(rng.normal(size=(true_idx.shape[0], K)) * 4) / 8).astype(np.float32)
    return ent, queries, true_idx


def _mesh_at(shape, r: int) -> mesh_lib.Mesh:
    """Rank ``r``'s place on a ``shape`` mesh, without its process groups."""
    return mesh_lib.Mesh({"data": shape[0], "model": shape[1]}, divmod(r, shape[1]), {"data": None, "model": None},
                         torch.device("cpu"))


def _held_rows(shape, r: int, host, n_entities: int):
    """The rows of each table that rank ``r`` of a ``shape`` mesh holds:
    its ``entity_rows``, its ``relation_rows`` of a relation-cut table, every
    row of a replicated one."""
    mesh = _mesh_at(shape, r)
    n_rel = host["relation"].shape[0]
    bounds = {key: mesh.relation_rows(n_rel) for key in sharding.RELATION_KEYS}
    bounds["entity"] = mesh.entity_rows(n_entities)
    held = {}
    for key, value in host.items():
        row0, row1 = bounds.get(key, (0, value.shape[0]))
        held[key] = row1 - row0
    return held


def _cli_argv(kg_dir: str, files: str, dist: int):
    return ["--datadir", kg_dir, "--outdir", files, "--size", str(K), "--method", "1", "--distance", str(dist),
            "--eval-batch", "64", "--eval-block", "24", "--seed", "1", "--device", "cpu"]


def _write_cli_files(kg_dir: str, files: str) -> None:
    """Dyadic TransR tables as eval_transr reads them (multiples of 1/16:
    the files' 6 decimals hold them exactly)."""
    dataset = triples.load_dataset(kg_dir, splits=("train",), use_native=False)
    host = _dyadic_tables("transr", dataset.n_entities, dataset.n_relations, seed=21)
    text.write_embeddings(files, Method.BERN, host["entity"], host["relation"], weights=host["proj"],
                          model_name="transr")


def _stdout_of(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _metric_lines(out: str):
    return [line for line in out.splitlines() if "-- " in line]


def _resume_case(model_name: str, ts, dataset, mesh, ckpt_dir: str):
    """A 2-epoch run over ``mesh``; the same run's first epoch, checkpointed
    with the valid eval on its (cut) tables; the run resumed from that
    checkpoint.  Returns (uninterrupted tables, resumed tables, valid metrics)."""
    model = get_model(model_name)
    cfg = _cfg(learning_rate=0.02, num_batches=4, max_epochs=2)
    valid = []

    def eval_fn(params):
        valid.append(harness.evaluate(model, params, dataset, EmbeddingConfig(**EVAL_KNOBS),
                                      test_triples=dataset.valid, mesh=mesh))
        return valid[-1]

    def run(cfg, **kw):
        init = params_from_numpy(_init_tables(model_name, ts), "cpu")
        out = loop.train(model, cfg, ts, init_params=init, device="cpu", mesh=mesh, **kw)
        return {k: v.numpy() for k, v in out.items()}

    whole = run(cfg)
    run(cfg.replace(max_epochs=1), checkpoint_dir=ckpt_dir, checkpoint_every=1, eval_every=1, eval_fn=eval_fn)
    return whole, run(cfg, checkpoint_dir=ckpt_dir, resume=True), valid


# --- the ranks -------------------------------------------------------------------

def _rank_main(rank: int, world: int, port: int, kg_dir: str, out_dir: str) -> None:
    """One rank of the module's gloo world: every multi-rank case, pickled to
    ``out_dir/rank<r>.pkl``."""
    from kb2e_tpu_torch.parallel import dist_step

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    got = {}
    try:
        mesh_lib.make_mesh(3, 1)
    except ValueError as exc:
        got["mismatch"] = str(exc)

    ts = _triple_set()
    dataset = triples.load_dataset(kg_dir, splits=("train", "valid", "test"), use_native=False)
    for m in EVAL_AXES:
        mesh = mesh_lib.make_mesh(1, m, ranks=range(m))
        for model_name, dist in EVAL_CASES:
            if mesh is None:
                continue
            model = get_model(model_name)
            host = _dyadic_tables(model_name, dataset.n_entities, dataset.n_relations, seed=11 + dist)
            cfg = EmbeddingConfig(distance=Distance(dist), **EVAL_KNOBS)
            placed = sharding.place_params(mesh, params_from_numpy(host, "cpu"))
            raw, filt, sizes = harness.rank_all(model, placed, dataset, cfg, mesh=mesh)
            got["eval", model_name, dist, m] = (raw, filt, harness.metrics_from_ranks(raw, filt, sizes),
                                                {k: v.shape[0] for k, v in placed.items()})
            if model_name in CUT_MODELS:  # the whole tables, as the driver passes them
                got["eval whole", model_name, dist, m] = harness.rank_all(
                    model, params_from_numpy(host, "cpu"), dataset, cfg, mesh=mesh)[:2]

    tie_mesh = mesh_lib.make_mesh(1, 3, ranks=range(3))
    if tie_mesh is not None:
        ent, queries, true_idx = _tie_inputs()
        row0, row1 = tie_mesh.entity_rows(TIE_N)
        for dist in Distance:
            q, shard = torch.from_numpy(queries), torch.from_numpy(ent[row0:row1])
            e_true = torch.from_numpy(((np.abs if dist == Distance.L1 else np.square)(
                ent[true_idx] - queries)).sum(-1).astype(np.float32))
            got["tie", int(dist)] = par_eval.local_counts(
                tie_mesh, rank_count.aligned_transpose(shard), q, e_true, torch.from_numpy(true_idx), row0, dist,
                block_size=3).numpy()

    lh, lt, lr, valid = multihost.partition_edges(ts.heads, ts.tails, ts.rels, rank, world)
    got["bern"] = multihost.global_bern_stats(lh, lt, lr, N_REL, valid=valid)
    got["edges"] = multihost.allgather_edges(lh, lt, lr, valid=valid)

    meshes = {shape: mesh_lib.make_mesh(*shape, ranks=range(shape[0] * shape[1])) for shape in ((2, 1), (1, 2), (2, 2))}
    for model_name, shape in STEP_CASES:
        mesh = meshes[shape]
        if mesh is None:
            continue
        model = get_model(model_name)
        data = _data(model, ts)
        for kind in ("dyadic", "init", "epoch"):
            host, cfg = _step_inputs(kind, model_name, ts)
            params = sharding.place_params(mesh, params_from_numpy(host, "cpu"))
            gen = torch.Generator().manual_seed(5)
            if kind == "epoch":
                out, loss = step_lib.make_epoch_runner(model, cfg, B, 4, mesh=mesh)(params, gen, data)
            else:
                out, loss = dist_step.make_distributed_train_step(model, cfg, mesh, B)(params, gen, data)
            full = sharding.gather_params(mesh, out, N_ENT)
            got["step", kind, model_name, shape] = ({k: v.numpy() for k, v in full.items()}, float(loss),
                                                   {k: v.shape[0] for k, v in out.items()})
            if kind == "dyadic":  # the dyadic tables as placed, assembled again
                again = sharding.gather_params(mesh, sharding.place_params(mesh, params_from_numpy(host, "cpu")),
                                               N_ENT)
                got["gather", model_name, shape] = {k: v.numpy() for k, v in again.items()}

    if meshes[1, 2] is not None:
        for model_name in CUT_MODELS:
            got["resume", model_name] = _resume_case(model_name, ts, dataset, meshes[1, 2],
                                                     os.path.join(out_dir, f"ckpt_{model_name}"))
    else:
        for _ in CUT_MODELS:
            multihost.barrier()  # the checkpoint's barrier, which every rank of the world joins

    # The eval CLI as torchrun starts it: WORLD_SIZE and RANK in the
    # environment, the process group (here the world's) found by from_torchrun.
    from kb2e_tpu_torch.cli import eval_transr

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    for m, dist in CLI_CASES:
        got["cli", m] = _stdout_of(eval_transr.main, _cli_argv(kg_dir, os.path.join(out_dir, "cli_transr"), dist)
                                   + ["--model-axis", str(m)])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    multihost.barrier()
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(kg_dir: str, out_dir: str):
    """Start the ranks, wait for all of them until the deadline, kill them all
    if it passes; returns each rank's pickled results."""
    port = _free_port()
    child = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_parallel as t; "
             "t._rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", child, os.path.dirname(__file__), str(r), str(WORLD),
                               str(port), kg_dir, out_dir], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = "".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:] for r in range(WORLD))
    assert rcs == [0] * WORLD, f"rank exit codes {rcs}:\n{text}"
    results = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_ranks"))


@pytest.fixture(scope="module")
def ranks(tiny_kg_dir, world_dir):
    _write_cli_files(tiny_kg_dir, os.path.join(world_dir, "cli_transr"))
    return _run_world(tiny_kg_dir, world_dir)


@pytest.fixture(scope="module")
def ts():
    return _triple_set()


# --- the sharded eval --------------------------------------------------------------

@pytest.mark.parametrize("m", EVAL_AXES)
@pytest.mark.parametrize("model_name,dist", EVAL_CASES)
def test_sharded_eval_equals_one_rank_and_jax_mesh_eval(ranks, tiny_kg_dir, tiny_dataset, model_name, dist, m):
    import jax
    import jax.numpy as jnp

    from kb2e_tpu.config import EmbeddingConfig as JConfig
    from kb2e_tpu.constants import Distance as JDistance
    from kb2e_tpu.eval import harness as jax_harness
    from kb2e_tpu.models import get_model as jax_get_model
    from kb2e_tpu.parallel import mesh as jax_mesh

    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"), use_native=False)
    host = _dyadic_tables(model_name, dataset.n_entities, dataset.n_relations, seed=11 + dist)
    cfg = EmbeddingConfig(distance=Distance(dist), **EVAL_KNOBS)
    raw, filt, sizes = harness.rank_all(get_model(model_name), params_from_numpy(host, "cpu"), dataset, cfg,
                                        device="cpu")
    one_rank = harness.metrics_from_ranks(raw, filt, sizes)
    for r in range(m):  # every rank of the mesh gets the one-rank ranks, from its cut of the tables
        s_raw, s_filt, s_metrics, held = ranks[r]["eval", model_name, dist, m]
        np.testing.assert_array_equal(s_raw, raw)
        np.testing.assert_array_equal(s_filt, filt)
        assert s_metrics == one_rank
        assert held == _held_rows((1, m), r, host, dataset.n_entities)
        if model_name in CUT_MODELS:  # and from the whole tables
            w_raw, w_filt = ranks[r]["eval whole", model_name, dist, m]
            np.testing.assert_array_equal(w_raw, raw)
            np.testing.assert_array_equal(w_filt, filt)
    want = jax_harness.evaluate(
        jax_get_model(model_name), {k: jnp.asarray(v) for k, v in host.items()}, tiny_dataset,
        JConfig(distance=JDistance(dist), **EVAL_KNOBS),
        mesh=jax_mesh.make_mesh(1, m, devices=jax.devices()[:m]),
    )
    assert one_rank == want  # every metric, to the last bit


@pytest.mark.parametrize("dist", list(Distance))
def test_sharded_rank_count_at_a_shard_boundary_with_exact_ties(ranks, dist):
    """The true entity on one rank, exact ties on its own and on the others,
    below and above its id: the summed counts equal the one-table count, a
    count by hand, and kb2e_tpu's sharded count."""
    import jax
    import jax.numpy as jnp

    from kb2e_tpu.constants import Distance as JDistance
    from kb2e_tpu.eval import ranking as jax_ranking
    from kb2e_tpu.parallel import eval as jax_par_eval
    from kb2e_tpu.parallel import mesh as jax_mesh

    ent, queries, true_idx = _tie_inputs()
    energy = (np.abs if dist == Distance.L1 else np.square)(ent[None, :, :] - queries[:, None, :]).sum(-1)
    e_true = energy[np.arange(true_idx.shape[0]), true_idx]
    ids = np.arange(TIE_N)[None, :]
    by_hand = ((ids != true_idx[:, None]) & ((energy < e_true[:, None])
                                            | ((energy == e_true[:, None]) & (ids < true_idx[:, None])))).sum(1)
    assert (energy[:, list(TIED)] == energy[:, [TIED[0]]]).all()  # the ties are exact
    one_table = rank_count.rank_counts_reference(
        torch.from_numpy(ent.T.copy()), torch.from_numpy(queries.T.copy()), torch.from_numpy(e_true),
        torch.from_numpy(true_idx), dist, block_size=5).numpy()
    np.testing.assert_array_equal(one_table, by_hand)
    for r in range(3):
        np.testing.assert_array_equal(ranks[r]["tie", int(dist)], by_hand)
    mesh = jax_mesh.make_mesh(1, 3, devices=jax.devices()[:3])
    proj = jax.device_put(jax_ranking.pad_entities(jnp.asarray(ent), 8),
                          jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("model", None)))
    raw, _ = jax_par_eval.sharded_rank_queries(mesh, proj, jnp.asarray(queries), jnp.asarray(true_idx),
                                               jnp.full((true_idx.shape[0], 8), -1, jnp.int32), JDistance(int(dist)),
                                               block_size=8)
    np.testing.assert_array_equal(np.asarray(raw) - 1, by_hand)


def test_shard_bounds_are_aligned_and_cover_the_rows():
    for n, m in ((64, 2), (64, 3), (14951, 2), (5, 3), (24, 3)):
        cuts = mesh_lib.shard_bounds(n, m)
        assert cuts[0] == 0 and cuts[-1] == n and list(cuts) == sorted(cuts)
        assert all(c % mesh_lib.ROW_ALIGN == 0 for c in cuts if c < n)  # a shard at the end may be empty


# --- the distributed step ------------------------------------------------------------

@pytest.mark.parametrize("model_name,shape", STEP_CASES)
def test_distributed_step_equals_one_device_bit_for_bit_on_dyadic_tables(ranks, ts, model_name, shape):
    want, want_loss = _single_step("dyadic", model_name, ts)
    for r in range(shape[0] * shape[1]):
        got, loss, held = ranks[r]["step", "dyadic", model_name, shape]
        assert held == _held_rows(shape, r, want, N_ENT)  # only its cut of each cut table
        assert loss == want_loss
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{model_name} {shape} rank {r} {key}")


@pytest.mark.parametrize("model_name,shape", STEP_CASES)
def test_gather_params_returns_the_whole_tables_bit_for_bit(ranks, model_name, shape):
    want = _dyadic_tables(model_name, N_ENT, N_REL, seed=MODELS.index(model_name))
    for r in range(shape[0] * shape[1]):
        got = ranks[r]["gather", model_name, shape]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{model_name} {shape} rank {r} {key}")


@pytest.mark.parametrize("model_name", CUT_MODELS)
def test_a_checkpoint_written_at_1x2_resumes_to_the_uninterrupted_run(ranks, tiny_kg_dir, world_dir, model_name):
    """Rank 0 writes the full tables (``gather_params``) after epoch 1; both
    ranks restore them, keep their cuts and end on the 2-epoch run's tables
    to the bit.  The valid eval at epoch 1, handed the cut tables, equals a
    one-rank eval of the checkpoint."""
    restored, step, _ = ckpt_lib.restore(os.path.join(world_dir, f"ckpt_{model_name}", "ckpt_1"))
    assert step == 1
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"), use_native=False)
    one_rank = harness.evaluate(get_model(model_name), restored, dataset, EmbeddingConfig(**EVAL_KNOBS),
                                test_triples=dataset.valid, device="cpu")
    for r in range(2):
        whole, resumed, valid = ranks[r]["resume", model_name]
        assert set(resumed) == set(whole) == set(restored)
        for key in whole:
            np.testing.assert_array_equal(resumed[key], whole[key], err_msg=f"{model_name} rank {r} {key}")
        assert valid == [one_rank]


@pytest.mark.parametrize("kind", ["init", "epoch"])
@pytest.mark.parametrize("model_name,shape", STEP_CASES)
def test_distributed_step_and_epoch_stay_within_jax_bounds_on_init_tables(ranks, ts, model_name, shape, kind):
    want, want_loss = _single_step(kind, model_name, ts)
    for r in range(shape[0] * shape[1]):
        got, loss, _ = ranks[r]["step", kind, model_name, shape]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=2e-6, err_msg=f"{model_name} {shape} rank {r} {key}")


def test_parity_mode_under_a_mesh_raises(ts):
    cfg = _cfg(update_mode="parity", max_epochs=1, num_batches=4)
    with pytest.raises(NotImplementedError, match="single-device"):
        loop.train(get_model("transe"), cfg, ts, device="cpu", mesh=mesh_lib.single_device_mesh("cpu"))


def test_the_fused_runner_refuses_a_mesh():
    with pytest.raises(ValueError, match="single-device"):
        step_lib.make_epoch_runner(get_model("transe"), _cfg(), B, 4, fused=True,
                                   mesh=mesh_lib.single_device_mesh("cpu"))


# --- the mesh and the flags ------------------------------------------------------------

def test_a_world_size_that_is_not_data_times_model_raises(ranks):
    for r in range(WORLD):
        assert ranks[r]["mismatch"].startswith("mesh 3x1 != 4 ranks")
    with pytest.raises(ValueError, match="no process group"):
        mesh_lib.make_mesh(2, 1)


def test_train_cli_with_a_data_axis_and_no_process_group_raises(tiny_kg_dir, tmp_path, monkeypatch):
    from kb2e_tpu_torch.cli import train_transe

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--datadir", tiny_kg_dir, "--outdir", str(tmp_path), "--size", "8", "--batches", "4", "--epochs", "1",
            "--seed", "1", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="torchrun"):
        train_transe.main(argv + ["--data-axis", "2"])
    assert not os.listdir(tmp_path)  # nothing trained, nothing written
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="torchrun started 3 ranks"):
        train_transe.main(argv + ["--data-axis", "2", "--model-axis", "1"])
    with pytest.raises(ValueError, match="needs a mesh, and none was passed"):
        loop.train(get_model("transe"), _cfg(data_axis=2, max_epochs=1, num_batches=4), _triple_set(), device="cpu")


def test_eval_cli_with_a_model_axis_and_no_process_group_raises(tiny_kg_dir, world_dir, monkeypatch):
    from kb2e_tpu_torch.cli import eval_transr

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    argv = _cli_argv(tiny_kg_dir, os.path.join(world_dir, "absent"), 0)
    with pytest.raises(RuntimeError, match="torchrun"):
        eval_transr.main(argv + ["--model-axis", "2"])
    with pytest.raises(NotImplementedError, match="no sharded path"):  # before any rendezvous
        eval_transr.main(argv + ["--model-axis", "2", "--task", "relation"])
    assert not torch.distributed.is_initialized()


def test_relation_prediction_under_a_mesh_raises(tiny_kg_dir):
    dataset = triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"), use_native=False)
    host = _dyadic_tables("transr", dataset.n_entities, dataset.n_relations, seed=3)
    with pytest.raises(NotImplementedError, match="no sharded path"):
        harness.evaluate_relation_prediction(get_model("transr"), params_from_numpy(host, "cpu"), dataset,
                                             EmbeddingConfig(embedding_size=K), mesh=mesh_lib.single_device_mesh())


@pytest.mark.parametrize("m,dist", CLI_CASES)
def test_eval_cli_over_the_world_prints_the_one_rank_lines(ranks, tiny_kg_dir, world_dir, m, dist):
    from kb2e_tpu_torch.cli import eval_transr

    want = _metric_lines(_stdout_of(eval_transr.main, _cli_argv(tiny_kg_dir, os.path.join(world_dir, "cli_transr"),
                                                                 dist)))
    assert len(want) == 4
    for r in range(WORLD):
        out = ranks[r]["cli", m]
        assert f"rank {r} of {WORLD}: Mesh(data={WORLD // m}, model={m}, coords={divmod(r, m)}, cpu)" in out
        assert _metric_lines(out) == want


def test_two_nccl_ranks_on_one_card_are_refused_before_any_rendezvous(monkeypatch):
    for var, value in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        mesh_lib.from_torchrun(2, 1, "cuda")
    assert not torch.distributed.is_initialized()


# --- multihost helpers against kb2e_tpu's -----------------------------------------------------

def test_partition_edges_equals_jax():
    from kb2e_tpu.parallel import multihost as jax_multihost

    rng = np.random.default_rng(3)
    h, t, r = (rng.integers(0, 50, 103).astype(np.int32) for _ in range(3))
    for pid in range(4):
        for got, want in zip(multihost.partition_edges(h, t, r, pid, 4), jax_multihost.partition_edges(h, t, r, pid, 4)):
            np.testing.assert_array_equal(got, want)


def test_global_bern_stats_and_allgather_edges_equal_jax_merge(ranks, ts):
    from kb2e_tpu.data import triples as jax_triples
    from kb2e_tpu.parallel import multihost as jax_multihost

    rows = []
    for pid in range(WORLD):
        sh, st, sr, valid = jax_multihost.partition_edges(ts.heads, ts.tails, ts.rels, pid, WORLD)
        rows += [jax_multihost._local_group_counts(sr[valid], st[valid], 0),
                 jax_multihost._local_group_counts(sr[valid], sh[valid], 1)]
    rows = np.concatenate(rows)
    uniq, inv = np.unique(rows[:, :3], axis=0, return_inverse=True)
    counts = np.bincount(inv.reshape(-1), weights=rows[:, 3].astype(np.float64))
    want = jax_multihost._stats_from_groups(np.concatenate([uniq, counts.astype(np.int64)[:, None]], 1), N_REL)
    np.testing.assert_array_equal(want, jax_triples.bern_tail_probability(ts.heads, ts.tails, ts.rels, N_REL))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["bern"], want)
        for got, arr in zip(ranks[r]["edges"], (ts.heads, ts.tails, ts.rels)):
            np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(multihost.global_bern_stats(ts.heads, ts.tails, ts.rels, N_REL), want)


# --- profiling and specs -----------------------------------------------------------------

def test_trace_context_names_a_region_of_the_exported_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.capture_trace(log_dir):
        with profiling.trace_context("unit-test-region"):
            x = torch.ones(8, 8).sum()
    assert float(x) == 64.0
    with open(os.path.join(log_dir, "trace.json"), encoding="utf-8") as f:
        assert "unit-test-region" in f.read()
    with profiling.capture_trace(None):  # a no-op
        pass


def test_step_timer_rate():
    timer = profiling.StepTimer(window=8)
    assert timer.rate(100.0) == 0.0  # fewer than 2 ticks
    clock = iter([0.0, 1.0, 2.0])
    timer._clock = lambda: next(clock)
    for _ in range(3):
        timer.tick()
    assert timer.rate(100.0) == pytest.approx(100.0)  # 2 intervals in 2 s, 200 units


@pytest.mark.parametrize("name", MODELS)
def test_param_specs_cover_every_model_and_place_on_a_mesh(name):
    """The JAX package's specs: entity rows and the per-relation tables of
    TransR and CTransR over ``model``, the rest replicated."""
    from kb2e_tpu.parallel import sharding as jax_sharding

    model = get_model(name)
    cfg = EmbeddingConfig(embedding_size=8, path_composition="rnn")
    params = model.init_params(torch.Generator().manual_seed(0), 64, 8, cfg, "cpu")
    assert set(params) <= set(sharding.PARAM_SPECS), set(params) - set(sharding.PARAM_SPECS)
    for key, value in params.items():
        assert sharding.PARAM_SPECS[key] == tuple(jax_sharding.PARAM_SPECS[key]), key
        assert len(sharding.PARAM_SPECS[key]) == value.dim(), key
    assert sharding.RELATION_KEYS == ("proj", "relation_c", "centers")
    placed = sharding.place_params(mesh_lib.single_device_mesh("cpu"), params)
    for key, value in placed.items():
        assert torch.equal(value, params[key])


@pytest.mark.parametrize("r,m", [(8, 2), (8, 3), (1345, 2), (1345, 4), (3, 4)])
def test_relation_rows_cut_the_relations_evenly_with_the_last_short(r, m):
    cuts = [_mesh_at((1, m), i).relation_rows(r) for i in range(m)]
    assert cuts[0][0] == 0 and cuts[-1][1] == r
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))  # contiguous, each relation once
    sizes = [hi - lo for lo, hi in cuts]
    assert sizes[0] == -(-r // m) and sorted(sizes, reverse=True) == sizes  # not rounded to ROW_ALIGN
    table = torch.arange(r * 2, dtype=torch.float32).reshape(r, 2)
    parts = [sharding.local_relations(_mesh_at((1, m), i), table, r) for i in range(m)]
    assert torch.equal(torch.cat(parts), table)
    assert all(sharding.local_relations(_mesh_at((1, m), i), part, r) is part for i, part in enumerate(parts))


@pytest.mark.parametrize("model_name", MODELS)
def test_data_parallel_step_adds_the_deltas_in_one_devices_order(ranks, ts, model_name):
    """The gathered deltas reach ``index_add`` in the whole batch's order, so
    on the CPU (where ``index_add`` adds in index order) the (2, 1) step on
    init tables, where sums are not exact, equals one device's to the bit."""
    want, _ = _single_step("init", model_name, ts)
    for r in range(2):
        got, _, _ = ranks[r]["step", "init", model_name, (2, 1)]
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{model_name} rank {r} {key}")


@pytest.mark.parametrize("first", [0, 3, 4096, 5000])
def test_block_squared_norms_equal_squared_norms_and_a_shard_the_whole(first):
    rng = np.random.default_rng(first)
    table = torch.from_numpy(rng.normal(size=(6, 9000)).astype(np.float32))
    whole = distances.squared_norms(table)
    shard = par_eval.shard_squared_norms(table[:, first:first + 3000], first, 9000)
    np.testing.assert_allclose(shard.numpy(), distances.squared_norms(table[:, first:first + 3000]).numpy(), rtol=1e-6)
    assert torch.equal(shard, whole[first:first + 3000])
