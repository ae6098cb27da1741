"""TransE's fast batch as hand-written CUDA kernels (``ops/transe_fast.py``)
on the CPU: the wrapper on CPU tensors against ``TransE.fused_table_update``
batch by batch, TransE's choice of the kernel path (``TransE.stepper``), its
counters, and the benchmark's reader of them.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
On CPU tensors the wrapper runs ``fused_table_update`` in place on the
table, so the two agree bit for bit.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base, transe
from kb2e_tpu_torch.ops import transe_fast
from kb2e_tpu_torch.parallel import mesh as mesh_lib
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N_ENT, N_REL = 30, 5
KEYS = ("ph", "pt", "r", "nh", "nt", "valid")


def _tables(seed, k, dyadic):
    """Entity and relation tables; ``dyadic``: multiples of 1/16 in [-1/2, 1/2]
    (every sum of a batch exact), some rows of norm above 1."""
    rng = np.random.default_rng(seed)
    if dyadic:
        ent, rel = (np.clip(np.round(rng.normal(size=(n, k)) * 3) / 16, -0.5, 0.5) for n in (N_ENT, N_REL))
    else:
        ent, rel = (rng.normal(size=(n, k)) * 0.25 for n in (N_ENT, N_REL))
        ent, rel = (x / np.maximum(1.0, np.linalg.norm(x, axis=1, keepdims=True)) for x in (ent, rel))
    return {"entity": torch.from_numpy(ent.astype(np.float32)), "relation": torch.from_numpy(rel.astype(np.float32))}


def _feed(seed, n_batches, positives, k_neg):
    """[n_batches, positives·K] int32 ids, positives repeated sample-major;
    in each batch a quarter of the positives have h == t, some rows are
    masked and a row is repeated."""
    rng = np.random.default_rng(seed)
    rows = positives * k_neg
    ph, pt, r = (np.repeat(rng.integers(0, n, (n_batches, positives)), k_neg, axis=1)
                 for n in (N_ENT, N_ENT, N_REL))
    pt[:, : rows // 4] = ph[:, : rows // 4]
    nh, nt = rng.integers(0, N_ENT, (2, n_batches, rows))
    valid = rng.random((n_batches, rows)) > 0.15
    feed = dict(zip(KEYS, (ph, pt, r, nh, nt, valid)))
    for v in feed.values():
        v[:, -1] = v[:, 0]
    return {key: torch.from_numpy(v.astype(bool if key == "valid" else np.int32)) for key, v in feed.items()}


def _cfg(distance, k, k_neg=1, **kw):
    return EmbeddingConfig(embedding_size=k, learning_rate=1 / 64, margin=1.0, distance=int(distance),
                           num_negatives=k_neg, **kw)


def _plain(params, feed, cfg):
    """``fused_table_update`` over the feed's batches in turn."""
    model = get_model("transe")
    table, losses = base.fuse(params), []
    for i in range(feed["ph"].shape[0]):
        table, loss = model.fused_table_update(table, N_ENT, {key: v[i] for key, v in feed.items()}, cfg)
        losses.append(loss)
    return base.unfuse(table, N_ENT), torch.stack(losses)


def _wrapper(params, feed, cfg):
    """The kernels' wrapper, as ``TransE.stepper`` makes it, over CPU tensors."""
    model = get_model("transe")
    return transe_fast.FusedBatches(
        base.fuse(params), N_ENT, feed, learning_rate=cfg.learning_rate, margin=cfg.margin,
        l1=cfg.distance == int(Distance.L1), group=max(1, cfg.num_negatives),
        plain=lambda t, batch: model.fused_table_update(t, N_ENT, batch, cfg))


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("k_neg", [1, 8])
@pytest.mark.parametrize("dyadic", [True, False])
def test_the_wrapper_on_cpu_tensors_equals_fused_table_update(distance, k_neg, dyadic):
    k = 12
    cfg, params = _cfg(distance, k, k_neg), _tables(3 + k_neg, k, dyadic)
    feed = _feed(5 + int(distance), 4, 24 // k_neg if k_neg > 1 else 24, k_neg)
    want, want_losses = _plain(params, feed, cfg)
    run = _wrapper(params, feed, cfg)
    for i in range(feed["ph"].shape[0]):
        run(i)
    got = run.params()
    assert not torch.equal(got["entity"], params["entity"]) and float(want_losses.sum()) > 0
    for key in got:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(run.loss, want_losses)


def test_rows_above_norm_one_that_no_sample_touches_are_ball_normed_as_the_plain_update_does():
    cfg, params = _cfg(Distance.L1, 12), _tables(7, 12, dyadic=True)
    params["entity"][N_ENT - 5:] = 0.5  # norm √3: above 1, and touched by no sample below
    feed = _feed(8, 1, 24, 1)
    for key in ("ph", "pt", "nh", "nt"):
        feed[key] %= N_ENT - 5
    want, _ = _plain(params, feed, cfg)
    run = _wrapper(params, feed, cfg)
    run(0)
    got = run.params()
    assert torch.allclose(got["entity"][N_ENT - 5:].norm(dim=1), torch.ones(5))
    for key in got:
        assert torch.equal(got[key], want[key]), key


def test_the_wrapper_refuses_what_it_does_not_take():
    params, feed = _tables(1, 8, False), _feed(2, 2, 8, 1)
    model, cfg = get_model("transe"), _cfg(Distance.L1, 8)
    table = base.fuse(params)
    kw = dict(learning_rate=0.01, margin=1.0, l1=True,
              plain=lambda t, batch: model.fused_table_update(t, N_ENT, batch, cfg))
    with pytest.raises(ValueError, match="no kernel"):
        transe_fast.FusedBatches(table.to("meta"), N_ENT, {key: v.to("meta") for key, v in feed.items()}, **kw)
    with pytest.raises(ValueError, match="float32"):
        transe_fast.FusedBatches(table.bfloat16(), N_ENT, feed, **kw)
    with pytest.raises(ValueError, match="shape"):
        transe_fast.FusedBatches(table, N_ENT, {**feed, "nt": feed["nt"][:, 1:]}, **kw)
    with pytest.raises(ValueError, match="k = 1025"):
        transe_fast.FusedBatches(torch.zeros(N_ENT + N_REL, 1025), N_ENT, feed, **kw)
    run = transe_fast.FusedBatches(table, N_ENT, feed, **kw)
    with pytest.raises(IndexError):
        run(2)


def test_the_kernels_build_through_the_shared_nvcc_helper(tmp_path, monkeypatch):
    # A stand-in nvcc that writes the file after -o.
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    (bin_dir / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(transe_fast, "BUILD_DIR", tmp_path / "kernels")
    so = transe_fast.build()
    assert so.parent == tmp_path / "kernels" and so.name.startswith("transe_fast_") and so.suffix == ".so"


# --- TransE's choice ------------------------------------------------------------


def _stand_in(device, dtype=torch.float32, shape=(N_ENT, 8)):
    """What the predicate reads of a table: its device, dtype and shape (a
    CUDA device needs no card to be named)."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape)


@pytest.mark.parametrize("name, tables, kw, want", [
    ("transe", ("cuda:0", "cuda:0"), {}, True),
    ("transe", ("cpu", "cpu"), {}, False),
    ("transe", ("meta", "meta"), {}, False),
    ("transe", ("cuda:0", "cuda:1"), {}, False),
    ("transe", ("cuda:0", "cuda:0"), {"dtype": torch.bfloat16}, False),
    ("transe", ("cuda:0", "cuda:0"), {"scatter_mode": "dedup"}, False),
    ("transe", ("cuda:0", "cuda:0"), {"relation_dtype": torch.bfloat16}, False),
    ("transe", ("cuda:0", "cuda:0"), {"mesh": True}, False),
    ("transr", ("cuda:0", "cuda:0"), {}, False),
    ("transe", ("cuda:0", "cuda:0"), {"k": 1024}, True),
    ("transe", ("cuda:0", "cuda:0"), {"k": 1025}, False),  # wider than a lane's 8 chunks
    ("transe", ("cuda:0", "cuda:0"), {"rows": 4_294_967}, True),
    ("transe", ("cuda:0", "cuda:0"), {"rows": 4_294_968}, False),  # 5·rows·k deltas past 32 bits
])
def test_the_runner_takes_the_kernels_only_for_float32_tables_on_one_card_direct_and_no_mesh(
        monkeypatch, name, tables, kw, want):
    # TransE's stepper decides (transe.kernels_take); a runner over a mesh,
    # and any other model, never asks it.
    k, rows = kw.get("k", 100), kw.get("rows", 16)
    cfg = _cfg(Distance.L1, k, scatter_mode=kw.get("scatter_mode", "direct"))
    dtypes = kw.get("dtype", torch.float32), kw.get("relation_dtype", kw.get("dtype", torch.float32))
    params = {key: _stand_in(dev, dtype, (n, k))
              for key, dev, dtype, n in zip(("entity", "relation"), tables, dtypes, (N_ENT, N_REL))}
    real = _tables(0, 8, False)
    assert transe.kernels_take(real, rows, cfg) is False
    assert transe.kernels_take({key: v.to("meta") for key, v in real.items()}, rows, cfg) is False
    if name == "transe" and not kw.get("mesh"):
        assert transe.kernels_take(params, rows, cfg) is want
        return
    asked = []
    monkeypatch.setattr(transe, "kernels_take", lambda *args: asked.append(args) or True)
    model, cfg = get_model(name), _cfg(Distance.L1, 8)
    mesh = mesh_lib.single_device_mesh("cpu") if kw.get("mesh") else None
    runner = step_lib.EpochRunner(model, cfg, 16, 3, mesh=mesh)
    runner.apply(model.init_params(torch.Generator().manual_seed(1), N_ENT, N_REL, cfg, "cpu"), _feed(2, 3, 16, 1),
                 N_ENT)
    assert asked == [] and want is False


@pytest.mark.parametrize("k, rows, want", [
    (1, 0, True), (100, 4_831, True), (100, 38_648, True), (1024, 1, True), (0, 16, False), (1025, 16, False),
    (100, 4_294_967, True), (100, 4_294_968, False), (4, 107_374_182, True), (4, 107_374_183, False),
])
def test_the_kernels_take_widths_up_to_max_k_and_batches_of_deltas_under_2_to_the_31(k, rows, want):
    assert transe_fast.takes(k, rows) is want


def _apply_traced(runner, params, feed):
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = runner.apply(params, feed, N_ENT)
        return out, profiling.snapshot()
    finally:
        profiling.reset()


@pytest.mark.parametrize("kernel", [False, True])
def test_a_fused_runner_counts_its_batches_and_those_the_kernels_ran(monkeypatch, kernel):
    # On the CPU the kernel path runs the wrapper on CPU tensors, which runs
    # the plain version: the runner's loop, counters and spans are those of
    # the card.
    cfg, params, feed = _cfg(Distance.L2, 8), _tables(4, 8, False), _feed(6, 3, 16, 1)
    runner = step_lib.EpochRunner(get_model("transe"), cfg, 16, 3)
    monkeypatch.setattr(transe, "kernels_take", lambda p, rows, c: kernel)
    before = {key: v.clone() for key, v in params.items()}
    (got, loss), snap = _apply_traced(runner, params, feed)
    assert snap["counters"]["train.batches"] == 3
    assert snap["counters"]["train.batches_kernel"] == (3 if kernel else 0)
    assert snap["spans"]["kb2e.train.batch"]["count"] == 3
    want, want_losses = _plain(params, feed, cfg)
    for key in params:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(params[key], before[key]), key  # the inputs are never written
    assert float(loss) == pytest.approx(float(want_losses.sum()), rel=1e-6)


def test_a_chunked_runner_counts_no_batches():
    runner = step_lib.EpochRunner(get_model("transr"), _cfg(Distance.L1, 8), 16, 3)
    params = get_model("transr").init_params(torch.Generator().manual_seed(1), N_ENT, N_REL, _cfg(Distance.L1, 8),
                                             "cpu")
    _, snap = _apply_traced(runner, params, _feed(7, 3, 16, 1))
    assert "train.batches" not in snap["counters"] and snap["counters"]["train.chunks"] == 3


# --- the benchmark's reader ---------------------------------------------------


def _reader():
    from portbench import spec

    return spec.load("transe-fb15k.train", REPO).reader("train.batch_kernel_share")


def _snap(counters, roots=2):
    spans = {"kb2e.train.apply": {"count": roots, "total_s": 1.0, "self_s": 0.1}} if roots else {}
    return {"spans": spans, "counters": {"sampler.slots": 10, **counters}}


@pytest.mark.parametrize("snap, want", [
    (_snap({"train.batches": 200, "train.batches_kernel": 200}), 100.0),
    (_snap({"train.batches": 200, "train.batches_kernel": 50}), 25.0),
    (_snap({"train.batches": 200, "train.batches_kernel": 0}), 0.0),
    (_snap({"sampler.retried": 0}), None),  # a program without the counters: the parent's
    (_snap({"train.batches": 0, "train.batches_kernel": 0}), None),
    (_snap({"train.batches": 4, "train.batches_kernel": 4}, roots=0), None),  # no epoch closed
])
def test_the_share_is_kernel_batches_over_fused_batches(monkeypatch, snap, want):
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    got = _reader().read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_its_entry_and_reader_agree():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["train.batch_kernel_share"]
    reader = _reader()
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    assert entry["workloads"] == ["transe-fb15k.train", "transe-fb15k.train-k8"]
    assert entry["source"] == "program_counter" and entry["better"] == "higher"
    layers = {m["layer"] for m in bench["per_layer"] if m["name"] in ("train.apply_ms", "train.chunk_graph_share")}
    assert layers == {entry["layer"]}
