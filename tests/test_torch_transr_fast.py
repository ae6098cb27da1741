"""TransR's fast chunk as a hand-written CUDA kernel (``ops/transr_fast.py``).

On the CPU: what the wrapper refuses (every device but CUDA among it), its
build through the shared nvcc helper, TransR's choice of the kernel path
(``TransR.stepper``, and CTransR's stepper, which never asks), the
``train.chunks_kernel`` counter and the benchmark's reader of it.

On the card (marked ``cuda``; they skip without a CUDA device): the kernel
against ``chunk_update_`` and its replayed graph (``ChunkGraph``).

* Bit for bit on dyadic chunks, at L1 and L2 and k 16, 33, 50 and 100.  Sums
  the kernel may take in another order than torch (cuBLAS's products with W
  at widths not probed, a row's steps where index_add's atomics land out of
  slot order) are exact only where their terms are, and a sphere norm
  rounds unless the row's norm is a power of two.  So every table row here has a power-of-two norm (``_pow2_rows``),
  and the valid samples come in cycles: sample i of a cycle has pair i as its
  positive and pair i + 1 as its negative, all on one fresh relation and
  fresh rows, and the margin is so wide that every one violates.  Their
  steps to W, the rows and the relation then cancel exactly (each pair's
  rows take + lr W x as a positive and − lr W x as a negative), the rows the
  descent reads keep power-of-two norms, and every sum of the chunk is
  exact.  The chunks hold repeated heads, tails and relations (the cycles
  share them), h' = t, nh = ph, invalid samples on any row, an all-invalid
  chunk and a padded last chunk.
* On seeded TransR-init tables at the benchmark's rate, within a stated
  tolerance (``RANDOM_ATOL``).
* A whole epoch through ``EpochRunner.apply``, with its counters and launch
  counts: one launch a run of chunks, no graph.
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
from kb2e_tpu_torch.models import base, transr
from kb2e_tpu_torch.ops import cuda_build, transr_fast
from kb2e_tpu_torch.parallel import mesh as mesh_lib
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
KEYS = base.CHUNK_KEYS
N_ENT, N_REL = 30, 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pow2_rows(rng, n, k):
    """[n, k] rows of power-of-two norm: 1 or 4 coordinates (at most k) of
    ±1 or ±1/2, halved or not, or 16 of ±1/4."""
    out = np.zeros((n, k), np.float32)
    for row in out:
        m = rng.choice([c for c in (1, 4, 16) if c <= k])
        scale = 1.0 if m == 16 else 2.0 ** -rng.integers(0, 2)
        row[rng.choice(k, m, replace=False)] = rng.choice([-1.0, 1.0], m) / np.sqrt(m) * scale
    return out


def _dyadic_tables(n, n_rel, k, seed):
    rng = np.random.default_rng(seed)
    return {"entity": torch.from_numpy(_pow2_rows(rng, n, k)), "relation": torch.from_numpy(_pow2_rows(rng, n_rel, k)),
            "proj": torch.from_numpy(_pow2_rows(rng, n_rel * k, k).reshape(n_rel, k, k))}


def _cycle_feed(n_chunks, chunk, n, n_rel, seed):
    """[n_chunks, chunk] int32 ids and valid: in every chunk but the second,
    about 5/8 of the slots are valid samples in cycles on fresh rows and a
    fresh relation (never one an earlier chunk stepped, nor row or relation
    0), the rest invalid samples on any rows; the second chunk is all
    invalid, and the last ends in pad slots (id 0, invalid)."""
    rng = np.random.default_rng(seed)
    ents, rels = iter(rng.permutation(np.arange(1, n))), iter(rng.permutation(np.arange(1, n_rel)))
    out = {key: np.zeros((n_chunks, chunk), np.int32) for key in KEYS[:-1]}
    out["valid"] = np.zeros((n_chunks, chunk), bool)
    for c in range(n_chunks):
        samples, pads = [], 5 if c == n_chunks - 1 else 0
        while c != 1:
            size = int(rng.integers(2, 6))
            if len(samples) + size > chunk * 5 // 8:
                break
            r, pairs = next(rels), []
            for i in range(size):
                kind = 0 if i == 0 else int(rng.integers(0, 3))
                h = next(ents) if kind == 0 else pairs[-1][kind - 1]  # kind 1: the same head; 2: h' = t
                pairs.append((h, next(ents)))
            samples += [(*pairs[i], r, *pairs[(i + 1) % size], True) for i in range(size)]
        while len(samples) < chunk - pads:
            h, t, a, b = rng.integers(0, n, 4)
            kind = int(rng.integers(0, 3))
            samples.append((h, t, int(rng.integers(0, n_rel)), h if kind == 1 else (t if kind == 2 else a), b, False))
        for slot, at in enumerate(rng.permutation(chunk - pads)):
            for key, v in zip(KEYS, samples[at]):
                out[key][c, slot] = v
    return {key: torch.from_numpy(v) for key, v in out.items()}


def _cfg(distance, k, lr=1 / 16, margin=64.0, **kw):
    return EmbeddingConfig(embedding_size=k, learning_rate=lr, margin=margin, distance=int(distance), **kw)


def _eager(params, feed, cfg):
    """``TransR.chunk_update_`` a chunk, in place on fused copies, eagerly."""
    steps = get_model("transr").eager_chunks(params, feed, cfg)
    for i in range(feed["ph"].shape[0]):
        steps(i)
    return steps.params(), steps.loss


def _kernels(params, feed, cfg):
    steps = get_model("transr").kernel_chunks(params, feed, cfg)
    for i in range(feed["ph"].shape[0]):
        steps(i)
    with pytest.raises(IndexError):
        steps(feed["ph"].shape[0])
    return steps.params(), steps.loss


# --- on the CPU -----------------------------------------------------------------


def test_the_wrapper_refuses_what_it_does_not_take():
    k = 8
    params, feed = _dyadic_tables(N_ENT, N_REL, k, seed=3), _cycle_feed(2, 8, N_ENT, N_REL, seed=4)
    table, proj = base.fuse(params), params["proj"]
    kw = dict(learning_rate=0.01, margin=1.0, l1=True)
    with pytest.raises(ValueError, match="no kernel"):
        transr_fast.FusedChunks(table.to("meta"), proj.to("meta"), N_ENT,
                                {key: v.to("meta") for key, v in feed.items()}, **kw)
    with pytest.raises(ValueError, match="float32"):
        transr_fast.FusedChunks(table.bfloat16(), proj, N_ENT, feed, **kw)
    with pytest.raises(ValueError, match="float32"):
        transr_fast.FusedChunks(table, proj.double(), N_ENT, feed, **kw)
    with pytest.raises(ValueError, match="float32"):
        transr_fast.FusedChunks(table, proj.transpose(1, 2), N_ENT, feed, **kw)  # not contiguous
    with pytest.raises(ValueError, match="proj must be of shape"):
        transr_fast.FusedChunks(table, proj[1:].contiguous(), N_ENT, feed, **kw)
    with pytest.raises(ValueError, match="shape"):
        transr_fast.FusedChunks(table, proj, N_ENT, {**feed, "nt": feed["nt"][:, 1:]}, **kw)
    with pytest.raises(ValueError, match="k = 129"):
        transr_fast.FusedChunks(torch.zeros(N_ENT + N_REL, 129), torch.zeros(N_REL, 129, 129), N_ENT, feed, **kw)
    big = {key: v[:1].repeat(1, 65) for key, v in feed.items()}  # 520 samples a chunk
    with pytest.raises(ValueError, match="512"):
        transr_fast.FusedChunks(table, proj, N_ENT, big, **kw)
    with pytest.raises(ValueError, match="entities and relations"):
        transr_fast.FusedChunks(table, proj, N_ENT + N_REL, feed, **kw)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        transr_fast.FusedChunks(table, proj, N_ENT, feed, **kw)


def test_the_kernels_build_through_the_shared_nvcc_helper(tmp_path, monkeypatch):
    # A stand-in nvcc that writes the file after -o.
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    (bin_dir / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(transr_fast, "BUILD_DIR", tmp_path / "kernels")
    so = transr_fast.build()
    assert so.parent == tmp_path / "kernels" and so.name.startswith("transr_fast_") and so.suffix == ".so"
    assert so == cuda_build.library_path(transr_fast.SOURCE, tmp_path / "kernels")
    assert transr_fast.build() == so  # built once
    assert so.with_suffix(".log").exists()


@pytest.mark.parametrize("k, rows, want", [
    (1, 1, True), (50, 256, True), (128, 256, True), (128, 512, True), (0, 16, False), (129, 16, False),
    (50, 0, False), (50, 513, False),
])
def test_the_kernels_take_widths_up_to_max_k_and_chunks_up_to_max_rows(k, rows, want):
    assert transr_fast.takes(k, rows) is want


def _stand_in(device, dtype=torch.float32, shape=(N_ENT, 8)):
    """What the predicate reads of a table: its device, dtype and shape (a
    CUDA device needs no card to be named)."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape)


@pytest.mark.parametrize("devices, kw, want", [
    (("cuda:0",) * 3, {}, True),
    (("cpu",) * 3, {}, False),
    (("meta",) * 3, {}, False),
    (("cuda:0", "cuda:0", "cuda:1"), {}, False),
    (("cuda:0", "cuda:1", "cuda:0"), {}, False),
    (("cuda:0",) * 3, {"dtype": torch.bfloat16}, False),
    (("cuda:0",) * 3, {"proj_dtype": torch.float64}, False),
    (("cuda:0",) * 3, {"scatter_mode": "dedup"}, False),
    (("cuda:0",) * 3, {"k": 128}, True),
    (("cuda:0",) * 3, {"k": 129}, False),
    (("cuda:0",) * 3, {"rows": 512}, True),
    (("cuda:0",) * 3, {"rows": 513}, False),
])
def test_transr_takes_the_kernels_only_for_float32_tables_on_one_card_with_direct_scatters(devices, kw, want):
    k, rows = kw.get("k", 50), kw.get("rows", 256)
    cfg = _cfg(Distance.L1, k, scatter_mode=kw.get("scatter_mode", "direct"))
    dtype = kw.get("dtype", torch.float32)
    dtypes = (dtype, dtype, kw.get("proj_dtype", dtype))
    shapes = ((N_ENT, k), (N_REL, k), (N_REL, k, k))
    params = {key: _stand_in(dev, dt, shape)
              for key, dev, dt, shape in zip(("entity", "relation", "proj"), devices, dtypes, shapes)}
    assert transr.kernels_take(params, rows, cfg) is want
    real = _dyadic_tables(N_ENT, N_REL, 8, seed=5)
    assert transr.kernels_take(real, 16, _cfg(Distance.L1, 8)) is False
    assert transr.kernels_take({key: v.to("meta") for key, v in real.items()}, 16, _cfg(Distance.L1, 8)) is False


def _apply_traced(runner, params, feed, n_ent):
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = runner.apply(params, feed, n_ent)
        return out, profiling.snapshot()
    finally:
        profiling.reset()


@pytest.mark.parametrize("kernel", [False, True])
def test_a_transr_runner_counts_its_chunks_and_those_the_kernels_ran(monkeypatch, kernel):
    # On the CPU the kernel path runs the eager chunks in the kernel's place:
    # the runner's loop, counters and spans are those of the card.
    k, n, n_rel = 8, 60, 12
    cfg, params, feed = _cfg(Distance.L2, k), _dyadic_tables(n, n_rel, k, seed=6), _cycle_feed(3, 16, n, n_rel, seed=7)
    runner = step_lib.EpochRunner(get_model("transr"), cfg, 16, 3)
    assert runner.chunk == 16
    asked, built = [], []
    monkeypatch.setattr(transr, "kernels_take", lambda p, rows, c: asked.append(rows) or kernel)
    monkeypatch.setattr(transr.TransR, "kernel_chunks", lambda self, *a: built.append(1) or self.eager_chunks(*a))
    before = {key: v.clone() for key, v in params.items()}
    (got, loss), snap = _apply_traced(runner, params, feed, n)
    assert asked == [16] and built == ([1] if kernel else [])
    counters = snap["counters"]
    assert counters["train.chunks"] == 3 and counters["train.chunks_replayed"] == 0
    assert counters["train.chunks_kernel"] == (3 if kernel else 0)
    assert snap["spans"]["kb2e.train.batch"]["count"] == 3
    want, want_loss = _eager(params, feed, cfg)
    for key in params:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(params[key], before[key]), key  # the inputs are never written
    assert torch.equal(loss, want_loss.sum())


def test_ctransr_never_asks_for_transr_kernels(monkeypatch):
    asked = []
    monkeypatch.setattr(transr, "kernels_take", lambda *args: asked.append(args) or True)
    model, cfg = get_model("ctransr"), _cfg(Distance.L1, 8, lr=0.01, margin=1.0)
    params = model.init_params(torch.Generator().manual_seed(1), N_ENT, N_REL, cfg, "cpu")
    feed = {key: v % (N_REL if key == "r" else N_ENT) if key != "valid" else v
            for key, v in _cycle_feed(3, 16, 60, 12, seed=8).items()}
    runner = step_lib.EpochRunner(model, cfg, 16, 3)
    (_, _), snap = _apply_traced(runner, params, feed, N_ENT)
    assert asked == [] and model.chunk_kernels is False and get_model("transr").chunk_kernels is True
    assert snap["counters"]["train.chunks"] == 3 and snap["counters"]["train.chunks_kernel"] == 0


def test_a_mesh_runner_never_asks_for_the_kernels(monkeypatch):
    asked = []
    monkeypatch.setattr(transr, "kernels_take", lambda *args: asked.append(args) or True)
    model, cfg = get_model("transr"), _cfg(Distance.L1, 8, lr=0.01, margin=1.0)
    runner = step_lib.EpochRunner(model, cfg, 16, 3, mesh=mesh_lib.single_device_mesh("cpu"))
    runner.apply(model.init_params(torch.Generator().manual_seed(1), 60, 12, cfg, "cpu"), _cycle_feed(3, 16, 60, 12, 9),
                 60)
    assert asked == []


# --- the benchmark's reader -----------------------------------------------------------


def _reader():
    from portbench import spec

    return spec.load("transr-fb15k.train", REPO).reader("train.chunk_kernel_share")


def _snap(counters, roots=2):
    spans = {"kb2e.train.apply": {"count": roots, "total_s": 1.0, "self_s": 0.1}} if roots else {}
    return {"spans": spans, "counters": {"sampler.slots": 10, **counters}}


@pytest.mark.parametrize("snap, want", [
    (_snap({"train.chunks": 3778, "train.chunks_replayed": 0, "train.chunks_kernel": 3778}), 100.0),
    (_snap({"train.chunks": 400, "train.chunks_replayed": 300, "train.chunks_kernel": 100}), 25.0),
    (_snap({"train.chunks": 400, "train.chunks_replayed": 400, "train.chunks_kernel": 0}), 0.0),
    (_snap({"train.chunks": 400, "train.chunks_replayed": 400}), None),  # a program without the kernel's counter
    (_snap({"sampler.retried": 0}), None),  # a program without the chunk counters
    (_snap({"train.chunks": 0, "train.chunks_kernel": 0}), None),
    (_snap({"train.chunks": 4, "train.chunks_kernel": 4}, roots=0), None),  # no epoch closed
])
def test_the_share_is_kernel_chunks_over_applied_chunks(monkeypatch, snap, want):
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    got = _reader().read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_its_entry_and_reader_agree():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["train.chunk_kernel_share"]
    reader = _reader()
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    assert entry["workloads"] == ["transr-fb15k.train", "ctransr-fb15k.train"]
    assert entry["source"] == "program_counter" and entry["better"] == "higher"
    layers = {m["layer"] for m in bench["per_layer"] if m["name"] in ("train.apply_ms", "train.chunk_graph_share")}
    assert layers == {entry["layer"]}


# --- on the card ---------------------------------------------------------------------


def _graph(params, feed, cfg):
    """The same chunks replayed as TransR's CUDA graph (``ChunkGraph``)."""
    graph = transr.ChunkGraph(get_model("transr"), cfg, params, feed["ph"].shape[1]).load(params, feed)
    for i in range(feed["ph"].shape[0]):
        graph(i)
    return graph.params(), graph.loss


def _active_pairs(params, feed, cfg):
    """(active, all) pairs of the descent over the valid samples of the
    chunks, on the tables as the dyadic cycles leave them after stage 3:
    the start rows sphere-normed (each chunk's valid rows are fresh)."""
    n = params["entity"].shape[0]
    fused = base.fuse(params).double()
    fused = fused / fused.norm(dim=1, keepdim=True)
    proj = params["proj"].double()
    proj = proj / proj.norm(dim=2, keepdim=True)
    valid = feed["valid"].reshape(-1)
    ph, pt, r, nh, nt = (feed[key].reshape(-1)[valid].long() for key in KEYS[:-1])
    rows = torch.stack([ph, pt, torch.where(nh != ph, nh, nt), n + r])
    p = torch.einsum("sbj,bji->sbi", fused[rows], proj[r])
    # Every valid sample violates its margin, on the rows as the chunk
    # starts (each as drawn, or sphere-normed by an earlier chunk).
    for table, w in ((base.fuse(params).double(), params["proj"].double()), (fused, proj)):
        res = [torch.einsum("bj,bji->bi", table[t], w[r]) - torch.einsum("bj,bji->bi", table[h], w[r]) - table[n + r]
               for h, t in ((ph, pt), (nh, nt))]
        e = [x.abs().sum(-1) if cfg.distance == int(Distance.L1) else (x * x).sum(-1) for x in res]
        assert float((e[1] - e[0]).max()) < cfg.margin / 2
    return int(((p * p).sum(-1) > 1).sum()), rows.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("k", [50, 100, 33, 16])
def test_the_kernel_equals_chunk_update_and_its_graph_bit_for_bit_on_dyadic_chunks(cuda, distance, k):
    n, n_rel, chunk = 700, 80, 64
    host = _dyadic_tables(n, n_rel, k, seed=10 + k + int(distance))
    feed_host = _cycle_feed(4, chunk, n, n_rel, seed=20 + k + int(distance))
    params = {key: v.to(cuda) for key, v in host.items()}
    feed = {key: v.to(cuda) for key, v in feed_host.items()}
    cfg = _cfg(distance, k)
    active, pairs = _active_pairs(host, feed_host, cfg)
    assert 0 < active < pairs  # the descent steps on some pairs and not on others
    want, want_loss = _eager(params, feed, cfg)
    graph, graph_loss = _graph(params, feed, cfg)
    cuda_build.reset_launch_counts()
    got, loss = _kernels(params, feed, cfg)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {name: 1 for name in transr_fast.KERNEL_NAMES}  # one run
    for key in want:
        assert torch.equal(got[key], want[key]), (key, float((got[key] - want[key]).abs().max()))
        assert torch.equal(got[key], graph[key]), key
        assert not torch.equal(got[key], params[key]), key
    assert torch.equal(loss, want_loss) and torch.equal(loss, graph_loss)
    assert float(loss[1]) == 0 and all(float(x) > 0 for x in (loss[0], loss[2], loss[3]))


def _distinct_feed(n_chunks, chunk, n, n_rel, seed, dev):
    """[n_chunks, chunk] ids and valid: in each chunk 3/4 of the samples valid,
    on rows and relations no other valid sample of the chunk touches (both
    sides corrupted), the rest invalid on the same rows (tail corrupted,
    nh = ph).  No row or matrix of a chunk then takes two non-zero steps,
    and every sum of steps is exact in any order."""
    rng = np.random.default_rng(seed)
    out = {key: np.zeros((n_chunks, chunk), np.int32) for key in KEYS[:-1]}
    out["valid"] = np.zeros((n_chunks, chunk), bool)
    n_valid = chunk * 3 // 4
    for c in range(n_chunks):
        ents, rels = rng.permutation(n)[:4 * n_valid].reshape(4, n_valid), rng.permutation(n_rel)[:n_valid]
        for key, ids in zip(("ph", "pt", "nh", "nt", "r"), (*ents, rels)):
            out[key][c, :n_valid] = ids
            out[key][c, n_valid:] = rng.choice(ids, chunk - n_valid)
        out["nh"][c, n_valid:] = out["ph"][c, n_valid:]
        out["valid"][c, :n_valid] = True
    return {key: torch.from_numpy(v).to(dev) for key, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_the_kernel_sums_as_cublas_at_the_benchmark_width(cuda, distance):
    # At k 50 and chunks of 256 the kernel's dot products add in the orders
    # cuBLAS's kernels for chunk_update_'s products use on an H100, so
    # where no row takes two steps it equals chunk_update_ bit for bit on
    # unrounded tables too.  A torch or card whose cuBLAS adds in other
    # orders fails here first (and the benchmark's start checks may then
    # read a flipped step of the descent, PERF.md §6).
    k, n, n_rel = 50, 3000, 400
    params = _init_tables(n, n_rel, k, seed=60 + int(distance), dev=cuda)
    feed = _distinct_feed(2, 256, n, n_rel, seed=61 + int(distance), dev=cuda)
    cfg = _cfg(distance, k, lr=0.001, margin=1.0)
    want, want_loss = _eager(params, feed, cfg)
    got, loss = _kernels(params, feed, cfg)
    for key in want:
        assert torch.equal(got[key], want[key]), (key, int((got[key] != want[key]).sum()))
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)


def _init_tables(n, n_rel, k, seed, dev):
    """TransR-init-like tables: rows of N(0, 1/k) ball-normed, W = I plus noise of scale 1/k."""
    g = torch.Generator().manual_seed(seed)
    ent, rel = (torch.randn(m, k, generator=g) / k ** 0.5 for m in (n, n_rel))
    ent, rel = (x / x.norm(dim=1, keepdim=True).clamp(min=1.0) for x in (ent, rel))
    proj = torch.eye(k) + torch.randn(n_rel, k, k, generator=g) / k
    return {"entity": ent.to(dev), "relation": rel.to(dev), "proj": proj.contiguous().to(dev)}


def _random_feed(n_chunks, chunk, n, n_rel, seed, dev):
    g = torch.Generator().manual_seed(seed)
    feed = {key: torch.randint(0, n_rel if key == "r" else n, (n_chunks, chunk), generator=g, dtype=torch.int32)
            for key in KEYS[:-1]}
    feed["valid"] = torch.rand(n_chunks, chunk, generator=g) > 0.1
    return {key: v.to(dev) for key, v in feed.items()}


# The largest difference the kernel may show from chunk_update_ on the card
# at the benchmark's rate, element by element: at k 100 its dot products add
# in another order than cuBLAS's, and a row's steps add in slot order where
# index_add's atomics may land otherwise, each an ulp or so of a value of
# order 1 (6e-8) that the following chunks carry on (the card read at most
# 1.8e-7 over six chunks).  An L1 direction flipped by such an ulp (a
# residual coordinate within it of 0) would move a row by 2 lr: the seeds
# here flip none.
RANDOM_ATOL = 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("k", [50, 100])
def test_the_kernel_stays_within_rounding_of_chunk_update_on_init_tables(cuda, distance, k):
    n, n_rel, chunk, n_chunks = 3000, 120, 256, 6
    params = _init_tables(n, n_rel, k, seed=30 + k, dev=cuda)
    feed = _random_feed(n_chunks, chunk, n, n_rel, seed=31 + k + int(distance), dev=cuda)
    cfg = _cfg(distance, k, lr=0.001, margin=1.0)
    want, want_loss = _eager(params, feed, cfg)
    again, _ = _eager(params, feed, cfg)
    got, loss = _kernels(params, feed, cfg)
    for key in want:
        err, itself = float((got[key] - want[key]).abs().max()), float((again[key] - want[key]).abs().max())
        print(f"{key}: kernels {err:.3e} from chunk_update_, which parts from itself by {itself:.3e}")
        assert err <= RANDOM_ATOL, key
        assert not torch.equal(got[key], params[key]), key
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_a_whole_epoch_through_the_runner_equals_the_eager_chunks_in_runs_of_chunks(
        cuda, distance):
    k, n, n_rel, chunk = 50, 3000, 700, 32
    n_chunks = transr_fast.RUN + 6  # two runs
    params = {key: v.to(cuda) for key, v in _dyadic_tables(n, n_rel, k, seed=40 + int(distance)).items()}
    feed = {key: v.to(cuda) for key, v in _cycle_feed(n_chunks, chunk, n, n_rel, seed=41 + int(distance)).items()}
    cfg = _cfg(distance, k)
    runner = step_lib.EpochRunner(get_model("transr"), cfg, chunk, n_chunks)
    assert runner.chunk == chunk
    before = {key: v.clone() for key, v in params.items()}
    cuda_build.reset_launch_counts()
    (got, loss), snap = _apply_traced(runner, params, feed, n)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {name: 2 for name in transr_fast.KERNEL_NAMES}
    assert "graph" not in runner.kept
    counters = snap["counters"]
    assert counters["train.chunks"] == counters["train.chunks_kernel"] == n_chunks
    assert counters["train.chunks_replayed"] == 0
    want, want_loss = _eager(params, feed, cfg)
    for key in params:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(params[key], before[key]), key
    assert torch.equal(loss, want_loss.sum()) and float(loss) > 0
