"""The port's spans and counters (``kb2e_tpu_torch/utils/profiling.py``), the
layers that carry them, and the benchmark's readers of them.

Spans record only under ``torch.profiler``; these tests run it on the CPU.
"""

import collections
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.cli import eval_transe, train_transe
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.parallel import mesh as mesh_lib
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


@contextlib.contextmanager
def _recording():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def _spans():
    return profiling.snapshot()["spans"]


def test_a_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    assert not profiling.recording()

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    with monkeypatch.context() as m:
        m.setattr(profiling.time, "perf_counter_ns", no_clock)
        m.setattr(profiling.time, "time_ns", no_clock)
        outer, inner = profiling.span("kb2e.a"), profiling.span("kb2e.b")
        assert outer is inner
        with outer:
            with inner:
                profiling.count("c", 3)
                profiling.count_device("d", torch.tensor(2))
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert profiling.records() == []


def _dataset(tiny_kg_dir):
    return triples.load_dataset(tiny_kg_dir, splits=("train", "valid", "test"))


@pytest.mark.parametrize("name", ["transe", "transr", "ctransr"])
def test_rank_all_records_each_layer_once_a_pass_and_the_feed_counts(tiny_kg_dir, name):
    # TransE ranks in one group; TransR in one group per relation of the test
    # split; CTransR in the same groups through its routed batches.
    dataset = _dataset(tiny_kg_dir)
    cfg = EmbeddingConfig(embedding_size=8, eval_batch_size=16)
    model = get_model(name)
    params = model.init_params(torch.Generator().manual_seed(0), dataset.n_entities, dataset.n_relations, cfg, "cpu")
    with _recording():
        raw, _, sizes = harness.rank_all(model, params, dataset, cfg, device="cpu")
    n_groups = 1 if name == "transe" else np.unique(dataset.test[2]).shape[0]
    spans = _spans()
    assert {key: s["count"] for key, s in spans.items()} == {
        "kb2e.eval.rank_all": 1, "kb2e.eval.filter_index": 1, "kb2e.eval.feed": 1,
        "kb2e.eval.group": n_groups, "kb2e.eval.batch": len(sizes), "kb2e.eval.fetch": 1}
    # The feed: every query, and each group padded to whole batches of 16.
    assert sum(sizes) == raw.shape[0] == 2 * dataset.test[0].shape[0]
    assert profiling.snapshot()["counters"] == {"eval.queries": sum(sizes), "eval.slots": 16 * len(sizes)}
    # Every span but the root lies under it, in the one pass.
    recs = profiling.records()
    assert [r.name for r in recs if r.parent == -1] == ["kb2e.eval.rank_all"] and {r.root for r in recs} == {0}
    for r in recs:
        if r.name == "kb2e.eval.batch":
            assert recs[r.parent].name == "kb2e.eval.group"


@pytest.mark.parametrize("name, mesh", [("transe", False), ("transr", False), ("transe", True)])
def test_an_epoch_records_one_span_a_batch_or_chunk(tiny_kg_dir, name, mesh):
    ts = triples.load_dataset(tiny_kg_dir).train
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    cfg = EmbeddingConfig(embedding_size=8, num_batches=3)
    batch_size = step_lib.batch_size_for(ts.num_triples, 3)
    model = get_model(name)
    runner = step_lib.EpochRunner(model, cfg, batch_size, 3, mesh=mesh_lib.single_device_mesh("cpu") if mesh else None)
    params = model.init_params(torch.Generator().manual_seed(1), ts.n_entities, ts.n_relations, cfg, "cpu")
    with _recording():
        runner(params, torch.Generator().manual_seed(2), data)
    # TransR's epoch is cut into chunks of min(256, batch): 3 batches padded to whole chunks.
    n = 3 if name == "transe" else -(-3 * batch_size // min(256, batch_size))
    spans = _spans()
    assert {key: s["count"] for key, s in spans.items()} == {
        "kb2e.train.sample": 1, "kb2e.train.apply": 1, "kb2e.train.batch": n}
    counters = profiling.snapshot()["counters"]
    assert counters["sampler.slots"] == 3 * batch_size and 0 <= counters["sampler.retried"] <= 3 * batch_size
    assert [r.root for r in profiling.records() if r.name == "kb2e.train.batch"] == [1] * n


def test_sampler_retried_equals_a_recount_of_the_first_candidates():
    # A dense graph: 12 entities, 2 relations, about half of all (h, r, t)
    # known, so a first candidate is often a known triple.
    rng = np.random.default_rng(5)
    n_ent, n_rel = 12, 2
    keys = rng.choice(n_ent * n_ent * n_rel, size=150, replace=False)
    h, rest = np.divmod(keys, n_ent * n_rel)
    t, r = np.divmod(rest, n_rel)
    ts = triples.TripleSet.from_arrays(h.astype(np.int32), t.astype(np.int32), r.astype(np.int32), n_ent, n_rel)
    data = step_lib.DeviceData.from_triple_set(ts, "cpu")
    cfg = EmbeddingConfig(embedding_size=4, method=1, num_negatives=2, corruption_resample_rounds=4)
    batch_size = 200
    with _recording():
        batch = step_lib.sample_batch(torch.Generator().manual_seed(9), data, cfg, batch_size)
    assert batch["nh"].shape[0] == 2 * batch_size

    # The same draws again, in sample_batch's order: triples, coins, candidates.
    g = torch.Generator().manual_seed(9)
    i = torch.randint(0, ts.num_triples, (batch_size,), generator=g).numpy()
    coin = (torch.rand(batch_size, generator=g) < data.bern_pr_tail[data.rels[i]]).numpy()
    cands = torch.randint(0, n_ent, (batch_size, 2, 4), generator=g).numpy()
    known = set(zip(ts.heads.tolist(), ts.rels.tolist(), ts.tails.tolist()))
    ph, pt, pr = ts.heads[i], ts.tails[i], ts.rels[i]
    retried = sum(((ph[b], pr[b], int(cands[b, j, 0])) if coin[b] else (int(cands[b, j, 0]), pr[b], pt[b])) in known
                  for b in range(batch_size) for j in range(2))
    assert 0.2 * 2 * batch_size < retried < 2 * batch_size
    assert profiling.snapshot()["counters"] == {"sampler.slots": 2 * batch_size, "sampler.retried": retried}


def test_self_time_is_total_less_the_children_and_roots_count_in_order():
    with _recording():
        for _ in range(2):
            with profiling.span("kb2e.root"):
                with profiling.span("kb2e.child"):
                    with profiling.span("kb2e.leaf"):
                        sum(range(20000))
                    sum(range(20000))
                with profiling.span("kb2e.child"):
                    sum(range(20000))
                sum(range(20000))
    recs = profiling.records()
    assert [r.root for r in recs] == [0] * 4 + [1] * 4
    assert [recs[r.parent].name if r.parent >= 0 else None for r in recs[:4]] == [
        None, "kb2e.root", "kb2e.child", "kb2e.root"]
    spans = _spans()
    for name in ("kb2e.root", "kb2e.child", "kb2e.leaf"):
        mine = [j for j, r in enumerate(recs) if r.name == name]
        total = sum(recs[j].end_ns - recs[j].start_ns for j in mine)
        children = sum(r.end_ns - r.start_ns for r in recs if r.parent in mine)
        assert spans[name]["count"] == len(mine)
        assert spans[name]["total_s"] == pytest.approx(total * 1e-9, abs=1e-9)
        assert spans[name]["self_s"] == pytest.approx((total - children) * 1e-9, abs=1e-9)
        assert 0 < spans[name]["self_s"] < spans[name]["total_s"] or name == "kb2e.leaf"
    assert spans["kb2e.leaf"]["self_s"] == pytest.approx(spans["kb2e.leaf"]["total_s"], abs=1e-9)


def _clock_gaps():
    profiling.reset()
    with _recording() as prof:
        with profiling.span("kb2e.warm"):  # the profiler's first annotation costs more
            pass
        for _ in range(3):
            with profiling.span("kb2e.outer"):
                with profiling.span("kb2e.inner"):
                    torch.ones(64).sum()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("kb2e.outer", "kb2e.inner"):
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    mine = {}
    for r in profiling.records():
        if r.name in ("kb2e.outer", "kb2e.inner"):
            mine.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    assert {k: len(v) for k, v in events.items()} == {k: len(v) for k, v in mine.items()} == {
        "kb2e.outer": 3, "kb2e.inner": 3}
    return max(abs(a - b) for name in mine for x, y in zip(sorted(mine[name]), sorted(events[name]))
               for a, b in zip(x, y))


def test_registry_spans_lie_on_the_profiler_clock():
    # Within 100 µs of the profiler's event of the same name; a thread
    # descheduled between the two clock reads can widen one edge, so the
    # loop may run up to three times.
    gaps = []
    for _ in range(3):
        gaps.append(_clock_gaps())
        if gaps[-1] < 100_000:
            break
    assert min(gaps) < 100_000, gaps


# --- the benchmark's readers ---------------------------------------------------------


def _reader(metric):
    path = REPO / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(count, total_s, self_s=None):
    return {"count": count, "total_s": total_s, "self_s": total_s if self_s is None else self_s}


EVAL_SNAPSHOT = {
    "spans": {"kb2e.eval.rank_all": _span(2, 3.0), "kb2e.eval.filter_index": _span(2, 0.5),
              "kb2e.eval.feed": _span(2, 0.1), "kb2e.eval.group": _span(4, 2.0, 0.3),
              "kb2e.eval.batch": _span(800, 0.4), "kb2e.eval.fetch": _span(2, 0.004)},
    "counters": {"eval.queries": 300, "eval.slots": 400},
}
TRAIN_SNAPSHOT = {
    "spans": {"kb2e.train.sample": _span(4, 0.01), "kb2e.train.apply": _span(4, 0.3),
              "kb2e.train.batch": _span(400, 0.28), "kb2e.transh.project": _span(800, 0.2)},
    "counters": {"sampler.slots": 20000, "sampler.retried": 13, "train.chunks": 400, "train.chunks_replayed": 300,
                 "ctransr.routed": 19000, "ctransr.routed_top": 6650, "transh.project_calls": 800,
                 "transh.project_syncs": 1000, "transh.project_capped": 3},
}


@pytest.mark.parametrize("metric, snap, want", [
    ("eval.filter_index_ms", EVAL_SNAPSHOT, 250.0),
    ("eval.feed_ms", EVAL_SNAPSHOT, 50.0),
    ("eval.group_self_ms", EVAL_SNAPSHOT, 150.0),
    ("eval.batch_host_us", EVAL_SNAPSHOT, 500.0),
    ("eval.fetch_ms", EVAL_SNAPSHOT, 2.0),
    ("eval.pad_share", EVAL_SNAPSHOT, 25.0),
    ("train.batch_host_us", TRAIN_SNAPSHOT, 700.0),
    ("train.sampler_retry_share", TRAIN_SNAPSHOT, 0.065),
    ("train.chunk_graph_share", TRAIN_SNAPSHOT, 75.0),
    ("train.cluster_top_share", TRAIN_SNAPSHOT, 35.0),
    ("train.projector_ms", TRAIN_SNAPSHOT, 50.0),
    ("train.projector_syncs_per_batch", TRAIN_SNAPSHOT, 2.5),
])
def test_each_reader_reads_its_number_and_none_without_a_root_span(monkeypatch, metric, snap, want):
    reader = _reader(metric)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[metric]
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert reader.read(None) == pytest.approx(want)
    roots = {"kb2e.eval.rank_all", "kb2e.train.apply", "kb2e.train.sample"}
    rootless = {"spans": {k: v for k, v in snap["spans"].items() if k not in roots}, "counters": snap["counters"]}
    monkeypatch.setattr(profiling, "snapshot", lambda: rootless)
    assert reader.read(None) is None
    # A program without the registry (the parent of this change) reads as nothing.
    monkeypatch.delattr(profiling, "snapshot")
    assert reader.read(None) is None


@pytest.mark.parametrize("metric", ["train.projector_ms", "train.projector_syncs_per_batch"])
def test_the_projector_readers_read_nothing_without_its_span_or_counters(monkeypatch, metric):
    # The parent of the projector's spans: an epoch's spans and counters, none of TransH's projector.
    parent = {"spans": {k: v for k, v in TRAIN_SNAPSHOT["spans"].items() if k != "kb2e.transh.project"},
              "counters": {k: v for k, v in TRAIN_SNAPSHOT["counters"].items() if not k.startswith("transh.")}}
    monkeypatch.setattr(profiling, "snapshot", lambda: parent)
    assert _reader(metric).read(None) is None
    entry = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]}[metric]
    assert entry["workloads"] == ["transh-fb15k.train"] and entry["better"] == "lower"


def _transh_batch():
    """TransH's model, tables, one batch and a config whose rate makes the projector fire."""
    from portbench.reference import transh

    n, n_rel, k, b = 64, 8, 16, 40
    tables = transh.init_tables(torch.Generator().manual_seed(1), n, n_rel, k, "train")
    g = torch.Generator().manual_seed(2)
    batch = {key: torch.randint(0, n_rel if key == "r" else n, (b,), generator=g, dtype=torch.int32)
             for key in ("ph", "pt", "r", "nt")}
    batch["nh"], batch["valid"] = batch["ph"].clone(), torch.ones(b, dtype=torch.bool)
    return get_model("transh"), tables, batch, EmbeddingConfig(embedding_size=k, learning_rate=0.05)


def test_a_transh_batch_counts_two_projector_calls_and_a_sync_a_trip(monkeypatch):
    model, tables, batch, cfg = _transh_batch()
    syncs = []
    as_bool = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: syncs.append(1) or as_bool(t))
    with _recording():
        model.batch_update(tables, batch, cfg)
    monkeypatch.undo()
    snap = profiling.snapshot()
    assert snap["spans"]["kb2e.transh.project"]["count"] == 2
    counters = snap["counters"]
    assert counters["transh.project_calls"] == 2 and counters["transh.project_syncs"] == len(syncs) > 2
    assert counters["transh.project_capped"] == 0


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched while it is open."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_with_tracing_off_the_projector_counts_nothing_and_adds_no_operator():
    model, tables, batch, cfg = _transh_batch()
    with _Ops() as off:
        model.batch_update(tables, batch, cfg)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    with _recording():
        with _Ops() as on:
            model.batch_update(tables, batch, cfg)
    assert not off.ops - on.ops
    # Recording adds only the capped counter's sum (one a call) and its copy
    # and add into the registry, beside the profiler's own annotations.
    extra = {name: n for name, n in (on.ops - off.ops).items() if name.startswith("aten.")}
    assert extra["aten.sum"] == 2 and set(extra) <= {"aten.sum", "aten.detach", "aten._to_copy", "aten.add_"}


def test_eval_cli_profile_dir_traces_the_pass(tiny_kg_dir, tmp_path):
    out_dir, trace_dir = str(tmp_path / "o"), tmp_path / "trace"
    common = ["--datadir", tiny_kg_dir, "--outdir", out_dir, "--size", "8", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        train_transe.main(common + ["--batches", "4", "--epochs", "1", "--seed", "7"])
        eval_transe.main(common + ["--eval-batch", "64", "--profile-dir", str(trace_dir)])
    names = {e.get("name") for e in json.loads((trace_dir / "trace.json").read_text())["traceEvents"]}
    assert {"kb2e.eval.rank_all", "kb2e.eval.filter_index", "kb2e.eval.batch", "kb2e.eval.fetch"} <= names
