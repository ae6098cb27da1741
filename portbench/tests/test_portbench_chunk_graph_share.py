"""``train.chunk_graph_share``: 100 · the chunks replayed as a CUDA graph over
the chunks applied, read from the program's counters; nothing without them."""

import json

import pytest

from portbench import spec

REPO = spec.HERE.parent


def _read(monkeypatch, snap):
    from kb2e_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return spec.load("transr-fb15k.train", REPO).reader("train.chunk_graph_share").read(None)


def _snap(counters):
    return {"spans": {"kb2e.train.apply": {"count": 2, "total_s": 1.0, "self_s": 0.1}}, "counters": counters}


@pytest.mark.parametrize("counters, want", [
    ({"train.chunks": 3778, "train.chunks_replayed": 3778}, 100.0),
    ({"train.chunks": 400, "train.chunks_replayed": 300}, 75.0),
    ({"train.chunks": 400, "train.chunks_replayed": 0}, 0.0),
])
def test_the_share_is_replayed_over_applied_chunks(monkeypatch, counters, want):
    assert _read(monkeypatch, _snap({"sampler.slots": 10, **counters})) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    _snap({"sampler.slots": 10, "sampler.retried": 0}),  # a program without the counters: the parent's
    _snap({"train.chunks": 0, "train.chunks_replayed": 0}),
    {"spans": {}, "counters": {"train.chunks": 4, "train.chunks_replayed": 4}},  # no epoch closed
])
def test_without_the_counters_it_reads_nothing(monkeypatch, snap):
    assert _read(monkeypatch, snap) is None


def test_its_entry_and_reader_agree():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["train.chunk_graph_share"]
    reader = spec.load("transr-fb15k.train", REPO).reader("train.chunk_graph_share")
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    assert entry["workloads"] == ["transr-fb15k.train"] and entry["source"] == "program_counter"
