"""BENCHMARK.json resolves to its files, and new files are found by name."""

import json
import re
import shutil

import pytest

from conftest import REPO
from portbench import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = spec.load(cell)
    assert c.config["model"] and c.traffic["kind"] in ("train", "eval") and c.limits["limits"]
    assert c.traffic["rate_metric"] in [m["name"] for m in c.end_to_end]
    assert "setup_s" in [m["name"] for m in c.end_to_end] and c.per_layer
    assert c.model.LEAVES
    for entry in c.per_layer:
        reader = c.reader(entry["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
        assert callable(reader.read)


def test_a_new_cell_mix_and_metric_are_found_by_their_files(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "transe-fb15k.train-k8", "config": "transe-fb15k", "traffic": "train-k8",
                               "chips": 1, "why": "K 8 negatives"})
    bench["end_to_end"][0]["workloads"].append("transe-fb15k.train-k8")
    bench["per_layer"].append({"name": "train.epochs", "unit": "epochs", "better": "higher", "source": "host_clock",
                               "layer": "epoch loop", "moves": "train_triples_per_s",
                               "workloads": ["transe-fb15k.train-k8", "transr-fb15k.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((REPO / "portbench/traffic/train.json").read_text())
    mix["embedding"] = {"num_negatives": 8}
    (tmp_path / "portbench/traffic/train-k8.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/limits/transe-fb15k.train-k8.json").write_text(
        (REPO / "portbench/limits/transe-fb15k.train.json").read_text())
    (tmp_path / "portbench/metrics/train.epochs.py").write_text(
        'UNIT = "epochs"\nLAYER = "epoch loop"\nMOVES = "train_triples_per_s"\n\n\ndef read(rec):\n'
        '    return float(len(rec.step_s))\n')

    c = spec.load("transe-fb15k.train-k8", tmp_path)
    assert c.traffic["embedding"] == {"num_negatives": 8}
    names = [m["name"] for m in c.per_layer]
    assert "train.epochs" in names and "train_mfu" not in names  # each metric lists its cells
    assert c.reader("train.epochs").read(type("Rec", (), {"step_s": [1.0, 2.0]})) == 2.0
    assert "train.epochs" in [m["name"] for m in spec.load("transr-fb15k.train", tmp_path).per_layer]
    assert "train.epochs" not in [m["name"] for m in spec.load("transe-fb15k.eval", tmp_path).per_layer]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.load("transe-fb15k.nothing")
