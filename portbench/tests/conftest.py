"""Fixtures: a copy of the benchmark with its configurations cut to a size a
test on the CPU can run, and the card for tests marked ``cuda``."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_GRAPH = {"n_entities": 120, "n_relations": 7, "n_train": 1600, "n_valid": 100, "n_test": 150}
SMALL_GRAPH = {"n_entities": 2000, "n_relations": 30, "n_train": 20000, "n_valid": 1000, "n_test": 2000}


def tiny_root(tmp: Path, k=8, num_batches: int = 4, graph=TINY_GRAPH) -> Path:
    """``tmp`` as a checkout holding the benchmark, its configurations cut to
    ``graph``'s counts, ``num_batches`` and k (None: the configuration's);
    limits as committed."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copytree(REPO / "portbench", tmp / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for entry in bench["configs"]:
        path = tmp / entry["file"]
        config = json.loads(path.read_text())
        config["graph"].update(graph)
        config["embedding"].update(num_batches=num_batches, **({} if k is None else {"embedding_size": k}))
        path.write_text(json.dumps(config))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_root(tmp_path)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
