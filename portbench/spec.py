"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration's file is
the one ``BENCHMARK.json`` gives it; the mix is ``traffic/<traffic>.json``,
the cell's limits ``limits/<cell>.json`` and a per-layer metric's reader
``metrics/<metric>.py``, all under the benchmark's folder; the model's plain
reference is ``reference/<model>.py``.  Adding a configuration, a mix, a
cell or a metric is adding its file and its entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration's file
    traffic: Dict  # the mix's file
    limits: Dict  # the cell's limits file
    end_to_end: List[Dict]  # the entries of the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the entries of the per-layer metrics this cell reports
    root: Path  # the checkout: where BENCHMARK.json lies

    @property
    def model(self) -> ModuleType:
        """The configuration's model's plain reference."""
        return importlib.import_module(f"portbench.reference.{self.config['model']}")

    def reader(self, metric: str) -> ModuleType:
        """A per-layer metric's reader, loaded from its file."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    @property
    def bench_dir(self) -> Path:
        return self.root / "portbench"


def load(cell: str, root: Path = HERE.parent) -> Cell:
    """The cell named ``cell`` of ``root``'s ``BENCHMARK.json``, with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[cell]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "portbench"

    def read(path: Path) -> Dict:
        return json.loads(path.read_text())

    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    return Cell(
        name=cell, chips=int(w["chips"]), config=read(root / config["file"]),
        traffic=read(here / "traffic" / f"{w['traffic']}.json"), limits=read(here / "limits" / f"{cell}.json"),
        end_to_end=e2e, per_layer=[m for m in bench["per_layer"] if cell in m["workloads"]], root=root,
    )
