"""Runs one cell once: set-up, the measured window, the check.

Set-up makes the graph from the seed (``data/graph.py``) and the tables on
the device (the model's ``reference/<model>.py``), builds the program's
objects and drives them through the steps that warm every shape the window
uses.  The window repeats one step, the same call the program's own loop
makes, until ``seconds`` have passed, and ends with the step in which they
did: a training step is one epoch of ``train/step.py::EpochRunner``
(``sample``, ``apply``, then the loss fetched as ``train/loop.py`` does); an
eval step is one ``eval/harness.py::rank_all`` over the test split.  Then
the peak memory is read, the program's state freed, and the plain reference
checks what the program produced (``checks.py``).

``control`` runs the program in a lower precision for the calibration of the
limits (``control.py``); a benchmark run never sets it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import os
import random
import statistics
import time
from types import ModuleType
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from portbench import checks, roofline, spec, trace as trace_lib
from portbench.data import graph as graph_lib
from portbench.reference import ranks as ref_ranks

# The lower precisions a calibration runs in place of the configured float32:
# the program under TF32 (its matrix products), the program with its tables
# stored in bfloat16 (its own ``param_dtype`` path), or, for a program that
# has no such path, the plain reference with its tables stored in bfloat16.
CONTROLS = (None, "tf32", "bf16_tables", "bf16_reference")


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader reads (``metrics/<metric>.py``)."""

    kind: str  # the mix's kind: "train" or "eval"
    on_card: bool  # False in a test on the CPU: no device metric is read then
    k: int
    l1: bool
    n_entities: int
    model: ModuleType  # the model's plain reference (its work counts)
    spans: Dict[str, List[float]]  # seconds of each span, one per step of the window
    step_s: List[float]  # each step of the window (none traced by the profiler)
    units_per_step: int  # positive triples (train) or queries (eval) a step
    trace: Optional[trace_lib.Trace]
    work: List[List[roofline.Work]]  # train: each traced epoch's batches; eval: a pass's
    group_queries: List[int]  # eval: the queries of each ranking group

    def median_step_s(self) -> float:
        """The window's median step (the profiler records none of them)."""
        return statistics.median(self.step_s)


def _seed(seed: int, stream: int) -> int:
    return (2 * seed + stream) % 2**63


def _config(cell: spec.Cell, seed: int, control):
    from kb2e_tpu_torch.config import EmbeddingConfig
    from kb2e_tpu_torch.constants import Distance, Method

    emb = {**cell.config["embedding"], **cell.traffic.get("embedding", {})}
    if control == "bf16_tables":
        emb["param_dtype"] = "bfloat16"
    emb["method"], emb["distance"] = Method.from_any(emb["method"]), Distance.from_any(emb["distance"])
    return EmbeddingConfig(**emb, seed=seed)


class _Train:
    """Epochs of the fast update.

    Set-up samples the first epoch and applies its first ``check_steps``
    batches (TransR: chunks) one ``apply`` call each: the start, which the
    reference follows from the benchmark's tables.  The window then runs
    whole epochs from there.  A sample of the window's epochs, drawn from
    the seed, is kept for the sampler's judge.  After the window,
    :meth:`finish` samples one more epoch and applies it through the same
    call and feed shape, with all but its first ``check_steps`` batches
    masked out, from the tables the window left: the stage the reference
    follows from the program's own state."""

    def __init__(self, cell: spec.Cell, graph, device, seed: int, control):
        from kb2e_tpu_torch.data.triples import TripleSet
        from kb2e_tpu_torch.models.base import get_model
        from kb2e_tpu_torch.train import step as step_lib

        self.cfg = cfg = _config(cell, seed, control)
        if cfg.update_mode != "fast":
            raise ValueError("the train mix runs the fast update only")
        g = cell.config["graph"]
        self.n_ent, n_rel, k = int(g["n_entities"]), int(g["n_relations"]), cfg.embedding_size
        self.ref, self.control = cell.model, control
        ts = TripleSet.from_arrays(*graph["train"], self.n_ent, n_rel)
        self.data = step_lib.DeviceData.from_triple_set(ts, device)
        batch_size = step_lib.batch_size_for(ts.num_triples, cfg.num_batches)
        self.runner = step_lib.EpochRunner(get_model(cell.config["model"]), cfg, batch_size, cfg.num_batches)
        self.units = batch_size * cfg.num_batches
        self.rows = self.units * max(1, cfg.num_negatives)
        self.steps = int(cell.traffic["check_steps"])
        self.kept, self.judged_epochs = [], int(cell.traffic["judged_epochs"])
        self.pick, self.seen = random.Random(_seed(seed, 2)), 0
        self.ref_start = self.ref.init_tables(torch.Generator(device).manual_seed(_seed(seed, 0)),
                                              self.n_ent, n_rel, k, "train")
        if control == "bf16_tables":
            self.prog_start = {key: v.bfloat16() for key, v in self.ref_start.items()}
        elif control == "bf16_reference":
            self.prog_start = {key: v.bfloat16().float() for key, v in self.ref_start.items()}
        else:
            self.prog_start = dict(self.ref_start)
        self.params = {key: v.clone() for key, v in self.prog_start.items()}
        self.gen = torch.Generator(device).manual_seed(_seed(seed, 1))
        # The start: the first epoch's first batches, one call each, the
        # state kept after the first and the last of them.
        self.epoch = self.runner.sample(self.gen, self.data)
        self.losses, self.states = [], []
        for i in range(self.steps):
            self.params, loss = self._apply(self.params, {key: v[i:i + 1] for key, v in self.epoch.items()})
            self.losses.append(float(loss))
            if i in (0, self.steps - 1):
                self.states.append({key: v.clone() for key, v in self.params.items()})

    def _apply(self, params, batches):
        """The program's ``apply``, or for the ``bf16_reference`` control the
        plain reference in its place, its tables stored in bfloat16 after
        every batch."""
        if self.control != "bf16_reference":
            return self.runner.apply(params, batches, self.n_ent)
        cfg, loss = self.cfg, 0.0
        for i in range(batches["ph"].shape[0]):
            params, part = self.ref.fast_epoch(params, {key: v[i:i + 1] for key, v in batches.items()},
                                               cfg.learning_rate, cfg.margin, int(cfg.distance) == 0)
            params, loss = {key: v.bfloat16().float() for key, v in params.items()}, loss + part
        return params, torch.tensor(loss)

    def step(self, spans):
        with spans("sample"):
            batches = self.runner.sample(self.gen, self.data)
        with spans("apply"):
            self.params, loss = self.runner.apply(self.params, batches, self.n_ent)
        with spans("sync"):
            float(loss)
        self._keep(batches)
        return batches

    def _keep(self, batches) -> None:
        """A uniform sample of ``judged_epochs`` of the epochs run so far,
        drawn from the seed (reservoir sampling, in the order they ran)."""
        if len(self.kept) < self.judged_epochs:
            self.kept.append((self.seen, batches))
        else:
            at = self.pick.randrange(self.seen + 1)
            if at < self.judged_epochs:
                self.kept[at] = (self.seen, batches)
        self.seen += 1

    def finish(self) -> None:
        """The check's epoch through the window's call, from the window's tables."""
        self.last = self.runner.sample(self.gen, self.data)
        masked = dict(self.last)
        masked["valid"] = self.last["valid"].clone()
        masked["valid"][self.steps:] = False
        self.check_feed = masked
        self.check_start = {key: v.clone() for key, v in self.params.items()}
        self.check_end, loss = self._apply(self.params, masked)
        self.check_loss = float(loss)

    def release(self) -> None:
        del self.data, self.runner, self.params

    def work(self, traced) -> List[List[roofline.Work]]:
        return [self.ref.update_work(self.cfg.embedding_size, b) for b in traced]

    def numbers(self, graph, cell: spec.Cell, device) -> Dict[str, float]:
        g = cell.config["graph"]
        hp = {"learning_rate": self.cfg.learning_rate, "margin": self.cfg.margin,
              "num_negatives": max(1, self.cfg.num_negatives), "l1": int(self.cfg.distance) == 0}
        epochs = [self.epoch] + [b for _, b in sorted(self.kept, key=lambda kb: kb[0])] + [self.last]
        return checks.train_numbers(self.ref, self.prog_start, self.ref_start, self.states, self.losses, epochs,
                                    (self.check_start, self.check_feed, self.check_end, self.check_loss),
                                    graph, int(g["n_entities"]), int(g["n_relations"]), hp, self.rows, device)


class _Eval:
    """Passes of the link-prediction eval over the test split; set-up runs one."""

    def __init__(self, cell: spec.Cell, graph, device, seed: int, control):
        from kb2e_tpu_torch.data.triples import Dataset, TripleSet
        from kb2e_tpu_torch.eval import harness
        from kb2e_tpu_torch.models.base import get_model

        self.cfg = cfg = _config(cell, seed, control)
        g = cell.config["graph"]
        self.n_ent, n_rel, k = int(g["n_entities"]), int(g["n_relations"]), cfg.embedding_size
        self.ref, self.device, self.harness = cell.model, device, harness
        self.model = get_model(cell.config["model"])
        names = lambda n: {str(i): i for i in range(n)}  # noqa: E731 — ids stand for the names
        self.dataset = Dataset(entity2id=names(self.n_ent), relation2id=names(n_rel),
                               train=TripleSet.from_arrays(*graph["train"], self.n_ent, n_rel),
                               valid=graph["valid"], test=graph["test"])
        self.tables = self.ref.init_tables(torch.Generator(device).manual_seed(_seed(seed, 0)),
                                           self.n_ent, n_rel, k, "eval")
        dtype = torch.bfloat16 if control == "bf16_tables" else torch.float32
        self.params = {key: v.to(dtype) for key, v in self.tables.items()}
        q = ref_ranks.queries(graph["test"])
        self.units = q["rel"].shape[0]
        counts = np.bincount(q["rel"])
        self.groups = [int(c) for c in counts[counts > 0]] if self.ref.GROUPED else [self.units]
        self.passes = []
        self.step(trace_lib.Spans(False, device))
        self.warm = self.passes.pop()  # the set-up's pass: checked only where no window ran

    def step(self, spans):
        with spans("rank_all"):
            raw, filt, _ = self.harness.rank_all(self.model, self.params, self.dataset, self.cfg, device=self.device)
        self.passes.append((raw, filt))

    def finish(self) -> None:
        """Nothing: the window's own passes are checked."""

    def release(self) -> None:
        del self.params, self.dataset

    def work(self, traced) -> List[List[roofline.Work]]:
        k, l1 = self.cfg.embedding_size, int(self.cfg.distance) == 0
        return [[roofline.rank_count_work(l1, k, self.n_ent, self.groups),
                 self.ref.projection_work(k, self.n_ent, self.groups)]]

    def numbers(self, graph, cell: spec.Cell, device) -> Dict[str, float]:
        g = cell.config["graph"]
        return checks.eval_numbers(self.ref, self.tables, graph, self.passes or [self.warm], int(g["n_entities"]),
                                   int(g["n_relations"]), int(self.cfg.distance) == 0, device)


KINDS = {"train": _Train, "eval": _Eval}


def _window(run_, spans, seconds: float) -> List[float]:
    """Steps until ``seconds`` have passed, ending with the step in which they did."""
    step_s: List[float] = []
    deadline = time.perf_counter() + seconds
    while True:
        s0 = time.perf_counter()
        run_.step(spans)
        s1 = time.perf_counter()
        step_s.append(s1 - s0)
        if s1 >= deadline:
            return step_s


@contextlib.contextmanager
def _steady(card: bool) -> Iterator[None]:
    """The window's host, held steady while the context is open: set-up's
    objects frozen out of the collector's walks (``gc.freeze``), and on a
    card the calling thread, which launches every step, kept on the core it
    runs on, so that its loop is not moved between cores (the threads it
    has started keep theirs)."""
    gc.collect()
    gc.freeze()
    allowed = os.sched_getaffinity(0) if card and hasattr(os, "sched_setaffinity") else None
    if allowed is not None:
        core = ctypes.CDLL(None).sched_getcpu()
        os.sched_setaffinity(0, {core} if core in allowed else allowed)
    try:
        yield
    finally:
        if allowed is not None:
            os.sched_setaffinity(0, allowed)
        gc.unfreeze()


def _traced(run_, spans, seconds: float, device):
    """Steps under the profiler, as many as fill ``seconds`` and at least one:
    (their :class:`trace_lib.Trace`, what each step returned)."""
    prof, out, spent = trace_lib.profiler(device), [], 0.0
    prof.start()
    while spent < seconds or not out:
        s0 = time.perf_counter()
        with torch.profiler.record_function(trace_lib.STEP):
            out.append(run_.step(spans))
        spent += time.perf_counter() - s0
    prof.stop()
    return trace_lib.reduce(prof), out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda", control=None,
        t0: Optional[float] = None, keep_numbers: bool = False) -> Dict:
    """One run of ``cell``: the result's keys (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``trace`` ``breakdown``),
    ``step_s`` (the seconds of each step of the window), ``setup_parts``
    (set-up's seconds: to this call, the graph, the program's objects and
    warm-up) and ``checks``, each number compared beside its limit.

    ``t0`` is when the process started (``time.perf_counter``), which set-up
    is counted from.  With ``trace`` the window's steps carry the spans, and
    after the window the profiler records the traffic's ``trace_seconds`` of
    further steps.  ``seconds`` <= 0 runs no window: set-up and the check
    alone, for the calibration of the limits, where ``keep_numbers`` adds
    every number the check read, compared or not, as ``numbers``."""
    if control not in CONTROLS:
        raise ValueError(f"control {control!r}; expected one of {CONTROLS}")
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control == "tf32"
    g = cell.config["graph"]
    marks = [time.perf_counter()]
    graph = graph_lib.generate(g, seed)
    marks.append(time.perf_counter())
    run_ = KINDS[cell.traffic["kind"]](cell, graph, device, seed, control)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t0
    setup_parts = {"start": marks[0] - t0, "graph": marks[1] - marks[0], "program": marks[2] - marks[1]}

    spans = trace_lib.Spans(trace, device)
    with _steady(device.type == "cuda"):
        start = time.perf_counter()
        step_s = _window(run_, spans, seconds) if seconds > 0 else []
        window_s = time.perf_counter() - start
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0}
    result: Dict = {}
    if trace:
        window_spans = {name: list(v) for name, v in spans.seconds.items()}
        tr, traced = _traced(run_, spans, float(cell.traffic["trace_seconds"]), device)
        record = Record(kind=cell.traffic["kind"], on_card=device.type == "cuda", k=run_.cfg.embedding_size,
                        l1=int(run_.cfg.distance) == 0, n_entities=int(g["n_entities"]), model=cell.model,
                        spans=window_spans, step_s=step_s, units_per_step=run_.units, trace=tr,
                        work=run_.work(traced), group_queries=getattr(run_, "groups", []))
        del traced
        metrics = {}
        for entry in cell.per_layer:
            value = cell.reader(entry["name"]).read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        if tr is not None:
            dev_info["busy_s"], dev_info["window_s"] = tr.busy_s, tr.window_s
            result["breakdown"] = trace_lib.breakdown(tr)
    else:
        values = {cell.traffic["rate_metric"]: run_.units * len(step_s) / window_s if step_s else 0.0,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    run_.finish()
    run_.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # the reference's precision
    numbers = run_.numbers(graph, cell, device)
    correct, shown = checks.judge(numbers, cell.limits["limits"])
    attempted = len(step_s) * (run_.units if cell.traffic["kind"] == "eval" else 1)
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0, "metrics": metrics, "device": dev_info}
    out.update(result)
    if keep_numbers:
        out["numbers"] = numbers
    out["step_s"], out["setup_parts"] = step_s, setup_parts
    out["checks"] = shown
    return out
