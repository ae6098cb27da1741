"""kb2e_tpu_torch's multi-process driver, run as real processes over gloo on the CPU.

The cases of ``tests/test_multiprocess.py`` for ``kb2e_tpu_torch.parallel.multiprocess``:
a 2-process run over a (1, 2) mesh (the entity rows cut between the
processes) must

* gather the whole edge list and merge the bern statistics exactly (the
  driver raises otherwise),
* train to the tables of a 1-process run,
* survive the hard exit of one process after a checkpoint: both restart
  with ``--resume`` and end on the uninterrupted run's tables exactly,
* write the entity-sharded eval's metrics equal to a one-rank ``evaluate``
  of its final tables;
* do the same for TransR, whose matrices are cut on the relation axis: the
  whole tables in ``--out-npz`` (``gather_params``), the sharded eval's
  metrics equal to one rank's.

Every process has a deadline and is killed when it passes; the process
group's timeout makes a rank whose peer died leave its collective.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kb2e_tpu_torch import EmbeddingConfig, get_model
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import triples
from kb2e_tpu_torch.eval import harness

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, CKPT_EVERY, DIE_AFTER = 6, 2, 4
DEADLINE_S = 120
COMMON_ARGS = [
    "--model", "transe", "--size", "16", "--rate", "0.05", "--margin", "1.0", "--method", "1", "--batches", "4",
    "--epochs", str(EPOCHS), "--distance", "0", "--seed", "11", "--device", "cpu",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(pid: int, n: int, port: int, extra: list, log_path: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "kb2e_tpu_torch.parallel.multiprocess", "--coordinator", f"localhost:{port}",
           "--num-processes", str(n), "--process-id", str(pid), *COMMON_ARGS, *extra]
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)


def _wait_all(procs, timeout: float = DEADLINE_S):
    """Each process's exit code, each waited for at most ``timeout`` seconds;
    any still running then is killed."""
    try:
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _run(tmp, tag: str, n: int, extra: list):
    port = _free_port()
    procs = [_spawn(pid, n, port, extra, os.path.join(tmp, f"{tag}_p{pid}.log")) for pid in range(n)]
    rcs = _wait_all(procs)
    logs = "".join(_read_log(tmp, tag, pid) for pid in range(n))
    assert rcs == [0] * n, f"{tag}: exit codes {rcs}\n{logs[-4000:]}"
    return logs


def _read_log(tmp, tag, pid):
    with open(os.path.join(tmp, f"{tag}_p{pid}.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def mp_artifacts(tiny_kg_dir, tmp_path_factory):
    """One uninterrupted 2-process run and one 1-process run."""
    tmp = str(tmp_path_factory.mktemp("torch_mp"))
    out, one, eval_out = (os.path.join(tmp, name) for name in ("two.npz", "one.npz", "eval_metrics.json"))
    _run(tmp, "base", 2, ["--datadir", tiny_kg_dir, "--model-axis", "2", "--out-npz", out, "--eval-out", eval_out,
                          "--checkpoint-dir", os.path.join(tmp, "ckpt_a"), "--checkpoint-every", str(CKPT_EVERY)])
    _run(tmp, "one", 1, ["--datadir", tiny_kg_dir, "--out-npz", one])
    return {"tmp": tmp, "out": out, "one": one, "eval_out": eval_out, "kg": tiny_kg_dir}


@pytest.fixture(scope="module")
def transr_artifacts(tiny_kg_dir, tmp_path_factory):
    """TransR at model axis 2 over 2 processes, and at 1 process."""
    tmp = str(tmp_path_factory.mktemp("torch_mp_transr"))
    out, one, eval_out = (os.path.join(tmp, name) for name in ("two.npz", "one.npz", "eval_metrics.json"))
    common = ["--datadir", tiny_kg_dir, "--model", "transr", "--rate", "0.02"]
    _run(tmp, "base", 2, common + ["--model-axis", "2", "--out-npz", out, "--eval-out", eval_out])
    _run(tmp, "one", 1, common + ["--out-npz", one])
    return {"out": out, "one": one, "eval_out": eval_out, "kg": tiny_kg_dir}


def test_two_process_transr_writes_the_whole_matrices_and_trains_to_the_tables_of_one(transr_artifacts):
    two, one = np.load(transr_artifacts["out"]), np.load(transr_artifacts["one"])
    assert two["proj"].shape == (8, 16, 16)
    for key in ("entity", "relation", "proj"):
        np.testing.assert_allclose(two[key], one[key], atol=1e-6, rtol=1e-6, err_msg=key)
    with open(transr_artifacts["eval_out"], encoding="utf-8") as f:
        mp_metrics = json.load(f)
    cfg = EmbeddingConfig(embedding_size=16, distance=0)
    dataset = triples.load_dataset(transr_artifacts["kg"], splits=("train", "valid", "test"))
    assert harness.evaluate(get_model("transr"), params_from_numpy(dict(two), "cpu"), dataset, cfg,
                            device="cpu") == mp_metrics


def test_two_process_train_runs_and_writes(mp_artifacts):
    log0 = _read_log(mp_artifacts["tmp"], "base", 0)
    with open(os.path.join(mp_artifacts["kg"], "train.txt")) as f:
        n_train = sum(1 for _ in f)
    assert f"global {n_train}" in log0  # the gathered edge list is the whole train split
    assert "Mesh(data=1, model=2, coords=(0, 0), cpu)" in log0
    assert f"Epoch: {EPOCHS - 1}" in log0
    final = np.load(mp_artifacts["out"])
    assert final["entity"].shape == (64, 16)
    assert np.isfinite(final["entity"]).all()
    assert sorted(os.listdir(os.path.join(mp_artifacts["tmp"], "ckpt_a"))) == ["ckpt_2", "ckpt_4", "ckpt_6"]


def test_two_processes_train_to_the_tables_of_one(mp_artifacts):
    two, one = np.load(mp_artifacts["out"]), np.load(mp_artifacts["one"])
    for key in ("entity", "relation"):
        np.testing.assert_allclose(two[key], one[key], atol=1e-6, rtol=1e-6, err_msg=key)


def test_kill_one_process_and_resume(mp_artifacts, tmp_path):
    """Process 1 exits hard after the epoch-4 checkpoint; process 0 leaves its
    next collective when the peer's connection closes (or the group's timeout
    passes); both restart with --resume and end where the uninterrupted run did."""
    tmp, kg = str(tmp_path), mp_artifacts["kg"]
    ckpt = os.path.join(tmp, "ckpt_b")
    common = ["--datadir", kg, "--model-axis", "2", "--checkpoint-dir", ckpt, "--checkpoint-every", str(CKPT_EVERY)]
    port = _free_port()
    p0 = _spawn(0, 2, port, common, os.path.join(tmp, "fault_p0.log"))
    p1 = _spawn(1, 2, port, common + ["--die-after-epoch", str(DIE_AFTER), "--die-process-id", "1"],
                os.path.join(tmp, "fault_p1.log"))
    rc1, rc0 = _wait_all([p1, p0])
    assert rc1 == 17, _read_log(tmp, "fault", 1)[-3000:]  # the fault fired
    assert rc0 != 0  # the survivor did not finish alone
    assert f"ckpt_{DIE_AFTER}" in os.listdir(ckpt)

    out = os.path.join(tmp, "resumed.npz")
    logs = _run(tmp, "resume", 2, common + ["--resume", "--out-npz", out])
    assert f"Resumed from {os.path.join(ckpt, f'ckpt_{DIE_AFTER}')} at epoch {DIE_AFTER}" in logs
    want, got = np.load(mp_artifacts["out"]), np.load(out)
    for key in ("entity", "relation"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_two_process_sharded_eval_equals_one_rank_evaluate(mp_artifacts):
    with open(mp_artifacts["eval_out"], encoding="utf-8") as f:
        mp_metrics = json.load(f)
    final = np.load(mp_artifacts["out"])
    cfg = EmbeddingConfig(embedding_size=16, learning_rate=0.05, margin=1.0, method=1, num_batches=4,
                          max_epochs=EPOCHS, distance=0, seed=11)
    dataset = triples.load_dataset(mp_artifacts["kg"], splits=("train", "valid", "test"))
    local = harness.evaluate(get_model("transe"), params_from_numpy(dict(final), "cpu"), dataset, cfg, device="cpu")
    assert local == mp_metrics
