"""Smoke run of the PyTorch/CUDA port (kb2e_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one line (or a few) and stopping the run with a
non-zero exit on any failure:

1. device   — require CUDA, print the card's name and power limit, TF32 off;
2. build    — compile every kernel of the main path from ``csrc/``;
3. kernels  — each kernel against its plain PyTorch version at FB15k width
              (N = 14,951, k = 100, B = 256 and a ragged 250; L1 and L2):
              exact on dyadic inputs, and at most 0.1 % of queries off by
              at most 2 on TransE-init tables;
4. main     — an FB15k-shaped data directory and seeded TransE embeddings,
              evaluated through ``kb2e_tpu_torch.cli.eval_transe.main`` for
              ``--distance 0`` and ``1``; the kernel launch counts of that run
              must equal the number of batches, and the ranks of the first
              4,096 queries must agree with the plain version on the card;
5. timing   — per kernel at the main path's shapes: the kernel, the plain
              version, one PyTorch library call for the same function
              (``torch.cdist`` plus the count), and the card's lower bound.

The last lines are the card's ``name, power.limit``, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# FB15k's shape (bench.py:29-32).
N_ENTITIES, N_RELATIONS, K = 14_951, 1_345, 100
N_TRAIN, N_VALID, N_TEST = 483_142, 50_000, 59_071
EVAL_BATCH = 256
N_CHECK = 4_096  # main-path queries held against the plain version
SEED = 7
# Unrounded inputs: sums taken in another order may move an energy across a
# tie, so a few counts may differ; dyadic inputs must match exactly.
MAX_QUERY_SHARE_OFF, MAX_COUNT_OFF = 0.001, 2

# Peak rates of an H100 SXM at its full 700 W (NVIDIA data sheet): fp32 outside
# the tensor cores counts an FMA as two operations, and device memory.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def phase(name: str, fn, *args):
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:
        traceback.print_exc()
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
        sys.exit(1)
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def device_phase():
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    return card


def build_phase():
    from kb2e_tpu_torch.ops import rank_count

    t0 = time.perf_counter()
    path = rank_count.build()
    print(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s", flush=True)
    # ptxas's report per kernel template (ILb0E: L1, ILb1E: L2).
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)


def dyadic(rng, shape):
    """Multiples of 1/8 with |x| <= 4: every fp32 sum of k = 100 of them, or of
    their products, is exact in any order."""
    return np.clip(np.round(rng.normal(size=shape) * 8) / 8, -4, 4).astype(np.float32)


def transe_tables(dev):
    from kb2e_tpu_torch import EmbeddingConfig, get_model

    gen = torch.Generator().manual_seed(SEED)
    return get_model("transe").init_params(gen, N_ENTITIES, N_RELATIONS, EmbeddingConfig(embedding_size=K), dev)


def eval_inputs(entity, relation, b, distance, rng):
    """One eval batch as the harness builds it: q = e[anchor] ± r, e_true by
    the direct residual formula."""
    from kb2e_tpu_torch.ops import distances

    dev = entity.device
    anchor = torch.from_numpy(rng.integers(0, entity.shape[0], b)).to(dev)
    rel = torch.from_numpy(rng.integers(0, relation.shape[0], b)).to(dev)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], b).astype(np.float32)).to(dev)
    true_idx = torch.from_numpy(rng.integers(0, entity.shape[0], b).astype(np.int32)).to(dev)
    queries = entity[anchor] + sign[:, None] * relation[rel]
    e_true = distances.residual_energy(entity[true_idx] - queries, distance)
    return entity.T.contiguous(), queries.T.contiguous(), e_true.contiguous(), true_idx


def compare(got: torch.Tensor, want: torch.Tensor, exact: bool, what: str):
    diff = (got.long() - want.long()).abs()
    n_off, max_off = int((diff > 0).sum()), int(diff.max())
    if exact:
        check(n_off == 0, f"{what}: {n_off} counts differ (max {max_off}) on dyadic inputs")
    else:
        check(n_off <= MAX_QUERY_SHARE_OFF * diff.numel() and max_off <= MAX_COUNT_OFF,
              f"{what}: {n_off}/{diff.numel()} counts differ, by up to {max_off}")
    return n_off, max_off


def kernels_phase(tables):
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import distances, rank_count

    dev = tables["entity"].device
    rng = np.random.default_rng(SEED)
    worst = {}
    for distance in (Distance.L1, Distance.L2):
        for b in (EVAL_BATCH, 250):
            # Dyadic tables: exact.
            ent = torch.from_numpy(dyadic(rng, (N_ENTITIES, K))).to(dev)
            q = torch.from_numpy(dyadic(rng, (b, K))).to(dev)
            t = torch.from_numpy(rng.integers(0, N_ENTITIES, b).astype(np.int32)).to(dev)
            e_true = distances.residual_energy(ent[t] - q, distance).contiguous()
            args = (ent.T.contiguous(), q.T.contiguous(), e_true, t, distance)
            got = rank_count.rank_counts(*args)
            torch.cuda.synchronize()
            n_dy, _ = compare(got, rank_count.rank_counts_reference(*args), True, f"{distance.name} B={b} dyadic")
            # TransE-init tables, eval-shaped queries.
            args = (*eval_inputs(tables["entity"], tables["relation"], b, distance, rng), distance)
            got = rank_count.rank_counts(*args)
            torch.cuda.synchronize()
            n_off, max_off = compare(got, rank_count.rank_counts_reference(*args), False, f"{distance.name} B={b}")
            worst[distance] = max(worst.get(distance, 0), max_off)
            print(f"[kernels] {rank_count.KERNEL_NAMES[distance]} N={N_ENTITIES} k={K} B={b}: "
                  f"dyadic {n_dy} counts differ; TransE-init {n_off}/{b} differ (max {max_off})", flush=True)
    return worst


def write_fb15k_dir(data_dir: str):
    from kb2e_tpu_torch.data import synthetic

    n = N_TRAIN + N_VALID + N_TEST
    h, t, r = synthetic.random_kg(N_ENTITIES, N_RELATIONS, n + 1_000, seed=SEED)
    check(h.shape[0] >= n, f"random_kg gave {h.shape[0]} distinct triples, need {n}")
    # Half a triple of slack so int(n * fraction) lands on the exact counts.
    split = ((N_TRAIN + 0.5) / n, (N_VALID + 0.5) / n, (N_TEST + 0.5) / n)
    synthetic.write_kg_dir(data_dir, (h[:n], t[:n], r[:n]), N_ENTITIES, N_RELATIONS, split=split, seed=SEED)


def main_phase(tables, work: str):
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval_transe
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.convert import params_to_numpy
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.io import text
    from kb2e_tpu_torch.ops import distances, rank_count

    data_dir, out_dir = os.path.join(work, "data"), os.path.join(work, "out")
    t0 = time.perf_counter()
    write_fb15k_dir(data_dir)
    host = params_to_numpy(tables)
    text.write_embeddings(out_dir, Method.BERN, host["entity"], host["relation"], model_name="transe")
    print(f"[main] wrote the FB15k-shaped directory and k={K} TransE embeddings in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    n_test = dataset.test[0].shape[0]
    check((dataset.train.num_triples, dataset.valid[0].shape[0], n_test) == (N_TRAIN, N_VALID, N_TEST),
          "split sizes differ from FB15k's")
    n_batches = -(-2 * n_test // EVAL_BATCH)
    model = get_model("transe")
    # The tables as the CLI sees them: written at %.6f and read back.
    params = {k: torch.from_numpy(v.astype(np.float32)).cuda()
              for k, v in text.read_embeddings(out_dir, Method.BERN, N_ENTITIES, N_RELATIONS, K).items()}
    results = {}
    for distance in (Distance.L1, Distance.L2):
        name = rank_count.KERNEL_NAMES[distance]
        argv = ["--datadir", data_dir, "--outdir", out_dir, "--size", str(K), "--method", "1",
                "--distance", str(int(distance)), "--seed", str(SEED)]
        rank_count.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = eval_transe.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(rank_count.launch_counts)
        check(launches == {name: n_batches}, f"{name}: launches {launches}, expected {{{name!r}: {n_batches}}}")
        check(metrics["num_corruptions"] == 2 * n_test, f"{metrics['num_corruptions']} corruptions ranked")
        for key in ("raw_mean_rank", "filtered_mean_rank", "raw_hits10", "filtered_hits10"):
            check(np.isfinite(metrics[key]), f"{key} is not finite")
        check(1 <= metrics["filtered_mean_rank"] <= metrics["raw_mean_rank"] <= N_ENTITIES, "mean ranks out of order")
        print(f"[main] eval_transe --distance {int(distance)}: {2 * n_test} queries, {launches[name]} launches "
              f"of {name}, eval wall {wall:.2f} s (loading included); raw MR {metrics['raw_mean_rank']:.6f} "
              f"H@10 {metrics['raw_hits10']:.6f}, filtered MR {metrics['filtered_mean_rank']:.6f} "
              f"H@10 {metrics['filtered_hits10']:.6f}", flush=True)

        # The same ranks again (integer atomics: deterministic), then the first
        # N_CHECK queries' raw ranks by the plain version on the card.
        cfg = EmbeddingConfig(embedding_size=K, distance=distance)
        t0 = time.perf_counter()
        raw, filt = harness.rank_all(model, params, dataset, cfg, device="cuda")
        rank_wall = time.perf_counter() - t0
        acc = harness.EvalAccumulator()
        for s in range(0, raw.shape[0], EVAL_BATCH):
            acc.add(raw[s:s + EVAL_BATCH], filt[s:s + EVAL_BATCH])
        check(acc.metrics() == metrics, "a second run of the ranks gives other metrics")
        print(f"[main] ranking alone (rank_all on loaded data and tables, filter index and feed "
              f"included): {rank_wall:.3f} s", flush=True)
        th, tt, tr = (torch.from_numpy(a[: N_CHECK // 2].astype(np.int64)).cuda() for a in dataset.test)
        anchor = torch.stack([tt, th], 1).reshape(-1)
        true_idx = torch.stack([th, tt], 1).reshape(-1).to(torch.int32)
        sign = torch.tensor([-1.0, 1.0], device="cuda").repeat(N_CHECK // 2)
        queries = params["entity"][anchor] + sign[:, None] * params["relation"][tr.repeat_interleave(2)]
        e_true = distances.residual_energy(params["entity"][true_idx] - queries, distance)
        proj_t = params["entity"].T.contiguous()
        plain = torch.cat([
            1 + rank_count.rank_counts_reference(
                proj_t, queries[s:s + EVAL_BATCH].T.contiguous(), e_true[s:s + EVAL_BATCH],
                true_idx[s:s + EVAL_BATCH], distance)
            for s in range(0, N_CHECK, EVAL_BATCH)
        ])
        n_off, max_off = compare(torch.from_numpy(raw[:N_CHECK]).cuda(), plain, False,
                                 f"main path {distance.name}, first {N_CHECK} queries")
        print(f"[main] first {N_CHECK} raw ranks vs the plain version: {n_off} differ (max {max_off})", flush=True)
        results[distance] = dict(launches=launches[name], max_off=max_off, wall=wall, rank_wall=rank_wall)
    return results


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def library_call(proj_t, queries_t, e_true, true_idx, distance):
    """The same count from one PyTorch library call for the energies."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count

    en = torch.cdist(queries_t.T, proj_t.T, p=1 if distance == Distance.L1 else 2)
    if distance == Distance.L2:
        en = en * en
    idx = torch.arange(proj_t.shape[1], device=proj_t.device)[None, :]
    return torch.sum(rank_count.beats(en, idx, e_true, true_idx), dim=1, dtype=torch.int32)


def bound_ms(distance, k, n, b) -> tuple:
    """Least time on the card: operations at the fp32 peak, or bytes at the
    memory rate (each input read once, the output written once)."""
    from kb2e_tpu_torch.constants import Distance

    # L1: a subtract and an absolute-add per element, two fp32 instructions,
    # each as costly as an FMA (two operations); L2: one FMA per element.
    ops = (4 if distance == Distance.L1 else 2) * b * n * k
    nbytes = 4 * (k * n + k * b + b + b) + 4 * b
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timing_phase(tables, worst, results):
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count

    rng = np.random.default_rng(SEED + 1)
    records = []
    for distance in (Distance.L1, Distance.L2):
        args = (*eval_inputs(tables["entity"], tables["relation"], EVAL_BATCH, distance, rng), distance)
        ms = time_ms(lambda: rank_count.rank_counts(*args), 200)
        plain_ms = time_ms(lambda: rank_count.rank_counts_reference(*args), 5)
        library_ms = time_ms(lambda: library_call(*args), 20)
        lib_off = int((library_call(*args).long() - rank_count.rank_counts(*args).long()).abs().gt(0).sum())
        b_ms, b_by = bound_ms(distance, K, N_ENTITIES, EVAL_BATCH)
        name = rank_count.KERNEL_NAMES[distance]
        print(f"[timing] {name} B={EVAL_BATCH} N={N_ENTITIES} k={K}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms ({lib_off} counts differ from the kernel), bound {b_ms:.4f} ms "
              f"({b_by}); eval {results[distance]['wall']:.2f} s (ranking alone "
              f"{results[distance]['rank_wall']:.3f} s) over {results[distance]['launches']} launches",
              flush=True)
        records.append({
            "name": name,
            "route": "cuda",
            "source": "kb2e_tpu_torch/csrc/rank_count.cu",
            "replaces": "kb2e_tpu/ops/pallas_rank.py:" + ("48" if distance == Distance.L1 else "73"),
            "launches": results[distance]["launches"],
            "max_abs_err": max(worst[distance], results[distance]["max_off"]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": library_ms,
        })
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import kb2e_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a kb2e checkout ({exc})", file=sys.stderr)
        return 1

    card = phase("device", device_phase)
    phase("build", build_phase)
    tables = transe_tables(torch.device("cuda"))
    worst = phase("kernels", kernels_phase, tables)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) as work:
        results = phase("main", main_phase, tables, work)
    records = phase("timing", timing_phase, tables, worst, results)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
