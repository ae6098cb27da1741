"""Smoke run of the PyTorch/CUDA port (kb2e_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one line (or a few) and stopping the run with a
non-zero exit on any failure:

1. device   — require CUDA, print the card's name and power limit, TF32 off;
2. build    — compile every kernel of the main paths from ``csrc/``, one
              nvcc per source, all started together, and print ptxas's
              register and spill report per kernel template;
3. kernels  — each kernel against its plain PyTorch version at FB15k width:
              the rank count (N = 14,951, k = 100, B = 256 and a ragged 250;
              L1 and L2), exact on dyadic inputs and at most 0.1 % of
              queries off by at most 2 on TransE-init tables; the sequential
              update (N = 14,951, R = 1,345, k = 100, B = 4,831, a batch of
              the port's sampler with 1/8 of its rows h == t; L1 and L2),
              equal decisions and loss on dyadic snapshots and on TransE-init
              tables equal decisions, loss within rel 1e-5, tables within
              atol 1e-5; the TransH sequential update (the same width, a
              whole sampler batch of 4,831 with 1/8 of its positives h == t
              and the next 1/8 of its corrupted triples h' == t', on
              TransH-init tables at each of K4_SETTINGS), equal to its plain
              version bit for bit: decisions, projector trips, loss and all
              three tables;
4. main     — the main paths on an FB15k-shaped data directory (bench.py's
              configuration), each with the launch counts set to 0 just
              before it and read just after:
              * eval: seeded TransE embeddings through
                ``kb2e_tpu_torch.cli.eval_transe.main`` for ``--distance 0``
                and ``1``: one rank-count launch per batch, and the first
                4,096 ranks agree with the plain version on the card;
              * fast training: ``kb2e_tpu_torch.cli.train_transe.main`` for 2
                epochs; the loss is finite and falls, and ``eval_transe``
                scores the written files (rank count L1);
              * parity training: 1 epoch of ``--update-mode parity`` for L1
                and for L2, one sequential-update launch per batch (100);
              * quality: the planted-KG setting of QUALITY.md trained in both
                modes and scored through the rank count; filtered Hits@10
                must land in QUALITY_BAND;
              * TransH eval: seeded TransH-init tables through
                ``kb2e_tpu_torch.cli.eval_transh.main`` for ``--distance 0``
                and ``1``: the same metrics both times, one rank-count (L1)
                launch per batch of each relation's group, and the first
                4,096 ranks in the harness's group order agree with the plain
                version on the card;
              * TransH training: ``train_transh`` for 2 fast epochs (no
                kernel; the loss is finite and falls; ``eval_transh`` scores
                the written files) and 1 parity epoch (one TransH
                sequential-update launch per batch, 100);
              * TransH quality: QUALITY.md's TransH row, the same KG and
                flags in both modes; filtered Hits@10 must land in
                QUALITY_BAND_TRANSH;
5. timing   — per kernel at the main path's shapes: the kernel, the plain
              version, one PyTorch library call for the same function where
              there is one, and the card's lower bound.

The last lines are the card's ``name, power.limit``, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
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
# bench.py's training configuration: 100 batches of |T| / 100, lr 0.001,
# margin 1, bern, L1.
N_BATCHES = 100
TRAIN_BATCH = N_TRAIN // N_BATCHES  # 4,831
TRAIN_FLAGS = ["--size", str(K), "--rate", "0.001", "--margin", "1", "--method", "1",
               "--batches", str(N_BATCHES), "--seed", str(SEED)]
# QUALITY.md's TransE setting (examples/quality_run.py): a planted KG of 600
# entities, 24 relations and 20,000 drawn triples; k 32, lr 0.02, 16 batches,
# 40 epochs, bern, L1.  Filtered Hits@10 was 0.439 there (chance 0.017).
QUALITY_KG = (600, 24, 20_000, 11)
QUALITY_SIZE, QUALITY_BATCHES, QUALITY_EPOCHS = 32, 16, 40
QUALITY_FLAGS = ["--size", str(QUALITY_SIZE), "--rate", "0.02", "--margin", "1", "--method", "1", "--batches", str(QUALITY_BATCHES),
                 "--epochs", str(QUALITY_EPOCHS), "--seed", "5"]
QUALITY_BAND = (0.399, 0.479)
# QUALITY.md's TransH row (QUALITY.md:20): the same KG and flags gave
# filtered Hits@10 0.423 there; the band is +-0.04, as TransE's.
QUALITY_BAND_TRANSH = (0.383, 0.463)
# (learning rate, projector cap) of the TransH update's checks against its
# plain version: bench.py's rate and the default cap, which the main path
# runs, then lr 0.05 with caps of 2 and of 1.  On TransH-init tables few
# projector calls reach a cap of 2, so the cap of 1, where every fired trip
# reaches it, is what makes sure the capped exit is held against the plain
# version.
K4_SETTINGS = ((0.001, 16), (0.05, 2), (0.05, 1))
IDX_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")
TRANSH_KEYS = ("entity", "relation", "norm")
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


def kernel_modules():
    from kb2e_tpu_torch.ops import rank_count, transe_update, transh_update

    return rank_count, transe_update, transh_update


def build_phase():
    modules = kernel_modules()
    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        paths = list(pool.map(lambda m: m.build(), modules))
    print(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in paths)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # ptxas's report per kernel template; the template's bool is kL2 for the
    # rank count and kL1 for the TransE update; the TransH update (L1 only)
    # has no template.
    distance_of = {"rank_count_kernel": ("L1", "L2"), "transe_update_kernel": ("L2", "L1"),
                   "transh_update_kernel": ("L1",)}
    for path in paths:
        entry = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            found = re.search(r"([A-Za-z_]+_kernel)(?:ILb([01])E)?", line) if "Compiling entry" in line else None
            if found:
                entry = f"{found[1]} {distance_of.get(found[1], ('false', 'true'))[int(found[2] or 0)]}"
            elif "registers" in line or "spill" in line:
                print(f"[build] {entry}: {line.replace('ptxas info    :', '').strip()}", flush=True)


def reset_all_launch_counts():
    for module in kernel_modules():
        module.reset_launch_counts()


def all_launch_counts() -> dict:
    counts = {}
    for module in kernel_modules():
        counts.update(module.launch_counts)
    return counts


def dyadic(rng, shape):
    """Multiples of 1/8 with |x| <= 4: every fp32 sum of k = 100 of them, or of
    their products, is exact in any order."""
    return np.clip(np.round(rng.normal(size=shape) * 8) / 8, -4, 4).astype(np.float32)


def init_tables(model: str, dev):
    """Seeded init tables of ``model`` at FB15k's width."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model

    gen = torch.Generator().manual_seed(SEED)
    return get_model(model).init_params(gen, N_ENTITIES, N_RELATIONS, EmbeddingConfig(embedding_size=K), dev)


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


def kernels_phase(tables, transh, data_dir):
    """Every kernel against its plain version; returns the worst errors and
    the sequential updates' inputs for the timing phase."""
    ctx = dict(rank_worst=rank_kernel_checks(tables), **update_kernel_checks(tables, data_dir))
    ctx.update(transh_kernel_checks(transh, ctx["train_data"]))
    return ctx


def rank_kernel_checks(tables):
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


def update_kernel_checks(tables, data_dir):
    """The sequential-update kernel against its plain version at FB15k width,
    on a batch of the port's sampler over the FB15k-shaped training graph."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.ops import transe_update
    from kb2e_tpu_torch.train import step

    dev = tables["entity"].device
    t0 = time.perf_counter()
    data = step.DeviceData.from_triple_set(triples.load_dataset(data_dir).train, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = step.sample_batch(gen, data, EmbeddingConfig(embedding_size=K, method=1), TRAIN_BATCH)
    # Self-loops: 1/8 of the positives h == t, the next 1/8 of the negatives.
    eighth = TRAIN_BATCH // 8
    batch["pt"][:eighth] = batch["ph"][:eighth]
    batch["nt"][eighth:2 * eighth] = batch["nh"][eighth:2 * eighth]
    idx = [batch[key] for key in IDX_KEYS]
    print(f"[kernels] sampled a batch of {TRAIN_BATCH} on the FB15k-shaped graph (cuckoo index included) in "
          f"{time.perf_counter() - t0:.1f} s; {int((~batch['valid']).sum())} invalid", flush=True)

    rng = np.random.default_rng(SEED + 2)
    snapshots = {
        "dyadic": [torch.from_numpy(dyadic(rng, (n, K))).to(dev) for n in (N_ENTITIES, N_RELATIONS)],
        "TransE-init": [tables["entity"], tables["relation"]],
    }
    worst = {}
    for l1 in (True, False):
        name = transe_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]
        for what, (ent, rel) in snapshots.items():
            args = (ent, rel, *idx)
            kw = dict(learning_rate=0.001, margin=1.0, l1=l1)
            got = transe_update.transe_sequential_update(*args, **kw)
            torch.cuda.synchronize()
            want = transe_update.transe_sequential_update_reference(*args, **kw)
            off = (got[3] != want[3]).nonzero()[:, 0].tolist()
            for i in off[:10]:
                print(f"[kernels] {name} {what}: sample {i} {[int(x[i]) for x in idx]} decided "
                      f"{bool(got[3][i])} on the card, {bool(want[3][i])} in the plain version", flush=True)
            check(not off, f"{name} {what}: {len(off)} update decisions differ")
            err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
            loss, want_loss = float(got[2]), float(want[2])
            if what == "dyadic":  # exact energies in any order: the same loss
                check(loss == want_loss, f"{name} {what}: loss {loss!r} != {want_loss!r}")
            else:
                check(abs(loss - want_loss) <= 1e-5 * abs(want_loss), f"{name} {what}: loss {loss} vs {want_loss}")
            check(err <= 1e-5, f"{name} {what}: tables differ by {err}")
            worst[name] = max(worst.get(name, 0.0), err)
            print(f"[kernels] {name} N={N_ENTITIES} R={N_RELATIONS} k={K} B={TRAIN_BATCH} {what}: "
                  f"{int(got[3].sum())} updates, 0 decisions differ, loss {loss:.6f} vs {want_loss:.6f}, "
                  f"max table difference {err:.3g}", flush=True)
    return dict(update_worst=worst, update_args=(tables["entity"], tables["relation"], *idx), train_data=data)


def transh_kernel_checks(transh, data):
    """The TransH sequential-update kernel against its plain version at FB15k
    width on TransH-init tables, bit for bit, on a whole sampler batch of
    4,831 at each of K4_SETTINGS; returns the inputs of the timing phase (the
    same tables and batch), the largest table difference, and the plain
    version's time at the main path's setting, K4_SETTINGS[0]."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.ops import transh_update
    from kb2e_tpu_torch.train import step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = step.sample_batch(gen, data, EmbeddingConfig(embedding_size=K, method=1), TRAIN_BATCH)
    # 1/8 of the positives h == t, the next 1/8 of the corrupted triples h' == t'.
    eighth = TRAIN_BATCH // 8
    batch["pt"][:eighth] = batch["ph"][:eighth]
    batch["nt"][eighth:2 * eighth] = batch["nh"][eighth:2 * eighth]
    idx = [batch[key] for key in IDX_KEYS]

    tables = [transh[key] for key in TRANSH_KEYS]
    name = transh_update.KERNEL_NAME
    worst, plain_ms = 0.0, {}
    for lr, cap in K4_SETTINGS:
        kw = dict(learning_rate=lr, margin=1.0, max_iters=cap)
        got = transh_update.transh_sequential_update(*tables, *idx, **kw)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = transh_update.transh_sequential_update_reference(*tables, *idx, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms[lr, cap] = start.elapsed_time(stop)
        what = f"{name} lr={lr} max_iters={cap}"
        off = (got[4] != want[4]).nonzero()[:, 0].tolist()
        for i in off[:10]:
            print(f"[kernels] {what}: sample {i} {[int(x[i]) for x in idx]} decided {bool(got[4][i])} on the card, "
                  f"{bool(want[4][i])} in the plain version", flush=True)
        check(not off, f"{what}: {len(off)} update decisions differ")
        check(torch.equal(got[5], want[5]), f"{what}: projector trips differ")
        loss, want_loss = float(got[3]), float(want[3])
        check(loss == want_loss, f"{what}: loss {loss!r} != {want_loss!r}")
        rows_off = [int((g != w).any(dim=1).sum()) for g, w in zip(got[:3], want[:3])]
        check(rows_off == [0, 0, 0], f"{what}: rows differ (entity, relation, norm): {rows_off}")
        worst = max([worst] + [float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])])
        fired, capped = (int(x) for x in got[5].sum(0))
        if cap == 1:
            check(capped > 0, f"{what}: no projector call reached the cap")
        print(f"[kernels] {what} N={N_ENTITIES} R={N_RELATIONS} k={K} B={TRAIN_BATCH} (a sampler batch; "
              f"{int((idx[1] == idx[0]).sum())} h == t, {int((idx[4] == idx[3]).sum())} h' == t') on TransH-init "
              f"tables: {int(got[4].sum())} updates, {fired} projector trips fired, {capped} projector calls "
              f"stopped at the cap; decisions, trips, loss ({loss:.6f}) and all three tables equal to the "
              f"plain version's bit for bit (max difference {worst}); plain version {plain_ms[lr, cap]:.1f} ms",
              flush=True)
    return dict(transh_args=(*tables, *idx), transh_worst=worst, transh_plain_ms=plain_ms[K4_SETTINGS[0]])


def write_fb15k_dir(data_dir: str):
    from kb2e_tpu_torch.data import synthetic

    n = N_TRAIN + N_VALID + N_TEST
    h, t, r = synthetic.random_kg(N_ENTITIES, N_RELATIONS, n + 1_000, seed=SEED)
    check(h.shape[0] >= n, f"random_kg gave {h.shape[0]} distinct triples, need {n}")
    # Half a triple of slack so int(n * fraction) lands on the exact counts.
    split = ((N_TRAIN + 0.5) / n, (N_VALID + 0.5) / n, (N_TEST + 0.5) / n)
    synthetic.write_kg_dir(data_dir, (h[:n], t[:n], r[:n]), N_ENTITIES, N_RELATIONS, split=split, seed=SEED)


def data_phase(tables, transh, work: str):
    from kb2e_tpu_torch.constants import Method
    from kb2e_tpu_torch.convert import params_to_numpy
    from kb2e_tpu_torch.io import text

    data_dir, out_dir, transh_dir = (os.path.join(work, name) for name in ("data", "out", "out_transh"))
    write_fb15k_dir(data_dir)
    host = params_to_numpy(tables)
    text.write_embeddings(out_dir, Method.BERN, host["entity"], host["relation"], model_name="transe")
    host = params_to_numpy(transh)
    text.write_embeddings(transh_dir, Method.BERN, host["entity"], host["relation"], weights=host["norm"],
                          model_name="transh")
    print(f"[data] wrote the FB15k-shaped directory, k={K} TransE embeddings and k={K} TransH embeddings "
          "(with weights.bern)", flush=True)
    return data_dir, out_dir, transh_dir


def main_phase(tables, work: str, data_dir: str, out_dir: str, transh_dir: str):
    results = eval_path(tables, data_dir, out_dir)
    results.update(training_paths(work, data_dir))
    results["quality"] = quality_path(work, "transe", QUALITY_BAND, "transe_update_l1", "QUALITY.md 0.439")
    results["transh_eval"] = transh_eval_path(data_dir, transh_dir)
    results.update(transh_training_paths(work, data_dir))
    results["transh_quality"] = quality_path(work, "transh", QUALITY_BAND_TRANSH, "transh_update", "QUALITY.md 0.423")
    return results


def eval_path(tables, data_dir: str, out_dir: str):
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval_transe
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.io import text
    from kb2e_tpu_torch.ops import distances, rank_count

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
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = eval_transe.main(argv)
        wall = time.perf_counter() - t0
        launches = all_launch_counts()
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
        raw, filt, sizes = harness.rank_all(model, params, dataset, cfg, device="cuda")
        rank_wall = time.perf_counter() - t0
        check(harness.metrics_from_ranks(raw, filt, sizes) == metrics, "a second run of the ranks gives other metrics")
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


def eval_launches(data_dir: str, grouped: bool) -> int:
    """Rank-count launches of one eval of ``data_dir``'s test split: one per
    batch of 256 queries, in one group, or (grouped) in one group per relation."""
    from kb2e_tpu_torch.data import triples

    rels = triples.load_dataset(data_dir, splits=("train", "valid", "test")).test[2]
    sizes = np.bincount(rels) if grouped else np.array([rels.shape[0]])
    return int(sum(-(-2 * int(n) // EVAL_BATCH) for n in sizes))


def transh_eval_path(data_dir: str, transh_dir: str):
    """Seeded TransH-init tables through ``eval_transh`` for both distance
    flags (TransH ignores it); the ranks in the harness's group order against
    the plain rank count on the card."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval_transh
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.io import text
    from kb2e_tpu_torch.ops import distances, rank_count

    name = rank_count.KERNEL_NAMES[Distance.L1]
    n_launch = eval_launches(data_dir, grouped=True)
    metrics, walls = {}, {}
    for distance in ("0", "1"):
        argv = ["--datadir", data_dir, "--outdir", transh_dir, "--size", str(K), "--method", "1",
                "--distance", distance, "--seed", str(SEED)]
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics[distance] = eval_transh.main(argv)
        walls[distance] = time.perf_counter() - t0
        launches = all_launch_counts()
        check(launches == {name: n_launch}, f"eval_transh: launches {launches}, expected {{{name!r}: {n_launch}}}")
        m = metrics[distance]
        check(m["num_corruptions"] == 2 * N_TEST, f"{m['num_corruptions']} corruptions ranked")
        check(1 <= m["filtered_mean_rank"] <= m["raw_mean_rank"] <= N_ENTITIES, "mean ranks out of order")
        print(f"[main] eval_transh --distance {distance}: {2 * N_TEST} queries in {N_RELATIONS} relation groups, "
              f"{launches[name]} launches of {name}, eval wall {walls[distance]:.2f} s (loading included); raw MR "
              f"{m['raw_mean_rank']:.6f} H@10 {m['raw_hits10']:.6f}, filtered MR {m['filtered_mean_rank']:.6f} "
              f"H@10 {m['filtered_hits10']:.6f}", flush=True)
    check(metrics["0"] == metrics["1"], "TransH's metrics depend on --distance")

    # The same ranks again, then the first N_CHECK queries of the harness's
    # group order by the plain version on the card.
    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    host = text.read_embeddings(transh_dir, Method.BERN, N_ENTITIES, N_RELATIONS, K, weights_shape=(N_RELATIONS, K))
    params = {key: torch.from_numpy(host[src].astype(np.float32)).cuda()
              for key, src in zip(TRANSH_KEYS, ("entity", "relation", "weights"))}
    model = get_model("transh")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw, filt, sizes = harness.rank_all(model, params, dataset, EmbeddingConfig(embedding_size=K), device="cuda")
    rank_wall = time.perf_counter() - t0
    check(harness.metrics_from_ranks(raw, filt, sizes) == metrics["0"],
          "a second run of the ranks gives other metrics")
    print(f"[main] TransH ranking alone (rank_all on loaded data and tables: filter index, feed, one projection "
          f"per relation, {len(sizes)} batches, fetch): {rank_wall:.3f} s", flush=True)
    th, tt, tr = (a.astype(np.int64) for a in dataset.test)
    q_rel, q_anchor = np.repeat(tr, 2), np.stack([tt, th], 1).reshape(-1)
    q_true, q_sign = np.stack([th, tt], 1).reshape(-1), np.tile(np.float32([-1.0, 1.0]), th.shape[0])
    order = np.argsort(q_rel, kind="stable")[:N_CHECK]
    plain = []
    for rel in np.unique(q_rel[order]):
        sel = order[q_rel[order] == rel]
        proj = model.project_entities(params, int(rel))
        anchor, true_idx = (torch.from_numpy(a[sel]).cuda() for a in (q_anchor, q_true))
        queries = proj[anchor] + torch.from_numpy(q_sign[sel]).cuda()[:, None] * params["relation"][int(rel)]
        e_true = distances.residual_energy(proj[true_idx] - queries, Distance.L1)
        proj_t = proj.T.contiguous()
        for s in range(0, sel.shape[0], EVAL_BATCH):
            plain.append(1 + rank_count.rank_counts_reference(
                proj_t, queries[s:s + EVAL_BATCH].T.contiguous(), e_true[s:s + EVAL_BATCH],
                true_idx[s:s + EVAL_BATCH].to(torch.int32), Distance.L1))
    n_off, max_off = compare(torch.from_numpy(raw[:N_CHECK]).cuda(), torch.cat(plain), False,
                             f"TransH main path, first {N_CHECK} queries in group order")
    print(f"[main] TransH: first {N_CHECK} raw ranks in group order vs the plain version: {n_off} differ "
          f"(max {max_off})", flush=True)
    return dict(launches=n_launch, max_off=max_off, wall=walls["0"], rank_wall=rank_wall)


def read_jsonl(path: str):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def train_run(argv, metrics_path: str, expect: dict, what: str, model: str = "transe"):
    """``kb2e_tpu_torch.cli.train_<model>``'s main on ``argv`` with the launch
    counts set to 0 just before it and read just after; returns its metrics
    records and the counts."""
    from kb2e_tpu_torch.cli import train

    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.main([*argv, "--metrics-jsonl", metrics_path], model_name=model)
    wall = time.perf_counter() - t0
    launches = all_launch_counts()
    check(launches == expect, f"{what}: launches {launches}, expected {expect}")
    records = read_jsonl(metrics_path)
    losses = [r["loss"] for r in records]
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    shown = records if len(records) <= 3 else [records[0], records[-1]]
    print(f"[main] {what}: {len(records)} epochs in {wall:.2f} s (loading and the cuckoo build included), "
          f"launches {launches}; " + "; ".join(
              f"epoch {r['epoch']}: loss {r['loss']:.6f}, wall {r['wall_s']:.4f} s, {r['triples_per_s']:.0f} triples/s"
              for r in shown), flush=True)
    return records, launches


def eval_run(argv, expect: dict, what: str, model: str = "transe"):
    from kb2e_tpu_torch.cli import eval as eval_cli

    reset_all_launch_counts()
    metrics = eval_cli.main(argv, model_name=model)
    launches = all_launch_counts()
    check(launches == expect, f"{what}: launches {launches}, expected {expect}")
    print(f"[main] {what}: launches {launches}; filtered MR {metrics['filtered_mean_rank']:.6f}, "
          f"filtered Hits@10 {metrics['filtered_hits10']:.6f}", flush=True)
    return metrics


def training_paths(work: str, data_dir: str):
    """bench.py's configuration through ``train_transe``: 2 fast epochs, the
    written files scored by ``eval_transe``; 1 parity epoch per distance."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count, transe_update

    out = os.path.join(work, "trained_fast")
    fast, _ = train_run(["--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "2"],
                        os.path.join(work, "fast.jsonl"), {}, "train_transe fast, 2 epochs")
    check(fast[1]["loss"] < fast[0]["loss"], "the fast loss does not fall")
    check(all(r["batch_size"] == TRAIN_BATCH for r in fast), "batch size differs from |T| / 100")
    for name in ("entity2vec.bern", "relation2vec.bern", "embedding_meta.json"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")
    n_eval = -(-2 * N_TEST // EVAL_BATCH)
    trained = eval_run(["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1", "--seed", str(SEED)],
                       {rank_count.KERNEL_NAMES[Distance.L1]: n_eval}, "eval_transe on the fast-trained files")
    results = dict(fast=fast, fast_eval=trained)
    for distance in (Distance.L1, Distance.L2):
        name = transe_update.KERNEL_NAMES[distance]
        records, launches = train_run(
            ["--datadir", data_dir, "--outdir", os.path.join(work, f"trained_{name}"), *TRAIN_FLAGS, "--epochs", "1",
             "--update-mode", "parity", "--distance", str(int(distance))],
            os.path.join(work, f"{name}.jsonl"), {name: N_BATCHES}, f"train_transe parity {distance.name}, 1 epoch",
        )
        results[name] = dict(launches=launches[name], records=records)
    return results


def transh_training_paths(work: str, data_dir: str):
    """bench.py's configuration through ``train_transh``: 2 fast epochs, the
    written files scored by ``eval_transh``; 1 parity epoch."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count, transh_update

    out = os.path.join(work, "transh_fast")
    fast, _ = train_run(["--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "2"],
                        os.path.join(work, "transh_fast.jsonl"), {}, "train_transh fast, 2 epochs", model="transh")
    check(fast[1]["loss"] < fast[0]["loss"], "the TransH fast loss does not fall")
    for name in ("entity2vec.bern", "relation2vec.bern", "weights.bern", "embedding_meta.json"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")
    trained = eval_run(["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1", "--seed", str(SEED)],
                       {rank_count.KERNEL_NAMES[Distance.L1]: eval_launches(data_dir, grouped=True)},
                       "eval_transh on the fast-trained files", model="transh")
    name = transh_update.KERNEL_NAME
    records, launches = train_run(
        ["--datadir", data_dir, "--outdir", os.path.join(work, "transh_parity"), *TRAIN_FLAGS, "--epochs", "1",
         "--update-mode", "parity"],
        os.path.join(work, "transh_parity.jsonl"), {name: N_BATCHES}, "train_transh parity, 1 epoch", model="transh",
    )
    return dict(transh_fast=fast, transh_fast_eval=trained, transh_parity=dict(launches=launches[name], records=records))


def quality_path(work: str, model: str, band, parity_kernel: str, reference: str):
    """QUALITY.md's planted-KG setting for ``model`` in both modes, each
    scored through the rank count; filtered Hits@10 must land in ``band``."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import synthetic
    from kb2e_tpu_torch.ops import rank_count

    n_ent, n_rel, n_triples, seed = QUALITY_KG
    kg = os.path.join(work, "planted")
    synthetic.write_kg_dir(kg, synthetic.planted_kg(n_ent, n_rel, n_triples, seed=seed), n_ent, n_rel, seed=seed)
    n_eval = eval_launches(kg, grouped=model == "transh")
    hits = {}
    for mode, expect in (("fast", {}), ("parity", {parity_kernel: QUALITY_BATCHES * QUALITY_EPOCHS})):
        out = os.path.join(work, f"planted_{model}_{mode}")
        train_run(["--datadir", kg, "--outdir", out, *QUALITY_FLAGS, "--update-mode", mode],
                  os.path.join(work, f"planted_{model}_{mode}.jsonl"), expect, f"planted KG, {model} {mode}, {QUALITY_EPOCHS} epochs",
                  model=model)
        metrics = eval_run(["--datadir", kg, "--outdir", out, "--size", str(QUALITY_SIZE), "--method", "1"],
                           {rank_count.KERNEL_NAMES[Distance.L1]: n_eval}, f"planted KG, {model} {mode}: eval_{model}",
                           model=model)
        hits[mode] = metrics["filtered_hits10"]
        check(band[0] <= hits[mode] <= band[1],
              f"planted KG, {model} {mode}: filtered Hits@10 {hits[mode]} outside {band}")
    print(f"[main] planted KG {model} filtered Hits@10: fast {hits['fast']:.6f}, parity {hits['parity']:.6f} "
          f"(band {band}; {reference}, chance {10 / n_ent:.3f})", flush=True)
    return hits


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def update_bound_ms(n, n_rel, k, b, n_updates) -> tuple:
    """Least time on the card for one sequential-update call: the tables
    read once and written once, the batch read and the decisions written, at
    the memory rate; or its fp32 operations at the fp32 peak (per sample 6k
    for the residuals and energies, per update 24k for the two directions'
    adds, squares, norm sums and divisions)."""
    nbytes = 2 * 4 * (n + n_rel) * k + b * (5 * 4 + 1) + 4 * b + 4
    ops = 6 * k * b + 24 * k * n_updates
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def transh_bound_ms(n, n_rel, k, b, n_updates, fired, capped) -> tuple:
    """Least time on the card for one TransH sequential-update call.

    Bytes: the three tables read once and written once, the batch read, the
    decisions and trips written, at the memory rate.  Operations: fp32
    instructions per coordinate, each costed as an FMA (two operations) at
    the fp32 peak: 32 per sample (four w-dots, both residuals, x, energies
    and sum_x); per update 46 for the two directions' deltas and norms and 6
    for each of the six projector calls' two sphere norms; 5 per projector
    test (Σb², the rescale, b^.a) and 4 per fired trip.  A call makes one
    test more than it fires trips unless it stopped at the cap, so this
    run's ``fired`` trips and ``capped`` calls give its count of tests."""
    nbytes = 2 * 4 * (n + 2 * n_rel) * k + b * (5 * 4 + 1) + 3 * 4 * b + 4
    tests = fired + 6 * n_updates - capped
    ops = 2 * k * (32 * b + (46 + 36) * n_updates + 5 * tests + 4 * fired)
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def transh_timing(ctx, results):
    """The TransH update per launch at B 4,831 on TransH-init tables, its plain
    version on the same inputs (timed in the kernels phase), the bound, and
    the TransH main paths' walls."""
    from kb2e_tpu_torch.ops import transh_update

    name = transh_update.KERNEL_NAME
    lr, cap = K4_SETTINGS[0]
    kw = dict(learning_rate=lr, margin=1.0, max_iters=cap)
    args = ctx["transh_args"]
    ms = time_ms(lambda: transh_update.transh_sequential_update(*args, **kw), 5, warmup=1)
    plain_ms = ctx["transh_plain_ms"]
    out = transh_update.transh_sequential_update(*args, **kw)
    n_updates, (fired, capped) = int(out[4].sum()), (int(x) for x in out[5].sum(0))
    b_ms, b_by = transh_bound_ms(N_ENTITIES, N_RELATIONS, K, TRAIN_BATCH, n_updates, fired, capped)
    epoch = results["transh_parity"]["records"][0]
    print(f"[timing] {name} B={TRAIN_BATCH} N={N_ENTITIES} R={N_RELATIONS} k={K}: kernel {ms:.4f} ms per launch "
          f"(wrapper: id check, table copies, launch), plain {plain_ms:.4f} ms (one run; its per-sample loop syncs "
          f"the host at every projector test), library none, bound {b_ms:.5f} ms "
          f"({b_by}; the sample chain is latency-bound), {n_updates} updates, {fired} projector trips fired, "
          f"{capped} calls capped; parity epoch {epoch['wall_s']:.3f} s over {N_BATCHES} launches, "
          f"{epoch['triples_per_s']:.0f} triples/s", flush=True)
    fast, ev = results["transh_fast"], results["transh_eval"]
    print(f"[timing] train_transh fast at bench.py's configuration: epoch walls "
          + ", ".join(f"{r['wall_s']:.3f} s ({r['triples_per_s']:.0f} triples/s)" for r in fast)
          + f"; eval_transh {ev['wall']:.2f} s (ranking alone {ev['rank_wall']:.3f} s) over {ev['launches']} launches",
          flush=True)
    return {
        "name": name,
        "route": "cuda",
        "source": "kb2e_tpu_torch/csrc/transh_update.cu",
        "replaces": "kb2e_tpu/ops/pallas_update.py:242",
        "launches": results["transh_parity"]["launches"],
        "max_abs_err": ctx["transh_worst"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def epoch_breakdown(ctx, model_name: str, params: dict, parity_reps: int = 3):
    """Where one fast epoch and one parity epoch of ``model_name`` spend their
    time at bench.py's configuration: the epoch on CUDA events (median of a
    few runs), the card's busy time in one more run from torch.profiler, and
    its parts alone — the fast epoch's one sampling call and 100 updates, the
    parity epoch's 100 (sample, update) pairs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.train import step

    data = ctx["train_data"]
    model = get_model(model_name)
    cfg = EmbeddingConfig(embedding_size=K, learning_rate=0.001, margin=1.0, method=1, num_batches=N_BATCHES)
    gen = torch.Generator(device=data.heads.device).manual_seed(SEED)
    runner = step.make_epoch_runner(model, cfg, TRAIN_BATCH, N_BATCHES)

    def timed(fn, reps=1):
        """fn's last result and its median time over ``reps`` runs, on the
        card's clock and on the host's, in ms."""
        card, host = [], []
        for _ in range(reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = fn()
            stop.record()
            torch.cuda.synchronize()
            card.append(start.elapsed_time(stop))
            host.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(card)), float(np.median(host))

    def device_busy_ms(fn, what):
        """The card's kernel and copy time during fn: the sum of the device
        events' durations in a torch.profiler trace (0 when it has none);
        prints the kernels that took most of it."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # Host ops carry their kernels' device time too: count device events only.
        ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
        print(f"[timing] {model_name} {what}, device time by kernel: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms over {count}" for ms, count, name in ops[:5]), flush=True)
        return sum(ms for ms, _, _ in ops)

    def idle(busy, wall):
        return f"{1 - busy / wall:.3f}" if busy > 0 else "not measured (no device time in the profile)"

    pcfg = cfg.replace(update_mode="parity")
    train_step = step.make_train_step(model, pcfg, TRAIN_BATCH)

    def parity_epoch():
        p = params
        for _ in range(N_BATCHES):
            p, _ = train_step(p, gen, data)
        return p

    runner(params, gen, data)  # warm-up
    _, fast_ms, fast_host_ms = timed(lambda: runner(params, gen, data), reps=5)
    batches, sample_ms, _ = timed(lambda: runner.sample(gen, data), reps=5)
    _, apply_ms, _ = timed(lambda: runner.apply(params, batches, data.n_entities), reps=5)
    _, parity_ms, parity_host_ms = timed(parity_epoch, reps=parity_reps)
    p_sample = p_update = 0.0
    p = params
    for _ in range(N_BATCHES):
        b, ms, _ = timed(lambda: step.sample_batch(gen, data, pcfg, TRAIN_BATCH))
        p_sample += ms
        (p, _), ms, _ = timed(lambda: model.sequential_update(p, b, pcfg))
        p_update += ms
    # Profiled last: the host launches more slowly once the profiler has run.
    fast_busy = device_busy_ms(lambda: runner(params, gen, data), "fast epoch")
    parity_busy = device_busy_ms(parity_epoch, "parity epoch")
    print(f"[timing] {model_name} fast epoch at B={TRAIN_BATCH} x {N_BATCHES}: {fast_ms:.3f} ms on the card's clock "
          f"({fast_host_ms:.3f} ms on the host's; medians of 5), device busy {fast_busy:.3f} ms, idle share "
          f"{idle(fast_busy, fast_ms)}; alone (medians of 5): sampling the epoch {sample_ms:.3f} ms, "
          f"{N_BATCHES} {'fused ' if runner.fused else ''}updates {apply_ms:.3f} ms", flush=True)
    print(f"[timing] {model_name} parity epoch: {parity_ms:.3f} ms on the card's clock ({parity_host_ms:.3f} ms on "
          f"the host's; medians of {parity_reps}), device busy {parity_busy:.3f} ms, idle share "
          f"{idle(parity_busy, parity_ms)}; each step synchronised: sampling {p_sample:.3f} ms, {N_BATCHES} "
          f"sequential updates {p_update:.3f} ms", flush=True)


def update_timing(ctx, results):
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import transe_update

    records = []
    args = ctx["update_args"]
    for l1 in (True, False):
        distance = Distance.L1 if l1 else Distance.L2
        name = transe_update.KERNEL_NAMES[distance]
        kw = dict(learning_rate=0.001, margin=1.0, l1=l1)
        ms = time_ms(lambda: transe_update.transe_sequential_update(*args, **kw), 10)
        plain_ms = time_ms(lambda: transe_update.transe_sequential_update_reference(*args, **kw), 2, warmup=1)
        n_updates = int(transe_update.transe_sequential_update(*args, **kw)[3].sum())
        b_ms, b_by = update_bound_ms(N_ENTITIES, N_RELATIONS, K, TRAIN_BATCH, n_updates)
        epoch = results[name]["records"][0]
        print(f"[timing] {name} B={TRAIN_BATCH} N={N_ENTITIES} R={N_RELATIONS} k={K}: kernel {ms:.4f} ms per launch "
              f"(wrapper: id check, table copies, launch), plain {plain_ms:.4f} ms, library none, bound "
              f"{b_ms:.4f} ms ({b_by}; the sample chain is latency-bound), {n_updates} updates; parity epoch "
              f"{epoch['wall_s']:.3f} s over {N_BATCHES} launches, {epoch['triples_per_s']:.0f} triples/s",
              flush=True)
        records.append({
            "name": name,
            "route": "cuda",
            "source": "kb2e_tpu_torch/csrc/transe_update.cu",
            "replaces": "kb2e_tpu/ops/pallas_update.py:44",
            "launches": results[name]["launches"],
            "max_abs_err": ctx["update_worst"][name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    return records


def timing_phase(tables, ctx, results):
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count

    worst = ctx["rank_worst"]
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
    records += update_timing(ctx, results)
    fast = results["fast"]
    print(f"[timing] train_transe fast at bench.py's configuration: epoch walls "
          + ", ".join(f"{r['wall_s']:.3f} s ({r['triples_per_s']:.0f} triples/s)" for r in fast), flush=True)
    epoch_breakdown(ctx, "transe", {"entity": ctx["update_args"][0], "relation": ctx["update_args"][1]})
    records.append(transh_timing(ctx, results))
    epoch_breakdown(ctx, "transh", dict(zip(TRANSH_KEYS, ctx["transh_args"][:3])), parity_reps=2)
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
    tables, transh = init_tables("transe", torch.device("cuda")), init_tables("transh", torch.device("cuda"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) as work:
        data_dir, out_dir, transh_dir = phase("data", data_phase, tables, transh, work)
        ctx = phase("kernels", kernels_phase, tables, transh, data_dir)
        results = phase("main", main_phase, tables, work, data_dir, out_dir, transh_dir)
        records = phase("timing", timing_phase, tables, ctx, results)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
