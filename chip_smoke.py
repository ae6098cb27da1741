"""Smoke run of the PyTorch/CUDA port (kb2e_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --rank-count-only   # phases 1-2, the rank count's checks and timing
    python3 chip_smoke.py --ranking-alone     # phases 1-2, harness.rank_all timed alone
    python3 chip_smoke.py --transr-fast-only  # phases 1-2, TransR's fast-chunk kernels checked and timed
    python3 chip_smoke.py --distributed-only  # phases 1-2, the data, the distributed phase
    python3 chip_smoke.py --nccl-cards        # the same over NCCL on every card of a host (2 or more)
    python3 chip_smoke.py --quality-scale [model ...]  # phases 1-2 and the scale-quality cells of the models

Phases, each printing one line (or a few) and stopping the run with a
non-zero exit on any failure:

1. device   — require CUDA, print the card's name and power limit, TF32 off;
2. build    — compile every kernel of the main paths from ``csrc/``, one
              nvcc per source, all started together, and print ptxas's
              register and spill report per kernel template;
3. kernels  — each kernel against its plain PyTorch version at FB15k width:
              the rank count (N = 14,951, k = 100, B = 256 and a ragged 250;
              L1 and L2), exact on dyadic inputs (through the wrapper and
              through the bare launch) and at most 0.1 % of queries off by
              at most 2 on TransE-init tables; the TransE
              sequential update (N = 14,951, R = 1,345, k = 100, B = 4,831, a
              batch of the port's sampler with 1/8 of its positives h == t
              and the next 1/8 of its corrupted triples h' == t'; L1 and L2),
              equal to its plain version bit for bit on dyadic and on
              TransE-init snapshots: decisions, loss and both tables; the
              TransH sequential update (the same width, a
              whole sampler batch of 4,831 with 1/8 of its positives h == t
              and the next 1/8 of its corrupted triples h' == t', on
              TransH-init tables at each of K4_SETTINGS), equal to its plain
              version bit for bit: decisions, projector trips, loss and all
              three tables; the TransR sequential update (the same width, a
              whole sampler batch of 4,831 with every 8th h == t and every
              8th h' == t', on TransR-init tables at each of K5_SETTINGS, L1
              and L2), equal bit for bit to its plain version, which runs on
              the host's CPU in one process per setting while the card checks
              the other kernels; all three updates also bit for bit on the
              STRESS batches of their schedule (stress_batches: one chain of
              the whole batch through one relation or one entity, no shared
              row, fewer samples than resident blocks, no valid sample) and
              on a sampler batch of a skewed graph (skewed_batch) at the
              main path's setting (TransE: L1 and L2); TransE's fast batch
              (``ops/transe_fast.py``) through its wrapper against
              ``fused_table_update`` on the first batch of a sampler epoch
              at K = 1 and 8 (4,831 and 38,648 rows; L1 and L2), bit for bit
              on dyadic tables and within a unit in the last place on
              TransE-init tables, one launch of each kernel a call;
4. main     — the main paths on an FB15k-shaped data directory (bench.py's
              configuration), each with the launch counts set to 0 just
              before it and read just after:
              * eval: seeded TransE embeddings through
                ``kb2e_tpu_torch.cli.eval_transe.main`` for ``--distance 0``
                and ``1``: one rank-count launch per batch, and the first
                4,096 ranks agree with the plain version on the card;
              * fast training: ``kb2e_tpu_torch.cli.train_transe.main`` for 2
                epochs, one launch of each of TransE's three fast-batch
                kernels a batch (200); the loss is finite and falls, and
                ``eval_transe`` scores the written files (rank count L1);
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
              * TransR eval: seeded TransR-init tables through
                ``kb2e_tpu_torch.cli.eval_transr.main`` for ``--distance 0``
                (rank count L1) and ``1`` (L2), one launch per batch of each
                relation's group, the first 4,096 ranks in group order
                against the plain version;
              * TransR training, warm-started from the fast TransE run's
                files: 2 fast epochs (no kernel; the loss is finite and
                falls; ``eval_transr`` scores the written files) and 1
                parity epoch (one TransR sequential-update launch per batch,
                100);
              * TransR quality: QUALITY.md's TransR row (lr 0.01,
                warm-started from the planted-KG TransE fast run) in both
                modes; filtered Hits@10 must land in the bands of
                QUALITY_BANDS_TRANSR;
              * CTransR (no kernel: plain torch on the card), warm-started
                from the fast TransE run's files: ``train_ctransr`` for 2
                fast epochs (the loss is finite and falls; the files and the
                sidecar's extras are written; ``build_centers``' seconds),
                ``eval_ctransr`` for ``--distance 0`` and ``1`` on them with
                no kernel launch, each with its ranking alone; and on seeded
                dyadic tables the routed ranks of the first N_CHECK or more
                queries in group order equal on the card and on the CPU;
              * CTransR quality: QUALITY.md's CTransR row (TransR's flags and
                warm start, centers seeded by --seed 5) in both modes; the
                parity run warns that CTransR has no parity mode and
                launches no kernel; filtered Hits@10 must land in the bands
                of QUALITY_BANDS_CTRANSR;
              * relation prediction: ``eval_<model> --task relation`` on the
                fast-trained files of TransE, TransR and CTransR: finite
                metrics, no kernel launch, seconds and peak device memory;
              * loader: the native triple loader must build and load, and
                give the Python loader's arrays; the seconds of the triple
                parse each way, of ``load_dataset`` each way, and of
                ``read_matrix`` on TransR's ``weights.bern``;
              * PTransE (no kernel of its own), warm-started from the fast
                TransE run's files with ADD, 2 hops and 8 paths: the native
                PCRA store of the train split (seconds, coverage),
                ``train_ptranse`` for 2 fast epochs (the loss is finite and
                falls; ``relation_inv.bern`` and the sidecar's extras are
                written), ``eval_ptranse`` for ``--distance 0`` and ``1``
                (one rank-count launch per batch, the first 4,096 ranks
                against the plain version), ``--task relation`` with the
                test pairs' path evidence (no launch; the store's seconds,
                the wall, the scoring alone, the peak device memory), and on
                dyadic tables the ranks with evidence of the first 8 batches
                equal on the card and on the CPU;
              * PTransE quality: QUALITY.md's rows on the planted KG
                (warm-started from its TransE fast run), entity Hits@10 in
                QUALITY_BANDS_PTRANSE and relation Hits@10 with evidence in
                QUALITY_BAND_PTRANSE_RELATION; and the mechanism of
                benchmarks/ptranse_composition.py on compositional_kg: with
                evidence in MECHANISM_BAND, at least MECHANISM_MIN_GAIN above
                without;
5. scale    — benchmarks/quality_fb15k_scale.py's protocol through the
              port's CLIs (SCALE_CELLS): a planted KG of FB15k's shape
              (14,951 entities, 1,345 relations, 483,142 drawn triples, seed
              11; generated on the host, cut in order into train, 5 % valid
              and 5 % test), k 100, bern, L1, 100 batches, 40 epochs:
              TransE at K = 1 and K = 8 negatives and TransH at K = 8 here
              (``--quality-scale`` adds TransR and CTransR at K = 8,
              warm-started from the K = 1 TransE files), each trained by
              ``train_<model>`` (TransE: one launch of each fast-batch
              kernel a batch) and scored by ``eval_<model>`` with one K1
              launch a batch of each group; on TransE K = 8's trained tables
              the first N_CHECK ranks equal K1's plain version; each cell's
              filtered Hits@10 within SCALE_HITS_TOL and filtered MR within
              SCALE_MR_RTOL of the JAX package's record, K = 8 at least
              SCALE_K_GAIN above K = 1, filtered MR in the record's order;
6. distributed — the port's ``parallel/`` package on the card, after the
              scale cells, on the main paths' FB15k-shaped directory:
              (a) the entity-sharded eval, 2 ranks on cuda:0 over gloo
              (NCCL refuses two ranks on one device), model axis 2, from
              tables placed as the mesh cuts them (entity rows, and
              TransR's and CTransR's per-relation tables on the relation
              axis; each rank fetches a group's W_r from its owner): the
              seeded TransE files at ``--distance 0`` and ``1``, the TransR
              files (W = I) at L1 and L2, the TransR files with a seeded
              non-dyadic W at L1 and L2, seeded dyadic and non-dyadic
              CTransR tables at L1 and L2 (these six on the test triples of
              the first relations): each rank's ranks equal the one-rank
              harness's exactly, with one rank-count launch per batch on each
              rank (462 a TransE eval, 1,345 a TransR eval; they add to the
              kernel records' launches; none for CTransR), and each rank's
              first N_CHECK counts agree with the plain version on that
              rank's inputs (its shard, its ‖e‖², the shifted true index);
              (b) fast training over 2 ranks on cuda:0 over gloo from
              seeded init tables, bench.py's configuration (the batch
              rounded down to the data axis; DP_RUNS): TransE, TransH and
              PTransE (with the train split's path store) data-parallel for
              one epoch and TransH with its entity rows cut for three
              batches: after the first batch the tables within atol 2e-6
              of the single-rank runner's and the loss within rel 1e-5 (the
              JAX package's bounds), and the run's largest difference
              printed; then TransR and CTransR (warm-started from the
              TransE files) at mesh (1, 2) for
              CUT_CHUNKS chunks of 256, each rank's cut of the tables held
              to the same bounds after the first chunk;
              (c) ``parallel/multiprocess.py`` at 1 process over NCCL, 2
              epochs of TransE and 1 of TransR with ``--eval-out``: its
              metrics equal ``harness.evaluate`` on the tables it wrote.
              Each part's processes are killed after DIST_DEADLINE_S;
              their walls are printed beside the card's name and power limit;
7. timing   — per kernel at the main path's shapes: the kernel, the plain
              version, one PyTorch library call for the same function where
              there is one, and the card's lower bound.  The rank count's
              records count the launches of every eval path (TransE,
              PTransE, both TransH flags, TransR); their ``ms`` is the wrapper's time as
              the harness calls it, with the bare launch's device time beside
              it (``device_ms``: CUDA events, the profiler as a cross-check),
              the grid, the resident blocks and waves.  The TransE, TransH and TransR updates
              are also timed on each STRESS batch and on the skewed batch,
              beside its longest chain of samples that share a row (from the
              schedule's predecessors) and its count of updates, with the
              update pass's resident blocks per SM, the device time of one
              call by kernel, and the wrapper's id check alone.  TransE's
              fast batch a batch over a sampler epoch at K = 1 and 8: the
              wrapper on CUDA events, the device time by kernel,
              ``fused_table_update`` on the same batches and the bound from
              ``portbench/reference/transe.py::update_work``.  TransR's
              fast chunk (``ops/transr_fast.py``) at the transr-fb15k.train
              cell's shape (``transr_fast_timing``: bit for bit on dyadic
              chunks first, then the device time a chunk and by phase, the
              host's, ``ChunkGraph`` and the bound).  Then
              CTransR's fast epoch (the loop's walls, the breakdown on its
              trained tables), its clustered eval, relation prediction and
              the loader, and PTransE's fast epoch (the breakdown on its
              trained tables and path store), path stores and evals, each
              line beside the card's name and power limit.

The last lines are the card's ``name, power.limit``, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import multiprocessing as mp
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


def quality_flags(rate: str):
    return ["--size", str(QUALITY_SIZE), "--rate", rate, "--margin", "1", "--method", "1",
            "--batches", str(QUALITY_BATCHES), "--epochs", str(QUALITY_EPOCHS), "--seed", "5"]


QUALITY_FLAGS = quality_flags("0.02")
QUALITY_BAND = (0.399, 0.479)
# QUALITY.md's TransH row (QUALITY.md:20): the same KG and flags gave
# filtered Hits@10 0.423 there; the band is +-0.04, as TransE's.
QUALITY_BAND_TRANSH = (0.383, 0.463)
# QUALITY.md's TransR row (QUALITY.md:21, examples/quality_run.py:105-113):
# half TransE's rate, warm-started from the TransE run; filtered Hits@10
# 0.499 there, +-0.04 in fast mode.  Parity mode must keep at least the
# TransE band's low end, so the warm start is not lost.
QUALITY_BANDS_TRANSR = {"fast": (0.459, 0.539), "parity": (0.399, 1.0)}
# QUALITY.md's CTransR row (QUALITY.md:22, examples/quality_run.py:105-118):
# TransR's rate and warm start, centers seeded by --seed 5; filtered Hits@10
# 0.512 there, +-0.04 in fast mode.  Its parity mode is the fast update at
# batch granularity, held to TransR's parity floor.
QUALITY_BANDS_CTRANSR = {"fast": (0.472, 0.552), "parity": (0.399, 1.0)}
# (learning rate, projector cap) of the TransH update's checks against its
# plain version: bench.py's rate and the default cap, which the main path
# runs, then lr 0.05 with caps of 2 and of 1.  On TransH-init tables few
# projector calls reach a cap of 2, so the cap of 1, where every fired trip
# reaches it, is what makes sure the capped exit is held against the plain
# version.
K4_SETTINGS = ((0.001, 16), (0.05, 2), (0.05, 1))
# The same settings for the TransR update, each for L1 and L2, on a whole
# sampler batch: its plain version walks every output dim of every projector
# trip in Python, tens of ms a sample, so it runs on the host's CPU, one
# process per setting, while the card checks the other kernels.
K5_SETTINGS = K4_SETTINGS
# Batches that stress the sequential updates' schedule (stress_batches),
# checked and timed at the main path's setting.
STRESS = ("one relation", "one entity", "distinct rows", "smaller than the grid", "all invalid")
IDX_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")
TRANSH_KEYS = ("entity", "relation", "norm")
TRANSR_KEYS = ("entity", "relation", "proj")
# A skewed graph at FB15k's entity and relation counts (skewed_batch):
# data/synthetic.py::skewed_kg(14,951, 1,345, 120,000, seed=1).  Only the
# triple count is cut, from FB15k's 483,142: generation grows about as
# |T|^1.8 (12.5 s at 120,000 on one core, over 150 s at 483,142), and the
# shares that set the longest chain do not depend on |T| (the top relation
# holds 6.4 % of the triples).
SKEWED_KG = (N_ENTITIES, N_RELATIONS, 120_000, 1)
# Unrounded inputs: sums taken in another order may move an energy across a
# tie, so a few counts may differ; dyadic inputs must match exactly.
MAX_QUERY_SHARE_OFF, MAX_COUNT_OFF = 0.001, 2

# PTransE at bench.py's configuration and in QUALITY.md's runs: ADD
# composition, 2-hop PCRA paths, the 8 most reliable a triple.
PTRANSE_FLAGS = ["--path-comp", "add", "--max-paths", "8", "--path-length", "2"]
# QUALITY.md's PTransE rows (QUALITY.md:23 and :54; examples/quality_run.py:
# 120-141): TransE's flags, warm-started from the planted-KG TransE run;
# filtered Hits@10 0.435 on the entity task and 0.611 on relation prediction
# with path evidence, +-0.04.  Its parity mode is the fast update, held to
# the entity band's low end.
QUALITY_BANDS_PTRANSE = {"fast": (0.395, 0.475), "parity": (0.395, 1.0)}
QUALITY_BAND_PTRANSE_RELATION = (0.571, 0.651)
# PTRANSE_COMP_r05.json (benchmarks/ptranse_composition.py): on
# compositional_kg(seed=0), k 32, 60 epochs, lr 0.01, 20 batches, bern, L1,
# seed 11, ADD, path weight 0, stores of 16 paths, relation prediction's
# filtered Hits@10 was 0.7802 with path evidence and 0.6645 without.  One
# seed's result moves by more than the band's width (seed 11 gave 0.838 with
# the evidence on an H100), so the port trains MECHANISM_SEEDS and their mean
# must land in MECHANISM_BAND with the evidence and gain at least half of
# that 0.116 from it; the evidence must help at every seed.
MECHANISM_BAND, MECHANISM_MIN_GAIN = (0.74, 0.82), 0.058
MECHANISM_SEEDS = (11, 12, 13, 14)
# Checks of relation evidence on the card against the CPU: the first batches.
N_RELATION_CHECK_BATCHES = 8


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
    from kb2e_tpu_torch.ops import rank_count, transe_fast, transe_update, transh_update, transr_update

    return rank_count, transe_update, transh_update, transr_update, transe_fast


def build_phase():
    modules = kernel_modules()
    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        paths = list(pool.map(lambda m: m.build(), modules))
    print(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in paths)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # ptxas's report per kernel and template; the template's bool is kL2 for
    # the rank count and kL1 for the TransE and TransR decide passes; the
    # TransE fast batch's templates are printed as they are (score: chunks a
    # lane, vector loads, L1; apply: chunks a lane, vector loads); the other
    # kernels have no template (the TransH update is L1 only; the TransH and
    # TransR update passes and the loss kernel read x, not the distance; the
    # TransE update pass takes it as an argument).
    distance_of = {"rank_count_kernel": ("L1", "L2"), "transe_decide_kernel": ("L2", "L1"),
                   "transr_decide_kernel": ("L2", "L1")}
    for path in paths:
        entry = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            found = re.search(r"([A-Za-z_]+_kernel)(?:I((?:L[bi]\d+E)+))?", line) if "Compiling entry" in line else None
            if found:
                entry = f"{path.stem.rsplit('_', 1)[0]}: {found[1]}"
                args = re.findall(r"L[bi](\d+)E", found[2] or "")
                if found[1] in distance_of:
                    entry += f" {distance_of[found[1]][int(args[0])]}"
                elif args:
                    entry += f" <{', '.join(args)}>"
            elif "registers" in line or "spill" in line:
                print(f"[build] {entry}: {line.replace('ptxas info    :', '').strip()}", flush=True)


def reset_all_launch_counts():
    from kb2e_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()


def all_launch_counts() -> dict:
    from kb2e_tpu_torch.ops import cuda_build

    return dict(cuda_build.launch_counts)


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


def kernels_phase(tables, transh, transr, data_dir, work):
    """Every kernel against its plain version; returns the worst errors and
    the sequential updates' inputs for the timing phase.  The TransR update's
    plain version runs on the host's CPU, one process per setting, while the
    card checks the other kernels."""
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.train import step

    t0 = time.perf_counter()
    data = step.DeviceData.from_triple_set(triples.load_dataset(data_dir).train, "cuda")
    print(f"[kernels] loaded the FB15k-shaped training graph and built its cuckoo index in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    skewed = skewed_batch()
    batches, paths = transr_batches(transr, data, work, skewed)
    jobs = [("sampler", l1, lr, cap) for l1 in (True, False) for lr, cap in K5_SETTINGS]
    jobs += [(kind, True, *K5_SETTINGS[0]) for kind in (*STRESS, "skewed")]
    # Spawned, not forked: the parent holds a CUDA context.
    with concurrent.futures.ProcessPoolExecutor(len(jobs), mp_context=mp.get_context("spawn")) as pool:
        plain = {job: pool.submit(transr_plain_job, paths["tables"], paths[job[0]], *job[1:]) for job in jobs}
        ctx = dict(rank_worst=rank_kernel_checks(tables), train_data=data, skewed=skewed)
        ctx.update(update_kernel_checks(tables, data, skewed))
        ctx.update(transe_fast_kernel_checks(tables, data))
        ctx.update(transh_kernel_checks(transh, data, skewed))
        ctx.update(transr_kernel_checks(transr, batches, plain))
    return ctx


def skewed_batch():
    """A sampler batch of 4,831 (bern, the port's sampler) from an
    FB15k-shaped ``skewed_kg`` (SKEWED_KG): its most frequent relations set
    the longest chain of samples that share a row."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.data import synthetic, triples
    from kb2e_tpu_torch.train import step

    n_ent, n_rel, n_triples, seed = SKEWED_KG
    t0 = time.perf_counter()
    h, t, r = synthetic.skewed_kg(n_ent, n_rel, n_triples, seed=seed)
    made = time.perf_counter() - t0
    data = step.DeviceData.from_triple_set(triples.TripleSet.from_arrays(h, t, r, n_ent, n_rel), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    batch = step.sample_batch(gen, data, EmbeddingConfig(embedding_size=K, method=1), TRAIN_BATCH)
    idx = [batch[key] for key in IDX_KEYS]
    top = np.bincount(r, minlength=n_rel).max()
    in_batch = int(torch.bincount(batch["r"].long(), minlength=n_rel).max())
    print(f"[kernels] skewed_kg{SKEWED_KG}: {h.shape[0]} distinct triples in {made:.1f} s, the top relation "
          f"{top} of them ({top / h.shape[0]:.2%}); a sampler batch of {TRAIN_BATCH} holds {in_batch} samples of "
          f"its most frequent relation, {int((idx[1] == idx[0]).sum())} h == t, "
          f"{int((~batch['valid']).sum())} invalid", flush=True)
    return idx


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
            want = rank_count.rank_counts_reference(*args)
            n_dy, _ = compare(got, want, True, f"{distance.name} B={b} dyadic")
            # The bare launch, on the harness's aligned layout with ‖e‖² given.
            compare(bare_launch(args), want, True, f"{distance.name} B={b} dyadic, bare launch")
            # TransE-init tables, eval-shaped queries.
            args = (*eval_inputs(tables["entity"], tables["relation"], b, distance, rng), distance)
            got = rank_count.rank_counts(*args)
            torch.cuda.synchronize()
            n_off, max_off = compare(got, rank_count.rank_counts_reference(*args), False, f"{distance.name} B={b}")
            worst[distance] = max(worst.get(distance, 0), max_off)
            print(f"[kernels] {rank_count.KERNEL_NAMES[distance]} N={N_ENTITIES} k={K} B={b}: "
                  f"dyadic {n_dy} counts differ; TransE-init {n_off}/{b} differ (max {max_off})", flush=True)
    return worst


def update_kernel_checks(tables, data, skewed):
    """The TransE sequential-update kernel against its plain version at
    FB15k width, bit for bit, L1 and L2: on a batch of the port's sampler
    over the FB15k-shaped training graph with dyadic and with TransE-init
    snapshots, and on the stress batches made from it and the skewed batch
    with TransE-init snapshots.  Returns the inputs of the timing phase, the
    largest table difference, and the plain version's time on the sampler
    batch (TransE-init)."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import transe_update
    from kb2e_tpu_torch.train import step

    dev = tables["entity"].device
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = step.sample_batch(gen, data, EmbeddingConfig(embedding_size=K, method=1), TRAIN_BATCH)
    # Self-loops: 1/8 of the positives h == t, the next 1/8 of the negatives.
    eighth = TRAIN_BATCH // 8
    batch["pt"][:eighth] = batch["ph"][:eighth]
    batch["nt"][eighth:2 * eighth] = batch["nh"][eighth:2 * eighth]
    batches = {"sampler": {key: batch[key] for key in IDX_KEYS}, **stress_batches(batch, SEED + 8)}
    batches["skewed"] = dict(zip(IDX_KEYS, skewed))
    print(f"[kernels] sampled a batch of {TRAIN_BATCH} on the FB15k-shaped graph in "
          f"{time.perf_counter() - t0:.1f} s; {int((~batch['valid']).sum())} invalid", flush=True)

    rng = np.random.default_rng(SEED + 2)
    snapshots = {
        "dyadic": [torch.from_numpy(dyadic(rng, (n, K))).to(dev) for n in (N_ENTITIES, N_RELATIONS)],
        "TransE-init": [tables["entity"], tables["relation"]],
    }
    checks = [("sampler", what) for what in snapshots] + [(kind, "TransE-init") for kind in (*STRESS, "skewed")]
    worst, plain_ms = {}, {}
    for l1 in (True, False):
        name = transe_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]
        for kind, what in checks:
            idx = [batches[kind][key] for key in IDX_KEYS]
            args = (*snapshots[what], *idx)
            kw = dict(learning_rate=0.001, margin=1.0, l1=l1)
            got = transe_update.transe_sequential_update(*args, **kw)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            want = transe_update.transe_sequential_update_reference(*args, **kw)
            stop.record()
            torch.cuda.synchronize()
            plain_ms[name, kind, what] = start.elapsed_time(stop)
            worst[name] = max(worst.get(name, 0.0), check_update_equal(f"{name} {what}", idx, got, want, m=2))
            print(f"[kernels] {name} N={N_ENTITIES} R={N_RELATIONS} k={K} {describe_batch(kind, idx)} on {what} "
                  f"tables: {int(got[3].sum())} updates; decisions, loss ({float(got[2]):.6f}) and both tables equal "
                  f"to the plain version's bit for bit; plain version {plain_ms[name, kind, what]:.1f} ms", flush=True)
    sampler = [batches["sampler"][key] for key in IDX_KEYS]
    return dict(update_worst=worst, update_args=(tables["entity"], tables["relation"], *sampler),
                update_stress={kind: [batches[kind][key] for key in IDX_KEYS] for kind in STRESS},
                update_plain_ms={name: plain_ms[name, "sampler", "TransE-init"] for name in worst})


# The TransE training cells' K negatives: sampler batches of 4,831 and 38,648 rows.
FAST_NEGATIVES = (1, 8)


def fast_batch_launches(model: str, n_batches: int, data_dir: str = None, epochs: int = 1, k_neg: int = 1) -> dict:
    """The launch counts of ``model``'s fast epochs on the card (float32
    tables): for TransE the three kernels of its fast batch
    (``ops/transe_fast.py``) once each of ``n_batches`` batches; for TransR
    its chunk kernel (``ops/transr_fast.py``) once a run of up to
    ``transr_fast.RUN`` chunks, over ``epochs`` epochs of ``n_batches``
    batches of ``data_dir``'s train split (``k_neg`` rows a positive); no
    other model launches one (CTransR replays its chunk as a CUDA graph)."""
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.data.triples import load_dataset
    from kb2e_tpu_torch.ops import transe_fast, transr_fast

    if model == "transe":
        return {name: n_batches for name in transe_fast.KERNEL_NAMES}
    if model != "transr":
        return {}
    rows = max(1, load_dataset(data_dir).train.num_triples // n_batches) * max(1, k_neg)
    chunks = -(-n_batches * rows // min(get_model("transr").chunk_size, rows))
    return {name: epochs * -(-chunks // transr_fast.RUN) for name in transr_fast.KERNEL_NAMES}


def fast_epoch_feed(data, k_neg: int):
    """bench.py's configuration with ``k_neg`` negatives, and one epoch of the
    port's sampler under it on the FB15k-shaped graph, [N_BATCHES, rows]."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.train import step

    cfg = EmbeddingConfig(embedding_size=K, learning_rate=0.001, margin=1.0, method=1, num_batches=N_BATCHES,
                          num_negatives=k_neg)
    runner = step.EpochRunner(get_model("transe"), cfg, TRAIN_BATCH, N_BATCHES)
    return cfg, runner.sample(torch.Generator(device="cuda").manual_seed(SEED + k_neg), data)


def transe_fast_kernel_checks(tables, data):
    """TransE's fast batch through its wrapper (``ops/transe_fast.py``, as
    ``TransE.stepper`` makes it for float32 tables on the card) against ``TransE.fused_table_update`` on the card,
    on the first batch of a sampler epoch at each of FAST_NEGATIVES (B 4,831
    and 38,648 rows), L1 and L2, from one start each: bit for bit on dyadic
    tables (multiples of 1/16 in [-1/2, 1/2], most rows of norm above 1, lr
    1/16: every sum of the batch exact in any order); on TransE-init tables
    at lr 0.001 within 1e-7 (L2 1e-6) and in no more elements than four
    times those in which ``fused_table_update`` parts from itself, or a
    thousandth of them; the loss within 1e-6 of the plain version's (1e-5
    on TransE-init tables), summed in another order.  The launch counts are
    set to 0 just before each call: one launch of each kernel.  Returns the
    largest table difference and the epochs for the timing phase."""
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.models import base
    from kb2e_tpu_torch.ops import transe_fast

    model, feeds, cfgs, worst = get_model("transe"), {}, {}, 0.0
    rng = np.random.default_rng(SEED + 3)
    dyadic_tables = [torch.from_numpy(np.clip(np.round(rng.normal(size=(n, K)) * 3) / 16, -0.5, 0.5)
                                      .astype(np.float32)).cuda() for n in (N_ENTITIES, N_RELATIONS)]
    snapshots = {"dyadic": (dyadic_tables, 1 / 16), "TransE-init": ([tables["entity"], tables["relation"]], 0.001)}
    one_each = {name: 1 for name in transe_fast.KERNEL_NAMES}
    for k_neg in FAST_NEGATIVES:
        cfg, feeds[k_neg] = fast_epoch_feed(data, k_neg)
        cfgs[k_neg] = cfg
        first = {key: v[:1] for key, v in feeds[k_neg].items()}
        batch = {key: v[0] for key, v in feeds[k_neg].items()}
        for distance in (Distance.L1, Distance.L2):
            for what, (snapshot, lr) in snapshots.items():
                c = cfg.replace(distance=distance, learning_rate=lr)
                params = dict(zip(("entity", "relation"), snapshot))
                start = base.fuse(params)
                run = model.stepper(params, first, c)
                reset_all_launch_counts()
                run(0)
                torch.cuda.synchronize()
                launches = all_launch_counts()
                table = base.fuse(run.params())
                what_ = f"transe_fast {distance.name} K={k_neg} ({first['ph'].shape[1]} rows) on {what} tables"
                check(launches == one_each, f"{what_}: launches {launches}, expected {one_each}")
                want, want_loss = model.fused_table_update(start, N_ENTITIES, batch, c)
                again, _ = model.fused_table_update(start, N_ENTITIES, batch, c)
                apart, itself = int((table != want).sum()), int((again != want).sum())
                err, loss, want_loss = float((table - want).abs().max()), float(run.loss[0]), float(want_loss)
                if what == "dyadic":
                    check(apart == 0, f"{what_}: {apart} elements differ (max {err:.3e}) from the plain version")
                    check(abs(loss - want_loss) <= 1e-6 * abs(want_loss), f"{what_}: loss {loss!r} against {want_loss!r}")
                else:
                    atol = 1e-7 if distance == Distance.L1 else 1e-6
                    check(err <= atol and apart <= 4 * itself + want.numel() // 1000,
                          f"{what_}: {apart} elements differ, max {err:.3e} (atol {atol}); the plain version "
                          f"parts from itself in {itself}")
                    check(abs(loss - want_loss) <= 1e-5 * abs(want_loss), f"{what_}: loss {loss!r} against {want_loss!r}")
                check(want_loss > 0, f"{what_}: no sample violates its margin")
                worst = max(worst, err)
                print(f"[kernels] {what_}, lr {lr}: launches {launches}; {apart} of {want.numel()} elements differ "
                      f"from fused_table_update's (max {err:.3e}; it parts from itself in {itself}); loss "
                      f"{loss:.6f} against {want_loss:.6f}", flush=True)
    return dict(fast_worst=worst, fast_feeds=feeds, fast_cfgs=cfgs)


def transh_kernel_checks(transh, data, skewed):
    """The TransH sequential-update kernel against its plain version at FB15k
    width on TransH-init tables, bit for bit, on a whole sampler batch of
    4,831 at each of K4_SETTINGS, and on the stress batches made from it and
    the skewed batch at the main path's setting, K4_SETTINGS[0].  Returns
    the inputs of the timing phase (the same tables and batches), the
    largest table difference, and the plain version's time on the sampler
    batch at the main path's setting."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.ops import transh_update
    from kb2e_tpu_torch.train import step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = step.sample_batch(gen, data, EmbeddingConfig(embedding_size=K, method=1), TRAIN_BATCH)
    # 1/8 of the positives h == t, the next 1/8 of the corrupted triples h' == t'.
    eighth = TRAIN_BATCH // 8
    batch["pt"][:eighth] = batch["ph"][:eighth]
    batch["nt"][eighth:2 * eighth] = batch["nh"][eighth:2 * eighth]
    batches = {"sampler": batch, **stress_batches(batch, SEED + 5), "skewed": dict(zip(IDX_KEYS, skewed))}
    checks = [("sampler", lr, cap) for lr, cap in K4_SETTINGS]
    checks += [(kind, *K4_SETTINGS[0]) for kind in (*STRESS, "skewed")]

    tables = [transh[key] for key in TRANSH_KEYS]
    name = transh_update.KERNEL_NAME
    worst, plain_ms = 0.0, {}
    for kind, lr, cap in checks:
        idx = [batches[kind][key] for key in IDX_KEYS]
        kw = dict(learning_rate=lr, margin=1.0, max_iters=cap)
        got = transh_update.transh_sequential_update(*tables, *idx, **kw)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = transh_update.transh_sequential_update_reference(*tables, *idx, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms[kind, lr, cap] = start.elapsed_time(stop)
        what = f"{name} lr={lr} max_iters={cap}"
        worst = max(worst, check_update_equal(what, idx, got, want, cap))
        fired, capped = (int(x) for x in got[5].sum(0))
        print(f"[kernels] {what} N={N_ENTITIES} R={N_RELATIONS} k={K} {describe_batch(kind, idx)} on TransH-init "
              f"tables: {int(got[4].sum())} updates, {fired} projector trips fired, {capped} projector calls "
              f"stopped at the cap; decisions, trips, loss ({float(got[3]):.6f}) and all three tables equal to the "
              f"plain version's bit for bit; plain version {plain_ms[kind, lr, cap]:.1f} ms", flush=True)
    return dict(transh_args=(*tables, *[batch[key] for key in IDX_KEYS]), transh_worst=worst,
                transh_stress={kind: [batches[kind][key] for key in IDX_KEYS] for kind in STRESS},
                transh_plain_ms=plain_ms[("sampler", *K4_SETTINGS[0])])


def stress_batches(batch, seed: int) -> dict:
    """Batches that stress the update pass's schedule at FB15k width, made
    from a sampler batch of 4,831: every sample on relation 0 (one chain of
    the whole batch); entity 0 in every sample, as h, t, h', t' in turn (one
    chain too); 1,345 samples that share no row (each relation once, 5,380
    distinct entities: no chain at all); the batch's first 3 samples, fewer
    than the resident blocks; and the batch with no valid sample."""
    sub = {key: batch[key] for key in IDX_KEYS}
    one_entity = {key: value.clone() for key, value in sub.items()}
    for j, key in enumerate(("ph", "pt", "nh", "nt")):
        one_entity[key][j::4] = 0
    gen = torch.Generator().manual_seed(seed)
    ents = torch.randperm(N_ENTITIES, generator=gen)[:4 * N_RELATIONS].to(torch.int32).reshape(4, N_RELATIONS)
    distinct = {key: ents[j].cuda() for j, key in enumerate(("ph", "pt", "nh", "nt"))}
    distinct["r"] = torch.randperm(N_RELATIONS, generator=gen).to(torch.int32).cuda()
    distinct["valid"] = torch.ones(N_RELATIONS, dtype=torch.bool, device="cuda")
    return {
        "one relation": dict(sub, r=torch.zeros_like(sub["r"])),
        "one entity": one_entity,
        "distinct rows": distinct,
        "smaller than the grid": {key: value[:3].clone() for key, value in sub.items()},
        "all invalid": dict(sub, valid=torch.zeros_like(sub["valid"])),
    }


def describe_batch(kind: str, idx) -> str:
    if kind == "sampler":
        return (f"B={idx[0].shape[0]} (a sampler batch; {int((idx[1] == idx[0]).sum())} h == t, "
                f"{int((idx[4] == idx[3]).sum())} h' == t')")
    if kind == "skewed":
        return f"B={idx[0].shape[0]} (a sampler batch of skewed_kg{SKEWED_KG})"
    return f"B={idx[0].shape[0]} ({kind})"


def check_update_equal(what: str, idx, got, want, cap: int | None = None, m: int = 3) -> float:
    """An update's outputs (its m tables, the loss, the decisions, then K4's
    and K5's projector trips) against its plain version's, bit for bit; at a
    cap of 1 some projector call must have reached it.  Returns the largest
    table difference (0)."""
    viol, want_viol = got[m + 1].cpu(), want[m + 1].cpu()
    off = (viol != want_viol).nonzero()[:, 0].tolist()
    for i in off[:10]:
        print(f"[kernels] {what}: sample {i} {[int(x[i]) for x in idx]} decided {bool(viol[i])} on the card, "
              f"{bool(want_viol[i])} in the plain version", flush=True)
    check(not off, f"{what}: {len(off)} update decisions differ")
    check(all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got[m + 2:], want[m + 2:])),
          f"{what}: projector trips differ")
    check(float(got[m]) == float(want[m]), f"{what}: loss {float(got[m])!r} != {float(want[m])!r}")
    pairs = [(g.cpu(), w.cpu()) for g, w in zip(got[:m], want[:m])]
    rows_off = [int((g != w).reshape(g.shape[0], -1).any(dim=1).sum()) for g, w in pairs]
    check(rows_off == [0] * m, f"{what}: rows differ (entity, relation[, weights]): {rows_off}")
    if cap == 1 and bool(viol.any()):
        check(int(got[5][:, 1].sum()) > 0, f"{what}: no projector call reached the cap")
    return max(float((g - w).abs().max()) for g, w in pairs)


def transr_batches(transr, data, work: str, skewed):
    """A sampler batch of 4,831 for the TransR update (every 8th sample
    h == t, every 8th from the second h' == t'), the stress batches made
    from it and the skewed batch; and files holding the TransR-init tables
    and each batch for the plain version's processes."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.train import step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch = step.sample_batch(gen, data, EmbeddingConfig(embedding_size=K, method=1), TRAIN_BATCH)
    batch["pt"][0::8] = batch["ph"][0::8]
    batch["nt"][1::8] = batch["nh"][1::8]
    batches = {"sampler": batch, **stress_batches(batch, SEED + 6), "skewed": dict(zip(IDX_KEYS, skewed))}
    paths = {"tables": os.path.join(work, "k5_tables.npz")}
    np.savez(paths["tables"], **{key: transr[key].cpu().numpy() for key in TRANSR_KEYS})
    for kind, b in batches.items():
        paths[kind] = os.path.join(work, f"k5_{kind.replace(' ', '_')}.npz")
        np.savez(paths[kind], **{key: b[key].cpu().numpy() for key in IDX_KEYS})
    return batches, paths


def transr_plain_job(tables_path: str, batch_path: str, l1: bool, lr: float, cap: int):
    """The TransR update's plain version on the host's CPU, one thread, on
    the tables and the batch of those files; returns its outputs and its
    seconds."""
    from kb2e_tpu_torch.ops import transr_update

    torch.set_num_threads(1)
    with np.load(tables_path) as tables, np.load(batch_path) as batch:
        args = [torch.from_numpy(tables[key]) for key in TRANSR_KEYS]
        args += [torch.from_numpy(batch[key]) for key in IDX_KEYS]
    t0 = time.perf_counter()
    out = transr_update.transr_sequential_update_reference(*args, learning_rate=lr, margin=1.0, l1=l1,
                                                           max_iters=cap)
    return [x.numpy() for x in out], time.perf_counter() - t0


def transr_kernel_checks(transr, batches, plain):
    """The TransR sequential-update kernel against its plain version at FB15k
    width on TransR-init tables, bit for bit, against the CPU processes'
    results (``plain``: one future per (batch, l1, lr, cap)): the whole
    sampler batch of 4,831 at every setting, the stress batches and the
    skewed batch at the main path's (L1, K5_SETTINGS[0]).  Returns the
    inputs of the timing phase (the same tables and batches), the largest
    table difference, and the plain version's time on the sampler batch at
    the main path's setting."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import transr_update

    tables = [transr[key] for key in TRANSR_KEYS]
    worst, plain_ms = 0.0, {}
    for (kind, l1, lr, cap), future in plain.items():
        idx = [batches[kind][key] for key in IDX_KEYS]
        name = transr_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]
        kw = dict(learning_rate=lr, margin=1.0, l1=l1, max_iters=cap)
        got = [x.cpu() for x in transr_update.transr_sequential_update(*tables, *idx, **kw)]
        want, seconds = future.result()
        want = [torch.from_numpy(x) for x in want]
        plain_ms[kind, l1, lr, cap] = seconds * 1e3
        what = f"{name} lr={lr} max_iters={cap}"
        worst = max(worst, check_update_equal(what, idx, got, want, cap))
        fired, capped = (int(x) for x in got[5].sum(0))
        print(f"[kernels] {what} N={N_ENTITIES} R={N_RELATIONS} k={K} {describe_batch(kind, idx)} on TransR-init "
              f"tables: {int(got[4].sum())} updates, {fired} projector trips fired, {capped} projector calls "
              f"stopped at the cap; decisions, trips, loss ({float(got[3]):.6f}) and all three tables equal to the "
              f"plain version's (host CPU, {seconds:.1f} s, {seconds / idx[0].shape[0] * 1e3:.1f} ms a sample) "
              f"bit for bit", flush=True)
    return dict(transr_args=(*tables, *[batches["sampler"][key] for key in IDX_KEYS]), transr_worst=worst,
                transr_stress={kind: [batches[kind][key] for key in IDX_KEYS] for kind in STRESS},
                transr_plain_ms=plain_ms[("sampler", True, *K5_SETTINGS[0])])


def write_fb15k_dir(data_dir: str):
    from kb2e_tpu_torch.data import synthetic

    n = N_TRAIN + N_VALID + N_TEST
    h, t, r = synthetic.random_kg(N_ENTITIES, N_RELATIONS, n + 1_000, seed=SEED)
    check(h.shape[0] >= n, f"random_kg gave {h.shape[0]} distinct triples, need {n}")
    # Half a triple of slack so int(n * fraction) lands on the exact counts.
    split = ((N_TRAIN + 0.5) / n, (N_VALID + 0.5) / n, (N_TEST + 0.5) / n)
    synthetic.write_kg_dir(data_dir, (h[:n], t[:n], r[:n]), N_ENTITIES, N_RELATIONS, split=split, seed=SEED)


def data_phase(tables, transh, transr, work: str):
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.constants import Method
    from kb2e_tpu_torch.convert import params_to_numpy
    from kb2e_tpu_torch.io import text

    data_dir, out_dir, transh_dir, transr_dir = (os.path.join(work, name)
                                                 for name in ("data", "out", "out_transh", "out_transr"))
    write_fb15k_dir(data_dir)
    for name, params, path in (("transe", tables, out_dir), ("transh", transh, transh_dir),
                               ("transr", transr, transr_dir)):
        host, key = params_to_numpy(params), get_model(name).weights_key
        text.write_embeddings(path, Method.BERN, host["entity"], host["relation"],
                              weights=host[key] if key else None, model_name=name)
    print(f"[data] wrote the FB15k-shaped directory, k={K} TransE embeddings, k={K} TransH embeddings "
          f"(with weights.bern) and k={K} TransR embeddings (weights.bern: R·k rows of k)", flush=True)
    return data_dir, out_dir, transh_dir, transr_dir


def main_phase(work: str, data_dir: str, out_dir: str, transh_dir: str, transr_dir: str):
    results = eval_path(data_dir, out_dir)
    results.update(training_paths(work, data_dir))
    results["quality"] = quality_path(work, "transe", {"fast": QUALITY_BAND, "parity": QUALITY_BAND},
                                      "transe_update_l1", "QUALITY.md 0.439")
    results["transh_eval"] = projected_eval_path("transh", data_dir, transh_dir)
    results.update(transh_training_paths(work, data_dir))
    results["transh_quality"] = quality_path(work, "transh", {"fast": QUALITY_BAND_TRANSH, "parity": QUALITY_BAND_TRANSH},
                                             "transh_update", "QUALITY.md 0.423")
    results["transr_eval"] = projected_eval_path("transr", data_dir, transr_dir)
    results.update(transr_training_paths(work, data_dir))
    # Warm-started from the planted-KG TransE fast run above.
    seed = ["--seeddatadir", os.path.join(work, "planted_transe_fast"), "--seedmethod", "1"]
    results["transr_quality"] = quality_path(work, "transr", QUALITY_BANDS_TRANSR, "transr_update_l1",
                                             "QUALITY.md 0.499", quality_flags("0.01") + seed)
    results.update(ctransr_paths(work, data_dir))
    # The parity run warns and launches no kernel: CTransR has no parity mode.
    results["ctransr_quality"] = quality_path(work, "ctransr", QUALITY_BANDS_CTRANSR, None,
                                              "QUALITY.md 0.512", quality_flags("0.01") + seed)
    results["relation"] = relation_prediction_path(work, data_dir)
    results["loader"] = loader_path(data_dir, transr_dir)
    results.update(ptranse_paths(work, data_dir))
    results["ptranse_quality"] = quality_path(work, "ptranse", QUALITY_BANDS_PTRANSE, None, "QUALITY.md 0.435",
                                              QUALITY_FLAGS + seed + PTRANSE_FLAGS)
    results["ptranse_quality_relation"] = ptranse_quality_relation(work)
    results["mechanism"] = mechanism_path()
    return results


def eval_path(data_dir: str, out_dir: str, model_name: str = "transe"):
    """``eval_<model>`` of a one-group model (TransE, PTransE) on ``out_dir``'s
    files for ``--distance 0`` and ``1``: one rank-count launch per batch;
    the ranks again by ``rank_all`` (ranking alone), and the first N_CHECK
    queries' raw ranks against the plain version on the card."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval as eval_cli
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.io import text
    from kb2e_tpu_torch.ops import rank_count

    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    n_test = dataset.test[0].shape[0]
    check((dataset.train.num_triples, dataset.valid[0].shape[0], n_test) == (N_TRAIN, N_VALID, N_TEST),
          "split sizes differ from FB15k's")
    n_batches = -(-2 * n_test // EVAL_BATCH)
    model = get_model(model_name)
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
        metrics = eval_cli.main(argv, model_name=model_name)
        wall = time.perf_counter() - t0
        launches = all_launch_counts()
        check(launches == {name: n_batches}, f"{name}: launches {launches}, expected {{{name!r}: {n_batches}}}")
        check(metrics["num_corruptions"] == 2 * n_test, f"{metrics['num_corruptions']} corruptions ranked")
        for key in ("raw_mean_rank", "filtered_mean_rank", "raw_hits10", "filtered_hits10"):
            check(np.isfinite(metrics[key]), f"{key} is not finite")
        check(1 <= metrics["filtered_mean_rank"] <= metrics["raw_mean_rank"] <= N_ENTITIES, "mean ranks out of order")
        print(f"[main] eval_{model_name} --distance {int(distance)}: {2 * n_test} queries, {launches[name]} launches "
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
        print(f"[main] {model_name} ranking alone (rank_all on loaded data and tables, filter index and feed "
              f"included): {rank_wall:.3f} s", flush=True)
        n_off, max_off = compare(torch.from_numpy(raw[:N_CHECK]).cuda(), plain_first_ranks(params, dataset, distance),
                                 False,
                                 f"eval_{model_name} {distance.name}, first {N_CHECK} queries")
        print(f"[main] {model_name} {distance.name}: first {N_CHECK} raw ranks vs the plain version: {n_off} differ "
              f"(max {max_off})", flush=True)
        results[distance] = dict(launches=launches[name], max_off=max_off, wall=wall, rank_wall=rank_wall)
    return results


def plain_first_ranks(params, dataset, distance) -> torch.Tensor:
    """Raw ranks of a one-group model's first N_CHECK queries (corrupt-head,
    then corrupt-tail, per test triple) by the rank count's plain version on
    the card, in the harness's batches of EVAL_BATCH."""
    from kb2e_tpu_torch.ops import distances, rank_count

    th, tt, tr = (torch.from_numpy(a[: N_CHECK // 2].astype(np.int64)).cuda() for a in dataset.test)
    anchor = torch.stack([tt, th], 1).reshape(-1)
    true_idx = torch.stack([th, tt], 1).reshape(-1).to(torch.int32)
    sign = torch.tensor([-1.0, 1.0], device="cuda").repeat(N_CHECK // 2)
    queries = params["entity"][anchor] + sign[:, None] * params["relation"][tr.repeat_interleave(2)]
    e_true = distances.residual_energy(params["entity"][true_idx] - queries, distance)
    proj_t = params["entity"].T.contiguous()
    return torch.cat([
        1 + rank_count.rank_counts_reference(
            proj_t, queries[s:s + EVAL_BATCH].T.contiguous(), e_true[s:s + EVAL_BATCH],
            true_idx[s:s + EVAL_BATCH], distance)
        for s in range(0, N_CHECK, EVAL_BATCH)
    ])


def eval_launches(data_dir: str, grouped: bool) -> int:
    """Rank-count launches of one eval of ``data_dir``'s test split: one per
    batch of 256 queries, in one group, or (grouped) in one group per relation."""
    from kb2e_tpu_torch.data import triples

    rels = triples.load_dataset(data_dir, splits=("train", "valid", "test")).test[2]
    sizes = np.bincount(rels) if grouped else np.array([rels.shape[0]])
    return int(sum(-(-2 * int(n) // EVAL_BATCH) for n in sizes))


def projected_eval_path(model_name: str, data_dir: str, out_dir: str):
    """Seeded init tables of a projecting model through ``eval_<model>`` for
    both distance flags: one rank-count launch per batch of each relation's
    group; for each flag the ranks again by ``rank_all`` (ranking alone),
    and the first N_CHECK queries of the harness's group order against the
    plain rank count on the card.  TransH ignores the flag (quirk B5): both
    give the same metrics."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval as eval_cli
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.io import text
    from kb2e_tpu_torch.ops import distances, rank_count

    model = get_model(model_name)
    n_launch = eval_launches(data_dir, grouped=True)
    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    host = text.read_embeddings(out_dir, Method.BERN, N_ENTITIES, N_RELATIONS, K,
                                weights_shape=model.weights_shape(N_RELATIONS, K))
    params = {name: torch.from_numpy(host[src].astype(np.float32)).cuda()
              for name, src in (("entity", "entity"), ("relation", "relation"), (model.weights_key, "weights"))}
    th, tt, tr = (a.astype(np.int64) for a in dataset.test)
    q_rel, q_anchor = np.repeat(tr, 2), np.stack([tt, th], 1).reshape(-1)
    q_true, q_sign = np.stack([th, tt], 1).reshape(-1), np.tile(np.float32([-1.0, 1.0]), th.shape[0])
    order = np.argsort(q_rel, kind="stable")
    results = {}
    for flag in (Distance.L1, Distance.L2):
        distance = model.effective_distance(flag)
        name = rank_count.KERNEL_NAMES[distance]
        argv = ["--datadir", data_dir, "--outdir", out_dir, "--size", str(K), "--method", "1",
                "--distance", str(int(flag)), "--seed", str(SEED)]
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eval_cli.main(argv, model_name=model_name)
        wall = time.perf_counter() - t0
        launches = all_launch_counts()
        check(launches == {name: n_launch}, f"eval_{model_name}: launches {launches}, expected {{{name!r}: {n_launch}}}")
        check(m["num_corruptions"] == 2 * N_TEST, f"{m['num_corruptions']} corruptions ranked")
        check(1 <= m["filtered_mean_rank"] <= m["raw_mean_rank"] <= N_ENTITIES, "mean ranks out of order")
        print(f"[main] eval_{model_name} --distance {int(flag)}: {2 * N_TEST} queries in {N_RELATIONS} relation "
              f"groups, {launches[name]} launches of {name}, eval wall {wall:.2f} s (loading included); raw MR "
              f"{m['raw_mean_rank']:.6f} H@10 {m['raw_hits10']:.6f}, filtered MR {m['filtered_mean_rank']:.6f} "
              f"H@10 {m['filtered_hits10']:.6f}", flush=True)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, filt, sizes = harness.rank_all(model, params, dataset, EmbeddingConfig(embedding_size=K, distance=flag),
                                            device="cuda")
        rank_wall = time.perf_counter() - t0
        check(harness.metrics_from_ranks(raw, filt, sizes) == m, "a second run of the ranks gives other metrics")
        print(f"[main] {model_name} ranking alone (rank_all on loaded data and tables: filter index, feed, one "
              f"projection per relation, {len(sizes)} batches, fetch): {rank_wall:.3f} s", flush=True)
        # The harness's batches: each group padded to whole batches with query
        # 0 (relation 0, sign 0).  A short batch would sum its norms and true
        # energies in another order (torch's reduction order follows the
        # shape), and a near tie could then rank otherwise.
        plain, n_real = [], 0
        for rel in np.unique(q_rel):
            if n_real >= N_CHECK:
                break
            sel = order[q_rel[order] == rel]
            n_real += sel.shape[0]
            pad = -(-sel.shape[0] // EVAL_BATCH) * EVAL_BATCH - sel.shape[0]
            anchor, true_idx, rels = (torch.from_numpy(np.concatenate([a[sel], np.zeros(pad, np.int64)])).cuda()
                                      for a in (q_anchor, q_true, q_rel))
            sign = torch.from_numpy(np.concatenate([q_sign[sel], np.zeros(pad, np.float32)])).cuda()
            proj = model.project_entities(params, int(rel))
            proj_t = proj.T.contiguous()
            for s in range(0, anchor.shape[0], EVAL_BATCH):
                b = slice(s, s + EVAL_BATCH)
                queries = proj[anchor[b]] + sign[b, None] * params["relation"][rels[b]]
                e_true = distances.residual_energy(proj[true_idx[b]] - queries, distance)
                plain.append(1 + rank_count.rank_counts_reference(
                    proj_t, queries.T.contiguous(), e_true, true_idx[b].to(torch.int32), distance))
            plain[-1] = plain[-1][:EVAL_BATCH - pad]
        n_off, max_off = compare(torch.from_numpy(raw[:N_CHECK]).cuda(), torch.cat(plain)[:N_CHECK], False,
                                 f"{model_name} main path {distance.name}, first {N_CHECK} queries in group order")
        print(f"[main] {model_name} {distance.name}: first {N_CHECK} raw ranks in group order vs the plain version: "
              f"{n_off} differ (max {max_off})", flush=True)
        results[flag] = dict(kernel=name, launches=n_launch, max_off=max_off, wall=wall, rank_wall=rank_wall, metrics=m)
    if not model.uses_distance_flag:
        check(results[Distance.L1]["metrics"] == results[Distance.L2]["metrics"],
              f"{model_name}'s metrics depend on --distance")
    return results


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
    """bench.py's configuration through ``train_transe``: 2 fast epochs (one
    launch of each fast-batch kernel a batch), the written files scored by
    ``eval_transe``; 1 parity epoch per distance."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count, transe_update

    out = os.path.join(work, "trained_fast")
    fast, fast_launches = train_run(["--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "2"],
                                    os.path.join(work, "fast.jsonl"), fast_batch_launches("transe", 2 * N_BATCHES),
                                    "train_transe fast, 2 epochs")
    check(fast[1]["loss"] < fast[0]["loss"], "the fast loss does not fall")
    check(all(r["batch_size"] == TRAIN_BATCH for r in fast), "batch size differs from |T| / 100")
    for name in ("entity2vec.bern", "relation2vec.bern", "embedding_meta.json"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")
    n_eval = -(-2 * N_TEST // EVAL_BATCH)
    trained = eval_run(["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1", "--seed", str(SEED)],
                       {rank_count.KERNEL_NAMES[Distance.L1]: n_eval}, "eval_transe on the fast-trained files")
    results = dict(fast=fast, fast_launches=fast_launches, fast_eval=trained)
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


def transr_training_paths(work: str, data_dir: str):
    """bench.py's configuration through ``train_transr``, warm-started from
    the fast TransE run's files: 2 fast epochs, the written files scored by
    ``eval_transr``; 1 parity epoch (L1)."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import rank_count, transr_update

    seed = ["--seeddatadir", os.path.join(work, "trained_fast"), "--seedmethod", "1"]
    out = os.path.join(work, "transr_fast")
    fast, _ = train_run(["--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "2", *seed],
                        os.path.join(work, "transr_fast.jsonl"),
                        fast_batch_launches("transr", N_BATCHES, data_dir, epochs=2),
                        "train_transr fast, 2 epochs (warm start: train_transe's fast files)", model="transr")
    check(fast[1]["loss"] < fast[0]["loss"], "the TransR fast loss does not fall")
    for name in ("entity2vec.bern", "relation2vec.bern", "weights.bern", "embedding_meta.json"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")
    trained = eval_run(["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1", "--seed", str(SEED)],
                       {rank_count.KERNEL_NAMES[Distance.L1]: eval_launches(data_dir, grouped=True)},
                       "eval_transr on the fast-trained files", model="transr")
    name = transr_update.KERNEL_NAMES[Distance.L1]
    records, launches = train_run(
        ["--datadir", data_dir, "--outdir", os.path.join(work, "transr_parity"), *TRAIN_FLAGS, "--epochs", "1",
         "--update-mode", "parity", *seed],
        os.path.join(work, "transr_parity.jsonl"), {name: N_BATCHES}, "train_transr parity L1, 1 epoch (warm start)",
        model="transr",
    )
    return dict(transr_fast=fast, transr_fast_eval=trained, transr_parity=dict(launches=launches[name], records=records))


def quality_path(work: str, model: str, bands: dict, parity_kernel, reference: str, flags=QUALITY_FLAGS):
    """QUALITY.md's planted-KG setting for ``model`` in both modes, each
    scored by ``eval_<model>``; filtered Hits@10 must land in
    ``bands[mode]``.  The fast run of TransE launches its three fast-batch
    kernels once a batch each, of the other models none; the parity run
    launches ``parity_kernel`` once a batch;
    a model without a parity mode (``parity_kernel`` None: CTransR) must warn
    and launch no kernel, and a cluster-aware model's eval launches none."""
    import warnings

    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import synthetic
    from kb2e_tpu_torch.ops import rank_count

    n_ent, n_rel, n_triples, seed = QUALITY_KG
    kg = os.path.join(work, "planted")
    synthetic.write_kg_dir(kg, synthetic.planted_kg(n_ent, n_rel, n_triples, seed=seed), n_ent, n_rel, seed=seed)
    m = get_model(model)
    eval_expect = {} if m.cluster_aware else {rank_count.KERNEL_NAMES[Distance.L1]: eval_launches(kg, m.needs_projection)}
    parity_expect = {} if parity_kernel is None else {parity_kernel: QUALITY_BATCHES * QUALITY_EPOCHS}
    hits = {}
    fast_expect = (fast_batch_launches(model, QUALITY_BATCHES, kg, epochs=QUALITY_EPOCHS) if model == "transr" else
                   fast_batch_launches(model, QUALITY_BATCHES * QUALITY_EPOCHS))
    for mode, expect in (("fast", fast_expect), ("parity", parity_expect)):
        out = os.path.join(work, f"planted_{model}_{mode}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_run(["--datadir", kg, "--outdir", out, *flags, "--update-mode", mode],
                      os.path.join(work, f"planted_{model}_{mode}.jsonl"), expect,
                      f"planted KG, {model} {mode}, {QUALITY_EPOCHS} epochs", model=model)
        warned = [str(w.message) for w in caught if "--update-mode parity has no effect" in str(w.message)]
        check(len(warned) == (mode == "parity" and not m.has_parity_mode),
              f"planted KG, {model} {mode}: parity warnings {warned}")
        if warned:
            print(f"[main] planted KG, {model} parity: warned {warned[0]!r}", flush=True)
        metrics = eval_run(["--datadir", kg, "--outdir", out, "--size", str(QUALITY_SIZE), "--method", "1"],
                           eval_expect, f"planted KG, {model} {mode}: eval_{model}", model=model)
        hits[mode] = metrics["filtered_hits10"]
        check(bands[mode][0] <= hits[mode] <= bands[mode][1],
              f"planted KG, {model} {mode}: filtered Hits@10 {hits[mode]} outside {bands[mode]}")
    print(f"[main] planted KG {model} filtered Hits@10: fast {hits['fast']:.6f}, parity {hits['parity']:.6f} "
          f"(bands {bands}; {reference}, chance {10 / n_ent:.3f})", flush=True)
    return hits


def read_params(model_name: str, out_dir: str):
    """``model_name``'s tables as ``eval_<model>`` reads them from ``out_dir``, on the card."""
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.constants import Method
    from kb2e_tpu_torch.io import text

    model = get_model(model_name)
    host = text.read_embeddings(out_dir, Method.BERN, N_ENTITIES, N_RELATIONS, K,
                                weights_shape=model.weights_shape(N_RELATIONS, K))
    names = {"entity": "entity", "relation": "relation",
             **{key: name for name, key in model.file_extras.items() if name in host}}
    if model.weights_key:
        names[model.weights_key] = "weights"
    return {key: torch.from_numpy(host[name].astype(np.float32)).cuda() for key, name in names.items()}


def loader_path(data_dir: str, transr_dir: str):
    """The native triple loader on the FB15k-shaped directory against the
    Python one: it must build and load, and give the same arrays; the
    seconds of the triple parse (three splits, 592,213 rows), of
    ``load_dataset`` (the parse, the id maps, the sort and bern statistics)
    each way, and of ``io/text.py::read_matrix`` on TransR's ``weights.bern``
    (13.45M values) and on ``entity2vec.bern``: the split of an eval's
    loading."""
    from kb2e_tpu_torch.constants import Method
    from kb2e_tpu_torch.data import native, triples, vocab
    from kb2e_tpu_torch.io import text

    check(native.available(), "the native loader did not build or load (the reason is on stderr)")
    e2i, r2i = (vocab.load_id_file(os.path.join(data_dir, name)) for name in ("entity2id.txt", "relation2id.txt"))
    paths = [os.path.join(data_dir, f"{split}.txt") for split in ("train", "valid", "test")]
    parse, arrays = {}, {}
    for name, loader in (("native", native.load_triple_file), ("python", triples.load_triple_file)):
        t0 = time.perf_counter()
        arrays[name] = [loader(path, e2i, r2i) for path in paths]
        parse[name] = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for x, y in zip(arrays["native"], arrays["python"]) for a, b in zip(x, y)),
          "the native loader's arrays differ from the Python loader's")
    dataset_s = {}
    for name, use_native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        triples.load_dataset(data_dir, splits=("train", "valid", "test"), use_native=use_native)
        dataset_s[name] = time.perf_counter() - t0
    tag = Method.BERN.tag
    t0 = time.perf_counter()
    text.read_matrix(os.path.join(transr_dir, f"weights.{tag}"), N_RELATIONS * K, K)
    weights_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    text.read_matrix(os.path.join(transr_dir, f"entity2vec.{tag}"), N_ENTITIES, K)
    entity_s = time.perf_counter() - t0
    n_rows = sum(a[0].shape[0] for a in arrays["native"])
    print(f"[main] loader: {os.path.relpath(native.library_path(), ROOT)} (built at the run's first load); "
          f"triple parse of {n_rows} rows: native "
          f"{parse['native']:.3f} s, Python {parse['python']:.3f} s ({parse['python'] / parse['native']:.1f} times); "
          f"load_dataset: native {dataset_s['native']:.3f} s, Python {dataset_s['python']:.3f} s; read_matrix: "
          f"TransR weights.bern ({N_RELATIONS * K * K} values) {weights_s:.3f} s, entity2vec.bern "
          f"({N_ENTITIES * K} values) {entity_s:.3f} s", flush=True)
    return dict(parse=parse, dataset=dataset_s, weights_s=weights_s, entity_s=entity_s)


def ctransr_paths(work: str, data_dir: str):
    """bench.py's configuration through ``train_ctransr``, warm-started from
    the fast TransE run's files: 2 fast epochs with the seconds of
    ``build_centers``, the files and their extras; ``eval_ctransr`` on them
    for both distance flags with no kernel launch, each with its ranking
    alone (``rank_all``); and the routed ranks of seeded dyadic tables on
    the card against the CPU."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval as eval_cli
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness

    seed = ["--seeddatadir", os.path.join(work, "trained_fast"), "--seedmethod", "1"]
    out = os.path.join(work, "ctransr_fast")
    with timed_build_centers() as centers_s:
        fast, _ = train_run(["--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "2", *seed],
                            os.path.join(work, "ctransr_fast.jsonl"), {},
                            "train_ctransr fast, 2 epochs (warm start: train_transe's fast files)", model="ctransr")
    check(len(centers_s) == 1, f"build_centers ran {len(centers_s)} times")
    check(fast[1]["loss"] < fast[0]["loss"], "the CTransR fast loss does not fall")
    for name in ("entity2vec.bern", "relation2vec.bern", "weights.bern", "relation_clusters.bern",
                 "cluster_centers.bern", "embedding_meta.json"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")
    with open(os.path.join(out, "embedding_meta.json"), encoding="utf-8") as f:
        extras = json.load(f)["extras"]
    shape = [N_RELATIONS, get_model("ctransr").n_clusters, K]
    check(extras == {"relation_clusters": shape, "cluster_centers": shape}, f"sidecar extras {extras}")
    print(f"[main] CTransR warm start: build_centers (k-means of {N_TRAIN} seed offsets, {shape[1]} clusters for "
          f"each of {N_RELATIONS} relations, on the host) {centers_s[0]:.3f} s", flush=True)

    model = get_model("ctransr")
    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    params = read_params("ctransr", out)
    evals = {}
    for flag in (Distance.L1, Distance.L2):
        argv = ["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1",
                "--distance", str(int(flag)), "--seed", str(SEED)]
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eval_cli.main(argv, model_name="ctransr")
        wall = time.perf_counter() - t0
        launches = all_launch_counts()
        check(launches == {}, f"eval_ctransr --distance {int(flag)}: launches {launches}, expected none")
        check(m["num_corruptions"] == 2 * N_TEST, f"{m['num_corruptions']} corruptions ranked")
        check(all(np.isfinite(v) for v in m.values()), f"eval_ctransr metrics {m}")
        check(1 <= m["filtered_mean_rank"] <= m["raw_mean_rank"] <= N_ENTITIES, "mean ranks out of order")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, filt, sizes = harness.rank_all(model, params, dataset, EmbeddingConfig(embedding_size=K, distance=flag),
                                            device="cuda")
        rank_wall = time.perf_counter() - t0
        check(harness.metrics_from_ranks(raw, filt, sizes) == m, "a second run of the routed ranks gives other metrics")
        print(f"[main] eval_ctransr --distance {int(flag)} on the fast-trained files: {2 * N_TEST} queries in "
              f"{len(sizes)} batches of {N_RELATIONS} relation groups, launches {launches}, eval wall {wall:.2f} s "
              f"(loading included), ranking alone (rank_all) {rank_wall:.3f} s; raw MR {m['raw_mean_rank']:.6f} "
              f"H@10 {m['raw_hits10']:.6f}, filtered MR {m['filtered_mean_rank']:.6f} H@10 "
              f"{m['filtered_hits10']:.6f}", flush=True)
        evals[flag] = dict(wall=wall, rank_wall=rank_wall, batches=len(sizes), metrics=m)
    subset = first_relations_test(dataset)
    routed_ranks_check(model, dataset, subset)
    return dict(ctransr_fast=fast, ctransr_eval=evals, centers_s=centers_s[0], ctransr_params=params,
                ctransr_data=(dataset, subset))


def first_relations_test(dataset):
    """The test triples of the first relations, at least N_CHECK queries:
    the first groups of the harness's order."""
    th, tt, tr = dataset.test
    r_cut = int(np.searchsorted(np.cumsum(np.bincount(tr, minlength=N_RELATIONS)), N_CHECK // 2)) + 1
    sel = tr < r_cut
    return th[sel], tt[sel], tr[sel]


def dyadic_ctransr_tables():
    """Seeded dyadic CTransR tables at FB15k's width, on the host (multiples
    of 1/8: every product and sum of the projection, the routing and both
    energies is exact)."""
    from kb2e_tpu_torch import get_model

    rng = np.random.default_rng(SEED + 2)

    def dy(shape, scale):
        return torch.from_numpy(np.clip(np.round(rng.normal(size=shape) * scale) / 8, -1, 1).astype(np.float32))

    c = get_model("ctransr").n_clusters
    return dict(entity=dy((N_ENTITIES, K), 2), relation=dy((N_RELATIONS, K), 2), proj=dy((N_RELATIONS, K, K), 1),
                relation_c=dy((N_RELATIONS, c, K), 2), centers=dy((N_RELATIONS, c, K), 2))


def routed_ranks_check(model, dataset, subset):
    """``dyadic_ctransr_tables``: the routed ranks of ``subset``
    (``first_relations_test``: at least N_CHECK queries, the first groups of
    the harness's order), on the card in batches of 256 and on the CPU
    (``rank_queries_clustered`` through ``rank_all``, batches of 32), for
    each distance: equal, raw and filtered."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.eval import harness

    host = dyadic_ctransr_tables()
    r_cut = int(subset[2].max()) + 1
    for distance in (Distance.L1, Distance.L2):
        cfg = EmbeddingConfig(embedding_size=K, distance=distance)
        t0 = time.perf_counter()
        card = harness.rank_all(model, {k: v.cuda() for k, v in host.items()}, dataset, cfg, test_triples=subset,
                                device="cuda")[:2]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = harness.rank_all(model, host, dataset, cfg.replace(eval_batch_size=32), test_triples=subset,
                               device="cpu")[:2]
        cpu_s = time.perf_counter() - t0
        n_off = int(sum((a != b).sum() for a, b in zip(card, cpu)))
        check(n_off == 0, f"routed ranks {distance.name}: {n_off} of {2 * card[0].shape[0]} differ between the card "
                          "and the CPU on dyadic tables")
        print(f"[main] CTransR routed ranks {distance.name} on dyadic tables: the {card[0].shape[0]} queries of "
              f"relations 0-{r_cut - 1}, raw and filtered, equal on the card ({card_s:.2f} s) and on the CPU "
              f"({cpu_s:.2f} s)", flush=True)


def relation_prediction_path(work: str, data_dir: str):
    """``eval_<model> --task relation`` on TransE's, TransR's and CTransR's
    fast-trained FB15k-shaped files: finite metrics, no kernel launch, the
    eval's wall (loading included), the scoring alone
    (``harness.relation_ranks`` on loaded data), and the peak device memory
    of each."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval as eval_cli
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness

    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    results = {}
    for model_name, out in (("transe", "trained_fast"), ("transr", "transr_fast"), ("ctransr", "ctransr_fast")):
        out = os.path.join(work, out)
        argv = ["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1", "--seed", str(SEED),
                "--task", "relation"]
        reset_all_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = eval_cli.main(argv, model_name=model_name)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = all_launch_counts()
        check(launches == {}, f"eval_{model_name} --task relation: launches {launches}, expected none")
        check(m["num_corruptions"] == N_TEST and all(np.isfinite(v) for v in m.values()), f"relation metrics {m}")
        check(1 <= m["filtered_mean_rank"] <= m["raw_mean_rank"] <= N_RELATIONS, "relation mean ranks out of order")
        params = read_params(model_name, out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, filt, sizes = harness.relation_ranks(get_model(model_name), params, dataset,
                                                  EmbeddingConfig(embedding_size=K), device="cuda")
        score_s = time.perf_counter() - t0
        check(harness.metrics_from_ranks(raw, filt, sizes) == m, "a second run of the relation ranks differs")
        print(f"[main] eval_{model_name} --task relation: {N_TEST} triples x {N_RELATIONS} relations in "
              f"{len(sizes)} batches, launches {launches}, eval wall {wall:.2f} s (loading included), scoring alone "
              f"{score_s:.3f} s, peak device memory {peak / 2**20:.1f} MiB; raw MR {m['raw_mean_rank']:.6f} Hits@1 "
              f"{m['raw_hits1']:.6f}, filtered MR {m['filtered_mean_rank']:.6f} Hits@1 {m['filtered_hits1']:.6f}",
              flush=True)
        results[model_name] = dict(wall=wall, score_s=score_s, peak=peak, metrics=m)
    return results


def timed_path_stores(fn):
    """fn() with every ``data/paths.py::build_path_store`` call timed and the
    native extractor's calls counted; returns fn's result, [(seconds,
    store)] and the native calls."""
    from kb2e_tpu_torch.data import native_paths, paths

    build, extract = paths.build_path_store, native_paths.extract_path_arrays
    stores, native_calls = [], []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        store = build(*args, **kwargs)
        stores.append((time.perf_counter() - t0, store))
        return store

    def counted(*args, **kwargs):
        native_calls.append(1)
        return extract(*args, **kwargs)

    paths.build_path_store, native_paths.extract_path_arrays = timed, counted
    try:
        return fn(), stores, len(native_calls)
    finally:
        paths.build_path_store, native_paths.extract_path_arrays = build, extract


def describe_store(store, seconds: float) -> str:
    return (f"{store.rels.shape[0]} rows of {store.max_paths} paths of <= {store.max_len} hops in {seconds:.3f} s, "
            f"coverage {store.coverage():.4f}, {(store.rels.nbytes + store.conf.nbytes) / 2**20:.1f} MiB")


def ptranse_paths(work: str, data_dir: str):
    """bench.py's configuration through ``train_ptranse`` (ADD, 2 hops, 8
    paths), warm-started from the fast TransE run's files: the native PCRA
    store of the train split (its seconds and coverage), 2 fast epochs (no
    kernel; the loss is finite and falls; ``relation_inv.bern`` and the
    sidecar's extras are written); ``eval_ptranse`` for ``--distance 0`` and
    ``1`` through the rank count (``eval_path``); ``eval_ptranse --task
    relation`` with the test pairs' path evidence (the test store's seconds
    and coverage, the wall, the scoring alone with and without the evidence,
    the peak device memory); and on dyadic tables the ranks with evidence of
    the first N_RELATION_CHECK_BATCHES batches equal on the card and on the
    CPU."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.cli import eval as eval_cli
    from kb2e_tpu_torch.data import paths, triples
    from kb2e_tpu_torch.eval import harness

    seed = ["--seeddatadir", os.path.join(work, "trained_fast"), "--seedmethod", "1"]
    out = os.path.join(work, "ptranse_fast")
    (fast, _), stores, n_native = timed_path_stores(lambda: train_run(
        ["--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "2", *seed, *PTRANSE_FLAGS],
        os.path.join(work, "ptranse_fast.jsonl"), {},
        "train_ptranse fast, 2 epochs (warm start: train_transe's fast files)", model="ptranse"))
    check(len(stores) == 1 and n_native == 1, f"{len(stores)} path stores, {n_native} native extractions")
    store_s, store = stores[0]
    check(store.rels.shape == (N_TRAIN, 8, 2), f"path store of shape {store.rels.shape}")
    print(f"[main] PTransE train path store (native PCRA): {describe_store(store, store_s)}", flush=True)
    check(fast[1]["loss"] < fast[0]["loss"], "the PTransE fast loss does not fall")
    for name in ("entity2vec.bern", "relation2vec.bern", "relation_inv.bern", "embedding_meta.json"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")
    with open(os.path.join(out, "embedding_meta.json"), encoding="utf-8") as f:
        extras = json.load(f)["extras"]
    check(extras == {"relation_inv": [N_RELATIONS, K]}, f"sidecar extras {extras}")
    evals = eval_path(data_dir, out, "ptranse")

    model = get_model("ptranse")
    argv = ["--datadir", data_dir, "--outdir", out, "--size", str(K), "--method", "1", "--seed", str(SEED),
            "--task", "relation", *PTRANSE_FLAGS]
    reset_all_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m, test_stores, n_native = timed_path_stores(lambda: eval_cli.main(argv, model_name="ptranse"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = all_launch_counts()
    check(launches == {}, f"eval_ptranse --task relation: launches {launches}, expected none")
    check(len(test_stores) == 1 and n_native == 1, f"{len(test_stores)} test stores, {n_native} native extractions")
    test_s, test_store = test_stores[0]
    check(m["num_corruptions"] == N_TEST and all(np.isfinite(v) for v in m.values()), f"relation metrics {m}")
    check(1 <= m["filtered_mean_rank"] <= m["raw_mean_rank"] <= N_RELATIONS, "relation mean ranks out of order")
    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    params = read_params("ptranse", out)
    cfg = EmbeddingConfig(embedding_size=K)
    score = {}
    for evidence in (test_store, None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ranks = harness.relation_ranks(model, params, dataset, cfg, path_store=evidence, device="cuda")
        score[evidence is not None] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated(), ranks)
    check(harness.metrics_from_ranks(*score[True][2]) == m, "a second run of the relation ranks with evidence differs")
    plain = harness.metrics_from_ranks(*score[False][2])
    print(f"[main] eval_ptranse --task relation with path evidence: {N_TEST} triples x {N_RELATIONS} relations in "
          f"{len(score[True][2][2])} batches, launches {launches}; test store over the train graph: "
          f"{describe_store(test_store, test_s)}; eval wall {wall:.2f} s (loading and the store included), peak "
          f"device memory {peak / 2**20:.1f} MiB; scoring alone {score[True][0]:.3f} s with the evidence (peak "
          f"{score[True][1] / 2**20:.1f} MiB), {score[False][0]:.3f} s without (peak {score[False][1] / 2**20:.1f} "
          f"MiB); raw MR {m['raw_mean_rank']:.6f} Hits@1 {m['raw_hits1']:.6f}, filtered MR "
          f"{m['filtered_mean_rank']:.6f} Hits@1 {m['filtered_hits1']:.6f} Hits@10 {m['filtered_hits10']:.6f} "
          f"(without the evidence: filtered MR {plain['filtered_mean_rank']:.6f} Hits@10 "
          f"{plain['filtered_hits10']:.6f})", flush=True)
    relation_evidence_check(model, dataset, test_store)
    return dict(ptranse_fast=fast, ptranse_store=(store_s, store), ptranse_eval=evals,
                ptranse_relation=dict(wall=wall, peak=peak, test_s=test_s, test_store=test_store,
                                      score_s=score[True][0], score_peak=score[True][1], plain_s=score[False][0],
                                      metrics=m),
                ptranse_params=params)


def relation_evidence_check(model, dataset, test_store):
    """Seeded dyadic PTransE tables at FB15k's width, and the test store's
    confidences rounded to multiples of 1/64: every energy, composition and
    evidence term is exact in float32.  The ranks with evidence of the first
    N_RELATION_CHECK_BATCHES batches of test triples are equal on the card
    (batches of 256) and on the CPU (batches of 32), raw and filtered, for
    ADD and MUL."""
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.data import paths
    from kb2e_tpu_torch.eval import harness

    rng = np.random.default_rng(SEED + 3)
    host = {name: torch.from_numpy(np.clip(np.round(rng.normal(size=(n, K)) * 2) / 8, -1, 1).astype(np.float32))
            for name, n in (("entity", N_ENTITIES), ("relation", N_RELATIONS), ("relation_inv", N_RELATIONS))}
    n = N_RELATION_CHECK_BATCHES * EVAL_BATCH
    subset = tuple(a[:n] for a in dataset.test)
    store = paths.PathStore(rels=test_store.rels[:n], conf=(np.round(test_store.conf[:n] * 64) / 64).astype(np.float32))
    for comp in ("add", "mul"):
        cfg = EmbeddingConfig(embedding_size=K, path_composition=comp)
        t0 = time.perf_counter()
        card = harness.relation_ranks(model, {k: v.cuda() for k, v in host.items()}, dataset, cfg,
                                      test_triples=subset, path_store=store, device="cuda")[:2]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = harness.relation_ranks(model, host, dataset, cfg.replace(eval_batch_size=32), test_triples=subset,
                                     path_store=store, device="cpu")[:2]
        cpu_s = time.perf_counter() - t0
        n_off = int(sum((a != b).sum() for a, b in zip(card, cpu)))
        check(n_off == 0, f"relation ranks with evidence ({comp}): {n_off} of {2 * n} differ between the card and "
                          "the CPU on dyadic tables")
        print(f"[main] PTransE relation ranks with path evidence ({comp}) on dyadic tables: the first {n} test "
              f"triples, raw and filtered, equal on the card ({card_s:.2f} s) and on the CPU ({cpu_s:.2f} s)",
              flush=True)


def ptranse_quality_relation(work: str):
    """QUALITY.md's PTransE relation-prediction row: ``eval_ptranse --task
    relation`` with path evidence on the planted-KG PTransE fast run's files;
    filtered Hits@10 must land in QUALITY_BAND_PTRANSE_RELATION."""
    kg, out = os.path.join(work, "planted"), os.path.join(work, "planted_ptranse_fast")
    metrics = eval_run(["--datadir", kg, "--outdir", out, "--size", str(QUALITY_SIZE), "--method", "1", "--task",
                        "relation", *PTRANSE_FLAGS], {}, "planted KG, ptranse fast: eval_ptranse --task relation",
                       model="ptranse")
    hits = metrics["filtered_hits10"]
    check(QUALITY_BAND_PTRANSE_RELATION[0] <= hits <= QUALITY_BAND_PTRANSE_RELATION[1],
          f"planted KG, ptranse relation prediction: filtered Hits@10 {hits} outside {QUALITY_BAND_PTRANSE_RELATION}")
    print(f"[main] planted KG ptranse relation prediction with path evidence: filtered Hits@10 {hits:.6f}, filtered "
          f"MR {metrics['filtered_mean_rank']:.6f} (band {QUALITY_BAND_PTRANSE_RELATION}; QUALITY.md 0.611)",
          flush=True)
    return hits


def mechanism_path():
    """benchmarks/ptranse_composition.py's evidence-only ADD cell on the card,
    once for each of MECHANISM_SEEDS: ``compositional_kg(seed=0)``, its train
    and test-pair stores of 16 paths, PTransE trained with path weight 0 (k
    32, 60 epochs, lr 0.01, 20 batches, bern, L1; no kernel), then relation
    prediction without and with the path evidence.  The mean Hits@10 with it
    must land in MECHANISM_BAND, the mean gain be at least
    MECHANISM_MIN_GAIN, and every seed gain."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.data import paths, synthetic, triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.train import loop

    t0 = time.perf_counter()
    kg = synthetic.compositional_kg(seed=0)
    th, tt, tr = kg.train
    ts = triples.TripleSet.from_arrays(th, tt, tr, n_entities=kg.n_entities, n_relations=kg.n_relations)
    ds = triples.Dataset(entity2id={str(i): i for i in range(kg.n_entities)},
                         relation2id={str(i): i for i in range(kg.n_relations)}, train=ts, valid=kg.valid,
                         test=kg.test)
    kw = dict(max_paths=16, use_native="auto", n_entities=kg.n_entities)
    train_store = paths.build_path_store(th, tt, tr, kg.n_relations, **kw)
    eval_store = paths.build_path_store(th, tt, tr, kg.n_relations, query_pairs=(kg.test[0], kg.test[1]), **kw)
    print(f"[main] PTransE mechanism: compositional_kg(seed=0), {th.shape[0]} train / {kg.test[0].shape[0]} test "
          f"triples, stores of 16 paths with coverage {train_store.coverage():.3f} / {eval_store.coverage():.3f}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for seed in MECHANISM_SEEDS:
        cfg = EmbeddingConfig(embedding_size=32, learning_rate=0.01, margin=1.0, method=Method.BERN, num_batches=20,
                              max_epochs=60, distance=Distance.L1, seed=seed, path_composition="add", path_weight=0.0)
        records = []
        reset_all_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the loop's 60 epoch lines
            params = loop.train(get_model("ptranse"), cfg, ts, path_store=train_store, metrics_fn=records.append,
                                device="cuda")
        train_s = time.perf_counter() - t0
        check(all_launch_counts() == {}, f"PTransE training launched {all_launch_counts()}")
        check(all(np.isfinite(r["loss"]) for r in records) and records[-1]["loss"] < records[0]["loss"],
              f"the mechanism run's loss does not fall (seed {seed})")
        hits = [harness.evaluate_relation_prediction(get_model("ptranse"), params, ds, cfg, path_store=evidence,
                                                     device="cuda")["filtered_hits10"]
                for evidence in (None, eval_store)]
        runs.append(hits)
        print(f"[main] PTransE mechanism, seed {seed} (path weight 0, 60 epochs in {train_s:.1f} s): relation "
              f"prediction filtered Hits@10 {hits[0]:.6f} without the path evidence, {hits[1]:.6f} with it, gain "
              f"{hits[1] - hits[0]:.6f}", flush=True)
    without, with_evidence = np.mean(runs, axis=0)
    gain = with_evidence - without
    print(f"[main] PTransE mechanism, mean of seeds {MECHANISM_SEEDS}: filtered Hits@10 {without:.6f} without the "
          f"path evidence, {with_evidence:.6f} with it, gain {gain:.6f} (band {MECHANISM_BAND}, gain at least "
          f"{MECHANISM_MIN_GAIN}; PTRANSE_COMP_r05.json, seed 11: 0.6645 and 0.7802)", flush=True)
    check(MECHANISM_BAND[0] <= with_evidence <= MECHANISM_BAND[1],
          f"mean Hits@10 with evidence {with_evidence} outside {MECHANISM_BAND}")
    check(gain >= MECHANISM_MIN_GAIN, f"the path evidence gains {gain} on the mean, below {MECHANISM_MIN_GAIN}")
    check(all(b > a for a, b in runs), f"the path evidence does not help at every seed: {runs}")
    return dict(runs=runs, without=without, with_evidence=with_evidence)


# --- the scale-quality protocol ------------------------------------------------------
# benchmarks/quality_fb15k_scale.py's protocol on the port (its record:
# QUALITY_SCALE_r05.json, QUALITY.md:200-225): planted_kg(14,951, 1,345,
# 483,142, seed=11), cut in order (synthetic.split_in_order: 5 % test, as
# many valid, the rest train), k 100, bern, L1, 100 batches, 40 epochs, seed
# 5, each model through ``cli.train_<model>`` and ``cli.eval_<model>``.
SCALE_KG = (N_ENTITIES, N_RELATIONS, N_TRAIN, 11)
SCALE_EPOCHS = 40
SCALE_FLAGS = ["--size", str(K), "--margin", "1", "--method", "1", "--batches", str(N_BATCHES), "--epochs",
               str(SCALE_EPOCHS), "--seed", "5", "--distance", "0"]
# (cell, model, negatives, learning rate, warm-started from the first cell's
# files, the record's filtered MR, Hits@10 and MRR), in the record's order.
SCALE_CELLS = (
    ("TransE K=1", "transe", 1, "0.02", False, 671.99, 0.202, 0.1537),
    ("TransE K=8", "transe", 8, "0.0025", False, 97.64, 0.4505, 0.2278),
    ("TransH K=8", "transh", 8, "0.0025", False, 83.43, 0.454, 0.23),
    ("TransR K=8", "transr", 8, "0.00125", True, 74.53, 0.4354, 0.2256),
    ("CTransR K=8", "ctransr", 8, "0.00125", True, 94.31, 0.4108, 0.2181),
)
# The default smoke runs the first three cells; TransR's and CTransR's take
# 18-23 minutes each (``--quality-scale``).
DEFAULT_SCALE_MODELS = ("transe", "transh")
# Bands (PERF.md, written before the first run on the card): filtered Hits@10
# within SCALE_HITS_TOL of the record and filtered MR within SCALE_MR_RTOL of
# it; and the two findings QUALITY.md:218-222 carries to full scale: K = 8
# lifts TransE's filtered Hits@10 by at least SCALE_K_GAIN, and filtered MR
# orders TransR < TransH < TransE K = 8.
SCALE_HITS_TOL, SCALE_MR_RTOL, SCALE_K_GAIN = 0.03, 0.15, 0.2


def scale_graph(work: str) -> str:
    """The protocol's graph, generated on the host, cut in order and written
    once into ``work/planted_scale``; returns that directory."""
    from kb2e_tpu_torch.data import synthetic

    n_ent, n_rel, n_triples, seed = SCALE_KG
    t0 = time.perf_counter()
    triples = synthetic.planted_kg(n_ent, n_rel, n_triples, seed=seed)
    gen_s = time.perf_counter() - t0
    train, valid, test = synthetic.split_in_order(triples)
    kg = os.path.join(work, "planted_scale")
    t0 = time.perf_counter()
    synthetic.write_split_dir(kg, train, valid, test, n_ent, n_rel)
    print(f"[scale] planted_kg{SCALE_KG}: {triples[0].shape[0]} distinct triples, {train[0].shape[0]} train / "
          f"{valid[0].shape[0]} valid / {test[0].shape[0]} test; generated on the host in {gen_s:.1f} s, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return kg


@contextlib.contextmanager
def timed_build_centers():
    """Times every ``models/ctransr.py::build_centers`` call inside the block;
    yields the list of their seconds."""
    from kb2e_tpu_torch.models import ctransr

    build, seconds = ctransr.build_centers, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        centers = build(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return centers

    ctransr.build_centers = timed
    try:
        yield seconds
    finally:
        ctransr.build_centers = build


def scale_cell(work: str, kg: str, card: str, cell) -> dict:
    """One cell of SCALE_CELLS: ``train_<model>`` (TransE: its fast-batch
    kernels once a batch each; the other models no kernel launch), then
    ``eval_<model>`` on the written files (one K1 launch per batch of each
    group, none for CTransR).  For TransE at K = 8, K1's counts of the first
    N_CHECK queries on the trained tables against its plain version."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.ops import rank_count

    what, model_name, k_neg, rate, warm, *ref = cell
    model, kernel = get_model(model_name), rank_count.KERNEL_NAMES[Distance.L1]
    out = os.path.join(work, f"scale_{model_name}_k{k_neg}")
    argv = ["--datadir", kg, "--outdir", out, *SCALE_FLAGS, "--negatives", str(k_neg), "--rate", rate]
    if warm:
        argv += ["--seeddatadir", os.path.join(work, "scale_transe_k1"), "--seedmethod", "1"]
    expect = (fast_batch_launches(model_name, N_BATCHES, kg, epochs=SCALE_EPOCHS, k_neg=k_neg)
              if model_name == "transr" else fast_batch_launches(model_name, SCALE_EPOCHS * N_BATCHES))
    t0 = time.perf_counter()
    with timed_build_centers() as centers_s:
        records, _ = train_run(argv, os.path.join(work, f"scale_{model_name}_k{k_neg}.jsonl"), expect,
                               f"scale {what}, {SCALE_EPOCHS} epochs", model=model_name)
    train_s = time.perf_counter() - t0
    check(len(records) == SCALE_EPOCHS, f"scale {what}: {len(records)} epochs")
    check(records[-1]["loss"] < records[0]["loss"], f"scale {what}: the loss does not fall")
    n_launch = None if model.cluster_aware else eval_launches(kg, grouped=model.needs_projection)
    t0 = time.perf_counter()
    m = eval_run(["--datadir", kg, "--outdir", out, "--size", str(K), "--method", "1", "--seed", "5"],
                 {} if n_launch is None else {kernel: n_launch}, f"scale {what}: eval_{model_name}", model=model_name)
    eval_s = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in m.values()), f"scale {what}: metrics {m}")
    result = dict(kernel=None if n_launch is None else kernel, launches=n_launch or 0, max_off=None, metrics=m,
                  train_s=train_s, eval_s=eval_s, epoch_s=sum(r["wall_s"] for r in records))
    check_line = ""
    if model_name == "transe" and k_neg == 8:
        # K1 on a trained table at full width: the harness's first N_CHECK
        # raw ranks against the plain version, on the tables eval_transe read.
        dataset = triples.load_dataset(kg, splits=("train", "valid", "test"))
        params = read_params(model_name, out)
        raw, filt, sizes = harness.rank_all(model, params, dataset, EmbeddingConfig(embedding_size=K), device="cuda")
        check(harness.metrics_from_ranks(raw, filt, sizes) == m, f"scale {what}: a second run gives other metrics")
        n_off, result["max_off"] = compare(torch.from_numpy(raw[:N_CHECK]).cuda(),
                                           plain_first_ranks(params, dataset, Distance.L1), True,
                                           f"scale {what}: first {N_CHECK} ranks on the trained tables")
        check_line = (f"; K1 on the trained tables: the first {N_CHECK} raw ranks equal the plain version's "
                      f"({n_off} differ)")
    ref_mr, ref_hits, ref_mrr = ref
    print(f"[scale] {card}: {what}, lr {rate}{', warm-started from TransE K=1' if warm else ''}: "
          f"{m['num_corruptions']} queries; filtered MR {m['filtered_mean_rank']:.2f} (record {ref_mr}), "
          f"Hits@10 {m['filtered_hits10']:.4f} (record {ref_hits}), MRR {m['filtered_mrr']:.4f} (record {ref_mrr}), "
          f"raw MR {m['raw_mean_rank']:.2f}; train wall {train_s:.1f} s (loading and the cuckoo build included; "
          f"epochs {result['epoch_s']:.1f} s"
          + (f"; build_centers {centers_s[0]:.1f} s" if centers_s else "")
          + f"), eval wall {eval_s:.1f} s; "
          + ("no kernel launch (the routed sweep)" if n_launch is None
             else f"{n_launch} launches of {kernel}, one a batch of each group (eval_launches)")
          + check_line, flush=True)
    return result


def scale_bands(results: dict) -> list:
    """Each finished cell against its band and the cross-cell findings;
    returns the misses."""
    bad = []
    for what, _, _, _, _, ref_mr, ref_hits, _ in SCALE_CELLS:
        if what not in results:
            continue
        m = results[what]["metrics"]
        if abs(m["filtered_hits10"] - ref_hits) > SCALE_HITS_TOL:
            bad.append(f"{what}: filtered Hits@10 {m['filtered_hits10']:.4f} outside {ref_hits} +- {SCALE_HITS_TOL}")
        if abs(m["filtered_mean_rank"] - ref_mr) > SCALE_MR_RTOL * ref_mr:
            bad.append(f"{what}: filtered MR {m['filtered_mean_rank']:.2f} outside {ref_mr} +- {SCALE_MR_RTOL:.0%}")
    (k1, *_, k1_hits, _), (k8, *_, k8_hits, _) = SCALE_CELLS[:2]
    if k1 in results and k8 in results:
        gain = results[k8]["metrics"]["filtered_hits10"] - results[k1]["metrics"]["filtered_hits10"]
        print(f"[scale] K = 8 lifts TransE's filtered Hits@10 by {gain:.4f} (at least {SCALE_K_GAIN}; record "
              f"{k8_hits - k1_hits:.4f})", flush=True)
        if gain < SCALE_K_GAIN:
            bad.append(f"K = 8 lifts TransE's filtered Hits@10 by {gain:.4f}, below {SCALE_K_GAIN}")
    order = [what for what in ("TransR K=8", "TransH K=8", "TransE K=8") if what in results]
    mrs = [results[what]["metrics"]["filtered_mean_rank"] for what in order]
    if len(order) > 1:
        print("[scale] filtered MR by model, the record's order: " + ", ".join(
            f"{w} {r:.2f}" for w, r in zip(order, mrs)) + (" (increasing)" if mrs == sorted(mrs) else
                                                           " (NOT increasing)"), flush=True)
        if mrs != sorted(mrs):
            bad.append(f"filtered MR out of the record's order: {dict(zip(order, mrs))}")
    return bad


def quality_scale_path(work: str, models=None) -> dict:
    """The cells of SCALE_CELLS whose model is in ``models`` (all when None),
    with the first cell too when a warm-started one runs, then the bands."""
    card = card_line()
    kg = scale_graph(work)
    picked = [c for c in SCALE_CELLS if models is None or c[1] in models]
    if any(c[4] for c in picked) and SCALE_CELLS[0] not in picked:
        picked.insert(0, SCALE_CELLS[0])
    results = {c[0]: scale_cell(work, kg, card, c) for c in picked}
    bad = scale_bands(results)
    check(not bad, "\n".join(bad))
    print(f"[scale] {card}: {len(results)} cells inside their bands", flush=True)
    return results


# --- the distributed phase ---------------------------------------------------------
# Two ranks on the one card: NCCL refuses two ranks on one device, so parts
# (a) and (b) run gloo over CUDA tensors (every collective staged through the
# host); part (c) runs the production driver alone, over NCCL.
DIST_WORLD = 2
DIST_DEADLINE_S = 300  # a part's processes are killed after this
# Part (a): (what, model, tables, distance, subset) of each sharded eval.
# Tables: the data phase's files ("out", "out_transr": W = I), the TransR
# files with a seeded non-dyadic W ("transr W"), seeded dyadic CTransR tables
# ("ctransr") and seeded non-dyadic ones ("ctransr non-dyadic": the shard's
# u = e·ce and L2's q·e products round); subset: the test triples of the
# first relations (first_relations_test), else all.
DIST_EVALS = (("eval_transe L1", "transe", "out", 0, False), ("eval_transe L2", "transe", "out", 1, False),
              ("eval_transr L1", "transr", "out_transr", 0, False),
              ("eval_transr L2", "transr", "out_transr", 1, False),
              ("eval_transr L1, non-dyadic W", "transr", "transr W", 0, True),
              ("eval_transr L2, non-dyadic W", "transr", "transr W", 1, True),
              ("eval_ctransr L1", "ctransr", "ctransr", 0, True), ("eval_ctransr L2", "ctransr", "ctransr", 1, True),
              ("eval_ctransr L1, non-dyadic", "ctransr", "ctransr non-dyadic", 0, True),
              ("eval_ctransr L2, non-dyadic", "ctransr", "ctransr non-dyadic", 1, True))
DIST_ATOL, DIST_LOSS_RTOL = 2e-6, 1e-5  # tests/test_parallel.py:73-78
# Part (b): (model, mesh (data, model), batches after the first) of each run
# from seeded init tables at bench.py's configuration (the batch rounded down
# to the data axis) against the one-rank runner: TransE, TransH and PTransE
# (with the train split's path store, whose gradients go through the dense
# ``summed`` hook of ops/scatter.py) data-parallel for a whole epoch, and
# TransH with its entity rows cut for three batches.
DP_RUNS = (("transe", (2, 1), N_BATCHES - 1), ("transh", (2, 1), N_BATCHES - 1), ("transh", (1, 2), 2),
           ("ptranse", (2, 1), N_BATCHES - 1))
# Part (b): the models whose per-relation tables are cut over ``model``,
# trained at mesh (1, 2) for the first chunk, then the next ones up to
# CUT_CHUNKS (256 samples each: some 3 of bench.py's batches).
CUT_MODELS = ("transr", "ctransr")
CUT_CHUNKS = 57


def dist_tables(model_name: str, source: str, work: str):
    """Part (a)'s whole tables from ``source`` (DIST_EVALS), on the card, the
    same in every process."""
    from kb2e_tpu_torch import get_model

    if source == "ctransr":
        return {k: v.cuda() for k, v in dyadic_ctransr_tables().items()}
    if source == "ctransr non-dyadic":
        rng = np.random.default_rng(SEED + 6)
        c = get_model("ctransr").n_clusters
        shapes = dict(entity=(N_ENTITIES, K), relation=(N_RELATIONS, K), proj=(N_RELATIONS, K, K),
                      relation_c=(N_RELATIONS, c, K), centers=(N_RELATIONS, c, K))
        return {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) / 10).cuda()
                for k, shape in shapes.items()}
    if source in ("out", "out_transr"):
        return read_params(model_name, os.path.join(work, source))
    params = read_params("transr", os.path.join(work, "out_transr"))
    w = np.random.default_rng(SEED + 5).standard_normal((N_RELATIONS, K, K), dtype=np.float32) / 10
    return {**params, "proj": torch.from_numpy(w).cuda()}


def dist_data(data_dir: str, dev):
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.train import step

    ts = triples.load_dataset(data_dir, splits=("train",)).train
    return ts, step.DeviceData.from_triple_set(ts, dev)


def dist_cfg():
    from kb2e_tpu_torch import EmbeddingConfig
    from kb2e_tpu_torch.constants import Distance, Method

    return EmbeddingConfig(embedding_size=K, learning_rate=0.001, margin=1.0, method=Method.BERN,
                           distance=Distance.L1, num_batches=N_BATCHES, seed=SEED)


def write_dist_paths(work: str, ts) -> float:
    """PTransE's PCRA store of the train split (``cli/train.py``'s settings),
    built once and written to ``work/dist_paths.npz`` for every process;
    returns its seconds."""
    from kb2e_tpu_torch.data import paths

    cfg = dist_cfg()
    t0 = time.perf_counter()
    store = paths.build_path_store(ts.heads, ts.tails, ts.rels, ts.n_relations, max_len=cfg.path_length,
                                   min_conf=cfg.path_min_conf, max_paths=cfg.max_paths, max_branch=cfg.path_max_branch)
    np.savez(os.path.join(work, "dist_paths.npz"), rels=store.rels, conf=store.conf)
    return time.perf_counter() - t0


def with_dist_paths(data, work: str, dev):
    """``data`` with ``write_dist_paths``' store, one row per train triple."""
    import dataclasses

    store = np.load(os.path.join(work, "dist_paths.npz"))
    return dataclasses.replace(data, paths=torch.from_numpy(store["rels"]).to(dev),
                               path_conf=torch.from_numpy(store["conf"]).to(dev))


def batch_by_batch(model, params, batches, cfg):
    """``model.batch_update`` over [n, rows] batches (or chunks) in turn, as
    one rank: what the distributed step's ``batch_update`` calls are held to.
    Returns (params, the summed loss)."""
    losses = []
    for i in range(next(iter(batches.values())).shape[0]):
        params, loss = model.batch_update(params, {k: v[i] for k, v in batches.items()}, cfg)
        losses.append(loss)
    return params, torch.stack(losses).sum()


def dist_inputs(model_name: str, shape, data, dev):
    """Part (b)'s inputs of a DP_RUNS run, the same in every process:
    bench.py's configuration with the batch rounded down to the data axis,
    seeded init tables, and the epoch's 100 batches drawn on the card."""
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.train import step

    cfg = dist_cfg()
    batch = TRAIN_BATCH - TRAIN_BATCH % shape[0]
    model = get_model(model_name)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED), N_ENTITIES, N_RELATIONS, cfg, dev)
    runner = step.EpochRunner(model, cfg, batch, N_BATCHES)
    return model, cfg, batch, params, runner.sample(torch.Generator(device=dev).manual_seed(SEED + 1), data)


def write_cut_inputs(work: str, ts):
    """Part (b)'s TransR and CTransR tables, warm-started as their smoke
    paths are (``cli/train.py::_maybe_warm_start`` from the data phase's
    TransE files; CTransR's centers by ``build_centers``), written once to
    ``work/dist_<model>.npz`` for every process; returns build_centers'
    seconds."""
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.cli import train as train_cli

    cfg = dist_cfg().replace(seed_data_dir=os.path.join(work, "out"), seed_method=1)
    seconds = {}
    for model_name in CUT_MODELS:
        t0 = time.perf_counter()
        params = train_cli._maybe_warm_start(get_model(model_name), cfg, ts, torch.device("cuda"))
        seconds[model_name] = time.perf_counter() - t0
        np.savez(os.path.join(work, f"dist_{model_name}.npz"), **{k: v.cpu().numpy() for k, v in params.items()})
    return seconds


def cut_inputs(model_name: str, work: str, data, dev):
    """(model, params, the first CUT_CHUNKS chunks) of a CUT_MODELS run, the
    same in every process: ``write_cut_inputs``' tables and the chunked
    epoch drawn on the card."""
    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.train import step

    model = get_model(model_name)
    params = {k: torch.from_numpy(v).to(dev) for k, v in np.load(os.path.join(work, f"dist_{model_name}.npz")).items()}
    runner = step.EpochRunner(model, dist_cfg(), TRAIN_BATCH, N_BATCHES)
    chunks = runner.sample(torch.Generator(device=dev).manual_seed(SEED + 1), data)
    return model, params, {k: v[:CUT_CHUNKS] for k, v in chunks.items()}


def dist_rank(part: str, rank: int, port: int, work: str) -> None:
    """One rank of part ``part`` ('eval' or 'train'), in its own process on
    cuda:0 over gloo; pickles what it got to ``work/<part>.rank<r>``."""
    import pickle

    import torch.distributed as dist

    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.ops import rank_count
    from kb2e_tpu_torch.parallel import mesh as mesh_lib
    from kb2e_tpu_torch.parallel import multihost, sharding
    from kb2e_tpu_torch.train import step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(f"localhost:{port}", DIST_WORLD, rank, backend="gloo", device=dev)
    got = {}
    if part == "eval":
        mesh = mesh_lib.make_mesh(1, DIST_WORLD, device=dev)
        dataset = triples.load_dataset(os.path.join(work, "data"), splits=("train", "valid", "test"))
        subset = first_relations_test(dataset)
        counts, kept = rank_count.rank_counts, []

        def keeping_counts(*args, **kwargs):
            # The shard's inputs and counts of the first launches, for the
            # plain version after the timed run.
            out = counts(*args, **kwargs)
            if len(kept) < N_CHECK // EVAL_BATCH:
                kept.append(([a.clone() if torch.is_tensor(a) else a for a in args],
                             {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()}, out.clone()))
            return out

        rank_count.rank_counts = keeping_counts
        try:
            for what, model_name, source, flag, on_subset in DIST_EVALS:
                # Placed: this rank's entity rows and relations of the cut tables.
                params = sharding.place_params(mesh, dist_tables(model_name, source, work))
                cfg = EmbeddingConfig(embedding_size=K, distance=Distance(flag))
                kept.clear()
                reset_all_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                raw, filt, sizes = harness.rank_all(get_model(model_name), params, dataset, cfg, mesh=mesh,
                                                    test_triples=subset if on_subset else None)
                wall = time.perf_counter() - t0
                launches = all_launch_counts()
                ev = dict(raw=raw, filt=filt, sizes=sizes, launches=launches, wall=wall,
                          rows=mesh.entity_rows(N_ENTITIES), relations=mesh.relation_rows(N_RELATIONS),
                          held={k: params[k].nbytes for k in sharding.RELATION_KEYS if k in params})
                if kept:
                    # K1/K2 against the plain version on this rank's inputs:
                    # its shard of the table, its ‖e‖², the true index shifted
                    # by -row0 (negative or past the shard where another rank
                    # owns the true entity).
                    true_idx = torch.cat([args[3] for args, _, _ in kept])
                    n_local = kept[0][0][0].shape[1]
                    ev.update(kernel=torch.cat([out for _, _, out in kept]).cpu().numpy(),
                              plain=torch.cat([rank_count.rank_counts_reference(*args, **kwargs)
                                               for args, kwargs, _ in kept]).cpu().numpy(),
                              outside=int(((true_idx < 0) | (true_idx >= n_local)).sum()))
                got[what] = ev
        finally:
            rank_count.rank_counts = counts
    else:
        _, data = dist_data(os.path.join(work, "data"), dev)
        path_data = with_dist_paths(data, work, dev)
        for model_name, shape, rest in DP_RUNS:
            mesh = mesh_lib.make_mesh(*shape, device=dev)
            model, cfg, batch, params, batches = dist_inputs(model_name, shape,
                                                             path_data if model_name == "ptranse" else data, dev)
            runner = step.EpochRunner(model, cfg, batch, N_BATCHES, mesh=mesh)
            params = sharding.place_params(mesh, params)
            walls = []
            for sl in (slice(0, 1), slice(1, 1 + rest)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, loss = runner.apply(params, {k: v[sl] for k, v in batches.items()}, N_ENTITIES)
                got[model_name, shape, sl.start] = ({k: v.cpu().numpy() for k, v in params.items()}, float(loss))
                walls.append(time.perf_counter() - t0)
            got[model_name, shape, "walls"] = walls
            got[model_name, shape, "cut"] = dict(rows=mesh.entity_rows(N_ENTITIES),
                                                 relations=mesh.relation_rows(N_RELATIONS))
        # TransR and CTransR at mesh (1, 2): entity rows and the per-relation
        # tables cut; each rank keeps its cut of the tables it returns.
        mesh = mesh_lib.make_mesh(1, DIST_WORLD, device=dev)
        for model_name in CUT_MODELS:
            model, params, chunks = cut_inputs(model_name, work, data, dev)
            runner = step.EpochRunner(model, dist_cfg(), TRAIN_BATCH, N_BATCHES, mesh=mesh)
            params = sharding.place_params(mesh, params)
            walls = []
            for sl in (slice(0, 1), slice(1, None)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, loss = runner.apply(params, {k: v[sl] for k, v in chunks.items()}, N_ENTITIES)
                got[model_name, sl.start] = ({k: v.cpu().numpy() for k, v in params.items()}, float(loss))
                walls.append(time.perf_counter() - t0)
            got[model_name, "walls"] = walls
            got[model_name, "cut"] = dict(rows=mesh.entity_rows(N_ENTITIES), relations=mesh.relation_rows(N_RELATIONS),
                                          held=params["proj"].nbytes)
    with open(os.path.join(work, f"{part}.rank{rank}"), "wb") as f:
        pickle.dump(got, f)
    multihost.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(cmds, work: str, tag: str):
    """Start ``cmds`` together, each logging to ``work/<tag>.<i>.log``; wait
    for all until DIST_DEADLINE_S, kill any left; fail unless every one exits 0."""
    logs = [open(os.path.join(work, f"{tag}.{i}.log"), "w") for i in range(len(cmds))]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT) for cmd, log in zip(cmds, logs)]
    deadline = time.monotonic() + DIST_DEADLINE_S
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    texts = [open(os.path.join(work, f"{tag}.{i}.log")).read() for i in range(len(cmds))]
    check(rcs == [0] * len(cmds), f"{tag}: exit codes {rcs} (None: killed at {DIST_DEADLINE_S} s)\n"
          + "\n".join(t[-3000:] for t in texts))
    return texts


def dist_part(part: str, work: str):
    """Part ``part``'s two ranks; returns what each pickled."""
    import pickle

    port = free_port()
    child = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "chip_smoke.dist_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])")
    run_processes([[sys.executable, "-c", child, ROOT, part, str(r), str(port), work] for r in range(DIST_WORLD)],
                  work, part)
    out = []
    for r in range(DIST_WORLD):
        with open(os.path.join(work, f"{part}.rank{r}"), "rb") as f:
            out.append(pickle.load(f))
    return out


def mb(n_bytes: int) -> str:
    return f"{n_bytes / 1e6:.1f} MB"


def sharded_evals(work: str, dataset, card: str, results: dict):
    """Part (a): each sharded eval of DIST_EVALS on both ranks against the
    one-rank harness on the same whole tables; every difference is listed
    before the part fails."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.ops import rank_count

    t0 = time.perf_counter()
    ranks = dist_part("eval", work)
    wall_a = time.perf_counter() - t0
    subset, bad = first_relations_test(dataset), []
    for what, model_name, source, flag, on_subset in DIST_EVALS:
        model, distance = get_model(model_name), Distance(flag)
        params = dist_tables(model_name, source, work)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw, filt, sizes = harness.rank_all(model, params, dataset, EmbeddingConfig(embedding_size=K, distance=distance),
                                            test_triples=subset if on_subset else None)
        one_wall = time.perf_counter() - t1
        name = None if model.cluster_aware else rank_count.KERNEL_NAMES[model.effective_distance(distance)]
        parts = []
        for r, got in enumerate(ranks):
            ev = got[what]
            n_raw, n_filt = int((ev["raw"] != raw).sum()), int((ev["filt"] != filt).sum())
            if n_raw or n_filt or ev["sizes"] != sizes:
                bad.append(f"{what} rank {r}: sharded ranks differ from the one-rank harness's in {n_raw} raw and "
                           f"{n_filt} filtered places of {raw.shape[0]}")
            want_launches = {} if name is None else {name: len(sizes)}
            check(ev["launches"] == want_launches,
                  f"{what} rank {r}: launches {ev['launches']}, expected {want_launches}")
            line = f"rank {r} rows {ev['rows'][0]}:{ev['rows'][1]}"
            if ev["held"]:
                line += (f", relations {ev['relations'][0]}:{ev['relations'][1]} holding "
                         + ", ".join(f"{k} {mb(n)} of {mb(params[k].nbytes)}" for k, n in ev["held"].items()))
            line += f", rank_all {ev['wall']:.3f} s"
            if name is not None:
                check(ev["plain"].shape[0] == N_CHECK, f"{what} rank {r}: {ev['plain'].shape[0]} queries checked")
                ev["n_off"], ev["max_off"] = compare(
                    torch.from_numpy(ev["kernel"]), torch.from_numpy(ev["plain"]), False,
                    f"sharded {what} rank {r}, first {N_CHECK} queries against the plain version on the shard's "
                    "inputs")
                results["evals"].append(dict(kernel=name, launches=len(sizes), max_off=ev["max_off"],
                                             what=f"sharded {what} rank {r}"))
                line += (f", {ev['launches'][name]} launches of {name}, first {N_CHECK} counts against the plain "
                         f"version on the shard's inputs: {ev['n_off']} off (max {ev['max_off']}), {ev['outside']} "
                         "with the true entity outside the shard")
            else:
                line += ", no kernel launch (the routed sweep)"
            parts.append(line)
        m = harness.metrics_from_ranks(raw, filt, sizes)
        scope = (f"the {raw.shape[0]} queries of relations 0-{int(subset[2].max())}" if on_subset
                 else f"{2 * N_TEST} queries")
        print(f"[distributed] (a) {card}: sharded {what}, model axis {DIST_WORLD}, gloo on cuda:0, {scope}: "
              + "; ".join(parts) + f"; one rank {one_wall:.3f} s; "
              + ("ranks equal exactly" if not any(b.startswith(what + " rank") for b in bad) else "RANKS DIFFER")
              + f" (filtered MR {m['filtered_mean_rank']:.6f}, Hits@10 {m['filtered_hits10']:.6f})", flush=True)
    check(not bad, "\n".join(bad))
    print(f"[distributed] (a) {card}: wall {wall_a:.1f} s (two processes: start, loading, {len(DIST_EVALS)} evals)",
          flush=True)
    return wall_a


def cut_diff(tables: dict, whole: dict, cut: dict) -> float:
    """Largest |difference| of a rank's ``tables`` from the one-rank
    ``whole`` ones on the rows the rank holds: its entity rows and its
    relations of the relation-cut tables (``cut``)."""
    bounds = {key: cut["relations"] for key in ("proj", "relation_c", "centers")}
    bounds["entity"] = cut["rows"]
    return max(float(np.abs(v - whole[k][slice(*bounds.get(k, (0, None)))]).max()) for k, v in tables.items())


def dp_training(data, path_data, ranks, card: str):
    """Part (b)'s DP_RUNS against one rank's ``batch_update`` batch by batch
    on the same inputs: after the first batch each rank's tables within
    DIST_ATOL and the loss within DIST_LOSS_RTOL; after the rest the largest
    difference printed."""
    for model_name, shape, rest in DP_RUNS:
        model, cfg, batch, params, batches = dist_inputs(model_name, shape,
                                                         path_data if model_name == "ptranse" else data,
                                                         torch.device("cuda"))
        want, one_walls = {}, []
        for sl in (slice(0, 1), slice(1, 1 + rest)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, loss = batch_by_batch(model, params, {k: v[sl] for k, v in batches.items()}, cfg)
            want[sl.start] = ({k: v.cpu().numpy() for k, v in params.items()}, float(loss))
            one_walls.append(time.perf_counter() - t1)
        kind = "data-parallel" if shape[1] == 1 else "entity rows cut"
        for r, got in enumerate(ranks):
            cut, walls = got[model_name, shape, "cut"], got[model_name, shape, "walls"]
            (first_tables, first_loss), (end_tables, rest_loss) = (got[model_name, shape, at] for at in (0, 1))
            first, end = cut_diff(first_tables, want[0][0], cut), cut_diff(end_tables, want[1][0], cut)
            check(first <= DIST_ATOL, f"(b) {model_name} at {shape} rank {r}: the first batch's tables differ by "
                                      f"{first:.3e} > {DIST_ATOL}")
            check(abs(first_loss - want[0][1]) <= DIST_LOSS_RTOL * abs(want[0][1]),
                  f"(b) {model_name} at {shape} rank {r}: first-batch loss {first_loss!r} against {want[0][1]!r}")
            print(f"[distributed] (b) {card}: {kind} train_{model_name} at mesh {shape}, gloo on cuda:0, batch "
                  f"{batch} of bench.py's configuration: rank {r} (entity rows {cut['rows'][0]}:{cut['rows'][1]}): "
                  f"first batch max |diff| {first:.3e} (bound {DIST_ATOL}), loss {first_loss:.6f} against "
                  f"{want[0][1]:.6f}; after {1 + rest} batches max |diff| {end:.3e}, loss {first_loss + rest_loss:.6f} "
                  f"against {want[0][1] + want[1][1]:.6f}; walls: first batch {walls[0]:.3f} s, the other {rest} "
                  f"{walls[1]:.3f} s (one rank: {one_walls[0]:.3f} s, {one_walls[1]:.3f} s)", flush=True)


def cut_training(work: str, ts, data, ranks, card: str):
    """Part (b)'s TransR and CTransR at mesh (1, 2) against one rank's
    ``batch_update`` chunk by chunk: after the first chunk each rank's cut
    of every table within DIST_ATOL and the loss within DIST_LOSS_RTOL;
    after CUT_CHUNKS the largest difference printed."""
    for model_name in CUT_MODELS:
        model, params, chunks = cut_inputs(model_name, work, data, torch.device("cuda"))
        want, one_walls = {}, []
        for sl in (slice(0, 1), slice(1, None)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, loss = batch_by_batch(model, params, {k: v[sl] for k, v in chunks.items()}, dist_cfg())
            want[sl.start] = ({k: v.cpu().numpy() for k, v in params.items()}, float(loss))
            one_walls.append(time.perf_counter() - t1)
        for r, got in enumerate(ranks):
            cut = got[model_name, "cut"]
            first, end = (cut_diff(got[model_name, at][0], want[at][0], cut) for at in (0, 1))
            check(first <= DIST_ATOL, f"(b) {model_name} rank {r}: the first chunk's tables differ by {first:.3e} > "
                                      f"{DIST_ATOL}")
            check(abs(got[model_name, 0][1] - want[0][1]) <= DIST_LOSS_RTOL * abs(want[0][1]),
                  f"(b) {model_name} rank {r}: first-chunk loss {got[model_name, 0][1]!r} against {want[0][1]!r}")
            walls = got[model_name, "walls"]
            print(f"[distributed] (b) {card}: train_{model_name} at mesh (1, 2), gloo on cuda:0, bench.py's "
                  f"configuration, chunks of 256 (warm-started from the TransE files): rank {r} holds entity rows "
                  f"{cut['rows'][0]}:{cut['rows'][1]} and relations {cut['relations'][0]}:{cut['relations'][1]}, "
                  f"proj {mb(cut['held'])} of {mb(want[0][0]['proj'].nbytes)}; first chunk max |diff| {first:.3e} "
                  f"(bound {DIST_ATOL}), loss {got[model_name, 0][1]:.6f} against {want[0][1]:.6f}; after "
                  f"{CUT_CHUNKS} chunks max |diff| {end:.3e}, loss {got[model_name, 0][1] + got[model_name, 1][1]:.6f} "
                  f"against {want[0][1] + want[1][1]:.6f}; walls: first chunk {walls[0]:.3f} s, the other "
                  f"{CUT_CHUNKS - 1} {walls[1]:.3f} s (one rank: {one_walls[0]:.3f} s, {one_walls[1]:.3f} s)",
                  flush=True)


def distributed_phase(work: str):
    """(a) the entity-sharded eval, 2 ranks, model axis 2, against the
    one-rank harness, each rank's rank counts against the plain version,
    from tables placed as the mesh cuts them (TransR's and CTransR's
    per-relation tables on the relation axis); (b) the runs of DP_RUNS
    (TransE, TransH and PTransE data-parallel, TransH with its entity rows
    cut), 2 ranks, and TransR and CTransR at mesh (1, 2), against the
    single-rank runner; (c) ``parallel/multiprocess.py`` at 1 process over
    NCCL (TransE, then TransR) against ``harness.evaluate`` of its written
    tables."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness

    card = card_line()
    data_dir = os.path.join(work, "data")
    results = {"evals": []}
    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))

    # (a) the sharded eval.
    wall_a = sharded_evals(work, dataset, card, results)

    # (b) distributed training.
    t0 = time.perf_counter()
    ts, data = dist_data(data_dir, torch.device("cuda"))
    store_s = write_dist_paths(work, ts)
    warm = write_cut_inputs(work, ts)
    prep_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = dist_part("train", work)
    wall_b = time.perf_counter() - t0
    dp_training(data, with_dist_paths(data, work, torch.device("cuda")), ranks, card)
    cut_training(work, ts, data, ranks, card)
    print(f"[distributed] (b) {card}: wall {wall_b:.1f} s (two processes: start, loading, the cuckoo build, "
          f"the runs of DP_RUNS, TransR's and CTransR's {CUT_CHUNKS} chunks), after {prep_b:.1f} s here for the "
          f"data, PTransE's path store ({store_s:.1f} s), the warm starts ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in warm.items()) + ", CTransR's with build_centers) and their files",
          flush=True)

    # (c) the production driver alone over NCCL: TransE, then TransR.
    walls_c = []
    for model_name, epochs in (("transe", 2), ("transr", 1)):
        out_npz, eval_out = (os.path.join(work, f"driver_{model_name}{ext}") for ext in (".npz", ".json"))
        t0 = time.perf_counter()
        log = run_processes([[sys.executable, "-m", "kb2e_tpu_torch.parallel.multiprocess", "--coordinator",
                              f"localhost:{free_port()}", "--num-processes", "1", "--process-id", "0", "--model",
                              model_name, "--datadir", data_dir, *TRAIN_FLAGS, "--epochs", str(epochs),
                              "--device", "cuda", "--out-npz", out_npz, "--eval-out", eval_out]],
                            work, f"driver_{model_name}")[0]
        walls_c.append(time.perf_counter() - t0)
        check("backend nccl" in log, "the driver did not run over NCCL:\n" + log[-2000:])
        with open(eval_out, encoding="utf-8") as f:
            driver_metrics = json.load(f)
        tables = {k: torch.from_numpy(v).cuda() for k, v in np.load(out_npz).items()}
        want_metrics = harness.evaluate(get_model(model_name), tables, dataset, EmbeddingConfig(embedding_size=K))
        check(driver_metrics == want_metrics, f"(c) the {model_name} driver's metrics {driver_metrics} differ from "
              f"evaluate's {want_metrics}")
        epochs_seen = [line for line in log.splitlines() if line.startswith("Epoch:")]
        print(f"[distributed] (c) {card}: parallel/multiprocess.py --model {model_name}, 1 process over NCCL, "
              f"{epochs} epoch(s) + --eval-out: {'; '.join(epochs_seen)}; metrics equal harness.evaluate's on its "
              f"tables (filtered MR {want_metrics['filtered_mean_rank']:.6f}); wall {walls_c[-1]:.1f} s (start, "
              "loading, training, eval)", flush=True)
    print(f"[distributed] (c) {card}: --model transr runs at model axis 1 only here: a model axis of 2 needs two "
          "processes, and NCCL refuses two ranks on one card (D26); parts (a) and (b) cut TransR over gloo instead",
          flush=True)
    results["walls"] = (wall_a, wall_b, sum(walls_c))
    return results


def nccl_cards_phase(work: str):
    """``--nccl-cards``: the production paths over NCCL, one rank per card, on
    every card of the host (an even count of two or more): ``torchrun``
    ``train_transe`` for 1 epoch of bench.py's configuration at data axis N
    and at (N/2, 2), each within 1e-5 of one card's loop on the same draws
    (the files hold 6 decimals); and ``parallel/multiprocess.py`` over the
    cards at model axis 2 for that epoch with ``--eval-out``: its metrics
    equal ``harness.evaluate`` of its tables on one card, and its tables
    those of the (N/2, 2) run."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Method
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.io import text
    from kb2e_tpu_torch.train import step

    n = torch.cuda.device_count()
    check(n >= 2 and n % 2 == 0, f"--nccl-cards needs an even count of two or more cards, found {n}")
    card = card_line()
    data_dir = os.path.join(work, "data")
    ts = triples.load_dataset(data_dir, splits=("train",)).train
    cfg = EmbeddingConfig(embedding_size=K, learning_rate=0.001, margin=1.0, method=Method.BERN,
                          num_batches=N_BATCHES, seed=SEED)
    model, data = get_model("transe"), step.DeviceData.from_triple_set(ts, torch.device("cuda"))
    walls = {}
    for data_axis, model_axis in ((n, 1), (n // 2, 2)):
        # One card's loop on the same draws (the generator draws the init,
        # then the epoch), at the loop's batch: 4,831 rounded down to the
        # data axis.
        batch = TRAIN_BATCH - TRAIN_BATCH % data_axis
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = model.init_params(gen, N_ENTITIES, N_RELATIONS, cfg, torch.device("cuda"))
        want, _ = batch_by_batch(model, params, step.EpochRunner(model, cfg, batch, N_BATCHES).sample(gen, data), cfg)
        want = {k: v.cpu().numpy() for k, v in want.items()}
        out = os.path.join(work, f"nccl_{data_axis}x{model_axis}")
        t0 = time.perf_counter()
        run_processes([[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
                        "-m", "kb2e_tpu_torch.cli.train_transe", "--data-axis", str(data_axis), "--model-axis",
                        str(model_axis), "--datadir", data_dir, "--outdir", out, *TRAIN_FLAGS, "--epochs", "1"]],
                      work, f"torchrun_{data_axis}x{model_axis}")
        walls[data_axis, model_axis] = time.perf_counter() - t0
        got = text.read_embeddings(out, Method.BERN, N_ENTITIES, N_RELATIONS, K)
        diffs = {k: float(np.abs(got[k] - want[k]).max()) for k in ("entity", "relation")}
        print(f"[nccl] {card} x {n}: torchrun train_transe --data-axis {data_axis} --model-axis {model_axis}, "
              f"batch {batch}, 1 epoch over NCCL: the files' largest difference from one card's loop {diffs}; "
              f"wall {walls[data_axis, model_axis]:.1f} s (start, loading, the cuckoo build, the epoch)", flush=True)
        check(max(diffs.values()) <= 1e-5, f"torchrun {data_axis}x{model_axis}: the files differ from one card's")
    npz, eval_out, port = os.path.join(work, "nccl_driver.npz"), os.path.join(work, "nccl_driver.json"), free_port()
    t0 = time.perf_counter()
    run_processes([[sys.executable, "-m", "kb2e_tpu_torch.parallel.multiprocess", "--coordinator",
                    f"localhost:{port}", "--num-processes", str(n), "--process-id", str(r), "--model", "transe",
                    "--datadir", data_dir, *TRAIN_FLAGS, "--epochs", "1", "--model-axis", "2", "--device", "cuda",
                    "--out-npz", npz, "--eval-out", eval_out] for r in range(n)], work, "nccl_driver")
    walls["driver"] = time.perf_counter() - t0
    tables = dict(np.load(npz))
    mesh_files = text.read_embeddings(os.path.join(work, f"nccl_{n // 2}x2"), Method.BERN, N_ENTITIES, N_RELATIONS, K)
    diff = max(float(np.abs(tables[k] - mesh_files[k]).max()) for k in ("entity", "relation"))
    check(diff <= 1e-5, f"the driver's tables differ from torchrun's at ({n // 2}, 2) by {diff:.3e}")
    with open(eval_out, encoding="utf-8") as f:
        driver_metrics = json.load(f)
    dataset = triples.load_dataset(data_dir, splits=("train", "valid", "test"))
    want_metrics = harness.evaluate(model, {k: torch.from_numpy(v).cuda() for k, v in tables.items()}, dataset,
                                    EmbeddingConfig(embedding_size=K))
    check(driver_metrics == want_metrics, f"the driver's sharded metrics {driver_metrics} differ from one card's "
          f"{want_metrics}")
    print(f"[nccl] {card} x {n}: parallel/multiprocess.py, {n} processes over NCCL, mesh ({n // 2}, 2), 1 epoch + "
          f"--eval-out: tables within {diff:.3e} of torchrun's; sharded metrics equal one card's evaluate (filtered "
          f"MR {want_metrics['filtered_mean_rank']:.6f}); wall {walls['driver']:.1f} s", flush=True)
    return {f"{k[0]}x{k[1]}" if isinstance(k, tuple) else k: v for k, v in walls.items()}


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


def least_ms(ops, nbytes) -> tuple:
    """(ms, what bounds it): the least time of ``ops`` fp32 operations and
    ``nbytes`` bytes on the card (``portbench/roofline.py``, an H100 SXM's
    peaks at its full 700 W), and whether the operations or the bytes set it."""
    from portbench import roofline

    by = "operations" if ops / roofline.FP32_FLOPS >= nbytes / roofline.HBM_BYTES_PER_S else "bytes"
    return 1e3 * roofline.least_seconds(ops, nbytes), by


def update_bound_ms(n, n_rel, k, b, n_updates) -> tuple:
    """Least time on the card for one sequential-update call: the tables
    read once and written once, the batch read and the decisions written, at
    the memory rate; or its fp32 operations at the fp32 peak (per sample 6k
    for the residuals and energies, per update 24k for the two directions'
    adds, squares, norm sums and divisions)."""
    nbytes = 2 * 4 * (n + n_rel) * k + b * (5 * 4 + 1) + 4 * b + 4
    ops = 6 * k * b + 24 * k * n_updates
    return least_ms(ops, nbytes)


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
    return least_ms(ops, nbytes)


def device_busy_ms(fn, what: str, top: int = 5) -> float:
    """The card's kernel and copy time during fn: the sum of the device
    events' durations in a torch.profiler trace (0 when it has none);
    prints the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Host ops carry their kernels' device time too: count device events only.
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    print(f"[timing] {what}, device time by kernel: " + "; ".join(
        f"{name[:60]} {ms:.4f} ms over {count}" for ms, count, name in ops[:top]), flush=True)
    return sum(ms for ms, _, _ in ops)


def schedule_timing(name: str, module, update, args, stress: dict, kw: dict, reps: int) -> float:
    """One update wrapper (K3's, K4's or K5's) per launch on the sampler
    batch and on each batch of ``stress`` (the stress batches and the
    skewed batch), each with its longest chain of predecessors and its count
    of updates; the update pass's resident blocks; the device time of one
    call on the sampler batch by kernel; and the wrapper's id check (one
    host sync) alone.  Returns the sampler batch's ms per launch."""
    from kb2e_tpu_torch.ops import schedule

    m = len(args) - len(IDX_KEYS)  # the tables; the decisions follow them and the loss
    tables, idx = args[:m], args[m:]
    times = {}
    for kind, batch_idx in (("sampler", idx), *stress.items()):
        call = (*tables, *batch_idx)
        times[kind] = time_ms(lambda: update(*call, **kw), reps, warmup=1)
        decided = update(*call, **kw)[m + 1]
        ph, pt, r, nh, nt = batch_idx[:5]
        pred = schedule.row_predecessors(schedule.update_rows(ph, pt, nh, nt, r, N_ENTITIES), decided)
        depth = int(schedule.chain_levels(pred, decided).max(initial=0))
        print(f"[timing] {name} {describe_batch(kind, batch_idx)}: {times[kind]:.4f} ms per launch, "
              f"{int(decided.sum())} updates, longest chain {depth}"
              + (f" ({times[kind] / depth * 1e3:.2f} us a chained update)" if depth else ""), flush=True)
    per_sm = module.resident_blocks_per_sm(K)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[timing] {name}: the one-relation chain {times['one relation']:.4f} ms against the sampler batch's "
          f"{times['sampler']:.4f} ms ({times['one relation'] / times['sampler']:.2f} times); the update pass "
          f"holds {per_sm} blocks on each of {sms} SMs", flush=True)
    ph, pt, r, nh, nt = idx[:5]
    check_ms = time_ms(lambda: schedule.check_ids(name, ph, pt, r, nh, nt, N_ENTITIES, N_RELATIONS), 20)
    print(f"[timing] {name}: the wrapper's id check alone {check_ms:.4f} ms, "
          f"{check_ms / times['sampler']:.2%} of the sampler batch's launch", flush=True)
    device_busy_ms(lambda: update(*tables, *idx, **kw), f"{name} one call on the sampler batch", top=8)
    return times["sampler"]


def transh_timing(ctx, results):
    """The TransH update per launch at B 4,831 on TransH-init tables, its plain
    version on the same inputs (timed in the kernels phase), the bound, and
    the TransH main paths' walls."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import transh_update

    name = transh_update.KERNEL_NAME
    lr, cap = K4_SETTINGS[0]
    kw = dict(learning_rate=lr, margin=1.0, max_iters=cap)
    args = ctx["transh_args"]
    ms = schedule_timing(name, transh_update, transh_update.transh_sequential_update, args,
                         {**ctx["transh_stress"], "skewed": ctx["skewed"]}, kw, reps=5)
    plain_ms = ctx["transh_plain_ms"]
    out = transh_update.transh_sequential_update(*args, **kw)
    n_updates, (fired, capped) = int(out[4].sum()), (int(x) for x in out[5].sum(0))
    b_ms, b_by = transh_bound_ms(N_ENTITIES, N_RELATIONS, K, TRAIN_BATCH, n_updates, fired, capped)
    epoch = results["transh_parity"]["records"][0]
    print(f"[timing] {name} B={TRAIN_BATCH} N={N_ENTITIES} R={N_RELATIONS} k={K}: kernel {ms:.4f} ms per launch "
          f"(wrapper: id check, table copies, three launches and the schedule), plain {plain_ms:.4f} ms (one run; "
          f"its per-sample loop syncs the host at every projector test), library none, bound {b_ms:.5f} ms "
          f"({b_by}; the chains of samples are latency-bound), {n_updates} updates, {fired} projector trips fired, "
          f"{capped} calls capped; parity epoch {epoch['wall_s']:.3f} s over {N_BATCHES} launches, "
          f"{epoch['triples_per_s']:.0f} triples/s", flush=True)
    fast, ev = results["transh_fast"], results["transh_eval"][Distance.L1]
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


def transr_bound_ms(n, n_rel, k, b, n_updates, fired, capped) -> tuple:
    """Least time on the card for one TransR sequential-update call.

    Bytes: the three tables read once and written once (W_r is k² floats a
    relation), the batch read, the decisions and trips written, at the
    memory rate.  Operations: fp32 instructions, each costed as an FMA (two
    operations) at the fp32 peak: per sample 8k² for the four rows times W_r
    (a multiply and an add a term) and 8k for the residuals and energies;
    per update 16k² + 40k for the two directions' outer-product update of
    W_r, W·x, the row norms of W_r (a square, an add and a division an
    entry) and the vector updates and norms; per projector test 2k² + 2k
    (a·W and its squared norm); per fired trip 6k² (per output dim, a
    multiply and an add over k for the dot and two multiply-subtracts over
    k).  A call makes one test more than it fires trips unless it stopped at
    the cap, so this run's ``fired`` trips and ``capped`` calls give its
    count of tests."""
    nbytes = 2 * 4 * (n + n_rel + n_rel * k) * k + b * (5 * 4 + 1) + 3 * 4 * b + 4
    tests = fired + 6 * n_updates - capped
    ops = 2 * (b * (8 * k * k + 8 * k) + n_updates * (16 * k * k + 40 * k) + tests * (2 * k * k + 2 * k)
               + fired * 6 * k * k)
    return least_ms(ops, nbytes)


def transr_timing(ctx, results):
    """The TransR update per launch at B 4,831 on TransR-init tables at the
    main path's setting, its plain version on the same inputs (timed in the
    kernels phase, on the host's CPU), the bound, and the TransR main paths'
    walls."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import transr_update

    name = transr_update.KERNEL_NAMES[Distance.L1]
    lr, cap = K5_SETTINGS[0]
    kw = dict(learning_rate=lr, margin=1.0, l1=True, max_iters=cap)
    args = ctx["transr_args"]
    ms = schedule_timing(name, transr_update, transr_update.transr_sequential_update, args,
                         {**ctx["transr_stress"], "skewed": ctx["skewed"]}, kw, reps=5)
    out = transr_update.transr_sequential_update(*args, **kw)
    n_updates, (fired, capped) = int(out[4].sum()), (int(x) for x in out[5].sum(0))
    b_ms, b_by = transr_bound_ms(N_ENTITIES, N_RELATIONS, K, TRAIN_BATCH, n_updates, fired, capped)
    plain_ms = ctx["transr_plain_ms"]
    epoch = results["transr_parity"]["records"][0]
    print(f"[timing] {name} B={TRAIN_BATCH} N={N_ENTITIES} R={N_RELATIONS} k={K}: kernel {ms:.4f} ms per launch "
          f"({ms / TRAIN_BATCH * 1e3:.2f} us a sample; wrapper: id check, table copies, three launches and the "
          f"schedule), plain "
          f"{plain_ms:.1f} ms on the host's CPU, one thread ({plain_ms / TRAIN_BATCH:.2f} ms a sample), library "
          f"none, bound {b_ms:.5f} ms ({b_by}; "
          f"the chains of samples are latency-bound), {n_updates} updates, {fired} projector trips fired, {capped} calls "
          f"capped; parity epoch {epoch['wall_s']:.3f} s over {N_BATCHES} launches, "
          f"{epoch['triples_per_s']:.0f} triples/s", flush=True)
    # The L2 template on the same inputs (no main path launches it).
    kw_l2 = dict(kw, l1=False)
    ms_l2 = time_ms(lambda: transr_update.transr_sequential_update(*args, **kw_l2), 5, warmup=1)
    out = transr_update.transr_sequential_update(*args, **kw_l2)
    n_l2, (fired_l2, capped_l2) = int(out[4].sum()), (int(x) for x in out[5].sum(0))
    b2_ms, b2_by = transr_bound_ms(N_ENTITIES, N_RELATIONS, K, TRAIN_BATCH, n_l2, fired_l2, capped_l2)
    print(f"[timing] {transr_update.KERNEL_NAMES[Distance.L2]} on the same inputs: kernel {ms_l2:.4f} ms per launch, "
          f"bound {b2_ms:.5f} ms ({b2_by}), {n_l2} updates, {fired_l2} projector trips fired, {capped_l2} calls "
          f"capped", flush=True)
    fast = results["transr_fast"]
    evals = "; ".join(f"--distance {int(flag)}: eval {ev['wall']:.2f} s (ranking alone {ev['rank_wall']:.3f} s) "
                      f"over {ev['launches']} launches of {ev['kernel']}"
                      for flag, ev in results["transr_eval"].items())
    print(f"[timing] train_transr fast at bench.py's configuration: epoch walls "
          + ", ".join(f"{r['wall_s']:.3f} s ({r['triples_per_s']:.0f} triples/s)" for r in fast)
          + f"; eval_transr {evals}", flush=True)
    return {
        "name": name,
        "route": "cuda",
        "source": "kb2e_tpu_torch/csrc/transr_update.cu",
        "replaces": "kb2e_tpu/ops/pallas_update.py:464",
        "launches": results["transr_parity"]["launches"],
        "max_abs_err": ctx["transr_worst"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def epoch_breakdown(ctx, model_name: str, params: dict, fast_reps: int = 5, parity_reps: int = 3,
                    profile_window=None, parity: bool = True):
    """Where one fast epoch and one parity epoch of ``model_name`` spend their
    time at bench.py's configuration: the epoch on CUDA events (median of a
    few runs), the card's busy time in one more run from torch.profiler, and
    its parts alone — the fast epoch's one sampling call and its updates (100
    batches, or TransR's 1,888 chunks), the parity epoch's (sample, update)
    pairs.  ``profile_window`` profiles only the fast epoch's first that many
    updates, set against their own wall: the profiler's cost grows with the
    launches, to minutes for TransR's 1,888 chunks.  Ends with the seconds
    it took, and those of the two profiled runs.  ``parity=False`` leaves
    the parity epoch out (CTransR's parity mode is its fast update)."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.train import step

    data = ctx["train_data"]
    model = get_model(model_name)
    cfg = EmbeddingConfig(embedding_size=K, learning_rate=0.001, margin=1.0, method=1, num_batches=N_BATCHES)
    gen = torch.Generator(device=data.heads.device).manual_seed(SEED)
    runner = step.EpochRunner(model, cfg, TRAIN_BATCH, N_BATCHES)

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

    def idle(busy, wall):
        return f"{1 - busy / wall:.3f}" if busy > 0 else "not measured (no device time in the profile)"

    pcfg = cfg.replace(update_mode="parity")
    train_step = step.make_train_step(model, pcfg, TRAIN_BATCH)

    def parity_epoch():
        p = params
        for _ in range(N_BATCHES):
            p, _ = train_step(p, gen, data)
        return p

    t_start = time.perf_counter()
    runner(params, gen, data)  # warm-up
    _, fast_ms, fast_host_ms = timed(lambda: runner(params, gen, data), reps=fast_reps)
    batches, sample_ms, _ = timed(lambda: runner.sample(gen, data), reps=fast_reps)
    _, apply_ms, _ = timed(lambda: runner.apply(params, batches, data.n_entities), reps=fast_reps)
    if parity:
        _, parity_ms, parity_host_ms = timed(parity_epoch, reps=parity_reps)
        p_sample = p_update = 0.0
        p = params
        for _ in range(N_BATCHES):
            b, ms, _ = timed(lambda: step.sample_batch(gen, data, pcfg, TRAIN_BATCH))
            p_sample += ms
            (p, _), ms, _ = timed(lambda: model.sequential_update(p, b, pcfg))
            p_update += ms
    # Profiled last: the host launches more slowly once the profiler has run.
    if profile_window is None:
        busy_of, window_ms = "the epoch", fast_ms
        t_profiled = time.perf_counter()
        fast_busy = device_busy_ms(lambda: runner(params, gen, data), f"{model_name} fast epoch")
    else:
        part = {k: v[:profile_window] for k, v in batches.items()}
        _, window_ms, _ = timed(lambda: runner.apply(params, part, data.n_entities), reps=fast_reps)
        busy_of = f"its first {profile_window} updates, {window_ms:.3f} ms alone (median of {fast_reps})"
        t_profiled = time.perf_counter()
        fast_busy = device_busy_ms(lambda: runner.apply(params, part, data.n_entities),
                                   f"{model_name} fast epoch's first {profile_window} updates")
    t_fast_profiled = time.perf_counter() - t_profiled
    if parity:
        parity_busy = device_busy_ms(parity_epoch, f"{model_name} parity epoch")
    t_profiled = time.perf_counter() - t_profiled
    print(f"[timing] {model_name} fast epoch at B={TRAIN_BATCH} x {N_BATCHES}: {fast_ms:.3f} ms on the card's clock "
          f"({fast_host_ms:.3f} ms on the host's; medians of {fast_reps}), device busy {fast_busy:.3f} ms over "
          f"{busy_of}, idle share {idle(fast_busy, window_ms)}; alone (medians of {fast_reps}): sampling the epoch "
          f"{sample_ms:.3f} ms, "
          f"{next(iter(batches.values())).shape[0]} {'chunk ' if runner.chunk else ''}updates {apply_ms:.3f} ms",
          flush=True)
    if parity:
        print(f"[timing] {model_name} parity epoch: {parity_ms:.3f} ms on the card's clock ({parity_host_ms:.3f} ms "
              f"on the host's; medians of {parity_reps}), device busy {parity_busy:.3f} ms, idle share "
              f"{idle(parity_busy, parity_ms)}; each step synchronised: sampling {p_sample:.3f} ms, {N_BATCHES} "
              f"sequential updates {p_update:.3f} ms", flush=True)
    print(f"[timing] {model_name} breakdown took {time.perf_counter() - t_start:.1f} s, of it the profiled runs "
          f"{t_profiled:.1f} s (the fast epoch {t_fast_profiled:.1f} s)", flush=True)


def update_timing(ctx, results):
    """The TransE update per launch at B 4,831 on TransE-init tables, L1 and
    L2, through schedule_timing, beside its plain version on the same inputs
    (timed in the kernels phase) and the bound."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import transe_update

    records = []
    args = ctx["update_args"]
    stress = {**ctx["update_stress"], "skewed": ctx["skewed"]}
    for l1 in (True, False):
        distance = Distance.L1 if l1 else Distance.L2
        name = transe_update.KERNEL_NAMES[distance]
        kw = dict(learning_rate=0.001, margin=1.0, l1=l1)
        ms = schedule_timing(name, transe_update, transe_update.transe_sequential_update, args, stress, kw, reps=10)
        plain_ms = ctx["update_plain_ms"][name]
        n_updates = int(transe_update.transe_sequential_update(*args, **kw)[3].sum())
        b_ms, b_by = update_bound_ms(N_ENTITIES, N_RELATIONS, K, TRAIN_BATCH, n_updates)
        epoch = results[name]["records"][0]
        print(f"[timing] {name} B={TRAIN_BATCH} N={N_ENTITIES} R={N_RELATIONS} k={K}: kernel {ms:.4f} ms per launch "
              f"(wrapper: id check, table copies, three launches and the schedule), plain {plain_ms:.4f} ms (one "
              f"run, on the card), library none, bound {b_ms:.4f} ms ({b_by}; the chains of samples are "
              f"latency-bound), {n_updates} updates; parity epoch {epoch['wall_s']:.3f} s over {N_BATCHES} launches, "
              f"{epoch['triples_per_s']:.0f} triples/s", flush=True)
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


def transe_fast_timing(ctx, results):
    """TransE's fast batch per batch over the 100 batches of the kernels
    phase's sampler epoch at each of FAST_NEGATIVES, from TransE-init tables
    (L1, lr 0.001: bench.py's configuration): the wrapper's three launches a
    batch on CUDA events, their device time by kernel from torch.profiler,
    ``fused_table_update`` on the same batches, and the bound from the
    benchmark's count (``portbench/reference/transe.py::update_work``).  The
    launch counts are set to 0 just before the timed runs and must read one
    launch of each kernel a batch; a record's ``launches`` are those of the
    main path's 2 fast epochs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kb2e_tpu_torch import get_model
    from kb2e_tpu_torch.models import base
    from kb2e_tpu_torch.ops import transe_fast
    from portbench import roofline
    from portbench.reference import transe as ref_transe

    model, records, reps = get_model("transe"), [], 5
    params = {"entity": ctx["update_args"][0], "relation": ctx["update_args"][1]}
    start = base.fuse(params)
    for k_neg, feed in ctx["fast_feeds"].items():
        cfg, rows = ctx["fast_cfgs"][k_neg], feed["ph"].shape[1]
        run = model.stepper(params, feed, cfg)

        def epoch():
            for i in range(N_BATCHES):
                run(i)

        epoch()  # warm-up
        reset_all_launch_counts()
        ms = time_ms(epoch, reps, warmup=0) / N_BATCHES
        launches = all_launch_counts()
        expect = fast_batch_launches("transe", reps * N_BATCHES)
        check(launches == expect, f"transe_fast K={k_neg} timing: launches {launches}, expected {expect}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            epoch()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                name = next((n for n in transe_fast.KERNEL_NAMES if n in e.key), e.key[:40])
                by_kernel[name] = by_kernel.get(name, 0.0) + e.self_device_time_total / 1e3 / N_BATCHES
        device_ms = sum(by_kernel.values())
        batches = [{key: v[i] for key, v in feed.items()} for i in range(N_BATCHES)]

        def plain_epoch():
            table = start
            for b in batches:
                table, _ = model.fused_table_update(table, N_ENTITIES, b, cfg)

        plain_ms = time_ms(plain_epoch, 3, warmup=1) / N_BATCHES
        work = ref_transe.update_work(K, feed)
        b_ms = 1e3 * roofline.least_seconds_sum(work) / N_BATCHES
        b_by = "bytes" if sum(nb / roofline.HBM_BYTES_PER_S for _, nb in work) >= sum(
            op / roofline.FP32_FLOPS for op, _ in work) else "operations"
        print(f"[timing] transe_fast L1 K={k_neg}, {rows} rows a batch, N={N_ENTITIES} R={N_RELATIONS} k={K}: "
              f"wrapper {ms:.4f} ms a batch (three launches, one ctypes call; CUDA events over {reps} epochs of "
              f"{N_BATCHES} batches), device {device_ms:.4f} ms a batch ("
              + ", ".join(f"{name} {v:.4f}" for name, v in by_kernel.items())
              + f"), plain fused_table_update {plain_ms:.4f} ms a batch, library none, bound {b_ms:.5f} ms "
              f"({b_by}, update_work): device {device_ms / b_ms:.1f} times the bound", flush=True)
        records.append({
            "name": f"transe_fast L1 K={k_neg}",
            "route": "cuda",
            "source": "kb2e_tpu_torch/csrc/transe_fast.cu",
            "replaces": None,
            "launches": results["fast_launches"],
            "max_abs_err": ctx["fast_worst"],
            "ms": ms,
            "device_ms": device_ms,
            "device_ms_by_kernel": by_kernel,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    return records


def transr_fast_timing():
    """TransR's fast chunk as the kernels of ``ops/transr_fast.py`` at the
    ``transr-fb15k.train`` cell's shape: the cell's graph (``portbench``'s
    generator, seed SEED), one epoch of the port's sampler under the cell's
    configuration (1,888 chunks of 256, N 14,951, R 1,345, k = d = 50, L1,
    lr 0.001), TransR-init tables.  First the kernels against
    ``chunk_update_`` bit for bit on dyadic chunks (L1 and L2, k 50;
    ``tests/test_torch_transr_fast.py``'s cycles, which make every sum of a
    chunk exact) with one launch a run.  Then, at the cell's N, R, k and
    chunk of 256 on its TransR-init tables, against ``chunk_update_`` from
    the same start tables on the same feed: bit for bit on 4 chunks whose
    rows and matrices each take at most one step (``_distinct_feed``, L1 and
    L2: the steps do not cancel, and every sum but the dot products is exact
    in any order, which the kernel adds as cuBLAS does at k 50; the losses,
    summed in another order, within 1e-6 relative), and within
    ``RANDOM_ATOL`` on the first 8 chunks of the sampler's epoch, the
    largest difference the record's ``max_abs_err``.  Then per chunk over the epoch: the
    device time on CUDA events (median of 3 epochs) and per phase from the
    kernel's clock (medians), the host's time to queue a chunk, the plain
    version (``ChunkGraph``'s replays of the same epoch), the bound of
    ``portbench/roofline.py`` over ``reference/transr.py::update_work``, and
    ptxas's registers and spills."""
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance, Method
    from kb2e_tpu_torch.data.triples import TripleSet
    from kb2e_tpu_torch.models import transr
    from kb2e_tpu_torch.ops import cuda_build, transr_fast
    from kb2e_tpu_torch.train import step
    from portbench import roofline, spec
    from portbench.data import graph as graph_lib
    from portbench.reference import transr as ref_transr

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_transr_fast as cases  # the dyadic cycles

    model, dev = get_model("transr"), torch.device("cuda")
    for distance in (Distance.L1, Distance.L2):
        n, n_rel, k, chunk = 3000, 700, 50, 64
        host = cases._dyadic_tables(n, n_rel, k, seed=SEED + int(distance))
        feed = {key: v.to(dev) for key, v in cases._cycle_feed(6, chunk, n, n_rel, SEED + 2 + int(distance)).items()}
        params, cfg = {key: v.to(dev) for key, v in host.items()}, cases._cfg(distance, k)
        want, want_loss = cases._eager(params, feed, cfg)
        reset_all_launch_counts()
        got, loss = cases._kernels(params, feed, cfg)
        torch.cuda.synchronize()
        launches = all_launch_counts()
        check(launches == {name: 1 for name in transr_fast.KERNEL_NAMES}, f"transr_fast dyadic: launches {launches}")
        for key in want:
            check(torch.equal(got[key], want[key]), f"transr_fast {distance.name} dyadic: {key} apart from "
                  f"chunk_update_ in {int((got[key] != want[key]).sum())} elements")
        check(torch.equal(loss, want_loss), f"transr_fast {distance.name} dyadic: loss {loss} against {want_loss}")
        print(f"[kernels] transr_fast {distance.name} k={k}: 6 dyadic chunks of {chunk} (one all invalid) bit for bit "
              f"with chunk_update_, one launch; loss {float(loss.sum()):.4f}", flush=True)

    cell = spec.load("transr-fb15k.train")
    g, emb = cell.config["graph"], dict(cell.config["embedding"])
    emb["method"], emb["distance"] = Method.from_any(emb["method"]), Distance.from_any(emb["distance"])
    cfg = EmbeddingConfig(**emb, seed=SEED)
    n_ent, n_rel, k = int(g["n_entities"]), int(g["n_relations"]), cfg.embedding_size
    graph = graph_lib.generate(g, SEED)
    ts = TripleSet.from_arrays(*graph["train"], n_ent, n_rel)
    data = step.DeviceData.from_triple_set(ts, dev)
    runner = step.EpochRunner(model, cfg, step.batch_size_for(ts.num_triples, cfg.num_batches), cfg.num_batches)
    feed = runner.sample(torch.Generator(device=dev).manual_seed(SEED), data)
    n_chunks, rows = feed["ph"].shape
    params = model.init_params(torch.Generator().manual_seed(SEED), n_ent, n_rel, cfg, dev)

    for distance in (Distance.L1, Distance.L2):
        one = cfg.replace(distance=distance)
        distinct = cases._distinct_feed(4, rows, n_ent, n_rel, SEED + 4 + int(distance), dev)
        want, want_loss = cases._eager(params, distinct, one)
        got, loss = cases._kernels(params, distinct, one)
        for key in want:
            check(torch.equal(got[key], want[key]), f"transr_fast {distance.name} distinct chunks at the cell's shape: "
                  f"{key} apart from chunk_update_ in {int((got[key] != want[key]).sum())} elements, by at most "
                  f"{float((got[key] - want[key]).abs().max()):.3e}")
            check(not torch.equal(got[key], params[key]),
                  f"transr_fast {distance.name} distinct chunks: {key} unchanged")
        loss_rel = float(((loss - want_loss).abs() / want_loss.abs()).max())  # summed in another order
        check(loss_rel <= 1e-6, f"transr_fast {distance.name} distinct chunks: losses apart from chunk_update_'s by "
              f"{loss_rel:.3e}")
        print(f"[kernels] transr_fast {distance.name} at the cell's shape (N={n_ent} R={n_rel} k={k}): 4 chunks of "
              f"{rows} with no row stepped twice, TransR-init tables, bit for bit with chunk_update_; losses "
              f"within {loss_rel:.3e}", flush=True)
    first = {key: v[:8] for key, v in feed.items()}
    want, want_loss = cases._eager(params, first, cfg)
    got, loss = cases._kernels(params, first, cfg)
    errs = {key: float((got[key] - want[key]).abs().max()) for key in want}
    worst = max(errs.values())
    check(worst <= cases.RANDOM_ATOL, f"transr_fast: the epoch's first 8 chunks apart from chunk_update_ by {errs}, "
          f"over {cases.RANDOM_ATOL}")
    check(all(not torch.equal(got[key], params[key]) for key in want), "transr_fast: the first 8 chunks wrote nothing")
    loss_rel = float(((loss - want_loss).abs() / want_loss.abs().clamp(min=1e-30)).max())
    check(loss_rel <= 1e-6, f"transr_fast: the first 8 chunks' losses apart from chunk_update_'s by {loss_rel:.3e}")
    print(f"[kernels] transr_fast L1 at the cell's shape: the sampler's first 8 chunks of {rows}, TransR-init tables, "
          f"within {worst:.3e} of chunk_update_ (" + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
          + f"; limit {cases.RANDOM_ATOL}), losses within {loss_rel:.3e}", flush=True)

    def epoch_ms(make, reps=3):
        times = []
        for _ in range(reps):
            steps = make()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for i in range(n_chunks):
                steps(i)
            steps.params()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times)) / n_chunks

    reset_all_launch_counts()
    ms = epoch_ms(lambda: model.kernel_chunks(params, feed, cfg))
    launches = all_launch_counts()
    runs = 3 * -(-n_chunks // transr_fast.RUN)
    check(launches == {name: runs for name in transr_fast.KERNEL_NAMES}, f"transr_fast timing: launches {launches}, "
          f"expected {runs}")
    steps = model.kernel_chunks(params, feed, cfg)
    steps.stamps = torch.zeros(n_chunks, 5, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_chunks):
        steps(i)
    host_us = (time.perf_counter() - t0) * 1e6 / n_chunks
    steps.params()
    torch.cuda.synchronize()
    st = steps.stamps.double().cpu()
    phase_us = [float(x) for x in ((st[:, 1:] - st[:, :-1]) / 1e3).median(0).values]
    chunk_us = float(((st[:, 4] - st[:, 0]) / 1e3).median())
    graph = transr.ChunkGraph(model, cfg, params, rows)
    plain_ms = epoch_ms(lambda: graph.load(params, feed))
    work = ref_transr.update_work(k, {key: v.cpu() for key, v in feed.items()})
    b_ms = 1e3 * roofline.least_seconds_sum(work) / n_chunks
    b_by = "bytes" if sum(nb / roofline.HBM_BYTES_PER_S for _, nb in work) >= sum(
        op / roofline.FP32_FLOPS for op, _ in work) else "operations"
    log = cuda_build.library_path(transr_fast.SOURCE).with_suffix(".log").read_text()
    ptxas = "; ".join(f"{'L1' if 'ILb1E' in name else 'L2'} {regs} registers, {spill} bytes spilled"
                      for name, spill, regs in re.findall(
                          r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?Used (\d+) registers", log,
                          re.S))
    print(f"[timing] transr_fast L1 at transr-fb15k.train's shape ({n_chunks} chunks of {rows}, N={n_ent} R={n_rel} "
          f"k={k}), {card_line()}: {ms * 1e3:.2f} us a chunk on CUDA events over an epoch (median of 3; one launch "
          f"of {steps.blocks} blocks a run of {transr_fast.RUN}); by the kernel's clock {chunk_us:.2f} us a chunk, "
          "phases "
          + ", ".join(f"{name} {v:.2f}" for name, v in zip(("score", "steps and norms", "ball step", "ball adds"),
                                                            phase_us))
          + f" us; host {host_us:.2f} us to queue a chunk; plain ChunkGraph {plain_ms * 1e3:.2f} us a chunk; bound "
          f"{b_ms * 1e3:.3f} us ({b_by}, update_work): {ms / b_ms:.1f} times the bound; ptxas {ptxas}", flush=True)
    return {
        "name": "transr_fast L1",
        "route": "cuda",
        "source": "kb2e_tpu_torch/csrc/transr_fast.cu",
        "replaces": None,
        "launches": runs,
        "max_abs_err": worst,
        "ms": ms,
        "device_ms": chunk_us / 1e3,
        "device_ms_by_phase": dict(zip(("score", "steps_and_norms", "ball_step", "ball_adds"),
                                       [v / 1e3 for v in phase_us])),
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def bare_launcher(args):
    """The rank count's bare launch on buffers allocated once: the tables in
    the harness's aligned layout, ``e_sq`` and ``q_sq`` given, and ``out``
    zeroed once (each launch adds to it), with the arguments bound once, so
    the host enqueues faster than the card runs; returns (launch, out)."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import distances, rank_count

    proj_t, queries_t, e_true, true_idx, distance = args
    e_sq = q_sq = None
    if distance == Distance.L2:
        e_sq, q_sq = distances.squared_norms(proj_t), distances.squared_norms(queries_t)
    proj_t, queries_t = (rank_count.aligned_transpose(x.T) for x in (proj_t, queries_t))
    out = torch.zeros(queries_t.shape[1], dtype=torch.int32, device=proj_t.device)
    return rank_count.launcher(proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, distance), out


def bare_launch(args) -> torch.Tensor:
    """The counts of one bare launch."""
    launch, out = bare_launcher(args)
    launch()
    torch.cuda.synchronize()
    return out


def rank_count_device_ms(args, reps: int = 200) -> tuple:
    """The rank count's bare launch (bare_launcher): ms per launch on CUDA
    events over ``reps`` launches, and the kernel's own time in a
    torch.profiler trace of as many launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bare, _ = bare_launcher(args)
    ms = time_ms(bare, reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bare()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "rank_count_kernel" in e.key]
    # The profiler may drop a few of a burst's events: the mean over those it kept.
    count = sum(e.count for e in found)
    check(count > 0, f"the profiler saw no launch of rank_count_kernel in {reps}")
    return ms, sum(e.self_device_time_total for e in found) / count / 1e3


def clocks_under_load(fn, seconds: float = 1.5) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, sampled while
    ``fn`` runs back to back for ``seconds``: the clock the data-sheet
    peaks (1,980 MHz) assume against the one the card ran at."""
    import threading

    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip())

    thread = threading.Thread(target=sample)
    t0 = time.perf_counter()
    thread.start()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    done.set()
    thread.join()
    return "; ".join(samples[1:-1] or samples)


def rank_count_k_sweep(distance, ks=(0, 16, 50, 100, 200)) -> str:
    """The device time at N 14,951, B 256 and each k of ``ks`` on seeded
    tables, with the least-squares line through those of k > 0: its slope is
    the time of a k-row across the card, its intercept what a launch costs
    beside the rows (start, first copies, epilogue); k 0 is the launch and
    the epilogue alone."""
    from kb2e_tpu_torch.ops import distances

    rng = np.random.default_rng(SEED + 2)
    ms = []
    for k in ks:
        ent = torch.from_numpy(rng.normal(size=(N_ENTITIES, k)).astype(np.float32)).cuda()
        q = torch.from_numpy(rng.normal(size=(EVAL_BATCH, k)).astype(np.float32)).cuda()
        t = torch.from_numpy(rng.integers(0, N_ENTITIES, EVAL_BATCH).astype(np.int32)).cuda()
        e_true = distances.residual_energy(ent[t.long()] - q, distance).contiguous()
        ms.append(rank_count_device_ms((ent.T.contiguous(), q.T.contiguous(), e_true, t, distance), reps=100)[1])
    fit = [(k, m) for k, m in zip(ks, ms) if k > 0]
    slope, intercept = np.polyfit(np.array([k for k, _ in fit], dtype=np.float64), np.array([m for _, m in fit]), 1)
    return (", ".join(f"k {k} {m:.4f} ms" for k, m in zip(ks, ms))
            + f" (profiler): {slope * 1e3:.4f} us a k-row, {intercept * 1e3:.3f} us beside the rows")


def rank_count_timing(tables, ctx, results):
    """The rank count at the main path's shape (B 256, N 14,951, k 100), per
    distance: the wrapper as the harness calls it (aligned tables, e_sq
    given for L2: the record's ``ms``) and as a caller with contiguous
    tables and no ‖e‖² does, the bare launch's device time (CUDA events and
    the profiler), the plain version, one library call, the bound, and the
    grid against the card's resident blocks.  ``results`` is None when the
    main paths did not run (``--rank-count-only``): no launch counts, and in
    their place the SM clock under back-to-back launches and the device
    time by k."""
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.ops import distances, rank_count
    from portbench import roofline

    worst = ctx["rank_worst"]
    rng = np.random.default_rng(SEED + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = rank_count.plan(K, N_ENTITIES, EVAL_BATCH)
    records = []
    for distance in (Distance.L1, Distance.L2):
        args = (*eval_inputs(tables["entity"], tables["relation"], EVAL_BATCH, distance, rng), distance)
        name = rank_count.KERNEL_NAMES[distance]
        b_ms, b_by = least_ms(*roofline.rank_count_work(distance == Distance.L1, K, N_ENTITIES, [EVAL_BATCH]))
        device_ms, profiler_ms = rank_count_device_ms(args)
        per_sm = rank_count.resident_blocks_per_sm(distance)
        waves = plan.waves(per_sm, sms)
        # The wrapper as the harness calls it (aligned tables, ‖e‖² given)
        # and on contiguous tables without ‖e‖² (a padded copy, ‖e‖² computed).
        harness_args = (*(rank_count.aligned_transpose(x.T) for x in args[:2]), *args[2:])
        e_sq = distances.squared_norms(args[0]) if distance == Distance.L2 else None
        harness_ms = time_ms(lambda: rank_count.rank_counts(*harness_args, e_sq=e_sq), 200)
        wrapper_ms = time_ms(lambda: rank_count.rank_counts(*args), 200)
        check(torch.equal(rank_count.rank_counts(*harness_args, e_sq=e_sq), rank_count.rank_counts(*args)),
              f"{name}: the harness's layout and e_sq give other counts")
        plain_ms = time_ms(lambda: rank_count.rank_counts_reference(*args), 5)
        library_ms = time_ms(lambda: library_call(*args), 20)
        lib_off = int((library_call(*args).long() - rank_count.rank_counts(*args).long()).abs().gt(0).sum())
        print(f"[timing] {name} B={EVAL_BATCH} N={N_ENTITIES} k={K}: wrapper {harness_ms:.4f} ms as the harness "
              f"calls it (aligned tables, e_sq given), {wrapper_ms:.4f} ms on contiguous tables; device "
              f"{device_ms:.4f} ms per bare launch on CUDA events, {profiler_ms:.4f} ms in the profiler "
              f"({device_ms / b_ms:.2f} times the bound {b_ms:.4f} ms, {b_by}; {b_ms / device_ms:.1%} of it); "
              f"{plan.tile_n}x{plan.tile_b} tiles, {plan.blocks} blocks, {per_sm} resident on each of {sms} SMs: "
              f"{waves:.3f} waves; plain {plain_ms:.4f} ms, library {library_ms:.4f} ms ({lib_off} counts differ "
              f"from the kernel)", flush=True)
        record = {
            "name": name,
            "route": "cuda",
            "source": "kb2e_tpu_torch/csrc/rank_count.cu",
            "replaces": "kb2e_tpu/ops/pallas_rank.py:" + ("48" if distance == Distance.L1 else "73"),
            "launches": None,
            "max_abs_err": worst[distance],
            "ms": harness_ms,
            "ms_is": "the wrapper as the harness calls it",
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": library_ms,
            "device_ms": device_ms,
            "profiler_ms": profiler_ms,
            "wrapper_contiguous_ms": wrapper_ms,
            "tiles": plan.blocks,
            "blocks_per_sm": per_sm,
            "waves": waves,
            "bound_share": b_ms / device_ms,
        }
        if results is None:
            print(f"[timing] {name} back to back: nvidia-smi clocks.sm, clocks.max.sm, power.draw: "
                  f"{clocks_under_load(bare_launcher(args)[0])}", flush=True)
            print(f"[timing] {name} by k: {rank_count_k_sweep(distance)}", flush=True)
        else:
            # Every eval path's launches of this kernel: TransE's, then the
            # projecting models' for each flag that ranks by this distance.
            paths = [("eval_transe", results[distance]), ("eval_ptranse", results["ptranse_eval"][distance])] + [
                (f"eval_{model} --distance {int(flag)}", ev) for model in ("transh", "transr")
                for flag, ev in results[f"{model}_eval"].items() if ev["kernel"] == name] + [
                (f"scale {what}", ev) for what, ev in results["quality_scale"].items() if ev["kernel"] == name] + [
                (ev["what"], ev) for ev in results["distributed"]["evals"] if ev["kernel"] == name]
            record["launches"] = sum(ev["launches"] for _, ev in paths)
            # The scale cells' counts are checked against the plain version
            # on TransE K=8's tables only.
            record["max_abs_err"] = max([worst[distance]] + [ev["max_off"] for _, ev in paths
                                                             if ev["max_off"] is not None])
            print(f"[timing] {name}: eval {results[distance]['wall']:.2f} s (ranking alone "
                  f"{results[distance]['rank_wall']:.3f} s) over {results[distance]['launches']} launches; "
                  f"{record['launches']} launches over the eval paths ("
                  + ", ".join(f"{what} {ev['launches']}" for what, ev in paths) + ")", flush=True)
        records.append(record)
    return records


def ranking_alone_phase(reps: int = 3):
    """``harness.rank_all`` alone on FB15k-shaped data (the smoke's
    ``random_kg`` graph, loaded once) and seeded init tables, for TransE
    (one group) and TransR (1,345 relation groups) at each distance,
    ``reps`` times each after one warm-up: the seconds of each run and the
    host seconds spent inside ``rank_count.rank_counts`` (the wrapper, timed
    around each call); then one run under torch.profiler: the device's busy
    time, the rank count's launches and mean device time, and the costliest
    device ops.  It calls only what the port's harness has had since TransR
    was ported, so the same script times an earlier tree of the package in
    turns with this one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.data import triples
    from kb2e_tpu_torch.eval import harness
    from kb2e_tpu_torch.ops import rank_count

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) as work:
        write_fb15k_dir(work)
        dataset = triples.load_dataset(work, splits=("train", "valid", "test"))
    counts, in_wrapper = rank_count.rank_counts, [0.0]

    def timed_counts(*args, **kwargs):
        t0 = time.perf_counter()
        out = counts(*args, **kwargs)
        in_wrapper[0] += time.perf_counter() - t0
        return out

    seconds = {}
    rank_count.rank_counts = timed_counts
    try:
        for model_name in ("transe", "transr"):
            model, params = get_model(model_name), init_tables(model_name, torch.device("cuda"))
            for distance in (Distance.L1, Distance.L2):
                cfg = EmbeddingConfig(embedding_size=K, distance=distance)
                runs, wrapper = [], []
                for _ in range(reps + 1):
                    torch.cuda.synchronize()
                    in_wrapper[0] = 0.0
                    t0 = time.perf_counter()
                    raw, _, sizes = harness.rank_all(model, params, dataset, cfg, device="cuda")
                    runs.append(time.perf_counter() - t0)
                    wrapper.append(in_wrapper[0])
                check(raw.shape[0] == 2 * N_TEST and np.all(raw >= 1), f"{model_name} {distance.name}: ranks out of range")
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    harness.rank_all(model, params, dataset, cfg, device="cuda")
                    torch.cuda.synchronize()
                device = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                                key=lambda e: -e.self_device_time_total)
                kernel = [e for e in device if "rank_count_kernel" in e.key]
                n_kernel = sum(e.count for e in kernel)
                what = f"{model_name} {distance.name}"
                seconds[what] = runs[1:]
                print(f"[ranking] {what}: rank_all {len(sizes)} batches, warm-up {runs[0]:.4f} s, then "
                      + ", ".join(f"{r:.4f}" for r in runs[1:]) + f" s (median {np.median(runs[1:]):.4f}); inside "
                      "rank_counts " + ", ".join(f"{w:.4f}" for w in wrapper[1:]) + " s; profiled run: device busy "
                      f"{sum(e.self_device_time_total for e in device) / 1e3:.2f} ms, rank_count_kernel {n_kernel} x "
                      f"{sum(e.self_device_time_total for e in kernel) / max(n_kernel, 1) / 1e3:.4f} ms; costliest: "
                      + "; ".join(f"{e.key[:60]} {e.count} x {e.self_device_time_total / e.count / 1e3:.4f} ms"
                                  for e in device[:4]), flush=True)
    finally:
        rank_count.rank_counts = counts
    return seconds


def ctransr_timing(ctx, results):
    """CTransR's fast epoch at bench.py's configuration (the loop's walls;
    the breakdown on its trained tables, as TransR's), its clustered eval
    and ranking alone,
    relation prediction and the loader, beside the card's name and power
    limit.  No kernel: CTransR's paths are plain torch on the card."""
    card = card_line()
    fast = results["ctransr_fast"]
    print(f"[timing] {card}: train_ctransr fast at bench.py's configuration: epoch walls "
          + ", ".join(f"{r['wall_s']:.3f} s ({r['triples_per_s']:.0f} triples/s)" for r in fast)
          + f"; build_centers {results['centers_s']:.3f} s", flush=True)
    # One run a part and the profiler on 59 chunks (as TransR's), to leave
    # room in the time limit.
    epoch_breakdown(ctx, "ctransr", results["ctransr_params"], fast_reps=1, profile_window=59, parity=False)
    # The routed sweep's device share on the first groups (the profiler on
    # all 1,345 batches would take longer than the eval).
    from kb2e_tpu_torch import EmbeddingConfig, get_model
    from kb2e_tpu_torch.constants import Distance
    from kb2e_tpu_torch.eval import harness

    dataset, subset = results["ctransr_data"]
    for distance in (Distance.L1, Distance.L2):
        cfg = EmbeddingConfig(embedding_size=K, distance=distance)

        def rank():
            return harness.rank_all(get_model("ctransr"), results["ctransr_params"], dataset, cfg,
                                    test_triples=subset, device="cuda")

        rank()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sizes = rank()[2]
            walls.append((time.perf_counter() - t0) * 1e3)
        busy = device_busy_ms(rank, f"ctransr routed ranking {distance.name}, {len(sizes)} batches")
        wall = float(np.median(walls))
        print(f"[timing] {card}: ctransr routed ranking {distance.name} of {2 * subset[0].shape[0]} queries in "
              f"{len(sizes)} batches: {wall:.3f} ms (median of 3; {wall / len(sizes):.3f} ms a batch), device busy "
              f"{busy:.3f} ms, idle share "
              + (f"{1 - busy / wall:.3f}" if busy > 0 else "not measured (no device time in the profile)"), flush=True)
    print(f"[timing] {card}: eval_ctransr (cluster-routed, plain torch) "
          + "; ".join(f"--distance {int(flag)}: eval {ev['wall']:.2f} s, ranking alone {ev['rank_wall']:.3f} s over "
                      f"{ev['batches']} batches ({ev['rank_wall'] / ev['batches'] * 1e3:.3f} ms a batch)"
                      for flag, ev in results["ctransr_eval"].items()), flush=True)
    print(f"[timing] {card}: relation prediction "
          + "; ".join(f"{name}: eval {r['wall']:.2f} s, scoring alone {r['score_s']:.3f} s, peak "
                      f"{r['peak'] / 2**20:.1f} MiB" for name, r in results["relation"].items()), flush=True)
    ld = results["loader"]
    print(f"[timing] {card}: loading the FB15k-shaped directory: triple parse native {ld['parse']['native']:.3f} s, "
          f"Python {ld['parse']['python']:.3f} s; load_dataset native {ld['dataset']['native']:.3f} s, Python "
          f"{ld['dataset']['python']:.3f} s; read_matrix TransR weights.bern {ld['weights_s']:.3f} s, entity2vec "
          f"{ld['entity_s']:.3f} s", flush=True)


def ptranse_timing(ctx, results):
    """PTransE's fast epoch at bench.py's configuration (the loop's walls;
    the breakdown on its trained tables and the train split's path store),
    its path stores, entity eval through the rank count and relation
    prediction with path evidence, beside the card's name and power limit."""
    import dataclasses

    card = card_line()
    fast = results["ptranse_fast"]
    store_s, store = results["ptranse_store"]
    print(f"[timing] {card}: train_ptranse fast (ADD, 2 hops, 8 paths) at bench.py's configuration: epoch walls "
          + ", ".join(f"{r['wall_s']:.3f} s ({r['triples_per_s']:.0f} triples/s)" for r in fast)
          + f"; train path store {describe_store(store, store_s)}", flush=True)
    data = ctx["train_data"]
    path_data = dataclasses.replace(data, paths=torch.from_numpy(store.rels).cuda(),
                                    path_conf=torch.from_numpy(store.conf).cuda())
    # The profiler on the first 25 of the fast epoch's 100 updates: all of
    # them took 27 s of profiling.
    epoch_breakdown({**ctx, "train_data": path_data}, "ptranse", results["ptranse_params"], parity=False,
                    profile_window=25)
    rel = results["ptranse_relation"]
    print(f"[timing] {card}: eval_ptranse "
          + "; ".join(f"--distance {int(d)}: eval {ev['wall']:.2f} s, ranking alone {ev['rank_wall']:.3f} s over "
                      f"{ev['launches']} launches" for d, ev in results["ptranse_eval"].items())
          + f"; --task relation with path evidence: eval {rel['wall']:.2f} s (the test store "
          f"{rel['test_s']:.3f} s), scoring alone {rel['score_s']:.3f} s (without the evidence {rel['plain_s']:.3f} "
          f"s), peak {rel['peak'] / 2**20:.1f} MiB (scoring alone {rel['score_peak'] / 2**20:.1f} MiB)", flush=True)


def timing_phase(tables, ctx, results):
    lap = time.perf_counter()

    def took(what):
        """Print the seconds since the last call: where the phase's time goes."""
        nonlocal lap
        now = time.perf_counter()
        print(f"[timing] {what} took {now - lap:.1f} s", flush=True)
        lap = now

    records = rank_count_timing(tables, ctx, results)
    took("the rank-count timing")
    records += update_timing(ctx, results)
    took("the TransE update timing")
    records += transe_fast_timing(ctx, results)
    took("the TransE fast-batch timing")
    records.append(transr_fast_timing())
    took("the TransR fast-chunk timing")
    fast = results["fast"]
    print(f"[timing] train_transe fast at bench.py's configuration: epoch walls "
          + ", ".join(f"{r['wall_s']:.3f} s ({r['triples_per_s']:.0f} triples/s)" for r in fast), flush=True)
    epoch_breakdown(ctx, "transe", {"entity": ctx["update_args"][0], "relation": ctx["update_args"][1]})
    lap = time.perf_counter()
    records.append(transh_timing(ctx, results))
    took("the TransH update timing")
    # The profiler on the first 25 of the fast epoch's 100 updates (all of
    # them took 13 s of profiling), to leave room in the time limit.
    epoch_breakdown(ctx, "transh", dict(zip(TRANSH_KEYS, ctx["transh_args"][:3])), profile_window=25)
    lap = time.perf_counter()
    records.append(transr_timing(ctx, results))
    took("the TransR update timing")
    # One fast epoch of TransR a part (5-7 s each) where the others take
    # five, and the profiler on a thirty-second of its fast epoch's 1,888
    # chunks (the whole took 4 minutes, an eighth 28-35 s), to leave room for
    # the scale and distributed phases in the time limit.
    epoch_breakdown(ctx, "transr", dict(zip(TRANSR_KEYS, ctx["transr_args"][:3])), fast_reps=1, profile_window=59)
    lap = time.perf_counter()
    ctransr_timing(ctx, results)
    took("the CTransR timing")
    ptranse_timing(ctx, results)
    took("the PTransE timing")
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
    if sys.argv[1:2] == ["--quality-scale"]:
        # The scale-quality cells of the named models (all five without one).
        models = sys.argv[2:] or None
        check(all(m in {c[1] for c in SCALE_CELLS} for m in models or ()), f"--quality-scale takes model names of "
              f"{sorted({c[1] for c in SCALE_CELLS})}, got {models}")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) as work:
            results = phase("scale", quality_scale_path, work, models)
        print(json.dumps({what: {k: v for k, v in ev.items() if k != "kernel"} for what, ev in results.items()}))
        print(card)
        return 0
    if sys.argv[1:] == ["--rank-count-only"]:
        # The rank count's checks and timing alone, for work on that kernel.
        tables = init_tables("transe", torch.device("cuda"))
        ctx = phase("kernels", lambda: dict(rank_worst=rank_kernel_checks(tables)))
        records = phase("timing", rank_count_timing, tables, ctx, None)
        print(card)
        print(json.dumps({"kernels": records}))
        return 0
    if sys.argv[1:] == ["--transr-fast-only"]:
        # TransR's fast-chunk kernels alone: their checks and timing.
        records = [phase("timing", transr_fast_timing)]
        print(card)
        print(json.dumps({"kernels": records}))
        return 0
    if sys.argv[1:] == ["--ranking-alone"]:
        print(json.dumps(phase("ranking", ranking_alone_phase)))
        print(card)
        return 0
    tables, transh, transr = (init_tables(model, torch.device("cuda")) for model in ("transe", "transh", "transr"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) as work:
        data_dir, out_dir, transh_dir, transr_dir = phase("data", data_phase, tables, transh, transr, work)
        if sys.argv[1:] == ["--distributed-only"]:
            # The distributed phase alone, for work on that path.
            print(json.dumps({"walls": phase("distributed", distributed_phase, work)["walls"]}))
            print(card)
            return 0
        if sys.argv[1:] == ["--nccl-cards"]:
            # The production paths over NCCL across every card of the host.
            print(json.dumps({"walls": phase("nccl", nccl_cards_phase, work)}))
            print(card)
            return 0
        ctx = phase("kernels", kernels_phase, tables, transh, transr, data_dir, work)
        results = phase("main", main_phase, work, data_dir, out_dir, transh_dir, transr_dir)
        results["quality_scale"] = phase("scale", quality_scale_path, work, DEFAULT_SCALE_MODELS)
        results["distributed"] = phase("distributed", distributed_phase, work)
        records = phase("timing", timing_phase, tables, ctx, results)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
