"""The hand-written CUDA kernels against their plain versions, on the card:
the rank count (K1/K2), the sequential TransE update (K3), the sequential
TransH update (K4) and the sequential TransR update (K5); TransR's (its
kernel turned off) and CTransR's fast chunks replayed as a CUDA graph by the
epoch runner against the same chunks run eagerly; and TransE's fast batch as two kernels
(``ops/transe_fast.py``) against ``fused_table_update`` run eagerly.  K3, K4 and K5 run
samples that share no row side by side; batches built to stress that
schedule (a chain of the whole batch, no shared row at all, fewer samples
than resident blocks, no update at all) hold them bit-equal to their plain
versions at widths up to their largest.

Marked ``cuda``: without a CUDA device every test here skips.  This file
imports neither jax nor kb2e_tpu, so it also runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base, ctransr, get_model
from kb2e_tpu_torch.ops import cuda_build, distances, rank_count, schedule, transe_update, transh_update, transr_update
from kb2e_tpu_torch.parallel import eval as par_eval
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(n, k, b, distance, dev, seed, dyadic=True):
    rng = np.random.default_rng(seed)
    ent = rng.normal(size=(n, k))
    q = rng.normal(size=(b, k))
    if dyadic:
        ent, q = np.round(ent * 8) / 8, np.round(q * 8) / 8
    ent, q = torch.from_numpy(ent.astype(np.float32)).to(dev), torch.from_numpy(q.astype(np.float32)).to(dev)
    ent[n // 2:n // 2 + 5] = ent[:5]  # twins: ties broken by id
    t = torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(dev)
    t[:2] = torch.tensor([n // 2 + 1, 2], dtype=torch.int32)
    e_true = distances.residual_energy(ent[t.long()] - q, distance).contiguous()
    return ent.T.contiguous(), q.T.contiguous(), e_true, t, distance


def _bare_counts(args):
    """One launch on the harness's aligned layout, with ‖e‖² and ‖q‖²
    computed as the wrapper computes them."""
    proj_t, queries_t, e_true, t, distance = args
    e_sq = q_sq = None
    if distance == Distance.L2:
        e_sq, q_sq = distances.squared_norms(proj_t), distances.squared_norms(queries_t)
    out = torch.zeros(queries_t.shape[1], dtype=torch.int32, device=proj_t.device)
    proj_t, queries_t = (rank_count.aligned_transpose(x.T) for x in (proj_t, queries_t))
    rank_count.launcher(proj_t, queries_t, e_true, t, e_sq, q_sq, out, distance)()
    torch.cuda.synchronize()
    return out


# Ragged against the tile (128 entities x 256 queries x 16 k-rows a chunk)
# and FB15k's N = 14,951, whose contiguous rows are not 16-byte aligned (the
# wrapper pads a copy).
@pytest.mark.parametrize("n,k,b", [(200, 12, 21), (257, 33, 32), (1000, 100, 250), (14951, 100, 256),
                                   (127, 16, 128), (128, 17, 129), (129, 15, 127), (128, 1, 127),
                                   (129, 100, 128), (127, 100, 129), (14951, 100, 250), (14951, 1, 3)])
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_kernel_equals_plain_version_on_dyadic_inputs(cuda, n, k, b, distance):
    args = _args(n, k, b, distance, cuda, seed=n + k + b)
    cuda_build.reset_launch_counts()
    got = rank_count.rank_counts(*args)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {rank_count.KERNEL_NAMES[distance]: 1}
    want = rank_count.rank_counts_reference(*args)
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert torch.equal(got, want)
    assert dict(cuda_build.launch_counts) == {rank_count.KERNEL_NAMES[distance]: 1}
    # Integer atomics: the same counts on every run.
    assert torch.equal(rank_count.rank_counts(*args), got)


# The tile's edges: n and b one below, at and one above the tile (and two
# tiles of entities), k = 1, a chunk - 1, a chunk, a chunk + 1 and 100.
@pytest.mark.parametrize("k_of", ["1", "chunk - 1", "chunk", "chunk + 1", "100"])
@pytest.mark.parametrize("dn,db", [(-1, -1), (0, 0), (1, 1), (-1, 1), (1, -1), (129, 0)])
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_kernel_equals_plain_version_at_the_tile_edges(cuda, dn, db, k_of, distance):
    plan = rank_count.plan(1, 1, 1)
    k = {"1": 1, "chunk - 1": plan.chunk - 1, "chunk": plan.chunk, "chunk + 1": plan.chunk + 1, "100": 100}[k_of]
    n, b = plan.tile_n + dn, plan.tile_b + db
    args = _args(n, k, b, distance, cuda, seed=n + k + b)
    want = rank_count.rank_counts_reference(*args)
    assert torch.equal(_bare_counts(args), want)
    assert torch.equal(rank_count.rank_counts(*args), want)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_kernel_near_plain_version_on_unrounded_inputs(cuda, distance):
    args = _args(3000, 100, 256, distance, cuda, seed=5, dyadic=False)
    diff = (rank_count.rank_counts(*args).long() - rank_count.rank_counts_reference(*args).long()).abs()
    # Sums over k in one order on both sides; only fused-vs-unfused rounding
    # may move an energy across a near tie.
    assert int((diff > 0).sum()) <= 1 and int(diff.max()) <= 2


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_kernel_equals_plain_version_on_near_ties(cuda, distance):
    # Each query's entities are the query moved by a permutation of one
    # offset: equally far in exact arithmetic, so their float energies (and
    # the true one, by the direct formula) tie to within a few ulps, and a
    # count moves if the two sums round one step apart.  The plain version's
    # addcmul rounds once on the card, as the kernel's fmaf.
    rng = np.random.default_rng(6)
    k, b, per = 100, 32, 64
    q = rng.normal(size=(b, k)) * 0.1
    d = rng.normal(size=(b, k)) * 0.1
    ent = np.concatenate([q[i] + d[i][rng.permutation(k)][None, :] for i in range(b) for _ in range(per)])
    ent = torch.from_numpy(ent.astype(np.float32)).to(cuda)
    queries = torch.from_numpy(q.astype(np.float32)).to(cuda)
    true_idx = torch.arange(b, dtype=torch.int32, device=cuda) * per
    e_true = distances.residual_energy(ent[true_idx.long()] - queries, distance).contiguous()
    args = (ent.T.contiguous(), queries.T.contiguous(), e_true, true_idx, distance)
    got, want = rank_count.rank_counts(*args), rank_count.rank_counts_reference(*args)
    assert int((got > 0).sum()) > b // 2  # near ties do move counts
    assert torch.equal(got, want)
    assert torch.equal(_bare_counts(args), want)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_padded_leading_dimension_gives_the_counts_of_the_contiguous_table(cuda, distance):
    proj_t, queries_t, e_true, t, _ = _args(14951, 100, 250, distance, cuda, seed=3, dyadic=False)
    want = rank_count.rank_counts(proj_t, queries_t, e_true, t, distance)
    aligned = rank_count.aligned_transpose(proj_t.T)
    wide = torch.full((100, 15000), float("nan"), device=cuda)[:, :14951]  # NaN pad columns are never counted
    wide.copy_(proj_t)
    for table in (aligned, wide):
        assert rank_count.kernel_takes(table) and table.stride(0) != 14951
        assert torch.equal(rank_count.rank_counts(table, queries_t, e_true, t, distance), want)
        assert torch.equal(rank_count.rank_counts(table, rank_count.aligned_transpose(queries_t.T), e_true, t,
                                                  distance), want)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_passing_e_sq_gives_the_counts_of_not_passing_it(cuda, distance):
    proj_t, queries_t, e_true, t, _ = _args(14951, 100, 256, distance, cuda, seed=4, dyadic=False)
    aligned = rank_count.aligned_transpose(proj_t.T)
    e_sq = distances.squared_norms(aligned)
    assert torch.equal(e_sq, distances.squared_norms(proj_t))
    want = rank_count.rank_counts(proj_t, queries_t, e_true, t, distance)
    assert torch.equal(rank_count.rank_counts(aligned, queries_t, e_true, t, distance, e_sq=e_sq), want)
    assert torch.equal(rank_count.rank_counts_reference(proj_t, queries_t, e_true, t, distance, e_sq=e_sq),
                       rank_count.rank_counts_reference(proj_t, queries_t, e_true, t, distance))


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_tile_takes_fb15k_in_one_wave(cuda, distance):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = rank_count.plan(100, 14951, 256)
    per_sm = rank_count.resident_blocks_per_sm(distance)
    # 128 registers a thread at most: a block of 512 threads fits.
    assert per_sm >= 1 and plan.waves(per_sm, sms) <= 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    proj_t, queries_t, e_true, t, distance = _args(64, 8, 16, Distance.L1, cuda, seed=0)
    bad = [
        (proj_t.double(), queries_t, e_true, t),
        (proj_t, queries_t.T, e_true, t),  # not contiguous
        (proj_t, queries_t, e_true, t.long()),
        (proj_t, queries_t, e_true.cpu(), t),
        (proj_t, queries_t[:, :8].contiguous(), e_true, t),
        (proj_t.T.contiguous().T, queries_t, e_true, t),  # columns, not rows, contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError, match="rank_counts"):
            rank_count.rank_counts(*args, distance)
    with pytest.raises(ValueError, match="e_sq"):
        rank_count.rank_counts(proj_t, queries_t, e_true, t, Distance.L2, e_sq=torch.ones(63, device=cuda))


def _update_case(n, n_rel, k, b, seed, dev, dyadic=True):
    """A snapshot, a batch with self-loops (h == t, h' == t'), invalid samples
    and shared rows, on ``dev``."""
    rng = np.random.default_rng(seed)
    ent = rng.normal(size=(n, k)) * 0.4
    rel = rng.normal(size=(n_rel, k)) * 0.4
    if dyadic:  # every energy exact in any order: equal decisions and loss
        ent, rel = np.round(ent * 8) / 8, np.round(rel * 8) / 8
    ph, pt, nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(4))
    pt[: b // 4] = ph[: b // 4]
    nt[b // 8: b // 4] = nh[b // 8: b // 4]
    nh[b // 4: b // 2] = pt[b // 4: b // 2]  # the corrupted triple reads a row just written
    r = rng.integers(0, n_rel, b).astype(np.int32)
    valid = rng.random(b) > 0.1
    tensors = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (ent, rel)]
    tensors += [torch.from_numpy(a).to(dev) for a in (ph, pt, r, nh, nt, valid)]
    return tensors


@pytest.mark.parametrize("n,n_rel,k,b", [(40, 6, 16, 32), (64, 5, 12, 100), (300, 20, 33, 257),
                                         (2000, 50, 100, 1000), (500, 30, 200, 300)])
@pytest.mark.parametrize("l1", [True, False])
def test_update_kernel_equals_plain_version_on_dyadic_snapshots(cuda, n, n_rel, k, b, l1):
    args = _update_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=l1)
    cuda_build.reset_launch_counts()
    ent, rel, loss, viol = transe_update.transe_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    name = transe_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]
    assert dict(cuda_build.launch_counts) == {name: 1}
    want = transe_update.transe_sequential_update_reference(*args, **kw)
    assert dict(cuda_build.launch_counts) == {name: 1}
    assert torch.equal(viol, want[3]) and 0 < int(viol.sum()) < b
    assert float(loss) == float(want[2])
    assert torch.equal(ent, want[0]) and torch.equal(rel, want[1])
    # The snapshot is not written.
    assert torch.equal(args[0], _update_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)[0])


@pytest.mark.parametrize("l1", [True, False])
def test_update_kernel_near_plain_version_on_unrounded_tables(cuda, l1):
    # Bit for bit: the plain version sums over k in the kernel's order.
    args = _update_case(3000, 100, 100, 2000, seed=4, dev=cuda, dyadic=False)
    kw = dict(learning_rate=0.01, margin=1.0, l1=l1)
    ent, rel, loss, viol = transe_update.transe_sequential_update(*args, **kw)
    want = transe_update.transe_sequential_update_reference(*args, **kw)
    assert torch.equal(viol, want[3])
    assert float(loss) == float(want[2])
    assert torch.equal(ent, want[0]) and torch.equal(rel, want[1])


def test_update_kernel_leaves_an_all_invalid_batch_alone(cuda):
    args = _update_case(50, 4, 16, 40, seed=1, dev=cuda)
    args[-1] = torch.zeros_like(args[-1])
    ent, rel, loss, viol = transe_update.transe_sequential_update(*args, learning_rate=0.05, margin=1.0, l1=True)
    assert torch.equal(ent, args[0]) and torch.equal(rel, args[1]) and float(loss) == 0.0
    assert not viol.any()


def test_update_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = _update_case(50, 4, 16, 40, seed=2, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=True)
    bad = {
        0: args[0].double(),
        1: args[1].T.contiguous().T,  # not contiguous
        2: args[2].long(),
        7: args[7].int(),  # valid must be bool
        3: args[3].cpu(),
    }
    for i, x in bad.items():
        with pytest.raises(ValueError, match="must be a contiguous"):
            transe_update.transe_sequential_update(*args[:i], x, *args[i + 1:], **kw)
    out_of_range = args[4].clone()
    out_of_range[3] = 50
    with pytest.raises(ValueError, match="fall outside"):
        transe_update.transe_sequential_update(*args[:4], out_of_range, *args[5:], **kw)


def test_parity_update_on_the_card_takes_the_kernel_under_every_impl_but_scan(cuda):
    args = _update_case(50, 4, 16, 40, seed=3, dev=cuda)
    params = {"entity": args[0], "relation": args[1]}
    batch = dict(zip(("ph", "pt", "r", "nh", "nt", "valid"), args[2:]))
    cfg = EmbeddingConfig(embedding_size=16, learning_rate=0.05, update_mode="parity")
    for impl in ("auto", "pallas"):
        cuda_build.reset_launch_counts()
        get_model("transe").sequential_update(params, batch, cfg.replace(parity_impl=impl))
        assert dict(cuda_build.launch_counts) == {"transe_update_l1": 1}
    with pytest.raises(ValueError, match="parity_impl='scan'"):
        get_model("transe").sequential_update(params, batch, cfg.replace(parity_impl="scan"))


def _transh_case(n, n_rel, k, b, seed, dev):
    """A TransH snapshot (unit normals) and a batch with self-loops (h == t,
    h' == t'), invalid samples and shared rows, on ``dev``."""
    rng = np.random.default_rng(seed)
    ent, rel = rng.normal(size=(n, k)) * 0.4, rng.normal(size=(n_rel, k)) * 0.4
    w = rng.normal(size=(n_rel, k))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    ph, pt, nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(4))
    pt[: b // 4] = ph[: b // 4]
    nt[b // 8: b // 4] = nh[b // 8: b // 4]
    nh[b // 4: b // 2] = pt[b // 4: b // 2]  # the corrupted triple reads a row just written
    r = rng.integers(0, n_rel, b).astype(np.int32)
    valid = rng.random(b) > 0.1
    tensors = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (ent, rel, w)]
    tensors += [torch.from_numpy(a).to(dev) for a in (ph, pt, r, nh, nt, valid)]
    return tensors


@pytest.mark.parametrize("n,n_rel,k,b", [(40, 6, 12, 32), (64, 5, 16, 100), (300, 20, 33, 257),
                                         (2000, 50, 100, 300), (500, 30, 200, 200)])
@pytest.mark.parametrize("max_iters", [1, 2, 16])
def test_transh_kernel_equals_plain_version_bit_for_bit(cuda, n, n_rel, k, b, max_iters):
    # Unrounded tables: the plain version rounds every step as the kernel
    # does and sums over k in its order, so decisions, trips, loss and all
    # three tables agree exactly.
    args = _transh_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, max_iters=max_iters)
    cuda_build.reset_launch_counts()
    got = transh_update.transh_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {"transh_update": 1}
    want = transh_update.transh_sequential_update_reference(*args, **kw)
    assert dict(cuda_build.launch_counts) == {"transh_update": 1}
    assert torch.equal(got[4], want[4]) and 0 < int(got[4].sum()) < b
    assert torch.equal(got[5], want[5]) and int(got[5].sum()) > 0
    assert float(got[3]) == float(want[3])
    for table, plain in zip(got[:3], want[:3]):
        assert torch.equal(table, plain)
    # The snapshot is not written.
    assert torch.equal(args[0], _transh_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)[0])


def test_transh_kernel_leaves_an_all_invalid_batch_alone(cuda):
    args = _transh_case(50, 4, 16, 40, seed=1, dev=cuda)
    args[-1] = torch.zeros_like(args[-1])
    got = transh_update.transh_sequential_update(*args, learning_rate=0.05, margin=1.0, max_iters=16)
    assert all(torch.equal(g, x) for g, x in zip(got[:3], args[:3])) and float(got[3]) == 0.0
    assert not got[4].any() and not got[5].any()


def test_transh_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = _transh_case(50, 4, 16, 40, seed=2, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, max_iters=16)
    bad = {
        0: args[0].double(),
        2: args[2][:3].contiguous(),  # norm of the wrong shape
        1: args[1].T.contiguous().T,  # not contiguous
        3: args[3].long(),
        8: args[8].int(),  # valid must be bool
        4: args[4].cpu(),
    }
    for i, x in bad.items():
        with pytest.raises(ValueError, match="must be a contiguous"):
            transh_update.transh_sequential_update(*args[:i], x, *args[i + 1:], **kw)
    out_of_range = args[5].clone()
    out_of_range[3] = 4  # a relation id past R
    with pytest.raises(ValueError, match="fall outside"):
        transh_update.transh_sequential_update(*args[:5], out_of_range, *args[6:], **kw)
    wide = _transh_case(8, 2, 1025, 4, seed=3, dev=cuda)
    with pytest.raises(ValueError, match="k = 1025"):
        transh_update.transh_sequential_update(*wide, **kw)


def test_transh_parity_on_the_card_takes_the_kernel_under_every_impl_but_scan(cuda):
    args = _transh_case(50, 4, 16, 40, seed=3, dev=cuda)
    params = dict(zip(("entity", "relation", "norm"), args[:3]))
    batch = dict(zip(("ph", "pt", "r", "nh", "nt", "valid"), args[3:]))
    cfg = EmbeddingConfig(embedding_size=16, learning_rate=0.05, update_mode="parity")
    for impl in ("auto", "pallas"):
        cuda_build.reset_launch_counts()
        out, _ = get_model("transh").sequential_update(params, batch, cfg.replace(parity_impl=impl))
        assert dict(cuda_build.launch_counts) == {"transh_update": 1}
        assert set(out) == set(params)
    with pytest.raises(ValueError, match="parity_impl='scan'"):
        get_model("transh").sequential_update(params, batch, cfg.replace(parity_impl="scan"))


def _transr_case(n, n_rel, k, b, seed, dev):
    """A TransR snapshot (unit rows, W = I + noise) and a batch with
    self-loops (h == t, h' == t'), invalid samples and shared rows, on ``dev``."""
    rng = np.random.default_rng(seed)
    ent, rel = rng.normal(size=(n, k)), rng.normal(size=(n_rel, k))
    ent /= np.linalg.norm(ent, axis=1, keepdims=True)
    rel /= np.linalg.norm(rel, axis=1, keepdims=True)
    w = np.eye(k) + rng.normal(size=(n_rel, k, k)) * 0.15
    ph, pt, nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(4))
    pt[: b // 4] = ph[: b // 4]
    nt[b // 8: b // 4] = nh[b // 8: b // 4]
    nh[b // 4: b // 2] = pt[b // 4: b // 2]  # the corrupted triple reads a row just written
    r = rng.integers(0, n_rel, b).astype(np.int32)
    r[b // 2: b // 2 + 4] = r[0]  # a relation's W written, then read again
    valid = rng.random(b) > 0.1
    tensors = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (ent, rel, w)]
    tensors += [torch.from_numpy(a).to(dev) for a in (ph, pt, r, nh, nt, valid)]
    return tensors


# k = 224 is MAX_K: its working W_r (224 x 225 floats) needs the dynamic
# shared-memory opt-in above 48 KB.
@pytest.mark.parametrize("n,n_rel,k,b", [(40, 6, 12, 32), (64, 5, 16, 40), (300, 20, 33, 32),
                                         (2000, 50, 100, 16), (500, 8, transr_update.MAX_K, 8)])
@pytest.mark.parametrize("max_iters", [1, 2, 16])
@pytest.mark.parametrize("l1", [True, False])
def test_transr_kernel_equals_plain_version_bit_for_bit(cuda, n, n_rel, k, b, max_iters, l1):
    # Unrounded tables: the plain version rounds every step as the kernel
    # does and sums in its orders, so decisions, trips, loss and all three
    # tables agree exactly.
    args = _transr_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=l1, max_iters=max_iters)
    name = transr_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]
    cuda_build.reset_launch_counts()
    got = transr_update.transr_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {name: 1}
    want = transr_update.transr_sequential_update_reference(*args, **kw)
    assert dict(cuda_build.launch_counts) == {name: 1}
    assert torch.equal(got[4], want[4]) and 0 < int(got[4].sum()) < b
    assert torch.equal(got[5], want[5]) and int(got[5][:, 0].sum()) > 0
    if max_iters == 1:
        assert int(got[5][:, 1].sum()) > 0  # the capped exit ran
    assert float(got[3]) == float(want[3])
    for table, plain in zip(got[:3], want[:3]):
        assert torch.equal(table, plain)
    # The snapshot is not written.
    assert torch.equal(args[2], _transr_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)[2])


def test_transr_kernel_leaves_an_all_invalid_batch_alone(cuda):
    args = _transr_case(50, 4, 16, 40, seed=1, dev=cuda)
    args[-1] = torch.zeros_like(args[-1])
    for l1 in (True, False):
        got = transr_update.transr_sequential_update(*args, learning_rate=0.05, margin=1.0, l1=l1, max_iters=16)
        assert all(torch.equal(g, x) for g, x in zip(got[:3], args[:3])) and float(got[3]) == 0.0
        assert not got[4].any() and not got[5].any()


def test_transr_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = _transr_case(50, 4, 16, 40, seed=2, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=True, max_iters=16)
    bad = {
        0: args[0].double(),
        2: args[2][:, :8].contiguous(),  # proj of the wrong shape
        1: args[1].T.contiguous().T,  # not contiguous
        3: args[3].long(),
        8: args[8].int(),  # valid must be bool
        4: args[4].cpu(),
    }
    for i, x in bad.items():
        with pytest.raises(ValueError, match="must be a contiguous"):
            transr_update.transr_sequential_update(*args[:i], x, *args[i + 1:], **kw)
    out_of_range = args[5].clone()
    out_of_range[3] = 4  # a relation id past R
    with pytest.raises(ValueError, match="fall outside"):
        transr_update.transr_sequential_update(*args[:5], out_of_range, *args[6:], **kw)
    out_of_range = args[6].clone()
    out_of_range[0] = -1  # an entity id below 0
    with pytest.raises(ValueError, match="fall outside"):
        transr_update.transr_sequential_update(*args[:6], out_of_range, *args[7:], **kw)
    wide = _transr_case(8, 2, transr_update.MAX_K + 1, 4, seed=3, dev=cuda)
    with pytest.raises(ValueError, match=f"k = {transr_update.MAX_K + 1}"):
        transr_update.transr_sequential_update(*wide, **kw)


def test_transr_parity_on_the_card_takes_the_kernel_under_every_impl_but_scan(cuda):
    args = _transr_case(50, 4, 16, 40, seed=3, dev=cuda)
    params = dict(zip(("entity", "relation", "proj"), args[:3]))
    batch = dict(zip(("ph", "pt", "r", "nh", "nt", "valid"), args[3:]))
    cfg = EmbeddingConfig(embedding_size=16, learning_rate=0.05, update_mode="parity", distance=1)
    for impl in ("auto", "pallas"):
        cuda_build.reset_launch_counts()
        out, _ = get_model("transr").sequential_update(params, batch, cfg.replace(parity_impl=impl))
        assert dict(cuda_build.launch_counts) == {"transr_update_l2": 1}
        assert set(out) == set(params)
    with pytest.raises(ValueError, match="parity_impl='scan'"):
        get_model("transr").sequential_update(params, batch, cfg.replace(parity_impl="scan"))


STRESS = ("one relation", "distinct rows", "one entity", "smaller than the grid", "all invalid")


def _stress_case(model, kind, k, b, seed, dev):
    """Tables as _update_case's (unrounded), _transh_case's or _transr_case's,
    and a batch of one
    ``kind``: every sample on relation 0 (one chain of the whole batch); no
    row shared by two samples; entity 0 in every sample (in h, t, h', t' in
    turn); 3 valid samples whose corrupted triple is the positive one, so
    all update, fewer than the update pass's resident blocks; or no valid
    sample."""
    rng = np.random.default_rng(seed)
    if kind == "smaller than the grid":
        b = 3
    n, n_rel = (4 * b + 8, b + 3) if kind == "distinct rows" else (max(40, b), 6)
    ent, rel = rng.normal(size=(n, k)), rng.normal(size=(n_rel, k))
    if model == "transe":
        tables = (ent * 0.4, rel * 0.4)
    elif model == "transh":
        ent, rel = ent * 0.4, rel * 0.4
        w = rng.normal(size=(n_rel, k))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        tables = (ent, rel, w)
    else:
        ent /= np.linalg.norm(ent, axis=1, keepdims=True)
        rel /= np.linalg.norm(rel, axis=1, keepdims=True)
        w = np.eye(k) + rng.normal(size=(n_rel, k, k)) * 0.15
        tables = (ent, rel, w)
    if kind == "distinct rows":
        ph, pt, nh, nt = rng.permutation(n)[:4 * b].reshape(4, b).astype(np.int32)
        r = rng.permutation(n_rel)[:b].astype(np.int32)
    else:
        ph, pt, nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(4))
        r = rng.integers(0, n_rel, b).astype(np.int32)
    if kind == "one relation":
        r[:] = 0
    if kind == "smaller than the grid":  # e_n == e_p: every valid sample updates
        nh, nt = ph.copy(), pt.copy()
    if kind == "one entity":
        for j, ids in enumerate((ph, pt, nh, nt)):
            ids[j::4] = 0
    valid = np.full(b, kind != "all invalid") if kind in ("all invalid", "smaller than the grid") else rng.random(b) > 0.1
    tensors = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in tables]
    tensors += [torch.from_numpy(a).to(dev) for a in (ph, pt, r, nh, nt, valid)]
    return tensors


def _assert_stress_result(kind, args, got, want, m=3):
    """Bit for bit: decisions, trips (K4, K5), loss and all m tables; and
    the schedule the batch was built for.  The outputs are the m tables, the
    loss, the decisions, then the trips."""
    assert torch.equal(got[m + 1], want[m + 1])
    assert all(torch.equal(g, w) for g, w in zip(got[m + 2:], want[m + 2:]))
    assert float(got[m]) == float(want[m])
    for table, plain in zip(got[:m], want[:m]):
        assert torch.equal(table, plain)
    viol = got[m + 1]
    n_viol = int(viol.sum())
    if kind == "all invalid":
        assert n_viol == 0 and all(torch.equal(g, x) for g, x in zip(got[:m], args[:m]))
        return
    assert n_viol > 0
    ph, pt, r, nh, nt = args[m:m + 5]
    pred = schedule.row_predecessors(schedule.update_rows(ph, pt, nh, nt, r, args[0].shape[0]), viol)
    depth = schedule.chain_levels(pred, viol).max()
    if kind in ("one relation", "one entity"):
        assert depth == n_viol
    elif kind == "distinct rows":
        assert depth == 1


@pytest.mark.parametrize("k,b", [(12, 256), (33, 192), (100, 96), (transe_update.MAX_K, 24)])
@pytest.mark.parametrize("kind", STRESS)
@pytest.mark.parametrize("l1", [True, False])
def test_transe_kernel_equals_plain_version_on_stress_batches(cuda, kind, k, b, l1):
    args = _stress_case("transe", kind, k, b, seed=k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=l1)
    cuda_build.reset_launch_counts()
    got = transe_update.transe_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {transe_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]: 1}
    _assert_stress_result(kind, args, got, transe_update.transe_sequential_update_reference(*args, **kw), m=2)


@pytest.mark.parametrize("k,b", [(12, 256), (33, 192), (100, 96), (transh_update.MAX_K, 24)])
@pytest.mark.parametrize("kind", STRESS)
def test_transh_kernel_equals_plain_version_on_stress_batches(cuda, kind, k, b):
    args = _stress_case("transh", kind, k, b, seed=k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, max_iters=16)
    cuda_build.reset_launch_counts()
    got = transh_update.transh_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {"transh_update": 1}
    _assert_stress_result(kind, args, got, transh_update.transh_sequential_update_reference(*args, **kw))


# The plain version of K5 takes some thousands of small launches a sample,
# more at larger k: the batches shrink as k grows.
@pytest.mark.parametrize("k,b", [(12, 96), (33, 64), (100, 24), (transr_update.MAX_K, 6)])
@pytest.mark.parametrize("kind", STRESS)
@pytest.mark.parametrize("l1", [True, False])
def test_transr_kernel_equals_plain_version_on_stress_batches(cuda, kind, k, b, l1):
    args = _stress_case("transr", kind, k, b, seed=k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=l1, max_iters=16)
    cuda_build.reset_launch_counts()
    got = transr_update.transr_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_build.launch_counts) == {transr_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]: 1}
    _assert_stress_result(kind, args, got, transr_update.transr_sequential_update_reference(*args, **kw))


@pytest.mark.parametrize("module,k", [(transe_update, 100), (transe_update, transe_update.MAX_K),
                                      (transh_update, 100), (transh_update, transh_update.MAX_K),
                                      (transr_update, 100), (transr_update, transr_update.MAX_K)])
def test_update_pass_fits_several_blocks_per_sm_at_fb15k_width(cuda, module, k):
    per_sm = module.resident_blocks_per_sm(k)
    assert per_sm >= (1 if k == module.MAX_K else 4)


# --- PTransE: entity eval through the rank count, relation evidence, the update ---------


def _ptranse_kg(tmp_path, k):
    """A small planted KG on disk and dyadic PTransE tables (multiples of 1/8:
    every energy, composition and evidence term is exact in float32)."""
    from kb2e_tpu_torch.data import synthetic, triples

    synthetic.write_kg_dir(str(tmp_path), synthetic.planted_kg(300, 12, 4_000, seed=3), 300, 12, seed=3)
    dataset = triples.load_dataset(str(tmp_path), splits=("train", "valid", "test"), use_native=False)
    rng = np.random.default_rng(4)

    def dy(*shape):
        return torch.from_numpy(np.clip(np.round(rng.normal(size=shape) * 3) / 8, -1, 1).astype(np.float32))

    return dataset, {"entity": dy(300, k), "relation": dy(12, k), "relation_inv": dy(12, k)}


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_ptranse_entity_ranks_through_the_rank_count_equal_the_plain_version(cuda, tmp_path, distance):
    from kb2e_tpu_torch.eval import harness

    dataset, host = _ptranse_kg(tmp_path, 24)
    cfg = EmbeddingConfig(embedding_size=24, distance=distance)
    cuda_build.reset_launch_counts()
    card = harness.rank_all(get_model("ptranse"), {k: v.to(cuda) for k, v in host.items()}, dataset, cfg,
                            device=cuda)
    n_batches = -(-2 * dataset.test[0].shape[0] // cfg.eval_batch_size)
    assert cuda_build.launch_counts == {rank_count.KERNEL_NAMES[distance]: n_batches}  # one group, one a batch
    cpu = harness.rank_all(get_model("ptranse"), host, dataset, cfg, device="cpu")
    for got, want in zip(card, cpu):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("comp", ["add", "mul"])
def test_ptranse_relation_ranks_with_evidence_on_the_card_equal_the_cpus(cuda, tmp_path, comp, monkeypatch):
    from kb2e_tpu_torch.data import paths
    from kb2e_tpu_torch.eval import harness

    dataset, host = _ptranse_kg(tmp_path, 16)
    train = dataset.train
    store = paths.build_path_store(train.heads, train.tails, train.rels, train.n_relations, max_paths=6,
                                   use_native=False, n_entities=dataset.n_entities,
                                   query_pairs=(dataset.test[0], dataset.test[1]))
    cfg = EmbeddingConfig(embedding_size=16, path_composition=comp)
    m = get_model("ptranse")
    cuda_build.reset_launch_counts()
    card = harness.relation_ranks(m, {k: v.to(cuda) for k, v in host.items()}, dataset, cfg, path_store=store,
                                  device=cuda)
    assert not cuda_build.launch_counts
    cpu = harness.relation_ranks(m, host, dataset, cfg, path_store=store, device="cpu")
    plain = harness.relation_ranks(m, host, dataset, cfg, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(card, cpu)) and not np.array_equal(card[0], plain[0])
    # R in slices of 5 relations: the same ranks.
    monkeypatch.setattr(harness, "RELATION_SLICE_BYTES", cfg.eval_batch_size * 6 * 5 * 16 * 4)
    sliced = harness.relation_ranks(m, {k: v.to(cuda) for k, v in host.items()}, dataset, cfg, path_store=store,
                                    device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(sliced, cpu))


@pytest.mark.parametrize("comp", ["add", "mul", "rnn"])
def test_ptranse_update_on_the_card_equals_the_cpu(cuda, comp):
    rng = np.random.default_rng(5)
    n, n_rel, k, b, p = 200, 9, 32, 300, 6
    host = {name: torch.from_numpy((rng.normal(size=(rows, k)) * 0.2).astype(np.float32))
            for name, rows in (("entity", n), ("relation", n_rel), ("relation_inv", n_rel))}
    if comp == "rnn":
        host["comp_w"] = torch.from_numpy((np.concatenate([np.eye(k)] * 2) * 0.5).astype(np.float32))
    hops = rng.integers(0, 2 * n_rel, (b, p, 2)).astype(np.int32)
    hops[rng.random(hops.shape) < 0.2] = -1
    batch = {key: torch.from_numpy(rng.integers(0, n_rel if key in ("r", "nr") else n, b).astype(np.int32))
             for key in ("ph", "pt", "r", "nh", "nt", "nr")}
    batch.update(valid=torch.from_numpy(rng.random(b) > 0.1), nr_valid=torch.from_numpy(rng.random(b) > 0.1),
                 paths=torch.from_numpy(hops), conf=torch.from_numpy(rng.random((b, p)).astype(np.float32)))
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=0.05, path_composition=comp)
    m = get_model("ptranse")
    want, want_loss = m.batch_update(host, batch, cfg)
    got, loss = m.batch_update({key: v.to(cuda) for key, v in host.items()},
                               {key: v.to(cuda) for key, v in batch.items()}, cfg)
    for key in want:
        assert torch.allclose(got[key].cpu(), want[key], rtol=0, atol=1e-5), key
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)


@pytest.mark.parametrize("first", [0, 7476, 4096, 3])
def test_block_squared_norms_of_a_shard_have_the_whole_tables_bits(cuda, first):
    """The sharded eval's L2 norms: an entity shard's ‖e‖² equal the whole
    table's to the bit on unrounded values, wherever the shard starts."""
    rng = np.random.default_rng(first)
    table = rank_count.aligned_transpose(torch.from_numpy(rng.normal(size=(14951, 100)).astype(np.float32)).to(cuda))
    whole = distances.squared_norms(table)
    shard = rank_count.aligned_transpose(table.T[first:first + 7475].contiguous())
    got = par_eval.shard_squared_norms(shard, first, 14951)
    assert torch.equal(got, whole[first:first + 7475])
    torch.testing.assert_close(got, distances.squared_norms(shard), rtol=1e-6, atol=0)


# --- TransR's fast chunk as a CUDA graph (models/transr.py::ChunkGraph) ------------------

CHUNK_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")


def _dyadic_tables(n, n_rel, k, seed, dev):
    rng = np.random.default_rng(seed)

    def dy(shape):
        return torch.from_numpy(np.clip(np.round(rng.normal(size=shape) * 3) / 8, -1, 1).astype(np.float32)).to(dev)

    return {"entity": dy((n, k)), "relation": dy((n_rel, k)), "proj": dy((n_rel, k, k))}


def _chunk_feed(n_chunks, chunk, n, n_rel, seed, dev, distinct=True):
    """[n_chunks, chunk] int32 ids and valid.  With ``distinct`` a chunk's
    valid samples touch rows and relations no other valid sample of the
    chunk touches (both sides corrupted), so no two non-zero deltas meet on
    a row and the order of ``index_add``'s atomics cannot matter; its
    invalid samples (tail corrupted, nh == ph) repeat those rows and
    relations, and the last chunk ends in pad slots (id 0, invalid).
    Without it every sample is drawn at random, duplicates and all."""
    rng = np.random.default_rng(seed)
    out = {key: np.zeros((n_chunks, chunk), np.int32) for key in CHUNK_KEYS}
    out["valid"] = np.zeros((n_chunks, chunk), bool)
    n_valid = chunk * 3 // 4
    for c in range(n_chunks):
        if distinct:
            ents, rels = rng.permutation(n)[:4 * n_valid].reshape(4, n_valid), rng.permutation(n_rel)[:n_valid]
            for key, ids in zip(("ph", "pt", "nh", "nt", "r"), (*ents, rels)):
                out[key][c, :n_valid] = ids
                out[key][c, n_valid:] = rng.choice(ids, chunk - n_valid)
            out["nh"][c, n_valid:] = out["ph"][c, n_valid:]
            out["valid"][c, :n_valid] = True
        else:
            for key in ("ph", "pt", "nh", "nt"):
                out[key][c] = rng.integers(0, n, chunk)
            out["r"][c] = rng.integers(0, n_rel, chunk)
            out["valid"][c] = rng.random(chunk) > 0.1
    for key in CHUNK_KEYS:
        out[key][-1, -5:] = 0
    return {key: torch.from_numpy(v).to(dev) for key, v in out.items()}


def _eager_chunks(model, params, feed, cfg):
    """The chunks one ``batch_update`` call each: the body the graph records, run eagerly."""
    losses = []
    for i in range(feed["ph"].shape[0]):
        params, loss = model.batch_update(params, {key: v[i] for key, v in feed.items()}, cfg)
        losses.append(loss)
    return params, torch.stack(losses).sum()


def _graph_case(cuda, monkeypatch, distance, scatter_mode="direct", distinct=True, kernel=False):
    """TransR's chunks on the card.  Without ``kernel`` its kernel is turned
    off (``chunk_kernels``), as for a model whose chunk the kernel does not
    take, so that the runner replays the chunk as ChunkGraph."""
    n, n_rel, k, chunk, n_chunks = 300, 40, 16, 32, 5
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=1 / 16, margin=1.0, distance=int(distance),
                          scatter_mode=scatter_mode)
    model = get_model("transr")
    if not kernel:
        monkeypatch.setattr(model, "chunk_kernels", False)
    runner = step_lib.EpochRunner(model, cfg, chunk, n_chunks)
    assert runner.chunk == chunk
    return (model, cfg, runner, _dyadic_tables(n, n_rel, k, 11 + int(distance), cuda),
            _chunk_feed(n_chunks, chunk, n, n_rel, 5 + int(distance), cuda, distinct), n)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_transr_chunk_graph_equals_the_eager_body_bit_for_bit(cuda, monkeypatch, distance):
    model, cfg, runner, params, feed, n = _graph_case(cuda, monkeypatch, distance)
    before = {key: v.clone() for key, v in params.items()}
    got, loss = runner.apply(params, feed, n)
    assert runner.kept.get("graph") is not None
    want, want_loss = _eager_chunks(model, params, feed, cfg)
    for key in params:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(params[key], before[key]), key  # warm-up and capture left the inputs alone
    assert torch.equal(loss, want_loss) and float(loss) > 0


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_transr_chunk_graph_with_duplicate_valid_rows_equals_the_eager_body(cuda, monkeypatch, distance):
    # Duplicate rows of violating samples: the atomics of index_add may add
    # in another order in the two runs, an ulp apart at most.
    model, cfg, runner, params, feed, n = _graph_case(cuda, monkeypatch, distance, distinct=False)
    got, loss = runner.apply(params, feed, n)
    want, want_loss = _eager_chunks(model, params, feed, cfg)
    for key in params:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)


def test_transr_chunk_graph_is_captured_once_and_replays_every_chunk(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    model, cfg, runner, params, feed, n = _graph_case(cuda, monkeypatch, Distance.L1)
    first = {key: v[:1] for key, v in feed.items()}
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            one, _ = runner.apply(params, first, n)  # a start check's call: one chunk
            graph = runner.kept.get("graph")
            kept = {key: v.clone() for key, v in one.items()}
            out, loss = runner.apply(one, feed, n)  # then a whole feed
            assert runner.kept.get("graph") is graph
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    n_chunks = feed["ph"].shape[0]
    assert counters["train.chunks"] == counters["train.chunks_replayed"] == 1 + n_chunks
    for key in one:
        assert torch.equal(one[key], kept[key]), key  # the second call wrote none of the first's tables
    want, _ = _eager_chunks(model, *_eager_chunks(model, params, first, cfg)[:1], feed, cfg)
    for key in want:
        assert torch.equal(out[key], want[key]), key


def test_transr_dedup_runs_eagerly_on_the_card(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    model, cfg, runner, params, feed, n = _graph_case(cuda, monkeypatch, Distance.L2, scatter_mode="dedup",
                                                      kernel=True)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            got, loss = runner.apply(params, feed, n)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert runner.kept.get("graph") is None
    assert counters["train.chunks"] == feed["ph"].shape[0] and counters["train.chunks_replayed"] == 0
    assert counters["train.chunks_kernel"] == 0 and model.chunk_kernels is True
    want, want_loss = _eager_chunks(model, params, feed, cfg)
    for key in params:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(loss, want_loss)


# --- CTransR's fast chunk on TransR's stages, as the same CUDA graph ------------------------


def _ctransr_graph_case(cuda, distance):
    n, n_rel, k, chunk, n_chunks = 300, 40, 16, 32, 5
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=1 / 16, margin=1.0, distance=int(distance))
    model = get_model("ctransr")
    runner = step_lib.EpochRunner(model, cfg, chunk, n_chunks)
    assert runner.chunk == chunk
    params = _dyadic_tables(n, n_rel, k, 21 + int(distance), cuda)
    rng = np.random.default_rng(22 + int(distance))
    for key in ("relation_c", "centers"):
        params[key] = torch.from_numpy(np.clip(np.round(rng.normal(size=(n_rel, model.n_clusters, k)) * 3) / 8, -1, 1)
                                       .astype(np.float32)).to(cuda)
    return model, cfg, runner, params, _chunk_feed(n_chunks, chunk, n, n_rel, 23 + int(distance), cuda), n


def _routed(model, params, feed, cfg):
    """The eager chunks in order, and the valid samples each (relation,
    cluster) took, routed on each chunk's start tables: [R, C]."""
    n_rel, n_clusters = params["relation_c"].shape[:2]
    counts = torch.zeros(n_rel * n_clusters, dtype=torch.int64, device=params["entity"].device)
    for i in range(feed["ph"].shape[0]):
        one = {key: v[i] for key, v in feed.items()}
        h, t, r = one["ph"].long(), one["pt"].long(), one["r"].long()
        ent = params["entity"]
        flat = r * n_clusters + ctransr._nearest(ent[t] - ent[h], params["centers"][r])
        counts.index_add_(0, flat[one["valid"]], torch.ones_like(flat[one["valid"]]))
        params, _ = model.batch_update(params, one, cfg)
    return params, counts.view(n_rel, n_clusters)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_ctransr_chunk_graph_equals_the_eager_body_bit_for_bit(cuda, distance):
    model, cfg, runner, params, feed, n = _ctransr_graph_case(cuda, distance)
    before = {key: v.clone() for key, v in params.items()}
    got, loss = runner.apply(params, feed, n)
    graph = runner.kept["graph"]
    assert graph.counts is None  # no profiler: no count kernel
    want, want_loss = _eager_chunks(model, params, feed, cfg)
    assert sorted(got) == sorted(params) and got["centers"] is params["centers"]
    for key in params:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(params[key], before[key]), key  # warm-up and capture left the inputs alone
    assert torch.equal(loss, want_loss) and float(loss) > 0


def test_ctransr_chunk_graph_is_captured_once_counts_its_routes_and_replays_every_chunk(cuda):
    from torch.profiler import ProfilerActivity, profile

    model, cfg, runner, params, feed, n = _ctransr_graph_case(cuda, Distance.L1)
    first = {key: v[:1] for key, v in feed.items()}
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            one, _ = runner.apply(params, first, n)  # a start check's call: one chunk
            graph = runner.kept.get("graph")
            assert graph.counts is not None
            out, loss = runner.apply(one, feed, n)  # then a whole feed
            assert runner.kept.get("graph") is graph
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    n_chunks = feed["ph"].shape[0]
    assert counters["train.chunks"] == counters["train.chunks_replayed"] == 1 + n_chunks
    mid, first_counts = _routed(model, params, first, cfg)
    want, feed_counts = _routed(model, mid, feed, cfg)
    for key in want:
        assert torch.equal(out[key], want[key]), key
    assert counters["ctransr.routed"] == int(first_counts.sum() + feed_counts.sum()) == int(feed["valid"][:1].sum()
                                                                                          + feed["valid"].sum())
    assert counters["ctransr.routed_top"] == int(first_counts.amax(1).sum() + feed_counts.amax(1).sum())
    # With the profiler stopped the graph is captured again, without the count.
    again, _ = runner.apply(params, first, n)
    assert runner.kept["graph"] is not graph and runner.kept["graph"].counts is None
    assert torch.equal(again["entity"], one["entity"])


# --- TransE's fast batch, three launches a batch (ops/transe_fast.py) ---------------------
#
# The kernels sum each row in torch's order (k < 128) and add every delta
# into the accumulator on its own, role by role as the plain update's
# index_add does.  A row's deltas round alike in any order unless its running
# sum crosses a power of two, so where sums are exact (dyadic tables) the two
# agree bit for bit; elsewhere they part as index_add parts from itself run to
# run, a unit in the last place in a few elements.  So random tables are
# compared one batch at a time from one state: over many batches one rounding
# apart flips an L1 direction wherever a residual coordinate is within it of
# 0, a step of 2 lr.


def _fast_case(dev, distance, k_neg, k, n_batches, seed, dyadic=True, ordered=True, n=2000, n_rel=60, positives=512,
               distinct=False):
    """A TransE runner on one card, its tables and a [n_batches, positives·K]
    feed.  ``dyadic``: entries multiples of 1/16 in [-1/2, 1/2] (most rows of
    norm above 1) and lr 1/16, so every sum of one batch is exact in any
    order; else tables of norm at most 1 and lr 2^-10.  ``ordered``: the
    positives repeated sample-major, as the sampler lays out K negatives;
    else every row drawn at random.  ``distinct`` (K 1): no row of a batch
    shares an entity or a relation with another, so no two deltas meet."""
    rng = np.random.default_rng(seed)
    cfg = EmbeddingConfig(embedding_size=k, learning_rate=1 / 16 if dyadic else 2**-10, margin=1.0,
                          distance=int(distance), num_negatives=k_neg)
    if dyadic:
        ent, rel = (np.clip(np.round(rng.normal(size=(m, k)) * 3) / 16, -0.5, 0.5) for m in (n, n_rel))
    else:
        ent, rel = (rng.normal(size=(m, k)) / np.sqrt(k) for m in (n, n_rel))
        ent, rel = (x / np.maximum(1.0, np.linalg.norm(x, axis=1, keepdims=True)) for x in (ent, rel))
    params = {"entity": torch.from_numpy(ent.astype(np.float32)).to(dev),
              "relation": torch.from_numpy(rel.astype(np.float32)).to(dev)}
    rows = positives * k_neg
    rep = k_neg if ordered else 1
    ph, pt, r = (np.repeat(rng.integers(0, m, (n_batches, rows // rep)), rep, axis=1) for m in (n, n, n_rel))
    pt[:, :rows // 8] = ph[:, :rows // 8]  # h == t
    nh, nt = rng.integers(0, n, (2, n_batches, rows))
    if distinct:
        ph, pt, nh, nt = np.stack([rng.permutation(n)[:4 * rows].reshape(4, rows) for _ in range(n_batches)], 1)
        r = np.stack([rng.permutation(n_rel)[:rows] for _ in range(n_batches)])
    valid = rng.random((n_batches, rows)) > 0.1
    feed = {key: torch.from_numpy(v.astype(np.int32)).to(dev) for key, v in zip(("ph", "pt", "r", "nh", "nt"),
                                                                              (ph, pt, r, nh, nt))}
    feed["valid"] = torch.from_numpy(valid).to(dev)
    runner = step_lib.EpochRunner(get_model("transe"), cfg, positives, n_batches)
    return runner, cfg, params, feed, n


def _fast_plain(params, feed, cfg, n):
    """``fused_table_update`` over the feed's batches in turn (eager, on the tables' device)."""
    model = get_model("transe")
    table, losses = base.fuse(params), []
    for i in range(feed["ph"].shape[0]):
        table, loss = model.fused_table_update(table, n, {key: v[i] for key, v in feed.items()}, cfg)
        losses.append(loss)
    return base.unfuse(table, n), torch.stack(losses).sum()


def _one_call_each(runner, params, feed, n):
    """The feed's batches through the runner one ``apply`` call each: the states after each, and the losses."""
    states, losses = [], []
    for i in range(feed["ph"].shape[0]):
        params, loss = runner.apply(params, {key: v[i:i + 1] for key, v in feed.items()}, n)
        states.append(params)
        losses.append(loss)
    return states, torch.stack(losses)


def _fast_launches():
    from kb2e_tpu_torch.ops import transe_fast

    return sum(cuda_build.launch_counts[name] for name in transe_fast.KERNEL_NAMES)


@pytest.mark.parametrize("distance, k_neg, k, ordered", [
    (Distance.L1, 1, 100, True), (Distance.L2, 1, 100, True), (Distance.L1, 8, 100, True),
    (Distance.L2, 8, 100, True), (Distance.L1, 8, 100, False), (Distance.L2, 1, 30, True),
    (Distance.L1, 8, 30, True), (Distance.L1, 1, 300, True), (Distance.L2, 8, 257, True),
])
def test_transe_batch_kernels_equal_the_plain_update_bit_for_bit_on_dyadic_tables(cuda, distance, k_neg, k, ordered):
    # One batch: every sum exact, so the atomics' order cannot matter.  k 30
    # and 257 take the scalar loads (k not a multiple of 4), 257 and 300 more
    # than one chunk a lane; K 8 unordered: no two rows share a positive.
    runner, cfg, params, feed, n = _fast_case(cuda, distance, k_neg, k, 1, seed=k + k_neg, ordered=ordered)
    before = {key: v.clone() for key, v in params.items()}
    launches = _fast_launches()
    got, loss = runner.apply(params, feed, n)
    torch.cuda.synchronize()
    assert _fast_launches() == launches + 3
    want, want_loss = _fast_plain(params, feed, cfg, n)
    for key in params:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(params[key], before[key]), key
    assert torch.equal(loss, want_loss) and float(loss) > 0


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
@pytest.mark.parametrize("k_neg", [1, 8])
def test_transe_batch_kernels_near_the_plain_update_on_random_tables(cuda, distance, k_neg):
    # Five batches at k 100, each from the state the kernels left, against
    # the plain update from that state, run twice: within a unit in the last
    # place (1e-7 for rows of norm at most 1; L2 1e-6), and in no more
    # elements than four times those in which the plain update parts from
    # itself, or a thousandth of them.  The loss, summed in another order over
    # about a thousand terms, within 1e-5; the five batches in one call within
    # 1e-6 of them one call each.
    runner, cfg, params, feed, n = _fast_case(cuda, distance, k_neg, 100, 5, seed=40 + k_neg, dyadic=False,
                                              n=3000, n_rel=200, positives=1024)
    states, losses = _one_call_each(runner, params, feed, n)
    for i, (start, state) in enumerate(zip([params] + states, states)):
        one = {key: v[i:i + 1] for key, v in feed.items()}
        want, want_loss = _fast_plain(start, one, cfg, n)
        again, _ = _fast_plain(start, one, cfg, n)
        for key in params:
            torch.testing.assert_close(state[key], want[key], rtol=0, atol=1e-7 if distance == Distance.L1 else 1e-6)
            apart, itself = int((state[key] != want[key]).sum()), int((again[key] != want[key]).sum())
            assert apart <= 4 * itself + want[key].numel() // 1000, (key, apart, itself)
        assert float(losses[i]) == pytest.approx(float(want_loss), rel=1e-5) and float(want_loss) > 0
    got, loss = runner.apply(params, feed, n)
    for key in params:
        torch.testing.assert_close(got[key], states[-1][key], rtol=0, atol=1e-6)
    assert float(loss) == pytest.approx(float(losses.sum()), rel=1e-5)


def test_transe_one_and_hundred_batch_applies_take_the_kernels_three_launches_a_batch(cuda):
    from torch.profiler import ProfilerActivity, profile

    runner, cfg, params, feed, n = _fast_case(cuda, Distance.L1, 1, 100, 100, seed=7, dyadic=False)
    launches = _fast_launches()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            one, _ = runner.apply(params, {key: v[:1] for key, v in feed.items()}, n)  # a start check's call
            out, loss = runner.apply(one, feed, n)
        snap = profiling.snapshot()
    finally:
        profiling.reset()
    assert _fast_launches() == launches + 3 * 101
    assert snap["counters"]["train.batches"] == snap["counters"]["train.batches_kernel"] == 101
    assert snap["spans"]["kb2e.train.batch"]["count"] == 101
    for key in params:
        assert not torch.equal(out[key], one[key]) and bool(torch.isfinite(out[key]).all()), key
        assert bool((out[key].norm(dim=1) <= 1 + 1e-6).all()), key
    assert float(loss) > 0


@pytest.mark.parametrize("dtype, scatter_mode", [(torch.bfloat16, "direct"), (torch.float32, "dedup")])
def test_transe_bf16_and_dedup_stay_eager_on_the_card(cuda, dtype, scatter_mode):
    from torch.profiler import ProfilerActivity, profile

    # Rows that no two samples of a batch share: the eager update adds no
    # two deltas into one row, so it rounds alike every time it runs.
    _, cfg, params, feed, n = _fast_case(cuda, Distance.L2, 1, 100, 3, seed=9, n_rel=300, positives=256,
                                         distinct=True)
    cfg = cfg.replace(scatter_mode=scatter_mode)
    runner = step_lib.EpochRunner(get_model("transe"), cfg, feed["ph"].shape[1], 3)
    params = {key: v.to(dtype) for key, v in params.items()}
    launches = _fast_launches()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got, loss = runner.apply(params, feed, n)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert _fast_launches() == launches
    assert counters["train.batches"] == 3 and counters["train.batches_kernel"] == 0
    want, want_loss = _fast_plain(params, feed, cfg, n)
    for key in params:
        assert got[key].dtype == dtype and torch.equal(got[key], want[key]), key
    assert torch.equal(loss, want_loss) and float(loss) > 0


def test_transe_batch_kernels_ball_norm_untouched_rows_above_norm_one_as_the_plain_update(cuda):
    runner, cfg, params, feed, n = _fast_case(cuda, Distance.L1, 1, 100, 1, seed=11)
    params["entity"][n - 50:] = 0.25  # norm 2.5, and no sample below touches them
    for key in ("ph", "pt", "nh", "nt"):
        feed[key] %= n - 50
    got, _ = runner.apply(params, feed, n)
    want, _ = _fast_plain(params, feed, cfg, n)
    assert torch.allclose(got["entity"][n - 50:].norm(dim=1), torch.ones(50, device=cuda))
    for key in params:
        assert torch.equal(got[key], want[key]), key


GAP_SEEDS = 32  # table and sampler seeds a cell, on one graph


@pytest.mark.parametrize("cell", ["transe-fb15k.train", "transe-fb15k.train-k8"])
def test_transe_batch_kernels_hold_the_benchmark_gaps_over_many_seeds(cuda, cell):
    # The benchmark's check (portbench/checks.py) at its cells' shapes, the
    # sampler's judge left out: from the benchmark's init tables the first
    # epoch's first check_steps batches one apply call each, then the
    # epoch's whole feed with all but those batches masked out in one call,
    # each followed by the plain reference.  The cell's limits on the loss
    # and change gaps hold at every seed; the change limits lie under what
    # one L1 direction flipped by one rounding reads, so an update whose
    # rounding parts from the reference's index_add more often than the
    # eager one fails here.
    from portbench import cell as cell_lib
    from portbench import checks, spec
    from portbench.data import graph as graph_lib

    from kb2e_tpu_torch.data.triples import TripleSet

    c = spec.load(cell)
    ref, g, limits = c.model, c.config["graph"], c.limits["limits"]
    n_ent, n_rel = int(g["n_entities"]), int(g["n_relations"])
    graph = graph_lib.generate(g, 2147493101)
    data = step_lib.DeviceData.from_triple_set(TripleSet.from_arrays(*graph["train"], n_ent, n_rel), cuda)
    steps, worst = int(c.traffic["check_steps"]), {}
    for seed in range(2147493201, 2147493201 + GAP_SEEDS):
        cfg = cell_lib._config(c, seed, None)
        runner = step_lib.EpochRunner(get_model("transe"), cfg, step_lib.batch_size_for(graph["train"][0].shape[0],
                                                                                        cfg.num_batches),
                                      cfg.num_batches)
        lr, margin, l1 = cfg.learning_rate, cfg.margin, int(cfg.distance) == 0
        start = ref.init_tables(torch.Generator(cuda).manual_seed(cell_lib._seed(seed, 0)), n_ent, n_rel,
                                cfg.embedding_size, "train")
        epoch = runner.sample(torch.Generator(cuda).manual_seed(cell_lib._seed(seed, 1)), data)
        params, ref_tables, states, ref_states, numbers = dict(start), start, [], [], {"loss_gap": 0.0}
        for i in range(steps):
            one = {key: v[i:i + 1] for key, v in epoch.items()}
            params, loss = runner.apply(params, one, n_ent)
            ref_tables, ref_loss = ref.fast_epoch(ref_tables, one, lr, margin, l1)
            states.append(params)
            ref_states.append(ref_tables)
            numbers["loss_gap"] = max(numbers["loss_gap"], abs(float(loss) - ref_loss) / abs(ref_loss))
        counted = checks.moving_leaves(ref.LEAVES, start, ref_states[0])
        numbers["change1_gap"] = checks.change_gap(ref.LEAVES, start, states[0], start, ref_states[0], counted)
        numbers["change3_gap"] = checks.change_gap(ref.LEAVES, start, states[-1], start, ref_states[-1], counted)
        masked = {**epoch, "valid": epoch["valid"].clone()}
        masked["valid"][steps:] = False
        end, loss = runner.apply(params, masked, n_ent)
        ref_end, ref_loss = ref.fast_epoch(params, masked, lr, margin, l1)
        counted = checks.moving_leaves(ref.LEAVES, params, ref_end)
        numbers["window_loss_gap"] = abs(float(loss) - ref_loss) / abs(ref_loss)
        numbers["window_change_gap"] = checks.change_gap(ref.LEAVES, params, end, params, ref_end, counted)
        for name, value in numbers.items():
            worst[name] = max(worst.get(name, (0.0, 0)), (value, seed))
    print(f"{cell}: worst of {GAP_SEEDS} seeds " + ", ".join(f"{name} {v:.3g} (seed {s}, limit {limits[name]})"
                                                            for name, (v, s) in worst.items()))
    for name, (value, seed) in worst.items():
        assert value <= limits[name], (name, value, seed, limits[name])
