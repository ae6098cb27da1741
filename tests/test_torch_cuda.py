"""The hand-written CUDA kernels against their plain versions, on the card:
the rank count (K1/K2), the sequential TransE update (K3), the sequential
TransH update (K4) and the sequential TransR update (K5).  K3, K4 and K5 run
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
from kb2e_tpu_torch.models import get_model
from kb2e_tpu_torch.ops import distances, rank_count, schedule, transe_update, transh_update, transr_update
from kb2e_tpu_torch.parallel import eval as par_eval

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
    rank_count.reset_launch_counts()
    got = rank_count.rank_counts(*args)
    torch.cuda.synchronize()
    assert dict(rank_count.launch_counts) == {rank_count.KERNEL_NAMES[distance]: 1}
    want = rank_count.rank_counts_reference(*args)
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert torch.equal(got, want)
    assert dict(rank_count.launch_counts) == {rank_count.KERNEL_NAMES[distance]: 1}
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
    transe_update.reset_launch_counts()
    ent, rel, loss, viol = transe_update.transe_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    name = transe_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]
    assert dict(transe_update.launch_counts) == {name: 1}
    want = transe_update.transe_sequential_update_reference(*args, **kw)
    assert dict(transe_update.launch_counts) == {name: 1}
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
        transe_update.reset_launch_counts()
        get_model("transe").sequential_update(params, batch, cfg.replace(parity_impl=impl))
        assert dict(transe_update.launch_counts) == {"transe_update_l1": 1}
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
    transh_update.reset_launch_counts()
    got = transh_update.transh_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(transh_update.launch_counts) == {"transh_update": 1}
    want = transh_update.transh_sequential_update_reference(*args, **kw)
    assert dict(transh_update.launch_counts) == {"transh_update": 1}
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
        transh_update.reset_launch_counts()
        out, _ = get_model("transh").sequential_update(params, batch, cfg.replace(parity_impl=impl))
        assert dict(transh_update.launch_counts) == {"transh_update": 1}
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
    transr_update.reset_launch_counts()
    got = transr_update.transr_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(transr_update.launch_counts) == {name: 1}
    want = transr_update.transr_sequential_update_reference(*args, **kw)
    assert dict(transr_update.launch_counts) == {name: 1}
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
        transr_update.reset_launch_counts()
        out, _ = get_model("transr").sequential_update(params, batch, cfg.replace(parity_impl=impl))
        assert dict(transr_update.launch_counts) == {"transr_update_l2": 1}
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
    transe_update.reset_launch_counts()
    got = transe_update.transe_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(transe_update.launch_counts) == {transe_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]: 1}
    _assert_stress_result(kind, args, got, transe_update.transe_sequential_update_reference(*args, **kw), m=2)


@pytest.mark.parametrize("k,b", [(12, 256), (33, 192), (100, 96), (transh_update.MAX_K, 24)])
@pytest.mark.parametrize("kind", STRESS)
def test_transh_kernel_equals_plain_version_on_stress_batches(cuda, kind, k, b):
    args = _stress_case("transh", kind, k, b, seed=k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, max_iters=16)
    transh_update.reset_launch_counts()
    got = transh_update.transh_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(transh_update.launch_counts) == {"transh_update": 1}
    _assert_stress_result(kind, args, got, transh_update.transh_sequential_update_reference(*args, **kw))


# The plain version of K5 takes some thousands of small launches a sample,
# more at larger k: the batches shrink as k grows.
@pytest.mark.parametrize("k,b", [(12, 96), (33, 64), (100, 24), (transr_update.MAX_K, 6)])
@pytest.mark.parametrize("kind", STRESS)
@pytest.mark.parametrize("l1", [True, False])
def test_transr_kernel_equals_plain_version_on_stress_batches(cuda, kind, k, b, l1):
    args = _stress_case("transr", kind, k, b, seed=k + b, dev=cuda)
    kw = dict(learning_rate=0.05, margin=1.0, l1=l1, max_iters=16)
    transr_update.reset_launch_counts()
    got = transr_update.transr_sequential_update(*args, **kw)
    torch.cuda.synchronize()
    assert dict(transr_update.launch_counts) == {transr_update.KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]: 1}
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
    rank_count.reset_launch_counts()
    card = harness.rank_all(get_model("ptranse"), {k: v.to(cuda) for k, v in host.items()}, dataset, cfg,
                            device=cuda)
    n_batches = -(-2 * dataset.test[0].shape[0] // cfg.eval_batch_size)
    assert rank_count.launch_counts == {rank_count.KERNEL_NAMES[distance]: n_batches}  # one group, one a batch
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
    rank_count.reset_launch_counts()
    card = harness.relation_ranks(m, {k: v.to(cuda) for k, v in host.items()}, dataset, cfg, path_store=store,
                                  device=cuda)
    assert not rank_count.launch_counts
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
