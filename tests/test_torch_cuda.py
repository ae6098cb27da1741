"""The hand-written CUDA kernels against their plain versions, on the card:
the rank count (K1/K2), the sequential TransE update (K3) and the sequential
TransH update (K4).

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
from kb2e_tpu_torch.ops import distances, rank_count, transe_update, transh_update

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


# Ragged against every tile of the kernel: 256 entities x 32 queries x 32 k-rows.
@pytest.mark.parametrize("n,k,b", [(200, 12, 21), (257, 33, 32), (1000, 100, 250), (14951, 100, 256)])
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


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_kernel_near_plain_version_on_unrounded_inputs(cuda, distance):
    args = _args(3000, 100, 256, distance, cuda, seed=5, dyadic=False)
    diff = (rank_count.rank_counts(*args).long() - rank_count.rank_counts_reference(*args).long()).abs()
    # Sums over k in one order on both sides; only fused-vs-unfused rounding
    # may move an energy across a near tie.
    assert int((diff > 0).sum()) <= 1 and int(diff.max()) <= 2


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    proj_t, queries_t, e_true, t, distance = _args(64, 8, 16, Distance.L1, cuda, seed=0)
    bad = [
        (proj_t.double(), queries_t, e_true, t),
        (proj_t, queries_t.T, e_true, t),  # not contiguous
        (proj_t, queries_t, e_true, t.long()),
        (proj_t, queries_t, e_true.cpu(), t),
        (proj_t, queries_t[:, :8].contiguous(), e_true, t),
    ]
    for args in bad:
        with pytest.raises(ValueError, match="rank_counts"):
            rank_count.rank_counts(*args, distance)


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
    torch.testing.assert_close(ent, want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(rel, want[1], atol=1e-5, rtol=0)
    # The snapshot is not written.
    assert torch.equal(args[0], _update_case(n, n_rel, k, b, seed=n + k + b, dev=cuda)[0])


@pytest.mark.parametrize("l1", [True, False])
def test_update_kernel_near_plain_version_on_unrounded_tables(cuda, l1):
    args = _update_case(3000, 100, 100, 2000, seed=4, dev=cuda, dyadic=False)
    kw = dict(learning_rate=0.01, margin=1.0, l1=l1)
    ent, rel, loss, viol = transe_update.transe_sequential_update(*args, **kw)
    want = transe_update.transe_sequential_update_reference(*args, **kw)
    assert torch.equal(viol, want[3])
    assert float(loss) == pytest.approx(float(want[2]), rel=1e-5)
    torch.testing.assert_close(ent, want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(rel, want[1], atol=1e-5, rtol=0)


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
