"""The CUDA rank-count kernel against its plain version, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  This file
imports neither jax nor kb2e_tpu, so it also runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import distances, rank_count

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rank-count kernel has no CPU mode")
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
