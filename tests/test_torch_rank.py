"""kb2e_tpu_torch's rank count against kb2e_tpu's ranking sweeps.

On dyadic inputs (multiples of 1/8) every float sum is exact whatever its
order, so the port's plain rank count and ``rank_queries`` must EQUAL
kb2e_tpu's ``rank_queries`` and its Pallas kernel (interpret mode), raw and
filtered, as in tests/test_pallas_rank.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kb2e_tpu.constants import Distance as JDistance
from kb2e_tpu.eval import ranking as jax_ranking
from kb2e_tpu.ops import pallas_rank as jax_pallas_rank
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.eval import ranking
from kb2e_tpu_torch.ops import distances, rank_count

torch.set_num_threads(1)

N_ENT, K = 200, 12  # k not a multiple of 8


def _inputs(b: int, seed: int):
    rng = np.random.default_rng(seed)
    ent = (np.round(rng.normal(size=(N_ENT, K)) * 8) / 8).astype(np.float32)
    # Twin rows: entities 10..19 copy 0..9, so energies tie and the id breaks them.
    ent[10:20] = ent[0:10]
    queries = (np.round(rng.normal(size=(b, K)) * 8) / 8).astype(np.float32)
    queries[2] = ent[7]  # a query on an entity: energy 0 for 7 and 17
    true_idx = rng.integers(0, N_ENT, b).astype(np.int32)
    true_idx[:4] = (15, 3, 17, 7)  # true ids with a twin below and above them
    cands = np.full((b, 8), -1, np.int32)
    cands[:, 0] = rng.integers(0, N_ENT, b)
    cands[:, 1] = true_idx  # the true id in the filter list must be ignored
    cands[:, 2] = (true_idx + 10) % 20  # its twin, where it has one
    cands[:, 3] = cands[:, 0]  # a duplicate entry counts twice
    return ent, queries, true_idx, cands


@pytest.mark.parametrize("b", [24, 21])
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_rank_queries_equal_jax_on_dyadic_inputs(distance, b):
    ent, queries, true_idx, cands = _inputs(b, seed=9 + b)
    jd, block = JDistance(int(distance)), 128
    proj = jax_ranking.pad_entities(jnp.asarray(ent), block)
    args = (proj, jnp.asarray(queries), jnp.asarray(true_idx), jnp.asarray(cands), jd, block)
    raw_x, filt_x = (np.asarray(a) for a in jax_ranking.rank_queries(*args))
    raw_p, filt_p = (np.asarray(a) for a in jax_ranking.rank_queries_pallas(*args, interpret=True))
    np.testing.assert_array_equal(raw_x, raw_p)
    np.testing.assert_array_equal(filt_x, filt_p)

    # The port takes the real table; a block of 64 leaves a short last block.
    raw_t, filt_t = ranking.rank_queries(
        torch.from_numpy(ent), torch.from_numpy(queries), torch.from_numpy(true_idx),
        torch.from_numpy(cands), distance, block_size=64,
    )
    assert raw_t.dtype == torch.int32 and filt_t.dtype == torch.int32
    np.testing.assert_array_equal(raw_t.numpy(), raw_x)
    np.testing.assert_array_equal(filt_t.numpy(), filt_x)
    # The reference's own method: a stable sort of exact energies, ties by id
    # (15's twin 5 ranks before it, 3's twin 13 after it).
    res = ent[None, :, :].astype(np.float64) - queries[:, None, :]
    energy = np.abs(res).sum(-1) if distance == Distance.L1 else (res * res).sum(-1)
    order = np.argsort(energy, axis=1, kind="stable")
    np.testing.assert_array_equal(raw_x, 1 + np.argmax(order == true_idx[:, None], axis=1))

    # The count alone, against the Pallas kernel's, at several block sizes.
    e_true = distances.residual_energy(torch.from_numpy(ent[true_idx] - queries), distance)
    want = np.asarray(jax_pallas_rank.rank_counts(
        proj.T, jnp.asarray(queries).T, jnp.asarray(e_true.numpy()), jnp.asarray(true_idx), jd,
        tile_n=block, interpret=True,
    ))
    np.testing.assert_array_equal(want, raw_x - 1)
    for block_size in (1, 37, 200, 4096):
        got = rank_count.rank_counts_reference(
            torch.from_numpy(ent).T.contiguous(), torch.from_numpy(queries).T.contiguous(), e_true,
            torch.from_numpy(true_idx), distance, block_size,
        )
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_rank_feed_queries_equal_jax(distance):
    rng = np.random.default_rng(4)
    n_rel, n_q, batch, kmax = 5, 40, 16, 4
    ent = (np.round(rng.normal(size=(N_ENT, K)) * 8) / 8).astype(np.float32)
    rel = (np.round(rng.normal(size=(n_rel, K)) * 8) / 8).astype(np.float32)
    feed = dict(
        q_anchor=rng.integers(0, N_ENT, n_q).astype(np.int32),
        q_sign=rng.choice([-1.0, 1.0], n_q).astype(np.float32),
        q_rel=rng.integers(0, n_rel, n_q).astype(np.int32),
        q_true=rng.integers(0, N_ENT, n_q).astype(np.int32),
        q_lo=rng.integers(0, 30, n_q).astype(np.int32),
        q_count=rng.integers(0, kmax + 1, n_q).astype(np.int32),
        filt_vals=rng.integers(0, N_ENT, 34).astype(np.int32),
    )
    proj = jax_ranking.pad_entities(jnp.asarray(ent), 64)
    t_ent = torch.from_numpy(ent)
    for start in (0, batch, 2 * batch - 8):
        want = jax_ranking.rank_feed_queries(
            proj, jnp.asarray(rel), **{k: jnp.asarray(v) for k, v in feed.items()},
            start=start, distance=JDistance(int(distance)), block_size=64, batch=batch, kmax=kmax,
        )
        got = ranking.rank_feed_queries(
            t_ent, t_ent.T.contiguous(), torch.from_numpy(rel), **{k: torch.from_numpy(v) for k, v in feed.items()},
            start=start, distance=distance, block_size=64, batch=batch, kmax=kmax,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ent, queries, true_idx, _ = _inputs(21, seed=1)
    args = (torch.from_numpy(ent).T.contiguous(), torch.from_numpy(queries).T.contiguous(),
            distances.residual_energy(torch.from_numpy(ent[true_idx] - queries), Distance.L1),
            torch.from_numpy(true_idx), Distance.L1)
    rank_count.reset_launch_counts()
    np.testing.assert_array_equal(rank_count.rank_counts(*args).numpy(),
                                  rank_count.rank_counts_reference(*args).numpy())
    assert sum(rank_count.launch_counts.values()) == 0
    # A device with neither a kernel nor a plain version is refused.
    with pytest.raises(ValueError, match="no kernel"):
        rank_count.rank_counts(*(a.to("meta") if torch.is_tensor(a) else a for a in args))



def test_kernel_build_runs_nvcc_once_and_raises_on_failure(tmp_path, monkeypatch):
    # A stand-in nvcc: it writes the file after -o and prints a ptxas line,
    # or fails when FAIL is set.
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\n[ -n "$FAIL" ] && { echo "bad source" >&2; exit 2; }\n'
                    'while [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n'
                    'echo "ptxas info    : Used 60 registers"\necho call >> "$(dirname "$2")/calls"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(rank_count, "BUILD_DIR", tmp_path / "kernels")
    so = rank_count.build()
    assert so.parent == tmp_path / "kernels" and so.read_text() == "built\n"
    assert "Used 60 registers" in so.with_suffix(".log").read_text()
    assert rank_count.build() == so and (so.parent / "calls").read_text() == "call\n"

    so.unlink()
    monkeypatch.setenv("FAIL", "1")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*bad source"):
        rank_count.build()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rank_count.build()
