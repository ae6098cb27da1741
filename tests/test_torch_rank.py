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
from kb2e_tpu_torch.ops import cuda_build, distances, rank_count

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
    cuda_build.reset_launch_counts()
    np.testing.assert_array_equal(rank_count.rank_counts(*args).numpy(),
                                  rank_count.rank_counts_reference(*args).numpy())
    assert sum(cuda_build.launch_counts.values()) == 0
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


@pytest.mark.parametrize("b", [24, 21])
@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_plain_version_with_precomputed_e_sq_equals_jax(distance, b):
    ent, queries, true_idx, _ = _inputs(b, seed=31 + b)
    e_true = distances.residual_energy(torch.from_numpy(ent[true_idx] - queries), distance)
    proj = jax_ranking.pad_entities(jnp.asarray(ent), 128)
    want = np.asarray(jax_pallas_rank.rank_counts(
        proj.T, jnp.asarray(queries).T, jnp.asarray(e_true.numpy()), jnp.asarray(true_idx), JDistance(int(distance)),
        tile_n=128, interpret=True,
    ))
    # The harness's layout: tables padded to a leading dimension of 4 floats,
    # ‖e‖² computed once from the padded table.
    proj_t = rank_count.aligned_transpose(torch.from_numpy(ent))
    queries_t = rank_count.aligned_transpose(torch.from_numpy(queries))
    e_sq = distances.squared_norms(proj_t)
    assert torch.equal(e_sq, distances.squared_norms(torch.from_numpy(ent).T.contiguous()))
    for block_size in (37, 4096):
        got = rank_count.rank_counts_reference(proj_t, queries_t, e_true, torch.from_numpy(true_idx), distance,
                                               block_size, e_sq=e_sq)
        np.testing.assert_array_equal(got.numpy(), want)
    got = rank_count.rank_counts(proj_t, queries_t, e_true, torch.from_numpy(true_idx), distance, e_sq=e_sq)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k_of", ["1", "chunk - 1", "chunk", "chunk + 1", "100"])
def test_plan_covers_every_entity_query_and_k_row_once_and_reads_inside_the_padded_rows(k_of):
    tx, ty, per_e, per_q, lanes_e, chunk, stages = rank_count.TILE
    assert 32 % lanes_e == 0 and tx % lanes_e == 0 and ty % (32 // lanes_e) == 0  # whole warps
    assert per_e % 4 == 0 and per_q % 4 == 0 and stages >= 2
    k = {"1": 1, "chunk - 1": chunk - 1, "chunk": chunk, "chunk + 1": chunk + 1, "100": 100}[k_of]
    for n in (1, per_e * tx - 1, per_e * tx, per_e * tx + 1, 14951):
        for b in (1, per_q * ty - 1, per_q * ty, per_q * ty + 1, 21, 250):
            p = rank_count.plan(k, n, b)
            assert (p.tile_n, p.tile_b, p.threads) == (per_e * tx, per_q * ty, tx * ty)
            assert (p.grid[0] - 1) * p.tile_n + p.tail_n == n and 1 <= p.tail_n <= p.tile_n
            assert (p.grid[1] - 1) * p.tile_b + p.tail_b == b and 1 <= p.tail_b <= p.tile_b
            assert (p.chunks - 1) * chunk + p.tail_k == k and 1 <= p.tail_k <= chunk
            assert p.smem_bytes == 4 * stages * chunk * (p.tile_n + p.tile_b)
            # The kernel's 16-byte copies of the last block's row: live
            # where the column is below n, reading at most padded_ld(n)
            # floats of the row; the dead ones are zero-filled.
            for m, tile_m, grid_m in ((n, p.tile_n, p.grid[0]), (b, p.tile_b, p.grid[1])):
                cols = (grid_m - 1) * tile_m + 4 * np.arange(tile_m // 4)
                live = cols[cols < m]
                assert live.size == -(-(m - (grid_m - 1) * tile_m) // 4)
                assert live.max() + 4 <= rank_count.padded_ld(m)


@pytest.mark.parametrize("b", [256, 250])
def test_plan_takes_the_fb15k_eval_batch_in_one_query_tile(b):
    # FB15k's eval batch (and the smoke's ragged 250): one query tile of
    # 256, so each table row is read once a launch, and 117 blocks: one on
    # each of 117 of an H100's 132 SMs.
    p = rank_count.plan(100, 14951, b)
    assert (p.tile_n, p.tile_b, p.grid, p.blocks, p.threads) == (128, 256, (117, 1), 117, 512)
    assert (p.chunks, p.tail_k, p.tail_n, p.tail_b) == (7, 4, 14951 - 116 * 128, b)
    assert p.smem_bytes == 4 * 3 * 16 * (128 + 256) and p.waves(1, 132) == pytest.approx(117 / 132)


def test_aligned_transpose_pads_rows_to_four_floats_and_the_kernel_takes_it():
    rng = np.random.default_rng(2)
    for m in (1, 3, 4, 5, 250, 14951):
        x = torch.from_numpy(rng.normal(size=(m, 7)).astype(np.float32))
        x_t = rank_count.aligned_transpose(x)
        assert x_t.shape == (7, m) and x_t.stride() == (rank_count.padded_ld(m), 1)
        assert rank_count.padded_ld(m) % 4 == 0 and 0 <= rank_count.padded_ld(m) - m < 4
        assert torch.equal(x_t, x.T) and rank_count.kernel_takes(x_t)
        assert rank_count.kernel_takes(x.T.contiguous()) == (m % 4 == 0)
    wide = torch.zeros(5, 16)
    assert rank_count.kernel_takes(wide[:, :13]) and not rank_count.kernel_takes(wide[:, 1:])
    assert not rank_count.kernel_takes(wide.T)  # columns, not rows, contiguous
    # One row of 5 floats: the kernel would copy 8.
    assert not rank_count.kernel_takes(torch.zeros(1, 5)) and rank_count.kernel_takes(torch.zeros(1, 8)[:, :5])


@pytest.mark.parametrize("distance", [Distance.L1, Distance.L2])
def test_padded_tables_give_the_counts_of_contiguous_ones(distance):
    rng = np.random.default_rng(8)
    ent = torch.from_numpy(rng.normal(size=(N_ENT + 1, K)).astype(np.float32))
    queries = torch.from_numpy(rng.normal(size=(23, K)).astype(np.float32))
    true_idx = torch.from_numpy(rng.integers(0, N_ENT + 1, 23).astype(np.int32))
    e_true = distances.residual_energy(ent[true_idx.long()] - queries, distance)
    want = rank_count.rank_counts(ent.T.contiguous(), queries.T.contiguous(), e_true, true_idx, distance)
    proj_t = rank_count.aligned_transpose(ent)
    got = rank_count.rank_counts(proj_t, rank_count.aligned_transpose(queries), e_true, true_idx, distance,
                                 e_sq=distances.squared_norms(proj_t))
    assert torch.equal(got, want)
