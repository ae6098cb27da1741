"""kb2e_tpu_torch's update schedule (``ops/schedule.py``) on the CPU.

``row_predecessors`` is index bookkeeping that the JAX package never does:
it lets the TransE, TransH and TransR parity kernels run samples that share
no row side by side.  It is held against a plain Python last-toucher loop on seeded
batches (heavy conflicts, inactive samples, every kind of row a sample
lists twice, B = 0 and 1), and each active sample's chain of predecessors
must reach every earlier active sample that shares a row with it.  Then the
claim the schedule rests on, with the plain versions of K3, K4 and K5: a
batch run in the order of its chains' levels, which keeps each row's
updates in batch order, gives the sequential tables bit for bit.
"""

import numpy as np
import pytest
import torch

from kb2e_tpu_torch.ops import schedule, transe_update, transh_update, transr_update

torch.set_num_threads(1)

KINDS = ("conflicts", "inactive", "h==t", "h==h'", "t==t'", "h'==t'", "one entity", "sparse")


def _batch(kind, seed, b=48):
    """Seeded ids (ph, pt, nh, nt, r as int32 tensors), the entity count and
    the active mask of one kind of batch."""
    rng = np.random.default_rng(seed)
    n, n_rel = (400, 40) if kind == "sparse" else (8, 2)
    ph, pt, nh, nt = (rng.integers(0, n, b).astype(np.int32) for _ in range(4))
    r = rng.integers(0, n_rel, b).astype(np.int32)
    active = rng.random(b) > (0.5 if kind == "inactive" else 0.1)
    half = b // 2
    if kind == "h==t":
        pt[:half] = ph[:half]
    elif kind == "h==h'":
        nh[:half] = ph[:half]
    elif kind == "t==t'":
        nt[:half] = pt[:half]
    elif kind == "h'==t'":
        nt[:half] = nh[:half]
    elif kind == "one entity":  # h == t == h' == t' in a quarter, one row in every sample
        ph[:], pt[: b // 4], nh[: b // 4], nt[: b // 4] = 3, 3, 3, 3
    ids = [torch.from_numpy(a) for a in (ph, pt, nh, nt, r)]
    return ids, n, torch.from_numpy(active)


def _last_toucher(rows, active):
    """pred by a loop over the batch, remembering each row's last toucher."""
    last, pred = {}, np.full(rows.shape, -1)
    for i, row_keys in enumerate(rows.tolist()):
        if not active[i]:
            continue
        seen = []
        for j, key in enumerate(row_keys):
            if key not in seen:
                seen.append(key)
                pred[i, j] = last.get(key, -1)
        for key in seen:
            last[key] = i
    return pred


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_row_predecessors_equal_a_last_toucher_loop(kind, seed):
    (ph, pt, nh, nt, r), n, active = _batch(kind, seed)
    rows = schedule.update_rows(ph, pt, nh, nt, r, n)
    assert rows.dtype == torch.int64 and rows.shape == (ph.shape[0], 5)
    assert torch.equal(rows[:, 4], r.long() + n)
    pred = schedule.row_predecessors(rows, active)
    assert pred.dtype == torch.int32 and pred.shape == rows.shape
    np.testing.assert_array_equal(pred.numpy(), _last_toucher(rows.numpy(), active.numpy()))
    assert (pred[~active] == -1).all()
    assert (pred < torch.arange(pred.shape[0], dtype=torch.int32)[:, None]).all()  # never itself or later


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_each_chain_reaches_every_earlier_sample_that_shares_a_row(kind, seed):
    (ph, pt, nh, nt, r), n, active = _batch(kind, seed)
    rows = schedule.update_rows(ph, pt, nh, nt, r, n).numpy()
    pred = schedule.row_predecessors(torch.from_numpy(rows), active).numpy()
    act = active.numpy()
    reach = []  # reach[i]: every sample sample i waits on, directly or not
    for i in range(rows.shape[0]):
        direct = {int(p) for p in pred[i] if p >= 0}
        reach.append(set().union(direct, *(reach[p] for p in direct)))
    for i in np.flatnonzero(act):
        sharers = {j for j in np.flatnonzero(act[:i]) if set(rows[j]) & set(rows[i])}
        assert sharers <= reach[i], f"sample {i} does not wait on {sharers - reach[i]}"
        assert all(act[j] and j < i for j in reach[i])
    depth = schedule.chain_levels(torch.from_numpy(pred), active).max()
    assert 1 <= depth <= int(act.sum())
    if kind == "one entity":
        assert depth == int(act.sum())  # every active sample lists row 3


@pytest.mark.parametrize("b,active", [(0, []), (1, [True]), (1, [False])])
def test_row_predecessors_of_the_smallest_batches(b, active):
    rows = torch.tensor([[5, 5, 2, 5, 9]] * b, dtype=torch.int64).reshape(b, 5)
    pred = schedule.row_predecessors(rows, torch.tensor(active, dtype=torch.bool))
    assert pred.shape == (b, 5) and pred.dtype == torch.int32
    assert (pred == -1).all()
    assert schedule.chain_levels(pred, torch.tensor(active, dtype=torch.bool)).tolist() == [1] * sum(active) + [0] * (
        b - sum(active))


def test_chain_levels_of_one_relation_and_of_distinct_rows():
    b = 20
    ids = torch.arange(4 * b, dtype=torch.int32).reshape(4, b)
    active = torch.ones(b, dtype=torch.bool)
    active[7] = False
    one_relation = schedule.update_rows(*ids, torch.zeros(b, dtype=torch.int32), 4 * b)
    distinct = schedule.update_rows(*ids, torch.arange(b, dtype=torch.int32), 4 * b)
    chain = schedule.chain_levels(schedule.row_predecessors(one_relation, active), active)
    assert chain.tolist() == list(range(1, 8)) + [0] + list(range(8, b))
    assert schedule.chain_levels(schedule.row_predecessors(distinct, active), active).tolist() == active.tolist()
    assert (schedule.row_predecessors(distinct, active) == -1).all()


def _level_order(ids, n, viol):
    """A permutation of the batch by the level of each sample in its chains
    (0 for samples that do not update), then by index."""
    level = schedule.chain_levels(schedule.row_predecessors(schedule.update_rows(*ids, n), viol), viol)
    return torch.from_numpy(np.lexsort((np.arange(level.shape[0]), level)))


def _tables(rng, n, n_rel, k, model):
    ent = rng.normal(size=(n, k)) * 0.4
    rel = rng.normal(size=(n_rel, k)) * 0.4
    if model == "transe":
        tables = (ent, rel)
    elif model == "transh":
        w = rng.normal(size=(n_rel, k))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        tables = (ent, rel, w)
    else:
        ent /= np.linalg.norm(ent, axis=1, keepdims=True)
        rel /= np.linalg.norm(rel, axis=1, keepdims=True)
        w = np.eye(k) + rng.normal(size=(n_rel, k, k)) * 0.15
        tables = (ent, rel, w)
    return [torch.from_numpy(a.astype(np.float32)) for a in tables]


UPDATES = {
    "transe": transe_update.transe_sequential_update_reference,
    "transh": transh_update.transh_sequential_update_reference,
    "transr": transr_update.transr_sequential_update_reference,
}


@pytest.mark.parametrize("n,n_rel", [(12, 2), (60, 8)])
@pytest.mark.parametrize("model,kw", [
    ("transe", dict(l1=True)),
    ("transe", dict(l1=False)),
    ("transh", dict(max_iters=16)),
    ("transh", dict(max_iters=1)),
    ("transr", dict(l1=True, max_iters=16)),
    ("transr", dict(l1=False, max_iters=2)),
])
def test_plain_versions_give_the_same_tables_in_level_order(model, kw, n, n_rel):
    rng = np.random.default_rng(n + n_rel + len(kw))
    k, b = 8, 24
    tables = _tables(rng, n, n_rel, k, model)
    ph, pt, nh, nt = (torch.from_numpy(rng.integers(0, n, b).astype(np.int32)) for _ in range(4))
    pt[: b // 6] = ph[: b // 6]
    nh[b // 6: b // 3] = ph[b // 6: b // 3]
    r = torch.from_numpy(rng.integers(0, n_rel, b).astype(np.int32))
    valid = torch.from_numpy(rng.random(b) > 0.1)
    update = UPDATES[model]
    kw = dict(kw, learning_rate=0.05, margin=1.0)
    # The outputs: the tables, then the loss, the decisions and (K4, K5) the trips.
    m = len(tables)
    seq = update(*tables, ph, pt, r, nh, nt, valid, **kw)
    viol = seq[m + 1]
    assert 0 < int(viol.sum()) < b
    perm = _level_order((ph, pt, nh, nt, r), n, viol)
    if n == 60:
        assert not torch.equal(perm, torch.arange(b))  # the level order does reorder the batch
    got = update(*tables, *(x[perm] for x in (ph, pt, r, nh, nt, valid)), **kw)
    for table, want in zip(got[:m], seq[:m]):
        assert torch.equal(table, want)
    assert torch.equal(got[m + 1], viol[perm])
    for extra, want in zip(got[m + 2:], seq[m + 2:]):
        assert torch.equal(extra, want[perm])
    # Only the loss's sum order changed.
    assert float(got[m]) == pytest.approx(float(seq[m]), rel=1e-5)
