"""Exact, vectorised known-triple membership by binary search.

Counterpart of ``kb2e_tpu/sampling/membership.py``: the fallback of the
sampler for graphs where g = h·R + r overflows int32 and the cuckoo index
(:mod:`kb2e_tpu_torch.sampling.cuckoo`) cannot be built.  The triple set is
three int32 arrays sorted lexicographically by (h, r, t)
(:class:`kb2e_tpu_torch.data.triples.TripleSet`), and membership is a
branch-free binary search vectorised over the queries.
"""

from __future__ import annotations

import torch


def _lex_less(ah, ar, at, bh, br, bt):
    """(ah,ar,at) < (bh,br,bt) lexicographically, elementwise."""
    return (ah < bh) | ((ah == bh) & ((ar < br) | ((ar == br) & (at < bt))))


def contains(
    sorted_h: torch.Tensor,
    sorted_r: torch.Tensor,
    sorted_t: torch.Tensor,
    qh: torch.Tensor,
    qr: torch.Tensor,
    qt: torch.Tensor,
) -> torch.Tensor:
    """Is each query triple in the sorted, unique index?  bool, the query's shape."""
    n = sorted_h.shape[0]
    if n == 0:
        return torch.zeros(qh.shape, dtype=torch.bool, device=qh.device)
    lo = torch.zeros(qh.shape, dtype=torch.int64, device=qh.device)
    hi = torch.full(qh.shape, n, dtype=torch.int64, device=qh.device)
    for _ in range(max(1, (n + 1).bit_length())):
        mid = (lo + hi) >> 1
        # mid reaches n only once the search has settled at n; the gather
        # clamps there, as JAX's out-of-range gather does.
        at = torch.clamp(mid, max=n - 1)
        less = _lex_less(sorted_h[at], sorted_r[at], sorted_t[at], qh, qr, qt)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    idx = torch.clamp(lo, max=n - 1)
    return (sorted_h[idx] == qh) & (sorted_r[idx] == qr) & (sorted_t[idx] == qt)
