"""Cuckoo-hash membership index for known triples.

Counterpart of ``kb2e_tpu/sampling/cuckoo.py``.  The sampler asks, for every
corruption candidate, whether the corrupted triple is a known one.  This
index answers with TWO independent probes (two-table cuckoo hashing) instead
of the ~log2(T) dependent gathers of the binary search in
:mod:`kb2e_tpu_torch.sampling.membership`.

Keys are (g, t) pairs with g = h·R + r packed into int32 (valid while
N·R < 2^31; larger graphs fall back to the binary search).  Tables are built
on the host with random-walk insertion (:func:`build`, a NumPy copy of the
JAX package's, so the same triples give the same table, fingerprints, size
and salt); a failed build rehashes with fresh salts and, if needed, a larger
table.

Layout: one flat int32 array of shape [2·M, 2] — row (tbl·M + slot) holds
(g, t) of the resident key, or (-1, -1) when empty — and a per-slot int32
fingerprint array [2·M], 0 when empty.

On tensors the hashes are uint32 arithmetic with wrap-around.  torch has no
usable uint32 arithmetic, so :func:`hash_slots` and :func:`fingerprint` work
in int64 masked to the low 32 bits: every value is masked before each shift
(``>>`` on int64 is arithmetic) and before ``%``; a product of two 32-bit
values may wrap int64, and its low 32 bits survive the wrap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EMPTY = -1
# Distinct odd multipliers per table (Knuth-style multiplicative hashing).
_MULTS_G = (0x9E3779B1, 0x85EBCA77)
_MULTS_T = (0xC2B2AE3D, 0x27D4EB2F)
# Third multiplier pair for the 32-bit fingerprint (independent of the slot
# hashes so slot and fingerprint collisions are uncorrelated).
_FP_MULT_G = 0x165667B1
_FP_MULT_T = 0xD3A2646D
_FP_EMPTY = 0  # sentinel; computed fingerprints avoid it (0 -> 1)
_M32 = 0xFFFFFFFF


def _hash(g: np.ndarray, t: np.ndarray, salt: int, table: int, m: int) -> np.ndarray:
    """Slot index in [0, m) (uint32 wrap-around, host NumPy)."""
    h = (
        g.astype(np.uint32) * np.uint32(_MULTS_G[table])
        + t.astype(np.uint32) * np.uint32(_MULTS_T[table])
        + np.uint32(salt)
    )
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    return (h % np.uint32(m)).astype(np.int32)


def _fingerprint(g: np.ndarray, t: np.ndarray, salt: int) -> np.ndarray:
    """32-bit key fingerprint (uint32 wrap-around, host NumPy); never 0.

    Stored per slot so membership needs ONE int32 gather per probe instead
    of two (key + value).  The sentinel 0 marks empty slots; real
    fingerprints map 0 -> 1.
    """
    h = (
        g.astype(np.uint32) * np.uint32(_FP_MULT_G)
        + t.astype(np.uint32) * np.uint32(_FP_MULT_T)
        + np.uint32(salt ^ 0x5BF03635)
    )
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x7FEB352D)
    h ^= h >> np.uint32(15)
    return np.where(h == np.uint32(_FP_EMPTY), np.uint32(1), h).astype(np.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of an integer tensor, as int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    return (x * c) & _M32


def _to_int32(h: torch.Tensor) -> torch.Tensor:
    """Reinterpret a value in [0, 2^32) as int32 (two's complement)."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def hash_slots(g: torch.Tensor, t: torch.Tensor, salt: int, table: int, m: int) -> torch.Tensor:
    """int64 slot index in [0, m): :func:`_hash` on tensors, bit for bit."""
    h = (_mul32(_u32(g), _MULTS_G[table]) + _mul32(_u32(t), _MULTS_T[table]) + (salt & _M32)) & _M32
    h ^= h >> 15
    h = _mul32(h, 0x2C1B3C6D)
    h ^= h >> 12
    return h % (m & _M32)


def fingerprint(g: torch.Tensor, t: torch.Tensor, salt: int) -> torch.Tensor:
    """int32 fingerprint: :func:`_fingerprint` on tensors, bit for bit."""
    h = (_mul32(_u32(g), _FP_MULT_G) + _mul32(_u32(t), _FP_MULT_T) + ((salt ^ 0x5BF03635) & _M32)) & _M32
    h ^= h >> 16
    h = _mul32(h, 0x7FEB352D)
    h ^= h >> 15
    return _to_int32(torch.where(h == _FP_EMPTY, torch.ones_like(h), h))


@dataclasses.dataclass
class CuckooIndex:
    table: np.ndarray  # int32 [2*M, 2] rows of (g, t); -1 = empty
    fp: np.ndarray  # int32 [2*M] fingerprint per slot; 0 = empty
    m: int
    salt: int
    n_relations: int  # for g = h*R + r packing


def build(
    heads: np.ndarray,
    rels: np.ndarray,
    tails: np.ndarray,
    n_relations: int,
    *,
    seed: int = 0,
    max_kicks: int = 500,
) -> CuckooIndex:
    """Build the index from (deduplicated) triples.  Raises OverflowError if
    g = h·R + r doesn't fit int32 (caller falls back to binary search)."""
    g64 = heads.astype(np.int64) * n_relations + rels.astype(np.int64)
    if g64.size and g64.max() >= 2**31:
        raise OverflowError("N*R exceeds int32 packing range")
    g_all = g64.astype(np.int32)
    t_all = tails.astype(np.int32)
    n = g_all.shape[0]

    rng = np.random.default_rng(seed)
    m = 1
    while m < max(8, int(n * 1.3)):
        m *= 2

    for attempt in range(16):
        salt = int(rng.integers(0, 2**31))
        # Per-key global slots for both tables, hashed up front; the
        # insertion loop then moves key INDICES and never re-hashes.
        with np.errstate(over="ignore"):
            slots = np.stack(
                [
                    _hash(g_all, t_all, salt, 0, m).astype(np.int64),
                    _hash(g_all, t_all, salt, 1, m).astype(np.int64) + m,
                ],
                axis=1,
            )
        occupant = np.full(2 * m, _EMPTY, dtype=np.int64)  # key index per slot
        ok = True
        for i in range(n):
            key, tbl = i, 0
            for _ in range(max_kicks):
                slot = slots[key, tbl]
                resident = occupant[slot]
                occupant[slot] = key
                if resident == _EMPTY:
                    break
                # Continue with the evicted key in its other table (table-1
                # slots are offset by +m, so the two never collide).
                key = resident
                tbl = 1 if slots[key, 0] == slot else 0
            else:
                ok = False
                break
        if ok:
            table = np.full((2 * m, 2), _EMPTY, dtype=np.int32)
            filled = occupant != _EMPTY
            table[filled, 0] = g_all[occupant[filled]]
            table[filled, 1] = t_all[occupant[filled]]
            fp = np.full(2 * m, _FP_EMPTY, dtype=np.int32)
            with np.errstate(over="ignore"):
                fp[filled] = _fingerprint(g_all[occupant[filled]], t_all[occupant[filled]], salt)
            return CuckooIndex(table=table, fp=fp, m=m, salt=salt, n_relations=n_relations)
        if attempt % 4 == 3:
            m *= 2  # rare: grow and retry
    raise RuntimeError("cuckoo build failed after 16 attempts")


def _packed(n_relations: int, qh: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    # g = h·R + r fits int32 wherever the index exists (build checks N·R).
    return qh.to(torch.int64) * n_relations + qr.to(torch.int64)


def contains(
    table: torch.Tensor,  # int32 [2*M, 2]
    m: int,
    salt: int,
    n_relations: int,
    qh: torch.Tensor,
    qr: torch.Tensor,
    qt: torch.Tensor,
) -> torch.Tensor:
    """Membership of each query triple (bool, the query's shape): both slot
    probes against the resident (g, t) keys."""
    g = _packed(n_relations, qh, qr)
    qt = qt.to(torch.int64)
    s0 = hash_slots(g, qt, salt, 0, m)
    s1 = hash_slots(g, qt, salt, 1, m) + m
    keys, vals = table[:, 0], table[:, 1]
    hit0 = (keys[s0] == g) & (vals[s0] == qt)
    hit1 = (keys[s1] == g) & (vals[s1] == qt)
    return hit0 | hit1


def contains_fp(
    fp_table: torch.Tensor,  # int32 [2*M] per-slot fingerprints; 0 = empty
    m: int,
    salt: int,
    n_relations: int,
    qh: torch.Tensor,
    qr: torch.Tensor,
    qt: torch.Tensor,
) -> torch.Tensor:
    """Fingerprint membership: 2 gathers per query instead of 4.

    Members always match their own fingerprint, so no certified negative is
    ever a known triple.  A fingerprint collision (P ≈ 2·2⁻³² per probe)
    falsely rejects a true negative, which then falls to the next resample
    round.
    """
    g = _packed(n_relations, qh, qr)
    s0 = hash_slots(g, qt, salt, 0, m)
    s1 = hash_slots(g, qt, salt, 1, m) + m
    f = fingerprint(g, qt, salt)
    return (fp_table[s0] == f) | (fp_table[s1] == f)
