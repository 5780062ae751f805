"""Row-permutation and pivot-compaction ops (the port of
`conflux_tpu/ops/permute.py`; the reference's `utils.hpp:12-160` and
`push_pivots_up`, `conflux_opt.hpp:176-218`).

Index tensors are int64 (torch's index dtype). Where the JAX package's
scatters silently drop out-of-range ids (`mode="drop"`), these ops route
such ids to an explicit dump slot, since torch indexing raises on them.
"""

from __future__ import annotations

import torch


def permute_rows(A: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out[i, :] = A[perm[i], :]."""
    return A[perm, :]


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def inverse_permute_rows(A: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out[perm[i], :] = A[i, :] — the inverse of :func:`permute_rows`."""
    return A[invert_permutation(perm), :]


def prepend_column(A: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Glue an index column onto a candidate buffer (reference
    `utils.hpp:12-26`)."""
    return torch.cat([col[:, None].to(A.dtype), A], dim=1)


def swap_minimal_perm(gpiv: torch.Tensor, m: int) -> torch.Tensor:
    """Length-m permutation placing winner j at slot j with <= 2v moves.

    Slots [0, v) take the winners in pivot order, top-slot occupants
    displaced by an incoming winner drop into the slots those winners
    vacated (in ascending order), and every other row stays put. gpiv
    entries outside [0, m) (tournament pad ids from a rank-deficient panel)
    are replaced by the lowest unused row ids, so the result is always a
    valid permutation. A (B, v) batch of winners gives (B, m), row by row.
    """
    g = (gpiv if gpiv.dim() == 2 else gpiv[None]).long()
    B, v = g.shape
    dev = g.device
    pos = torch.arange(m, device=dev).expand(B, m)
    valid = (g >= 0) & (g < m)
    # slot m is the dump for invalid ids (the JAX scatter drops them)
    is_w = torch.zeros((B, m + 1), dtype=torch.bool, device=dev)
    is_w.scatter_(1, torch.where(valid, g, m), valid)
    is_w = is_w[:, :m]
    # lowest unused rows, ascending, to stand in for invalid winner ids
    unused = torch.sort(torch.where(is_w, m, pos), dim=1).values
    bad_rank = torch.cumsum((~valid).long(), 1) - 1
    g = torch.where(valid, g, torch.gather(unused, 1, bad_rank.clamp(0, m - 1)))
    is_w = torch.zeros((B, m), dtype=torch.bool, device=dev)
    is_w.scatter_(1, g.clamp(0, m - 1), True)
    # non-winner rows in the top v slots, ascending (padded with m, which
    # the clamp keeps in range; #vacant slots == #displaced rows)
    disp = torch.sort(torch.where((pos < v) & ~is_w, pos, m), dim=1).values
    vac = (pos >= v) & is_w
    rank = torch.cumsum(vac.long(), 1) - 1
    sperm = torch.where(vac, torch.gather(disp, 1, rank.clamp(0, m - 1)), pos)
    sperm[:, :v] = g
    return sperm if gpiv.dim() == 2 else sperm[0]


def push_pivots_up(A: torch.Tensor, pivot_mask: torch.Tensor):
    """Stable partition: rows with pivot_mask True move to the top, others
    keep their relative order below. Returns (A[perm], perm)."""
    n = A.shape[0]
    idx = torch.arange(n, device=A.device)
    perm = torch.argsort(torch.where(pivot_mask, idx, idx + n), stable=True)
    return A[perm, :], perm
