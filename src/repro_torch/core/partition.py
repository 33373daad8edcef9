"""Large-matrix partitioning (paper §IV-B).

A :class:`PartitionPlan` describes how ``A (M x N)`` is cut into an ``m x n``
grid of uniform ``phi x psi`` blocks, repeated for ``T_p`` independent random
resamples. The plan search is the numpy model in :mod:`.probability`, so the
port resolves the same plan as the reference package for the same arguments.

Each resample's permutations come from a ``torch.Generator`` seeded from
``(plan.seed, resample)``. They do not reproduce the reference's threefry
bits; tests inject the reference's index maps instead
(``extract_blocks(..., row_idx=, col_idx=)``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import seeded_generator
from . import probability

__all__ = ["PartitionPlan", "make_plan", "resample_indices", "extract_blocks",
           "extract_blocks_sparse", "coverage_probability"]

# Stream id of the per-resample permutations in ``seeded_generator``.
_PERM_STREAM = 0


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    n_rows: int
    n_cols: int
    m: int            # row-blocks per resample
    n: int            # col-blocks per resample
    phi: int          # rows per block
    psi: int          # cols per block
    t_p: int          # number of resamples
    seed: int = 0
    detection_p: float = 1.0  # Theorem-1 lower bound used to pick t_p
    # SpMM backend the plan priced its blocks with (``probability``); the
    # sparse path of ``lamc_cocluster`` overwrites it with the route that ran.
    spmm_route: str = "dense"

    @property
    def blocks_per_resample(self) -> int:
        return self.m * self.n

    @property
    def total_blocks(self) -> int:
        return self.m * self.n * self.t_p

    @property
    def rows_used(self) -> int:
        return self.m * self.phi

    @property
    def cols_used(self) -> int:
        return self.n * self.psi


def make_plan(
    n_rows: int,
    n_cols: int,
    *,
    min_cocluster_rows: int,
    min_cocluster_cols: int,
    p_thresh: float = 0.95,
    workers: int = 1,
    seed: int = 0,
    k: int = 8,
    expected_failed_blocks: int = 0,
    grid_candidates=(1, 2, 4, 8, 16, 32),
    svd_method: str = "randomized",
    density: float = 1.0,
    spmm_impl: str = "auto",
) -> PartitionPlan:
    """Optimal plan via the probabilistic model (Eq. 4 + cost search)."""
    cand = probability.plan_partition(
        n_rows,
        n_cols,
        min_cocluster_rows=min_cocluster_rows,
        min_cocluster_cols=min_cocluster_cols,
        p_thresh=p_thresh,
        workers=workers,
        k=k,
        expected_failed_blocks=expected_failed_blocks,
        grid_candidates=grid_candidates,
        svd_method=svd_method,
        density=density,
        spmm_impl=spmm_impl,
    )
    return PartitionPlan(
        n_rows=n_rows,
        n_cols=n_cols,
        m=cand.m,
        n=cand.n,
        phi=cand.phi,
        psi=cand.psi,
        t_p=cand.t_p,
        seed=seed,
        detection_p=cand.detection_p,
        spmm_route=cand.spmm_route,
    )


def coverage_probability(plan: PartitionPlan, axis: str | None = None) -> float:
    """P(a given index appears in >= 1 of the T_p resamples).

    ``axis='row'`` / ``'col'`` gives the per-axis coverage; the default
    (``None``) returns their min — the guarantee that holds for *every*
    index of the matrix.
    """
    miss_row = 1.0 - plan.rows_used / plan.n_rows
    miss_col = 1.0 - plan.cols_used / plan.n_cols
    row_cov = 1.0 - miss_row**plan.t_p
    col_cov = 1.0 - miss_col**plan.t_p
    if axis == "row":
        return row_cov
    if axis == "col":
        return col_cov
    if axis is not None:
        raise ValueError(f"axis must be 'row', 'col' or None, got {axis!r}")
    return min(row_cov, col_cov)


def resample_indices(plan: PartitionPlan, resample: int,
                     device: torch.device):
    """Row/col index groups ``(m, phi)`` / ``(n, psi)`` for one resample.

    ``row_idx[i]`` are the global row ids landing in block-row ``i``.
    Deterministic in ``(plan.seed, resample)``.
    """
    gen = seeded_generator(device, plan.seed, _PERM_STREAM, resample)
    row_perm = torch.randperm(plan.n_rows, generator=gen, device=device)
    col_perm = torch.randperm(plan.n_cols, generator=gen, device=device)
    row_idx = row_perm[: plan.rows_used].reshape(plan.m, plan.phi)
    col_idx = col_perm[: plan.cols_used].reshape(plan.n, plan.psi)
    return row_idx, col_idx


def extract_blocks(a: torch.Tensor, plan: PartitionPlan, resample: int, *,
                   row_idx: torch.Tensor | None = None,
                   col_idx: torch.Tensor | None = None):
    """Extract the ``(m*n, phi, psi)`` block stack for one resample.

    Also returns the index maps so labels can be scattered back:
    ``blocks[i * n + j] == a[row_idx[i]][:, col_idx[j]]``. ``row_idx`` /
    ``col_idx`` override the seeded permutations (injected draws).
    """
    if row_idx is None or col_idx is None:
        row_idx, col_idx = resample_indices(plan, resample, a.device)
    rows, cols = row_idx.reshape(-1), col_idx.reshape(-1)
    # Two gathers; the first materializes an intermediate whose size depends
    # on the order — (rows_used, N) rows-first vs (M, cols_used) cols-first.
    # Gather the axis that shrinks the matrix most first, and drop that
    # intermediate before the block-stack copy, so peak memory is A plus two
    # submatrix-sized buffers.
    if plan.rows_used * plan.n_cols <= plan.n_rows * plan.cols_used:
        inter = a.index_select(0, rows)
        sub = inter.index_select(1, cols)                # (m*phi, n*psi)
    else:
        inter = a.index_select(1, cols)
        sub = inter.index_select(0, rows)
    del inter
    blocks = (
        sub.reshape(plan.m, plan.phi, plan.n, plan.psi)
        .transpose(1, 2)
        .reshape(plan.m * plan.n, plan.phi, plan.psi)
    )
    return blocks, row_idx, col_idx


def extract_blocks_sparse(a: torch.Tensor, plan: PartitionPlan, resample: int, *,
                          row_idx: torch.Tensor | None = None,
                          col_idx: torch.Tensor | None = None,
                          block_range: tuple[int, int] | None = None):
    """:func:`extract_blocks` for a coalesced COO matrix, O(nnz); the dense
    ``M x N`` matrix never exists.

    Every stored entry finds its destination ``(block, row, col)`` through
    the inverse resample permutation and is scattered into the dense block
    stack; entries whose row or column misses this resample's grid are
    dropped. Bit-exact against :func:`extract_blocks` on the densified
    matrix: each block cell receives one stored value or stays zero.
    ``block_range=(first, count)`` builds only blocks ``first .. first +
    count`` of the stack (a distributed rank's share).
    """
    from . import sparse as _sparse

    _sparse.validate_bcoo(a)
    if row_idx is None or col_idx is None:
        row_idx, col_idx = resample_indices(plan, resample, a.device)
    idx, vals = a.indices(), a.values()
    pr = _sparse._inverse(row_idx.reshape(-1), plan.n_rows)[idx[0]]
    pc = _sparse._inverse(col_idx.reshape(-1), plan.n_cols)[idx[1]]
    # Both sentinels must drop the entry explicitly: the column sentinel
    # j == n would alias a valid block id i * n + n for i < m - 1.
    valid = (pr < plan.rows_used) & (pc < plan.cols_used)
    pr, pc, vals = pr[valid], pc[valid], vals[valid]
    bid = torch.div(pr, plan.phi, rounding_mode="floor") * plan.n \
        + torch.div(pc, plan.psi, rounding_mode="floor")
    first, count = (0, plan.m * plan.n) if block_range is None else block_range
    if block_range is not None:
        keep = (bid >= first) & (bid < first + count)
        bid, pr, pc, vals = bid[keep] - first, pr[keep], pc[keep], vals[keep]
    blocks = torch.zeros((count, plan.phi, plan.psi), dtype=vals.dtype,
                         device=vals.device)
    blocks[bid, pr % plan.phi, pc % plan.psi] = vals
    return blocks, row_idx, col_idx
