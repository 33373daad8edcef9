"""Synthetic data with planted co-cluster ground truth.

A numpy copy of the reference package's generator: the same ``rng`` call
sequence, so the same ``np.random.Generator`` state yields a byte-identical
matrix and labels in both packages. That identity is what the end-to-end
parity tests rest on.

Generator model: pick k row clusters x d col clusters; each (r, c) pair is a
potential co-cluster with mean ``mu[r, c]``; entries are
``mu[u_i, v_j] + noise``; for sparse variants a Bernoulli mask keeps the
target density (classic checkerboard / block-diagonal planting).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PlantedCoClusters", "planted_cocluster_matrix", "to_bcoo"]


@dataclasses.dataclass
class PlantedCoClusters:
    matrix: np.ndarray          # (M, N) float32
    row_labels: np.ndarray      # (M,) int32 ground truth
    col_labels: np.ndarray      # (N,) int32
    k: int
    d: int
    density: float              # fraction of nonzeros

    @property
    def shape(self):
        return self.matrix.shape


def planted_cocluster_matrix(
    rng: np.random.Generator,
    n_rows: int,
    n_cols: int,
    k: int,
    d: int | None = None,
    *,
    signal: float = 3.0,
    noise: float = 1.0,
    density: float = 1.0,
    diagonal_only: bool = False,
    balanced: bool = True,
    dtype=np.float32,
) -> PlantedCoClusters:
    """Checkerboard (or block-diagonal if ``diagonal_only``) planted matrix.

    ``signal/noise`` controls difficulty; ``density < 1`` produces sparse
    data (zeros off the support). Labels are shuffled so no algorithm can
    exploit index order.
    """
    if d is None:
        d = k
    if balanced:
        row_labels = np.arange(n_rows) % k
        col_labels = np.arange(n_cols) % d
    else:
        row_labels = rng.integers(0, k, n_rows)
        col_labels = rng.integers(0, d, n_cols)
    rng.shuffle(row_labels)
    rng.shuffle(col_labels)

    if diagonal_only:
        mu = np.zeros((k, d), dtype)
        for i in range(min(k, d)):
            mu[i, i] = signal
    else:
        # checkerboard: distinct mean per (r,c) cell, spread in [0, signal]
        mu = rng.uniform(0.0, signal, (k, d)).astype(dtype)

    mat = mu[row_labels][:, col_labels].astype(dtype)
    mat += rng.normal(0.0, noise, mat.shape).astype(dtype)
    if density < 1.0:
        mask = rng.random(mat.shape) < density
        mat = np.where(mask, mat, 0.0).astype(dtype)
    return PlantedCoClusters(
        matrix=mat,
        row_labels=row_labels.astype(np.int32),
        col_labels=col_labels.astype(np.int32),
        k=k,
        d=d,
        density=float((mat != 0).mean()),
    )


def to_bcoo(matrix: np.ndarray, device: str | torch.device = "cuda") -> torch.Tensor:
    """Dense numpy matrix -> coalesced 2-D COO tensor on ``device``: the
    ``np.nonzero`` triplets in row-major order (sorted and unique), as the
    reference's ``to_bcoo`` builds its BCOO."""
    mat = np.asarray(matrix)
    r, c = np.nonzero(mat)
    dev = resolve_device(device)
    indices = torch.from_numpy(np.stack([r, c]).astype(np.int64))
    values = torch.from_numpy(np.ascontiguousarray(mat[r, c], dtype=np.float32))
    return torch.sparse_coo_tensor(indices, values, mat.shape, is_coalesced=True,
                                   check_invariants=False).to(dev)
