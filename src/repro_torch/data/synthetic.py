"""Synthetic data with planted co-cluster ground truth.

A numpy copy of the reference package's generator: the same ``rng`` call
sequence, so the same ``np.random.Generator`` state yields a byte-identical
matrix and labels in both packages. That identity is what the end-to-end
parity tests rest on.

Generator model: pick k row clusters x d col clusters; each (r, c) pair is a
potential co-cluster with mean ``mu[r, c]``; entries are
``mu[u_i, v_j] + noise``; for sparse variants a Bernoulli mask keeps the
target density (classic checkerboard / block-diagonal planting). The
overlapping generator plants non-exhaustive memberships (DESIGN.md §11), and
the three proxies stand in for the paper's corpora at their shapes and
densities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "PlantedCoClusters",
    "PlantedOverlapCoClusters",
    "planted_cocluster_matrix",
    "planted_overlapping_cocluster_matrix",
    "to_bcoo",
    "amazon1000_proxy",
    "classic4_proxy",
    "rcv1_proxy",
]


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

    def bcoo(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """The planted matrix as a coalesced COO tensor (see ``to_bcoo``)."""
        return to_bcoo(self.matrix, device)


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


@dataclasses.dataclass
class PlantedOverlapCoClusters:
    """Overlapping, non-exhaustive planted ground truth (DESIGN.md §11).

    Membership matrices replace label vectors: a row (column) may belong
    to several co-clusters or to none. ``row_labels``/``col_labels`` are
    the hard projections (argmax membership, -1 for outliers) so the
    classic NMI/ARI metrics still apply to the covered points.
    """

    matrix: np.ndarray           # (M, N) float32
    row_membership: np.ndarray   # (M, k) bool
    col_membership: np.ndarray   # (N, d) bool
    k: int
    d: int
    density: float

    @property
    def shape(self):
        return self.matrix.shape

    @property
    def row_labels(self) -> np.ndarray:
        m = self.row_membership
        return np.where(m.any(1), m.argmax(1), -1).astype(np.int32)

    @property
    def col_labels(self) -> np.ndarray:
        m = self.col_membership
        return np.where(m.any(1), m.argmax(1), -1).astype(np.int32)

    def bcoo(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """The planted matrix as a coalesced COO tensor (see ``to_bcoo``)."""
        return to_bcoo(self.matrix, device)


def _overlap_membership(rng, n: int, k: int, overlap_frac: float,
                        outlier_frac: float) -> np.ndarray:
    """(n, k) bool membership: balanced primaries, ``overlap_frac`` of the
    covered points add a second distinct cluster, ``outlier_frac`` belong
    to none."""
    member = np.zeros((n, k), bool)
    n_out = int(round(outlier_frac * n))
    covered = n - n_out
    primary = np.arange(covered) % k
    member[np.arange(covered), primary] = True
    n_ov = int(round(overlap_frac * covered))
    second = (primary[:n_ov] + 1 + rng.integers(0, k - 1, n_ov)) % k
    member[np.arange(n_ov), second] = True
    member = member[rng.permutation(n)]
    return member


def planted_overlapping_cocluster_matrix(
    rng: np.random.Generator,
    n_rows: int,
    n_cols: int,
    k: int,
    d: int | None = None,
    *,
    row_overlap: float = 0.2,
    row_outliers: float = 0.05,
    col_overlap: float = 0.0,
    col_outliers: float = 0.0,
    signal: float = 4.0,
    noise: float = 1.0,
    density: float = 1.0,
    dtype=np.float32,
) -> PlantedOverlapCoClusters:
    """Planted co-clusters with overlapping and unassigned rows/columns.

    The NEO-CC regime (Whang & Dhillon): a point in several co-clusters
    has the *mean* of its clusters' checkerboard profiles (it sits midway
    between the cluster centroids — genuinely ambiguous, so consensus
    votes split across its clusters), and an outlier point is an
    *anomalous* row/column — an unstructured random profile at signal
    scale, so its restriction to different column blocks matches
    different clusters and its votes scatter instead of concentrating.
    ``row_overlap``/``col_overlap`` are the fraction of covered points
    with a second cluster; ``row_outliers``/``col_outliers`` the
    fraction belonging to none.

    Cell means are a circulant shift pattern (every cluster profile is a
    rotation of the same ramp, plus a seeded perturbation): equal norms,
    guaranteed pairwise separation — iid-uniform checkerboards
    occasionally draw two near-identical cluster profiles, which
    destroys the single-membership base clustering and with it any
    overlap measurement (the failure is in the planting, not the
    algorithm).
    """
    if d is None:
        d = k
    row_m = _overlap_membership(rng, n_rows, k, row_overlap, row_outliers)
    col_m = _overlap_membership(rng, n_cols, d, col_overlap, col_outliers)
    base = np.linspace(0.2, 1.0, max(k, d))
    mu = signal * base[(np.arange(k)[:, None] + np.arange(d)[None, :]) % max(k, d)]
    mu = (mu + rng.uniform(0.0, 0.1 * signal, (k, d))).astype(dtype)
    rw = row_m.astype(dtype) / np.maximum(row_m.sum(1, keepdims=True), 1)
    cw = col_m.astype(dtype) / np.maximum(col_m.sum(1, keepdims=True), 1)
    mat = rw @ mu @ cw.T
    row_out = ~row_m.any(1)
    col_out = ~col_m.any(1)
    mat[row_out] = rng.uniform(0.0, signal, (int(row_out.sum()), n_cols))
    mat[:, col_out] = rng.uniform(0.0, signal, (n_rows, int(col_out.sum())))
    mat += rng.normal(0.0, noise, mat.shape).astype(dtype)
    if density < 1.0:
        mask = rng.random(mat.shape) < density
        mat = np.where(mask, mat, 0.0).astype(dtype)
    return PlantedOverlapCoClusters(
        matrix=mat.astype(dtype),
        row_membership=row_m,
        col_membership=col_m,
        k=k,
        d=d,
        density=float((mat != 0).mean()),
    )


def amazon1000_proxy(seed: int = 0) -> PlantedCoClusters:
    """1000 x 1000 dense review-vector proxy (5 topics x 5 aspect groups)."""
    rng = np.random.default_rng(seed)
    return planted_cocluster_matrix(rng, 1000, 1000, k=5, d=5,
                                    signal=3.0, noise=1.0, density=1.0)


def classic4_proxy(seed: int = 0, n_docs: int = 18000) -> PlantedCoClusters:
    """18000 x 1000 doc-term proxy (4 collections), mildly sparse."""
    rng = np.random.default_rng(seed)
    return planted_cocluster_matrix(rng, n_docs, 1000, k=4, d=4,
                                    signal=4.0, noise=1.0, density=0.15)


def rcv1_proxy(seed: int = 0, n_docs: int = 100_000, n_terms: int = 5000) -> PlantedCoClusters:
    """RCV1-scale sparse proxy, trimmed by default to what host memory holds
    comfortably; ``n_docs`` / ``n_terms`` scale it."""
    rng = np.random.default_rng(seed)
    return planted_cocluster_matrix(rng, n_docs, n_terms, k=10, d=10,
                                    signal=5.0, noise=0.4, density=0.05)
