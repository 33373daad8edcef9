"""Hierarchical co-cluster merging (paper §IV-D), signature scheme.

Every atom co-cluster is summarized by a *signature*: its member mean over a
small set of globally shared anchor columns (anchor rows for column atoms),
centered and unit-normalized. Atoms from all blocks and resamples are then
aligned by one small weighted k-means over the signatures (best of a few
seedings), every point casts one vote per resample for its atom's global
cluster, and the final labels are the vote argmax. This is the reference's
``signature_merge``; its merge k-means stays on the plain (``"jnp"``) path,
as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kmeans as _kmeans

__all__ = [
    "MergeResult",
    "anchor_indices",
    "atom_signatures",
    "cluster_signatures",
    "cluster_atoms_best",
    "memberships_from_votes",
    "finalize_assignment",
    "signature_merge",
]


class MergeResult(NamedTuple):
    row_labels: torch.Tensor   # (M,) int64 (-1 = outlier in overlap mode)
    col_labels: torch.Tensor   # (N,) int64
    row_votes: torch.Tensor    # (M, K_row) vote counts
    col_votes: torch.Tensor    # (N, K_col)
    row_sigs: torch.Tensor | None = None   # (K_row, q_row) unit rows
    col_sigs: torch.Tensor | None = None   # (K_col, q_col)
    row_mean: torch.Tensor | None = None   # (q_row,) centering mean
    col_mean: torch.Tensor | None = None   # (q_col,)
    row_membership: torch.Tensor | None = None  # (M, K_row) bool
    col_membership: torch.Tensor | None = None  # (N, K_col) bool


def _one_hot(labels: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """One-hot over the last axis; label ``-1`` gives the zero row."""
    return (labels[..., None] == torch.arange(k, device=labels.device)).to(dtype)


def memberships_from_votes(votes: torch.Tensor, overlap_threshold: float,
                           min_membership: int = 0) -> torch.Tensor:
    """Boolean membership ``(P, K)`` from a vote table (DESIGN.md §11).

    A point joins every cluster whose vote share reaches
    ``overlap_threshold``; ``min_membership > 0`` guarantees its top
    clusters by share (ties toward the lower id, like ``argmax``).
    """
    votes = votes.to(torch.float32)
    total = torch.sum(votes, dim=1, keepdim=True)
    share = votes / total.clamp_min(1.0)
    member = share >= overlap_threshold
    if min_membership > 0:
        order = torch.argsort(-share, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        member = member | (rank < min_membership)
    return member


def finalize_assignment(votes: torch.Tensor, assignment: str = "hard",
                        overlap_threshold: float = 0.25,
                        min_membership: int = 0):
    """``(labels, membership)`` from a vote table: the argmax and its one-hot
    in hard mode; :func:`memberships_from_votes` with ``-1`` for outliers in
    overlap mode."""
    argmax = torch.argmax(votes, dim=1)
    if assignment == "hard":
        return argmax, _one_hot(argmax, votes.shape[1], torch.bool)
    if assignment != "overlap":
        raise ValueError(
            f"assignment must be 'hard' or 'overlap', got {assignment!r}")
    member = memberships_from_votes(votes, overlap_threshold, min_membership)
    labels = torch.where(member.any(dim=1), argmax, -1)
    return labels, member


def anchor_indices(length: int, q: int, generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    """``min(q, length)`` distinct anchor indices into an axis of ``length``."""
    return torch.randperm(length, generator=generator, device=device)[: min(q, length)]


def atom_signatures(feats: torch.Tensor, labels: torch.Tensor, k: int):
    """Per-atom signatures ``(B, k, q)`` and member counts ``(B, k)``.

    ``feats (B, P, q)`` are the points' anchor features and ``labels (B, P)``
    their local cluster ids. The signature is the member mean, centered by
    the block's feature mean and unit-normalized.
    """
    feats = feats - torch.mean(feats, dim=1, keepdim=True)
    onehot = _one_hot(labels, k, feats.dtype)                     # (B, P, k)
    sums = onehot.mT @ feats                                      # (B, k, q)
    counts = torch.sum(onehot, dim=1)                             # (B, k)
    sig = sums / counts[..., None].clamp_min(1.0)
    norm = torch.linalg.vector_norm(sig, dim=-1, keepdim=True)
    return sig / norm.clamp_min(1e-12), counts


def cluster_signatures(feats: torch.Tensor, labels: torch.Tensor, k: int):
    """Per-cluster serving signatures ``(sigs (k, q), mean (q,), counts (k,))``:
    member means of globally centered anchor features, unit-normalized.
    Label ``-1`` points count for no cluster."""
    feats = feats.to(torch.float32)
    mean = torch.mean(feats, dim=0)
    f = feats - mean
    onehot = _one_hot(labels, k, f.dtype)                         # (P, k)
    sums = onehot.mT @ f
    counts = torch.sum(onehot, dim=0)
    sig = sums / counts[:, None].clamp_min(1.0)
    norm = torch.linalg.vector_norm(sig, dim=-1, keepdim=True)
    return sig / norm.clamp_min(1e-12), mean, counts


def cluster_atoms_best(flat: torch.Tensor, w: torch.Tensor, k_global: int,
                       n_iter: int, n_restarts: int = 4,
                       generator: torch.Generator | None = None, seeds=None):
    """Weighted k-means over flattened atom signatures, best of
    ``n_restarts`` seedings by inertia; the restarts are one batch.

    ``flat (n_atoms, q)``, ``w (n_atoms,)``; ``seeds (n_restarts,
    k_global)`` atom indices replace the k-means++ draws. Returns the
    winning labels ``(n_atoms,)``.
    """
    x = flat[None].expand(n_restarts, -1, -1).contiguous()
    init = None if seeds is None else _kmeans.take_points(x, seeds)
    res = _kmeans.kmeans(x, k_global, n_iter=n_iter, weights=w[None].expand(
        n_restarts, -1), init=init, generator=generator, device=flat.device)
    return res.labels[torch.argmin(res.inertia)]


def _votes(atom_global, labels, index, of_block, n_points, k, w_mask):
    """Vote table ``(n_points, k)``: each point of each (resample, block)
    votes for its atom's global cluster, weighted by the block's survival."""
    point_global = torch.gather(atom_global, 2, labels)           # (T_p, B, P)
    points = index[:, of_block, :]                                # (T_p, B, P)
    w = torch.ones(points.shape, dtype=torch.float32, device=points.device)
    if w_mask is not None:
        w = w * w_mask[:, :, None]
    votes = torch.zeros((n_points, k), dtype=torch.float32, device=points.device)
    return votes.index_put_((points.reshape(-1), point_global.reshape(-1)),
                            w.reshape(-1), accumulate=True)


def signature_merge(
    *,
    row_sigs: torch.Tensor,     # (T_p, B, k, q)
    row_counts: torch.Tensor,   # (T_p, B, k)
    row_labels: torch.Tensor,   # (T_p, B, phi) local labels
    row_index: torch.Tensor,    # (T_p, m, phi) global row ids per block-row
    col_sigs: torch.Tensor,     # (T_p, B, d, q)
    col_counts: torch.Tensor,
    col_labels: torch.Tensor,   # (T_p, B, psi)
    col_index: torch.Tensor,    # (T_p, n, psi)
    n_rows: int,
    n_cols: int,
    k_row: int,
    k_col: int,
    m: int,
    n: int,
    kmeans_iters: int = 25,
    n_restarts: int = 4,
    row_features: torch.Tensor | None = None,   # (M, q_row) anchor-col sliver
    col_features: torch.Tensor | None = None,   # (N, q_col) anchor-row sliver
    assignment: str = "hard",
    overlap_threshold: float = 0.25,
    min_membership: int = 0,
    block_mask: torch.Tensor | None = None,     # (T_p, B) bool: True = survived
    generator: torch.Generator | None = None,
    row_seeds=None,
    col_seeds=None,
) -> MergeResult:
    """Consensus merge of the per-resample atom results.

    ``block_mask`` removes the masked (resample, block) atoms from the
    consensus: zero weight in the signature k-means and zero votes.
    ``row_seeds`` / ``col_seeds`` (``(n_restarts, k)`` atom indices)
    replace the merge k-means++ draws from ``generator``. With the anchor slivers the
    result also carries the per-cluster serving signatures.
    """
    t_p, b, k, _q = row_sigs.shape
    d = col_sigs.shape[2]
    if b != m * n:
        raise ValueError(f"{b} blocks per resample do not form an {m} x {n} grid")
    w_mask = None
    if block_mask is not None:
        w_mask = block_mask.to(torch.float32)                     # (T_p, B)
        row_counts = row_counts * w_mask[:, :, None]
        col_counts = col_counts * w_mask[:, :, None]
    blocks = torch.arange(b, device=row_sigs.device)

    def side(sigs, counts, labels, index, of_block, n_points, k_local, k_global, seeds):
        atom_global = cluster_atoms_best(
            sigs.reshape(-1, sigs.shape[-1]), counts.reshape(-1), k_global,
            kmeans_iters, n_restarts, generator=generator, seeds=seeds)
        atom_global = atom_global.reshape(t_p, b, k_local)
        votes = _votes(atom_global, labels, index, of_block, n_points,
                       k_global, w_mask)
        labels_out, member = finalize_assignment(
            votes, assignment, overlap_threshold, min_membership)
        return labels_out, votes, member

    final_rows, row_votes, row_member = side(
        row_sigs, row_counts, row_labels, row_index, blocks // n, n_rows, k,
        k_row, row_seeds)
    final_cols, col_votes, col_member = side(
        col_sigs, col_counts, col_labels, col_index, blocks % n, n_cols, d,
        k_col, col_seeds)

    row_sigs_out = col_sigs_out = row_mean = col_mean = None
    if row_features is not None:
        row_sigs_out, row_mean, _ = cluster_signatures(row_features, final_rows, k_row)
    if col_features is not None:
        col_sigs_out, col_mean, _ = cluster_signatures(col_features, final_cols, k_col)
    return MergeResult(final_rows, final_cols, row_votes, col_votes,
                       row_sigs=row_sigs_out, col_sigs=col_sigs_out,
                       row_mean=row_mean, col_mean=col_mean,
                       row_membership=row_member, col_membership=col_member)
