"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written kernel computes, batched over a
leading block dimension ``B``. ``ops.py`` runs them for tensors that lie on
the CPU; on the card they are the oracle the tests and ``chip_smoke.py``
hold the kernels against. They mirror the reference package's
``kernels/ref.py`` oracles.
"""

from __future__ import annotations

import torch

__all__ = ["kmeans_assign_ref", "kmeans_update_ref", "scale_apply_ref",
           "bipartite_normalize_ref"]


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment of ``x (B, P, D)`` to ``centroids (B, K, D)``.

    Returns ``(labels (B, P) int32, min squared distance (B, P))``; ties go to
    the lowest centroid id, as ``jnp.argmin`` breaks them.
    """
    x2 = torch.sum(x * x, dim=-1, keepdim=True)                  # (B, P, 1)
    c2 = torch.sum(centroids * centroids, dim=-1)                # (B, K)
    d2 = x2 - 2.0 * (x @ centroids.mT) + c2[:, None, :]          # (B, P, K)
    labels = torch.argmin(d2, dim=-1).to(torch.int32)
    return labels, torch.amin(d2, dim=-1).clamp_min(0.0)


def kmeans_update_ref(x: torch.Tensor, centroids: torch.Tensor,
                      weights: torch.Tensor | None = None):
    """One Lloyd step's statistics: ``(labels, d2, sums (B, K, D), counts (B, K))``.

    ``sums[b, k] = sum_{p: labels[b, p] == k} w[b, p] * x[b, p]`` and
    ``counts[b, k]`` the matching weight sum; ``weights=None`` weighs every
    point 1. Materializes the ``(B, P, K)`` one-hot the kernel avoids.
    """
    labels, d2 = kmeans_assign_ref(x, centroids)
    k = centroids.shape[1]
    ids = torch.arange(k, device=x.device)
    onehot = (labels[..., None] == ids).to(x.dtype)             # (B, P, K)
    if weights is not None:
        onehot = onehot * weights[..., None]
    sums = onehot.mT @ x                                         # (B, K, D)
    counts = torch.sum(onehot, dim=1)                            # (B, K)
    return labels, d2, sums, counts


def scale_apply_ref(a: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
    """``a (B, M, N) * s1 (B, M)[..., None] * s2 (B, N)[..., None, :]``,
    row scale first, as the reference formula associates it."""
    return a * s1[..., :, None] * s2[..., None, :]


def bipartite_normalize_ref(a: torch.Tensor, d1: torch.Tensor,
                            d2: torch.Tensor, eps: float = 1e-8):
    """``A * rsqrt(max(d1, eps))[:, None] * rsqrt(max(d2, eps))[None, :]``
    per block, from the raw degrees ``d1 (B, M)`` / ``d2 (B, N)``."""
    s1 = torch.rsqrt(torch.clamp_min(d1, eps))
    s2 = torch.rsqrt(torch.clamp_min(d2, eps))
    return scale_apply_ref(a, s1, s2)
