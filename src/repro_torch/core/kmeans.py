"""Fixed-iteration k-means, batched over a leading block dimension.

The reference vmaps its k-means over the block stack; here every function
takes ``x (B, P, D)`` and runs all ``B`` problems at once. The iteration
count is static, as in the reference (DESIGN.md §2): convergence is
reported (inertia) but never branched on.

``assign_impl`` keeps the reference's two values so configurations carry
across: ``"jnp"`` is the plain Lloyd step with a materialized one-hot, and
``"pallas"`` runs each step through ``kernels.ops.kmeans_update`` and the
final assignment through ``kernels.ops.kmeans_assign`` — the hand-written
CUDA kernels for tensors on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import fp32_policy, resolve_device, seeded_generator
from ..kernels import ops

__all__ = ["KMeansResult", "assign", "kmeans", "kmeanspp_init", "take_points"]

ASSIGN_IMPLS = ("jnp", "pallas")


class KMeansResult(NamedTuple):
    labels: torch.Tensor      # (B, P) int64
    centroids: torch.Tensor   # (B, K, D)
    inertia: torch.Tensor     # (B,) sum of (weighted) squared distances


def assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment: ``(labels (B, P) int64, min d2 (B, P))``."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)                  # (B, P, 1)
    c2 = torch.sum(centroids * centroids, dim=-1)                # (B, K)
    d2 = x2 - 2.0 * (x @ centroids.mT) + c2[:, None, :]          # (B, P, K)
    return torch.argmin(d2, dim=-1), torch.amin(d2, dim=-1).clamp_min(0.0)


def take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]`` for every block: ``(B, J, D)`` from ``idx (B, J)``.

    Seeds given as point indices are how injected k-means++ draws stay valid
    when the two packages' embeddings differ by singular-vector signs.
    """
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """k-means++ seeding per block, ``(B, K, D)``.

    With ``weights``, seeds are drawn proportional to ``w * d^2``, so
    zero-weight points are never selected.
    """
    b, p, d = x.shape
    w = torch.ones((b, p), dtype=x.dtype, device=x.device) if weights is None \
        else weights
    cents = torch.zeros((b, k, d), dtype=x.dtype, device=x.device)
    first = torch.multinomial(w, 1, generator=generator)
    cents[:, 0] = take_points(x, first)[:, 0]
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    for i in range(1, k):
        c = cents[:, :i]
        d2 = x2 - 2.0 * (x @ c.mT) + torch.sum(c * c, dim=-1)[:, None, :]
        dmin = torch.amin(d2, dim=-1).clamp_min(1e-12) * w
        cents[:, i] = take_points(x, torch.multinomial(dmin, 1, generator=generator))[:, 0]
    return cents


def _new_centroids(sums, counts, cents):
    """Member means; an empty cluster keeps its previous centroid."""
    return torch.where(counts[..., None] > 0,
                       sums / counts.clamp_min(1e-9)[..., None], cents)


def kmeans(
    x,
    k: int,
    n_iter: int = 16,
    assign_impl: str = "jnp",
    weights=None,
    init=None,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> KMeansResult:
    """Lloyd's algorithm on ``x (B, P, D)``: ``n_iter`` steps from k-means++.

    ``weights (B, P)`` makes seeding and updates weighted. ``init (B, K, D)``
    replaces the k-means++ seeding (the tests inject the reference's seeds
    here); otherwise seeds are drawn from ``generator`` (default: seeded 0).
    Inputs are moved to ``device``.
    """
    if assign_impl not in ASSIGN_IMPLS:
        raise ValueError(f"assign_impl must be one of {ASSIGN_IMPLS}, got "
                         f"{assign_impl!r}")
    dev = resolve_device(device)
    fp32_policy()
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    w = None if weights is None else torch.as_tensor(
        weights, dtype=torch.float32, device=dev).contiguous()
    if init is not None:
        cents = torch.as_tensor(init, dtype=torch.float32, device=dev).clone()
    else:
        gen = generator if generator is not None else seeded_generator(dev, 0)
        cents = kmeanspp_init(x, k, gen, weights=w)

    if assign_impl == "pallas":
        for _ in range(n_iter):
            _labels, _d2, sums, counts = ops.kmeans_update(x, cents, w)
            cents = _new_centroids(sums, counts, cents)
        labels, d2 = ops.kmeans_assign(x, cents)
    else:
        ids = torch.arange(k, device=dev)
        for _ in range(n_iter):
            labels, _d2 = assign(x, cents)
            onehot = (labels[..., None] == ids).to(x.dtype)     # (B, P, K)
            if w is not None:
                onehot = onehot * w[..., None]
            cents = _new_centroids(onehot.mT @ x, torch.sum(onehot, dim=1), cents)
        labels, d2 = assign(x, cents)
    if w is not None:
        d2 = d2 * w
    return KMeansResult(labels.long(), cents, torch.sum(d2, dim=-1))
