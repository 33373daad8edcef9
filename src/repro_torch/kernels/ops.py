"""Public kernel entry points: dispatch by the device the tensors lie on.

A CUDA tensor always launches the hand-written kernel (and raises if it
cannot); a CPU tensor takes the plain version in ``ref.py``. There is no
switch that sends CUDA tensors to the plain version and no fallback on
error, so a run on the card either went through the kernels or failed.

Every operand is batched over a leading block dimension ``B`` — the port's
form of the reference's ``vmap`` over the block stack.
"""

from __future__ import annotations

import torch

from . import bipartite_normalize as _scale
from . import kmeans_assign as _assign
from . import kmeans_update as _update
from . import ref

__all__ = ["kmeans_assign", "kmeans_update", "bipartite_normalize",
           "launch_counts", "reset_launch_counts"]

_KERNELS = {"kmeans_update": _update, "kmeans_assign": _assign,
            "scale_apply": _scale}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on CUDA or CPU tensors, got {t.device}")


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid: ``(labels (B, P) int32, d2 (B, P))``."""
    if _on_cuda(x):
        return _assign.kmeans_assign(x, centroids)
    return ref.kmeans_assign_ref(x, centroids)


def kmeans_update(x: torch.Tensor, centroids: torch.Tensor,
                  weights: torch.Tensor | None = None):
    """One fused Lloyd step: ``(labels, d2, sums (B, K, D), counts (B, K))``."""
    if _on_cuda(x):
        return _update.kmeans_update(x, centroids, weights)
    return ref.kmeans_update_ref(x, centroids, weights)


def bipartite_normalize(a: torch.Tensor, eps: float = 1e-8):
    """``A_n = D1^{-1/2} A D2^{-1/2}`` per block, degrees taken on ``|A|``.

    Returns ``(a_n, d1_isqrt (B, M), d2_isqrt (B, N))``. The degree sums are
    ``vector_norm(ord=1)`` reductions, which need no ``|A|`` temporary.
    """
    d1 = torch.linalg.vector_norm(a, ord=1, dim=2)
    d2 = torch.linalg.vector_norm(a, ord=1, dim=1)
    s1 = torch.rsqrt(torch.clamp_min(d1, eps))
    s2 = torch.rsqrt(torch.clamp_min(d2, eps))
    if _on_cuda(a):
        return _scale.scale_apply(a, s1, s2), s1, s2
    return ref.scale_apply_ref(a, s1, s2), s1, s2


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
