"""Wrapper of the CUDA k-means assignment kernel (``csrc/kmeans.cu``).

Replaces ``kmeans_assign_pallas`` (``src/repro/kernels/kmeans_assign.py:59``):
nearest-centroid labels and clamped squared distances for a ``(B, P, D)``
batch of points against ``(B, K, D)`` centroids, in one launch for all
blocks. The plain version is ``ref.kmeans_assign_ref``; ``ops.kmeans_assign``
picks between them by the tensor's device.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["kmeans_assign", "check_points", "MAX_D", "MAX_K"]

MAX_D = 64
MAX_K = 64

#: Launches of the kernel since the counter was last set to 0.
launches = 0


def check_points(x: torch.Tensor, centroids: torch.Tensor,
                 weights: torch.Tensor | None = None) -> None:
    """Raise unless the operands are what the CUDA k-means kernels take."""
    if x.ndim != 3 or centroids.ndim != 3:
        raise ValueError(f"expected x (B, P, D) and centroids (B, K, D), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    b, p, d = x.shape
    if centroids.shape[0] != b or centroids.shape[2] != d:
        raise ValueError(f"centroids {tuple(centroids.shape)} do not match x "
                         f"{tuple(x.shape)}")
    k = centroids.shape[1]
    if not (1 <= d <= MAX_D and 1 <= k <= MAX_K and b >= 1 and p >= 1):
        raise ValueError(f"kernel takes B, P >= 1, 1 <= D <= {MAX_D} and "
                         f"1 <= K <= {MAX_K}; got B={b} P={p} D={d} K={k}")
    if weights is not None and tuple(weights.shape) != (b, p):
        raise ValueError(f"weights must be (B, P) = {(b, p)}, got "
                         f"{tuple(weights.shape)}")
    for name, t in (("x", x), ("centroids", centroids), ("weights", weights)):
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")


def raise_on_error(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.kmeans_error_string(err).decode()}")


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """``(labels (B, P) int32, d2 (B, P))`` computed by the CUDA kernel."""
    global launches
    check_points(x, centroids)
    lib = _build.load("kmeans")
    b, p, d = x.shape
    k = centroids.shape[1]
    labels = torch.empty((b, p), dtype=torch.int32, device=x.device)
    d2 = torch.empty((b, p), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.kmeans_assign_f32(x.data_ptr(), centroids.data_ptr(), b, p, d, k,
                                labels.data_ptr(), d2.data_ptr(), stream)
    raise_on_error(lib, err, "kmeans_assign")
    launches += 1
    return labels, d2
