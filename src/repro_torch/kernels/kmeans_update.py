"""Wrapper of the CUDA fused Lloyd-step kernel (``csrc/kmeans.cu``).

Replaces ``kmeans_update_pallas`` (``src/repro/kernels/kmeans_update.py:79``):
labels, clamped squared distances and the per-cluster weighted sums and
counts of one Lloyd iteration, for a ``(B, P, D)`` batch in one launch. The
plain version is ``ref.kmeans_update_ref``; ``ops.kmeans_update`` picks
between them by the tensor's device.
"""

from __future__ import annotations

import torch

from . import _build
from .kmeans_assign import check_points, raise_on_error

__all__ = ["kmeans_update"]

#: Launches of the kernel since the counter was last set to 0.
launches = 0


def kmeans_update(x: torch.Tensor, centroids: torch.Tensor,
                  weights: torch.Tensor | None = None):
    """``(labels (B, P) int32, d2 (B, P), sums (B, K, D), counts (B, K))``
    computed by the CUDA kernel; ``weights=None`` weighs every point 1."""
    global launches
    check_points(x, centroids, weights)
    lib = _build.load("kmeans")
    b, p, d = x.shape
    k = centroids.shape[1]
    tiles = -(-p // lib.kmeans_tile(d, k, 1))
    dev = x.device
    labels = torch.empty((b, p), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, p), dtype=torch.float32, device=dev)
    psums = torch.empty((tiles, b, k, d), dtype=torch.float32, device=dev)
    pcounts = torch.empty((tiles, b, k), dtype=torch.float32, device=dev)
    sums = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((b, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.kmeans_update_f32(
        x.data_ptr(), centroids.data_ptr(),
        None if weights is None else weights.data_ptr(), b, p, d, k,
        labels.data_ptr(), d2.data_ptr(), psums.data_ptr(), pcounts.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), stream)
    raise_on_error(lib, err, "kmeans_update")
    launches += 1
    return labels, d2, sums, counts
