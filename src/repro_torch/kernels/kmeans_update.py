"""Wrapper of the CUDA fused Lloyd-step kernel (``csrc/kmeans.cu``).

Replaces ``kmeans_update_pallas`` (``src/repro/kernels/kmeans_update.py:79``):
labels, clamped squared distances and the per-cluster weighted sums and
counts of one Lloyd iteration, for a ``(B, P, D)`` batch. One launch assigns
every point and reduces each CTA's tile of points to a ``K x (D + 1)``
partial (the weighted sums, then the weight count), in a fixed point order;
a second launch adds the tiles' partials in a fixed order. Wherever the
distances are finite, the labels and distances are ``kmeans_assign``'s bit
for bit (one distance routine serves both); the results do not change from
run to run. The tile is narrow (1,024 points a CTA, features in
registers) for ``D <= 16`` and ``K <= 32`` and wide (128 points x 128
centroids of ``fmaf`` register tiles) otherwise; the header of
``csrc/kmeans.cu`` gives the design.

The partials are scratch this wrapper allocates: ``(tiles, B, K, D + 1)``
with ``tiles = ceil(P / kmeans_tile(D, K))``. The plain version is
``ref.kmeans_update_ref``; ``ops.kmeans_update`` picks between them by the
tensor's device.
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
    tiles = -(-p // lib.kmeans_tile(d, k))
    dev = x.device
    labels = torch.empty((b, p), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, p), dtype=torch.float32, device=dev)
    partials = torch.empty((tiles, b, k, d + 1), dtype=torch.float32, device=dev)
    sums = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((b, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kmeans_update_f32(
            x.data_ptr(), centroids.data_ptr(),
            None if weights is None else weights.data_ptr(), b, p, d, k,
            labels.data_ptr(), d2.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, err, "kmeans_update")
    launches += 1
    return labels, d2, sums, counts
