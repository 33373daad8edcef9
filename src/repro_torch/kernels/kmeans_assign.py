"""Wrappers of the CUDA assignment kernels: k-means (``csrc/kmeans.cu``) and
the serving path's cosine scorers (``csrc/cosine.cu``).

``kmeans_assign`` replaces ``kmeans_assign_pallas``
(``src/repro/kernels/kmeans_assign.py:59``): nearest-centroid labels and
clamped squared distances for a ``(B, P, D)`` batch of points against
``(B, K, D)`` centroids, in one launch for all blocks. Each distance is
``(|x|^2 - 2 x.c) + |c|^2`` from three ``fmaf`` chains over ascending
features, so it depends only on the two rows, never on the tile: wherever
the distances are finite, the labels and distances equal
``kmeans_update``'s bit for bit. At ``D <= 16`` and
``K <= 32`` (the LAMC atoms) a narrow tile, bound by reading ``x``, stages
1,024 points a CTA by 16-byte ``cp.async`` and keeps their features in
registers; otherwise a wide tile keeps 8 x 8 (points x centroids)
accumulators a thread over a ``cp.async`` ring of feature slices, bound by
the FFMA rate at ``K = D = 128`` (``csrc/kmeans.cu``).

``cosine_assign`` and ``cosine_topk`` replace ``cosine_assign_pallas``
(``:168``) and ``cosine_topk_pallas`` (``:132``): the best (or the ``k``
best, descending) of ``x (P, q) @ signatures (K, q).T`` per point, ties to
the lower id, NaN first. Both launch the one kernel, ``cosine_assign`` with
``k = 1``. ``P``, ``q``, ``K`` and ``k`` are run-time values; nothing is
padded. The reference's ``k_valid`` (signature rows at and past it are
masked to -inf) is passed to the kernel as its signature count, so those
rows are never read.

The kernel is a float32 SIMT product for Hopper, bound by the FFMA rate at
the reference's envelope (P = 4096, q = K = 1024) and by reading ``x`` at
the served shape (q = 64, K = 16). It keeps 16 x 8 scores a thread in
registers, stages feature slices transposed through a ``cp.async`` ring
with one barrier a slice, splits the signature axis over the warps of a CTA
and over a thread-block cluster of 2 CTAs (merged through distributed
shared memory), and keeps each point's running top-k in shared memory, so
no score matrix is stored; K <= 16 takes a narrow tile. Above
``k = cosine_max_k()`` (16) the scores go to a ``(P, K)`` scratch this
wrapper allocates, and the top ``k`` are selected from it. The header of
``csrc/cosine.cu`` gives the design.

The plain versions are in ``ref``; ``ops`` picks between kernel and plain
version by the tensor's device.
"""

from __future__ import annotations

import threading

import torch

from . import _build

__all__ = ["kmeans_assign", "check_points", "cosine_assign", "cosine_topk"]

#: Launches of the k-means assignment kernel since the counter was last set to 0.
launches = 0

#: Launches of the cosine scorers since the counters were last set to 0. The
#: serving path launches them from several worker threads, so the counts
#: are updated under a lock.
cosine_launches = {"cosine_assign": 0, "cosine_topk": 0}
_cosine_lock = threading.Lock()


def check_points(x: torch.Tensor, centroids: torch.Tensor,
                 weights: torch.Tensor | None = None) -> None:
    """Raise unless the operands are what the CUDA k-means kernels take (any
    K and D, as the reference's wrapper)."""
    if x.ndim != 3 or centroids.ndim != 3:
        raise ValueError(f"expected x (B, P, D) and centroids (B, K, D), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    b, p, d = x.shape
    if centroids.shape[0] != b or centroids.shape[2] != d:
        raise ValueError(f"centroids {tuple(centroids.shape)} do not match x "
                         f"{tuple(x.shape)}")
    k = centroids.shape[1]
    if min(b, p, d, k) < 1 or b > 65535:
        raise ValueError(f"kernel takes 1 <= B <= 65535 and P, D, K >= 1; got "
                         f"B={b} P={p} D={d} K={k}")
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
    # repro: allow[R3] the launch counter of ops.launch_counts (host-side launches)
    global launches
    check_points(x, centroids)
    lib = _build.load("kmeans")
    b, p, d = x.shape
    k = centroids.shape[1]
    dev = x.device
    labels = torch.empty((b, p), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kmeans_assign_f32(x.data_ptr(), centroids.data_ptr(), b, p, d, k,
                                    labels.data_ptr(), d2.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, err, "kmeans_assign")
    launches += 1
    return labels, d2


def cosine_topk(x: torch.Tensor, signatures: torch.Tensor, k: int,
                k_valid: int | None = None, *, counter: str = "cosine_topk"):
    """``(labels (P, k) int32, scores (P, k))``, descending, computed by the
    CUDA kernel over the first ``k_valid`` signatures (all by default); a
    zero-row ``x`` returns empty tensors without a launch. The launch is
    counted under ``counter``. The caller checks the arguments' meaning
    (``ops``); this checks what the kernel needs to read its operands."""
    k_valid = signatures.shape[0] if k_valid is None else k_valid
    if (x.ndim != 2 or signatures.ndim != 2 or x.shape[1] != signatures.shape[1]
            or k_valid > signatures.shape[0]):
        raise ValueError(f"expected x (P, q) and signatures (K >= k_valid, q), got "
                         f"{tuple(x.shape)}, {tuple(signatures.shape)}, k_valid={k_valid}")
    for name, t in (("x", x), ("signatures", signatures)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    lib = _build.load("cosine")
    p, q = x.shape
    labels = torch.empty((p, k), dtype=torch.int32, device=x.device)
    scores = torch.empty((p, k), dtype=torch.float32, device=x.device)
    if p == 0:
        return labels, scores
    # above cosine_max_k() best scores a point's running top-k is not kept:
    # the scores go to this scratch and the k best are selected from it
    spill = (torch.empty((p, k_valid), dtype=torch.float32, device=x.device)
             if k > lib.cosine_max_k() else None)
    # the kernel reads only the first k_valid signature rows: the rows the
    # reference masks to -inf are never scored
    with torch.cuda.device(x.device):
        err = lib.cosine_topk_f32(x.data_ptr(), signatures.data_ptr(), p, q, k_valid, k,
                                  labels.data_ptr(), scores.data_ptr(),
                                  None if spill is None else spill.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{counter} launch failed: "
                           f"{lib.cosine_error_string(err).decode()}")
    with _cosine_lock:
        # repro: allow[R3] the launch counter of ops.launch_counts (host-side launches)
        cosine_launches[counter] += 1
    return labels, scores


def cosine_assign(x: torch.Tensor, signatures: torch.Tensor, k_valid: int | None = None):
    """``(labels (P,) int32, scores (P,))``: the ``k = 1`` launch of
    :func:`cosine_topk`, counted under ``cosine_assign``."""
    labels, scores = cosine_topk(x, signatures, 1, k_valid, counter="cosine_assign")
    return labels[:, 0], scores[:, 0]
