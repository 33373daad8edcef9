"""Public kernel entry points: dispatch by the device the tensors lie on.

A CUDA tensor always launches the hand-written kernel (and raises if it
cannot); a CPU tensor takes the plain version in ``ref.py``. There is no
switch that sends CUDA tensors to the plain version and no fallback on
error, so a run on the card either went through the kernels or failed.

The k-means and scale operands are batched over a leading block dimension
``B`` — the port's form of the reference's ``vmap`` over the block stack.
The cosine scorers take one ``(P, q)`` batch of requests.
The SpMM family takes one tile-level sparse matrix
(``spmm.BlockSparseMatrix``); ``spmm`` and ``sddmm`` on a COO tensor have
no TPU kernel in the reference either and stay plain PyTorch.
"""

from __future__ import annotations

import torch

from . import bipartite_normalize as _scale
from . import kmeans_assign as _assign
from . import kmeans_update as _update
from . import ref
from . import spmm as _spmm

__all__ = ["kmeans_assign", "kmeans_update", "cosine_assign", "cosine_topk",
           "bipartite_normalize", "spmm", "sddmm", "spmm_tiled", "spmm_ata",
           "tiled_scale_fusion", "launch_counts", "reset_launch_counts"]

# Kernel name -> (module, counter attribute, key in that attribute or None
# when it is a plain integer).
_KERNELS = {"kmeans_update": (_update, "launches", None),
            "kmeans_assign": (_assign, "launches", None),
            "cosine_assign": (_assign, "cosine_launches", "cosine_assign"),
            "cosine_topk": (_assign, "cosine_launches", "cosine_topk"),
            "scale_apply": (_scale, "launches", None),
            "spmm": (_spmm, "launches", "spmm"),
            "spmm_t": (_spmm, "launches", "spmm_t"),
            "spmm_ata": (_spmm, "launches", "spmm_ata")}


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


def _check_signatures(x: torch.Tensor, signatures: torch.Tensor,
                      k_valid: int | None) -> int:
    """The signature count that counts: ``k_valid``, or all rows."""
    if x.ndim != 2 or signatures.ndim != 2 or x.shape[1] != signatures.shape[1]:
        raise ValueError(f"expected x (P, q) and signatures (K, q), got "
                         f"{tuple(x.shape)} and {tuple(signatures.shape)}")
    n_sigs = signatures.shape[0] if k_valid is None else k_valid
    if not 1 <= n_sigs <= signatures.shape[0]:
        raise ValueError(f"scoring needs 1 <= k_valid <= {signatures.shape[0]} "
                         f"signatures, got {n_sigs}")
    return n_sigs


def cosine_assign(x: torch.Tensor, signatures: torch.Tensor,
                  k_valid: int | None = None):
    """Serving scorer: ``(labels (P,) int32, score (P,))``, the argmax of
    ``x (P, q) @ signatures (K, q).T`` per point over the first ``k_valid``
    signatures (all by default), ties to the lowest id."""
    _check_signatures(x, signatures, k_valid)
    if _on_cuda(x):
        return _assign.cosine_assign(x.to(torch.float32).contiguous(),
                                     signatures.to(torch.float32).contiguous(), k_valid)
    return ref.cosine_assign_ref(x, signatures, k_valid)


def cosine_topk(x: torch.Tensor, signatures: torch.Tensor, k: int,
                k_valid: int | None = None):
    """Top-``k`` serving scorer: ``(labels (P, k) int32, scores (P, k))``
    ordered by descending score, ties toward the lower id, over the first
    ``k_valid`` signatures; column 0 equals :func:`cosine_assign`."""
    n_sigs = _check_signatures(x, signatures, k_valid)
    if not 1 <= k <= n_sigs:
        raise ValueError(
            f"top-k width must be in [1, {n_sigs}] (the signature count), "
            f"got k={k}")
    if _on_cuda(x):
        return _assign.cosine_topk(x.to(torch.float32).contiguous(),
                                   signatures.to(torch.float32).contiguous(), k, k_valid)
    return ref.cosine_topk_ref(x, signatures, k, k_valid)


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


def spmm(a: torch.Tensor, b: torch.Tensor, *, transpose: bool = False):
    """``A @ b`` (or ``A.T @ b``) for a coalesced COO tensor ``a``: gather of
    the RHS rows and a scatter-add over the output axis, O(nnz * r)."""
    idx = a.indices()
    rows, cols = (idx[1], idx[0]) if transpose else (idx[0], idx[1])
    n_out = a.shape[1] if transpose else a.shape[0]
    return ref.spmm_ref(a.values(), rows, cols, n_out, b)


def sddmm(x: torch.Tensor, y: torch.Tensor, indices: torch.Tensor):
    """Values of ``x @ y.T`` at ``indices (2, nnz)`` (a COO tensor's
    ``indices()``)."""
    return ref.sddmm_ref(x, y, indices[0], indices[1])


def tiled_scale_fusion(a: _spmm.BlockSparseMatrix) -> bool:
    """Whether pending diagonal scales stay lazy on ``a``: on the card the
    SpMM kernels apply them to each tile as it is read; on the CPU the
    plain products would re-apply them on every call, so they are folded
    into the payloads once."""
    return _on_cuda(a.blocks)


def spmm_tiled(a: _spmm.BlockSparseMatrix, b: torch.Tensor, *,
               transpose: bool = False) -> torch.Tensor:
    """``A @ b`` (or ``A.T @ b``) with ``A`` pre-tiled, ``b (K, r)`` (or
    ``(M, r)``); any RHS width."""
    if _on_cuda(b):
        b = b.contiguous()
        return _spmm.spmm_t(a, b) if transpose else _spmm.spmm(a, b)
    return ref.spmm_tiled_ref(a, b, transpose=transpose)


def spmm_ata(a: _spmm.BlockSparseMatrix, x: torch.Tensor, *,
             with_gram: bool = False):
    """The normal-equations step ``z = A.T @ (A @ x)``; with ``with_gram``
    returns ``(z, z.T @ z)``, the Gram formed by the kernel on the card."""
    if _on_cuda(x):
        return _spmm.spmm_ata(a, x.contiguous(), with_gram=with_gram)
    return ref.spmm_ata_ref(a, x, with_gram=with_gram)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    counts = {}
    for name, (mod, attr, key) in _KERNELS.items():
        value = getattr(mod, attr)
        counts[name] = value if key is None else value[key]
    return counts


def reset_launch_counts() -> None:
    for mod, attr, key in _KERNELS.values():
        if key is None:
            setattr(mod, attr, 0)
        else:
            getattr(mod, attr)[key] = 0
