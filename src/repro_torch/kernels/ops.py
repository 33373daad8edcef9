"""Public kernel entry points: dispatch by the device the tensors lie on.

A CUDA tensor always launches the hand-written kernel (and raises if it
cannot); a CPU tensor takes the plain version in ``ref.py``. There is no
switch that sends CUDA tensors to the plain version and no fallback on
error, so a run on the card either went through the kernels or failed.

The k-means and scale operands are batched over a leading block dimension
``B`` — the port's form of the reference's ``vmap`` over the block stack.
The cosine scorers take one ``(P, q)`` batch of requests; flash attention
takes ``(B, H, S, Dh)`` heads, as the LM's attention does.
The SpMM family takes one tile-level sparse matrix
(``spmm.BlockSparseMatrix``); ``spmm`` and ``sddmm`` on a COO tensor have
no TPU kernel in the reference either and stay plain PyTorch.

Every call meters its tier with ``obs.kernel_dispatch(op, tier)``: ``cuda``
or ``triton`` for a kernel, ``ref`` for the plain version.
"""

from __future__ import annotations

import torch

from .. import obs as _obs
from . import bipartite_normalize as _scale
from . import flash_attention as _flash
from . import kmeans_assign as _assign
from . import kmeans_update as _update
from . import ref
from . import spmm as _spmm

__all__ = ["kmeans_assign", "kmeans_update", "cosine_assign", "cosine_topk",
           "bipartite_normalize", "spmm", "sddmm", "spmm_tiled", "spmm_ata",
           "tiled_scale_fusion", "flash_attention", "launch_counts",
           "reset_launch_counts"]

# Kernel name -> (module, counter attribute, key in that attribute or None
# when it is a plain integer).
_KERNELS = {"kmeans_update": (_update, "launches", None),
            "kmeans_assign": (_assign, "launches", None),
            "cosine_assign": (_assign, "cosine_launches", "cosine_assign"),
            "cosine_topk": (_assign, "cosine_launches", "cosine_topk"),
            "scale_apply": (_scale, "launches", None),
            "spmm": (_spmm, "launches", "spmm"),
            "spmm_t": (_spmm, "launches", "spmm_t"),
            "spmm_ata": (_spmm, "launches", "spmm_ata"),
            "flash_attention": (_flash, "launches", None)}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on CUDA or CPU tensors, got {t.device}")


def _tier(op: str, t: torch.Tensor, kernel: str = "cuda", **attrs) -> bool:
    """Whether ``op`` launches its kernel on ``t`` (a CUDA tensor); meters
    the tier it takes."""
    cuda = _on_cuda(t)
    _obs.kernel_dispatch(op, kernel if cuda else "ref", **attrs)
    return cuda


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid: ``(labels (B, P) int32, d2 (B, P))``."""
    if _tier("kmeans_assign", x):
        return _assign.kmeans_assign(x, centroids)
    return ref.kmeans_assign_ref(x, centroids)


def kmeans_update(x: torch.Tensor, centroids: torch.Tensor,
                  weights: torch.Tensor | None = None):
    """One fused Lloyd step: ``(labels, d2, sums (B, K, D), counts (B, K))``."""
    if _tier("kmeans_update", x):
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
    if _tier("cosine_assign", x):
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
    if _tier("cosine_topk", x):
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
    if _tier("bipartite_normalize", a, "triton"):
        return _scale.scale_apply(a, s1, s2), s1, s2
    return ref.scale_apply_ref(a, s1, s2), s1, s2


def spmm(a: torch.Tensor, b: torch.Tensor, *, transpose: bool = False):
    """``A @ b`` (or ``A.T @ b``) for a coalesced COO tensor ``a``: gather of
    the RHS rows and a scatter-add over the output axis, O(nnz * r)."""
    _obs.kernel_dispatch("spmm", "ref")
    idx = a.indices()
    rows, cols = (idx[1], idx[0]) if transpose else (idx[0], idx[1])
    n_out = a.shape[1] if transpose else a.shape[0]
    return ref.spmm_ref(a.values(), rows, cols, n_out, b)


def sddmm(x: torch.Tensor, y: torch.Tensor, indices: torch.Tensor):
    """Values of ``x @ y.T`` at ``indices (2, nnz)`` (a COO tensor's
    ``indices()``)."""
    _obs.kernel_dispatch("sddmm", "ref")
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
    if _tier("spmm_tiled", b, transpose=transpose, scaled=a.has_scales):
        b = b.contiguous()
        return _spmm.spmm_t(a, b) if transpose else _spmm.spmm(a, b)
    return ref.spmm_tiled_ref(a, b, transpose=transpose)


def spmm_ata(a: _spmm.BlockSparseMatrix, x: torch.Tensor, *,
             with_gram: bool = False):
    """The normal-equations step ``z = A.T @ (A @ x)``; with ``with_gram``
    returns ``(z, z.T @ z)``, the Gram formed by the kernel on the card."""
    if _tier("spmm_ata", x, scaled=a.has_scales, with_gram=with_gram):
        return _spmm.spmm_ata(a, x.contiguous(), with_gram=with_gram)
    return ref.spmm_ata_ref(a, x, with_gram=with_gram)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None, window: int = 0,
                    q_offset: int = 0, chunk_size: int = 1024) -> torch.Tensor:
    """Softmax attention of ``q (B, Hq, Sq, Dh)`` over ``k, v (B, Hkv, Skv,
    Dh)`` (``Hq`` a multiple of ``Hkv``): the function of the reference's
    ``chunked_causal_attention`` with a ``causal`` switch and a ``kv_len``
    mask. On the card the kernel reads each query head's kv head directly
    and ``chunk_size`` only sets the value of a row with no live key; on
    the CPU the plain version walks KV chunks of ``chunk_size``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(f"GQA heads mismatch: {q.shape[1]} % {k.shape[1]}")
    kw = dict(causal=causal, kv_len=kv_len, window=window, q_offset=q_offset,
              chunk_size=chunk_size)
    if _tier("flash_attention", q):
        return _flash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    return ref.flash_attention_ref(q, k, v, **kw)


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
