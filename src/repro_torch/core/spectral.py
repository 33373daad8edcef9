"""Spectral co-clustering (Dhillon 2001) — the paper's atom co-clusterer (§IV-C).

Dense path of the reference's ``core/spectral.py``, batched over the block
stack ``(B, M, N)``:

  1. ``A_n = D1^{-1/2} A D2^{-1/2}`` — bipartite graph normalization, whose
     scale-apply is the hand-written Triton kernel on the card.
  2. Singular vectors ``u_2..u_{l+1}``, ``v_2..v_{l+1}`` of ``A_n`` by
     fixed-iteration randomized subspace iteration (large products stay
     ``torch.matmul``; QR, Cholesky and the small SVD are ``torch.linalg``).
  3. ``Z = [D1^{-1/2} U_hat ; D2^{-1/2} V_hat]`` stacked embedding.
  4. k-means on the rows of ``Z``; rows of A get ``labels[:M]``, cols
     ``labels[M:]``.

Sparse operands (DESIGN.md §9) are one matrix each: a coalesced COO tensor,
a dual-ELL operator (``sparse.EllOperator``) or a tiled block-sparse
operator (``kernels.spmm.BlockSparseMatrix``). Normalization stays in the
operand's format (degree sums and a rescale of the stored values, lazy on
the card for the tiled form); the subspace iteration's products become
SpMM, and a tiled operand runs the normal-equations form, one
``ops.spmm_ata`` step per power iteration. Results carry a leading
``B = 1``, so the rest of the atom is the batched dense code.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..device import fp32_policy, resolve_device, seeded_generator
from ..kernels import ops
from . import kmeans as _kmeans
from . import sparse as _sparse

__all__ = ["normalize_bipartite", "randomized_svd", "exact_svd", "scc",
           "SCCResult", "no_timer"]

QR_METHODS = ("qr", "cholesky")
SVD_METHODS = ("randomized", "exact")


def no_timer(_name: str):
    """Default phase timer: times nothing."""
    return contextlib.nullcontext()


class SCCResult(NamedTuple):
    row_labels: torch.Tensor   # (B, M) int64 in [0, k)
    col_labels: torch.Tensor   # (B, N) int64 in [0, d)
    row_embed: torch.Tensor    # (B, M, l) spectral embedding
    col_embed: torch.Tensor    # (B, N, l)
    inertia: torch.Tensor      # (B,)


def normalize_bipartite(a, eps: float = 1e-8,
                        device: str | torch.device = "cuda"):
    """``A_n = D1^{-1/2} A D2^{-1/2}`` per block, degrees on ``|A|``.

    Returns ``(a_n, d1_isqrt (B, M), d2_isqrt (B, N))``. A sparse operand
    gives an operand of the same form and ``B = 1`` scales.
    """
    dev = resolve_device(device)
    if _sparse.is_sparse_operand(a):
        a = _sparse.operand_to(a, dev)
        if _sparse.is_ell(a):
            (d1, d2), scale = _sparse.ell_abs_degree_sums(a), _sparse.ell_scale_rows_cols
        elif _sparse.is_tiled(a):
            (d1, d2), scale = (_sparse.tiled_abs_degree_sums(a),
                               _sparse.tiled_scale_rows_cols)
        else:
            (d1, d2), scale = _sparse.abs_degree_sums(a), _sparse.scale_rows_cols
        s1 = torch.rsqrt(torch.clamp_min(d1, eps))
        s2 = torch.rsqrt(torch.clamp_min(d2, eps))
        return scale(a, s1, s2), s1[None], s2[None]
    a = torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    return ops.bipartite_normalize(a, eps)


def _orth_from_gram(yf: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """CholeskyQR from a Gram ``G = LLᵀ``: ``Q = Y L^{-T}``, with a
    trace-scaled ridge that keeps the Cholesky finite for rank-deficient Y."""
    r = g.shape[-1]
    ridge = eps * (torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / r + 1.0)
    eye = torch.eye(r, dtype=g.dtype, device=g.device)
    chol = torch.linalg.cholesky(g + ridge[..., None, None] * eye)
    # Solve Q @ Lᵀ = Y.
    return torch.linalg.solve_triangular(chol.mT, yf, upper=True, left=False)


def _cholesky_orth(y: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Gram-based orthonormalization ``Q = Y (YᵀY)^{-1/2}`` (CholeskyQR)."""
    return _orth_from_gram(y, y.mT @ y, eps)


def _qr_orth(y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(y).Q


def randomized_svd(a, rank: int, n_iter: int = 4, qr_method: str = "qr",
                   omega=None, generator: torch.Generator | None = None,
                   device: str | torch.device = "cuda"):
    """Top-``rank`` singular triplets of each block by subspace iteration.

    ``n_iter`` stabilized power iterations, then an exact SVD of the small
    projected ``(r, N)`` matrix. Returns ``(U (B, M, r), S (B, r),
    Vt (B, r, N))``. ``omega (B, N, r)`` replaces the Gaussian sketch drawn
    from ``generator`` (the tests inject the reference's sketch).
    ``qr_method`` is ``"qr"`` (Householder) or ``"cholesky"`` (CholeskyQR).
    """
    if qr_method not in QR_METHODS:
        raise ValueError(f"qr_method must be one of {QR_METHODS}, got {qr_method!r}")
    dev = resolve_device(device)
    fp32_policy()
    if _sparse.is_sparse_operand(a):
        return _sparse_randomized_svd(_sparse.operand_to(a, dev), rank, n_iter,
                                      qr_method, omega, generator, dev)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    b, m, n = a.shape
    r = min(rank, m, n)
    orth = _cholesky_orth if qr_method == "cholesky" else _qr_orth
    if omega is None:
        gen = generator if generator is not None else seeded_generator(dev, 0)
        omega = torch.randn((b, n, r), generator=gen, dtype=a.dtype, device=dev)
    else:
        omega = torch.as_tensor(omega, dtype=a.dtype, device=dev)
    q = orth(a @ omega)                                  # (B, M, r)
    for _ in range(n_iter):
        z = orth(a.mT @ q)                               # (B, N, r)
        q = orth(a @ z)                                  # (B, M, r)
    proj = q.mT @ a                                      # (B, r, N)
    ub, s, vt = torch.linalg.svd(proj, full_matrices=False)
    return q @ ub, s, vt


def _sparse_randomized_svd(a, rank, n_iter, qr_method, omega, generator, dev):
    """:func:`randomized_svd` of one sparse operand; outputs carry ``B = 1``.

    The sketch is orthonormalized before the first product (same span), as
    in the reference. A tiled operand iterates the ``(N, r)`` sketch through
    ``A.T (A X)`` (``ops.spmm_ata``; under CholeskyQR the step also returns
    the Gram) and maps through ``A`` once at the end; the other forms keep
    the two-sided iteration. Both apply the same polynomial of ``A``.
    """
    m, n = a.shape
    r = min(rank, m, n)
    orth = _cholesky_orth if qr_method == "cholesky" else _qr_orth
    if _sparse.is_tiled(a):
        matvec = lambda x: ops.spmm_tiled(a, x)
        rmatvec = lambda x: ops.spmm_tiled(a, x, transpose=True)
        if qr_method == "cholesky":
            ata_step = lambda x: _orth_from_gram(*ops.spmm_ata(a, x, with_gram=True))
        else:
            ata_step = lambda x: orth(ops.spmm_ata(a, x))
    elif _sparse.is_ell(a):
        matvec = lambda x: _sparse.ell_matvec(a, x)
        rmatvec = lambda x: _sparse.ell_rmatvec(a, x)
        ata_step = None
    else:
        matvec = lambda x: ops.spmm(a, x)
        rmatvec = lambda x: ops.spmm(a, x, transpose=True)
        ata_step = None
    if omega is None:
        gen = generator if generator is not None else seeded_generator(dev, 0)
        omega = torch.randn((n, r), generator=gen, dtype=torch.float32, device=dev)
    else:
        omega = torch.as_tensor(omega, dtype=torch.float32, device=dev).reshape(n, r)
    x = orth(omega)
    if ata_step is not None:
        for _ in range(n_iter):
            x = ata_step(x)                              # (N, r)
        q = orth(matvec(x))                              # (M, r)
    else:
        q = orth(matvec(x))
        for _ in range(n_iter):
            q = orth(matvec(orth(rmatvec(q))))
    proj = rmatvec(q).T                                  # (r, N)
    ub, s, vt = torch.linalg.svd(proj, full_matrices=False)
    return (q @ ub)[None], s[None], vt[None]


def exact_svd(a, rank: int, device: str | torch.device = "cuda"):
    """Full SVD of each block truncated to ``rank`` — the paper's original
    atom cost profile."""
    a = torch.as_tensor(a, dtype=torch.float32, device=resolve_device(device))
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u[..., :rank], s[..., :rank], vt[..., :rank, :]


def scc(
    a,
    n_row_clusters: int,
    n_col_clusters: int | None = None,
    n_singular_vectors: int | None = None,
    svd_iters: int = 4,
    kmeans_iters: int = 16,
    assign_impl: str = "jnp",
    svd_method: str = "randomized",
    qr_method: str = "qr",
    *,
    omega=None,
    seeds=None,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
    timer=no_timer,
) -> SCCResult:
    """Spectral co-clustering of every block of ``a (B, M, N)``, or of one
    sparse operand (results with ``B = 1``).

    When ``n_col_clusters == n_row_clusters`` rows and columns are clustered
    jointly in the stacked ``Z`` space (Dhillon's algorithm); otherwise they
    get separate k-means in the same spectral space. ``omega (B, N, r)``
    replaces the SVD sketch and ``seeds`` the k-means++ draws, as point
    indices ``(B, k)`` into the embedding (into ``Z``, or a pair ``(row,
    col)`` when the cluster counts differ); the rest is drawn from
    ``generator``.
    ``timer(name)`` returns a context manager around each phase
    (``"normalize"``, ``"svd"``, ``"kmeans"``).
    """
    if svd_method not in SVD_METHODS:
        raise ValueError(f"svd_method must be one of {SVD_METHODS}, got {svd_method!r}")
    if svd_method == "exact" and _sparse.is_sparse_operand(a):
        raise ValueError(
            "svd_method='exact' (LAPACK) requires a dense matrix; the sparse "
            "path supports svd_method='randomized' (SpMM subspace iteration)")
    dev = resolve_device(device)
    fp32_policy()
    gen = generator if generator is not None else seeded_generator(dev, 0)
    k = n_row_clusters
    d = n_col_clusters if n_col_clusters is not None else k
    # Dhillon: ceil(log2 k) singular vectors carry the k-modal structure;
    # bit_length() gives one more for robustness, as in the reference.
    l = n_singular_vectors if n_singular_vectors is not None else max(k, d).bit_length()

    with timer("normalize"):
        a_n, d1_isqrt, d2_isqrt = normalize_bipartite(a, device=dev)
    n_rows = d1_isqrt.shape[-1]
    with timer("svd"):
        if svd_method == "exact":
            u, _s, vt = exact_svd(a_n, rank=l + 1, device=dev)
        else:
            u, _s, vt = randomized_svd(a_n, rank=l + 1, n_iter=svd_iters,
                                       qr_method=qr_method, omega=omega,
                                       generator=gen, device=dev)
        del a_n
        # Drop the leading (trivial) singular pair: u_2..u_{l+1}, v_2..v_{l+1}.
        row_embed = d1_isqrt[..., None] * u[..., 1 : l + 1]        # (B, M, l)
        col_embed = d2_isqrt[..., None] * vt[:, 1 : l + 1, :].mT    # (B, N, l)

    with timer("kmeans"):
        def km(x, kk, idx):
            init = None if idx is None else _kmeans.take_points(x, idx)
            return _kmeans.kmeans(x, kk, n_iter=kmeans_iters,
                                  assign_impl=assign_impl, init=init,
                                  generator=gen, device=dev)

        if k == d:
            res = km(torch.cat([row_embed, col_embed], dim=1), k, seeds)
            row_labels, col_labels = res.labels[:, :n_rows], res.labels[:, n_rows:]
            inertia = res.inertia
        else:
            row_seeds, col_seeds = (None, None) if seeds is None else seeds
            res_r = km(row_embed, k, row_seeds)
            res_c = km(col_embed, d, col_seeds)
            row_labels, col_labels = res_r.labels, res_c.labels
            inertia = res_r.inertia + res_c.inertia
    return SCCResult(row_labels, col_labels, row_embed, col_embed, inertia)
