"""Non-negative Matrix Tri-Factorization atom co-clusterer.

Orthogonal NMTF (Ding et al. 2006; the serial core of the "PNMTF [11]"
baseline in the paper's Table II): ``A ~= F S G^T`` with ``F (M, k) >= 0``,
``G (N, d) >= 0``, multiplicative updates and a fixed iteration count. Row
labels are ``argmax_k F``, column labels ``argmax_d G``.

The reference vmaps it over the block stack; here every product is a
batched ``torch.matmul`` over ``a (B, M, N)``, and the per-block shift and
sums reduce over each block's own dims. As in the reference, the products
are plain float32 matrix products, not hand-written kernels.

Used two ways:
  * as the LAMC atom ``atom="nmtf"`` (the ``LAMC-PNMTF`` row of Table II), and
  * unpartitioned, as the ``PNMTF`` baseline itself (``core.baselines``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import fp32_policy, resolve_device, seeded_generator
from . import kmeans as _kmeans
from .spectral import no_timer

__all__ = ["NMTFResult", "nmtf"]

_EPS = 1e-9
_INIT_KMEANS_ITERS = 8          # the reference's k-means init, whatever the config
_LOSS_CHUNK_BYTES = 1 << 29     # the reconstruction is formed this many bytes at a time


class NMTFResult(NamedTuple):
    row_labels: torch.Tensor   # (B, M) int64
    col_labels: torch.Tensor   # (B, N) int64
    f: torch.Tensor            # (B, M, k)
    s: torch.Tensor            # (B, k, d)
    g: torch.Tensor            # (B, N, d)
    loss: torch.Tensor         # (B,) ||A - F S G^T||_F^2 of the shifted A


def _squared_error(a: torch.Tensor, f: torch.Tensor, s: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """``sum((a - f s g^T)**2)`` per block, a band of rows at a time, so the
    reconstruction never exists at the stack's full size."""
    b, m, n = a.shape
    rows = max(1, _LOSS_CHUNK_BYTES // (4 * b * n))
    sg = s @ g.mT                                        # (B, k, N)
    loss = torch.zeros(b, dtype=a.dtype, device=a.device)
    for i in range(0, m, rows):
        diff = a[:, i : i + rows] - f[:, i : i + rows] @ sg
        loss += torch.sum(diff * diff, dim=(1, 2))
    return loss


def nmtf(a, k: int, d: int | None = None, n_iter: int = 64, *, init=None,
         generator: torch.Generator | None = None, overwrite_a: bool = False,
         device: str | torch.device = "cuda", timer=no_timer,
         stack=None) -> NMTFResult:
    """Orthogonal tri-factorization of every block of ``a (B, M, N)`` with
    multiplicative updates; a 2-D ``a`` is a stack of one.

    Each block is shifted to be non-negative (``a - min(min(a), 0)``). ``F``
    and ``G`` start from k-means of the rows and of the columns (8 Lloyd
    steps each, as in the reference): one-hot labels plus 0.2. ``init =
    (row_seeds (B, k), col_seeds (B, d))`` replaces the two k-means++
    seedings by point indices (rows of the block, columns of the block);
    otherwise they are drawn from ``generator`` (with ``stack=(offset,
    total)`` as for the whole stack these blocks are a slice of, as
    ``kmeans.kmeans`` takes it). ``overwrite_a`` lets a
    caller that owns the float32 stack on ``device`` have it shifted in
    place instead of copied. ``timer(name)`` returns a context manager
    around each phase (``"nmtf_init"``: the shift, both k-means and ``S``;
    ``"nmtf_updates"``: the updates and the loss).
    """
    d = k if d is None else d
    dev = resolve_device(device)
    fp32_policy()
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    if a.ndim == 2:
        a = a[None]
    if a.ndim != 3:
        raise ValueError(f"expected (B, M, N) blocks or an (M, N) matrix, got "
                         f"{tuple(a.shape)}")
    b = a.shape[0]
    gen = generator if generator is not None else seeded_generator(dev, 0)
    row_seeds, col_seeds = (None, None) if init is None else init

    def km(x, kk, seeds):
        start = None if seeds is None else _kmeans.take_points(
            x, torch.as_tensor(seeds, device=dev).reshape(b, kk))
        return _kmeans.kmeans(x, kk, n_iter=_INIT_KMEANS_ITERS, init=start,
                              generator=gen, device=dev, stack=stack).labels

    with timer("nmtf_init"):
        shift = torch.amin(a, dim=(1, 2), keepdim=True).clamp_max(0.0)
        a = a.sub_(shift) if overwrite_a else a - shift
        row_km = km(a, k, row_seeds)
        col_km = km(a.mT.contiguous(), d, col_seeds)    # the copy is freed on return
        f = torch.nn.functional.one_hot(row_km, k).to(a.dtype) + 0.2
        g = torch.nn.functional.one_hot(col_km, d).to(a.dtype) + 0.2
        s = f.mT @ a @ g / torch.clamp_min(
            torch.sum(f, dim=-2)[..., :, None] * torch.sum(g, dim=-2)[..., None, :], _EPS)
    with timer("nmtf_updates"):
        f, s, g = _updates(a, f, s, g, n_iter)
        loss = _squared_error(a, f, s, g)
    return NMTFResult(row_labels=torch.argmax(f, dim=-1),
                      col_labels=torch.argmax(g, dim=-1), f=f, s=s, g=g, loss=loss)


def _updates(a, f, s, g, n_iter: int):
    """``n_iter`` multiplicative updates of ``G``, ``F`` and ``S``, in the
    reference's order."""
    for _ in range(n_iter):
        # G <- G * sqrt( (A^T F S) / (G G^T A^T F S) )
        num_g = a.mT @ (f @ s)                              # (B, N, d)
        den_g = g @ (g.mT @ num_g)
        g = g * torch.sqrt(num_g / torch.clamp_min(den_g, _EPS))
        # F <- F * sqrt( (A G S^T) / (F F^T A G S^T) )
        num_f = a @ (g @ s.mT)                              # (B, M, k)
        den_f = f @ (f.mT @ num_f)
        f = f * torch.sqrt(num_f / torch.clamp_min(den_f, _EPS))
        # S <- S * sqrt( (F^T A G) / (F^T F S G^T G) )
        num_s = f.mT @ a @ g                                # (B, k, d)
        den_s = (f.mT @ f) @ s @ (g.mT @ g)
        s = s * torch.sqrt(num_s / torch.clamp_min(den_s, _EPS))
    return f, s, g
