"""Unpartitioned baselines from the paper's Table II/III.

* ``scc_full``  — Spectral Co-Clustering on the whole matrix (SCC [18]).
* ``nmtf_full`` — (P)NMTF on the whole matrix (PNMTF [11]; parallelism in the
  original is across worker nodes — here the whole-matrix factorization *is*
  the baseline cost being compared against).

They take the reference's arguments, so the paper's comparison runs with
the same atom settings as LAMC. Each is its atom lifted to a stack of one
block and squeezed back; the injected draws of the parity tests pass
through (``omega`` / ``seeds`` for SCC, ``init`` for NMTF).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import spectral
from .nmtf import nmtf as _nmtf

__all__ = ["BaselineResult", "scc_full", "nmtf_full"]


class BaselineResult(NamedTuple):
    row_labels: torch.Tensor   # (M,) int64
    col_labels: torch.Tensor   # (N,) int64


def scc_full(a, k: int, d: int | None = None, svd_iters: int = 4,
             kmeans_iters: int = 16, svd_method: str = "randomized", *,
             omega=None, seeds=None, generator: torch.Generator | None = None,
             device: str | torch.device = "cuda", timer=spectral.no_timer
             ) -> BaselineResult:
    """SCC of the whole dense matrix ``a (M, N)``.

    ``omega (N, r)`` and ``seeds`` (k-means++ point indices, as
    ``spectral.scc`` takes them for one block) replace the draws from
    ``generator``; ``timer`` times ``spectral.scc``'s phases.
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)[None]
    lift = lambda v: None if v is None else torch.as_tensor(v)[None]
    if isinstance(seeds, (tuple, list)):
        seeds = tuple(lift(v) for v in seeds)
    else:
        seeds = lift(seeds)
    res = spectral.scc(a, k, d if d is not None else k, svd_iters=svd_iters,
                       kmeans_iters=kmeans_iters, svd_method=svd_method,
                       omega=lift(omega), seeds=seeds, generator=generator,
                       device=dev, timer=timer)
    return BaselineResult(res.row_labels[0], res.col_labels[0])


def nmtf_full(a, k: int, d: int | None = None, n_iter: int = 64, *, init=None,
              generator: torch.Generator | None = None,
              device: str | torch.device = "cuda", timer=spectral.no_timer
              ) -> BaselineResult:
    """NMTF of the whole matrix ``a (M, N)``; ``init = (row_seeds (k,),
    col_seeds (d,))`` replaces the k-means++ draws from ``generator``;
    ``timer`` times ``nmtf``'s phases."""
    res = _nmtf(a, k, d, n_iter=n_iter, init=init, generator=generator,
                device=device, timer=timer)
    return BaselineResult(res.row_labels[0], res.col_labels[0])
