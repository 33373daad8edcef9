"""Online out-of-sample assignment against a fitted ``CoclusterModel``.

``assign_rows(model, x)`` scores a batch of full-width row vectors
``(B, N)`` against the model's row-cluster signatures; ``assign_cols``
does the same for column vectors ``(B, M)``. The scoring rule:

    f = x[:, anchor_cols] - row_mean          # restrict + center
    label = argmax_k  f . row_sigs[k]         # cosine vs unit signatures

Only the ``q`` anchor coordinates of each request are read, so a request
costs an ``O(q)`` gather and one ``(B, q) @ (q, K)`` product — the matrix
the model was fitted on is not needed. The product and its argmax (or its
top ``k``) run in the cosine kernels on the card (``kernels.ops``).

Requests are dense tensors or arrays, or coalesced ``torch.sparse_coo_tensor``
batches, of which only the anchor columns are densified (``(B, q)``). A
request is moved to the model's device; results stay there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import sparse as _sparse
from ..kernels import ops as _kops
from .model import CoclusterModel

__all__ = ["AssignResult", "TopKAssignResult", "assign_rows", "assign_cols",
           "assign_rows_topk", "assign_cols_topk"]


class AssignResult(NamedTuple):
    labels: torch.Tensor   # (B,) int32 assigned cluster ids
    score: torch.Tensor    # (B,) f32 winning cosine score (confidence)


class TopKAssignResult(NamedTuple):
    """Multi-assignment result: the ``k`` best clusters per request,
    descending by score. ``labels[:, 0]`` / ``scores[:, 0]`` equal the k=1
    :class:`AssignResult` exactly."""

    labels: torch.Tensor   # (B, k) int32 cluster ids, best first
    scores: torch.Tensor   # (B, k) f32 cosine scores, descending


def _assign(feats: torch.Tensor, mean: torch.Tensor, sigs: torch.Tensor) -> AssignResult:
    """Score gathered anchor features ``(B, q)``; a zero-row batch (the
    service's coalescer can flush one) is answered by ``ops`` without a
    launch, in the kernel's dtypes."""
    f = feats.to(torch.float32) - mean[None, :]
    return AssignResult(*_kops.cosine_assign(f, sigs))


def _assign_topk(feats: torch.Tensor, mean: torch.Tensor, sigs: torch.Tensor,
                 k: int) -> TopKAssignResult:
    """Top-``k`` twin of :func:`_assign`; ``ops`` checks ``k`` at every batch
    size, zero rows included."""
    f = feats.to(torch.float32) - mean[None, :]
    return TopKAssignResult(*_kops.cosine_topk(f, sigs, k))


def _request(x, width: int, model: CoclusterModel, what: str):
    """``x`` on the model's device, after its shape is checked; ``what`` is
    ``"<caller> row"`` or ``"<caller> column"`` for the message."""
    if not _sparse.is_bcoo(x):
        x = torch.as_tensor(x)
    shape = tuple(x.shape)
    if len(shape) != 2 or shape[1] != width:
        caller, kind = what.split()
        raise ValueError(f"{caller} expects (B, {width}) {kind} vectors, got {shape}")
    if _sparse.is_bcoo(x):
        return _sparse.operand_to(_sparse.validate_bcoo(x), model.device)
    return x.to(model.device)


def _gather_anchor(x: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    if _sparse.is_bcoo(x):
        return _sparse.gather_cols_dense(x, anchor)
    return torch.index_select(x, 1, anchor)


def assign_rows(model: CoclusterModel, x) -> AssignResult:
    """Assign new row vectors ``x (B, N)`` (dense or COO) to row clusters."""
    x = _request(x, model.n_cols, model, "assign_rows row")
    return _assign(_gather_anchor(x, model.anchor_cols), model.row_mean, model.row_sigs)


def assign_cols(model: CoclusterModel, y) -> AssignResult:
    """Assign new column vectors ``y (B, M)`` (dense or COO) to col clusters."""
    y = _request(y, model.n_rows, model, "assign_cols column")
    return _assign(_gather_anchor(y, model.anchor_rows), model.col_mean, model.col_sigs)


def assign_rows_topk(model: CoclusterModel, x, k: int = 4) -> TopKAssignResult:
    """Top-``k`` row-cluster assignment of ``x (B, N)`` (dense or COO): the
    ``k`` best clusters per request, descending, so a caller can threshold
    the scores for soft multi-membership."""
    x = _request(x, model.n_cols, model, "assign_rows_topk row")
    return _assign_topk(_gather_anchor(x, model.anchor_cols), model.row_mean,
                        model.row_sigs, k)


def assign_cols_topk(model: CoclusterModel, y, k: int = 4) -> TopKAssignResult:
    """Top-``k`` col-cluster assignment of ``y (B, M)`` (dense or COO)."""
    y = _request(y, model.n_rows, model, "assign_cols_topk column")
    return _assign_topk(_gather_anchor(y, model.anchor_rows), model.col_mean,
                        model.col_sigs, k)
