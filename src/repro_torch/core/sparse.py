"""Sparse inputs and operators of the sparse LAMC path (DESIGN.md §9).

The port's counterpart of the reference's 2-D BCOO is a coalesced 2-D
``torch.sparse_coo_tensor``: coalesced means sorted and unique indices, the
reference's "unique indices" contract, which keeps the sparse path
bit-exact against the dense one (every block cell receives one stored value
or stays zero). The full ``M x N`` matrix is never densified: only blocks,
``M x q`` anchor slivers and the spectral embeddings are dense.

Three operator forms serve the spectral step, chosen per matrix by
``probability.resolve_spmm_route``:

  * the COO tensor itself (gather + scatter-add products, ``ops.spmm``);
  * the dual-ELL operator (:class:`EllOperator`): padded rows in both
    orientations, gather-only products. It has no TPU kernel in the
    reference; plain torch is its port;
  * the tiled block-sparse operator (``kernels.spmm.BlockSparseMatrix``),
    whose products are the hand-written CUDA kernels on the card.

Conversions are built with torch ops on the tensor's device and go through
the pattern cache (``core.opcache``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import ops as _ops
from ..kernels import spmm as _spmm

__all__ = [
    "is_bcoo", "validate_bcoo", "density", "abs_degree_sums", "scale_rows_cols",
    "gather_cols_dense", "gather_rows_dense",
    "EllOperator", "EllPlan", "ell_plan", "ell_apply", "to_ell", "is_ell",
    "ell_matvec", "ell_rmatvec", "ell_abs_degree_sums", "ell_scale_rows_cols",
    "is_tiled", "to_tiled", "tiled_abs_degree_sums", "tiled_scale_rows_cols",
    "is_sparse_operand", "operand_to", "SPMM_IMPLS", "validate_spmm_impl",
    "prepare_operator",
]


def is_bcoo(a) -> bool:
    """True if ``a`` is a sparse COO tensor (the port's BCOO)."""
    return isinstance(a, torch.Tensor) and a.layout == torch.sparse_coo


def validate_bcoo(a) -> torch.Tensor:
    """Check the sparse path's input contract: a coalesced 2-D COO tensor
    with no dense dimensions."""
    if not is_bcoo(a):
        raise ValueError(f"sparse path needs a torch.sparse_coo_tensor, got "
                         f"{type(a).__name__}"
                         + ("" if not isinstance(a, torch.Tensor) else f" ({a.layout})"))
    if a.ndim != 2 or a.sparse_dim() != 2 or a.dense_dim() != 0:
        raise ValueError(f"sparse path needs a 2-D COO matrix with no dense "
                         f"dimensions, got shape {tuple(a.shape)}")
    if not a.is_coalesced():
        raise ValueError("sparse path needs a coalesced COO tensor (sorted, "
                         "unique indices); call .coalesce() first")
    return a


def density(a: torch.Tensor) -> float:
    """Fraction of stored entries."""
    m, n = a.shape
    return a._nnz() / float(m * n)


def abs_degree_sums(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row/col sums of ``|A|``, the bipartite degrees of Eq. 5, O(nnz)."""
    idx, av = a.indices(), a.values().abs()
    m, n = a.shape
    d1 = torch.zeros(m, dtype=av.dtype, device=av.device).index_add_(0, idx[0], av)
    d2 = torch.zeros(n, dtype=av.dtype, device=av.device).index_add_(0, idx[1], av)
    return d1, d2


def scale_rows_cols(a: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """``diag(s1) @ A @ diag(s2)`` with the same indices."""
    idx = a.indices()
    vals = a.values() * s1[idx[0]] * s2[idx[1]]
    return torch.sparse_coo_tensor(idx, vals, a.shape, is_coalesced=True,
                                   check_invariants=False)


def _inverse(index: torch.Tensor, length: int) -> torch.Tensor:
    """``inv[index[j]] = j``; ``len(index)`` (out of range) elsewhere."""
    q = index.shape[0]
    inv = torch.full((length,), q, dtype=torch.int64, device=index.device)
    inv[index.long()] = torch.arange(q, device=index.device)
    return inv


def gather_cols_dense(a: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Dense ``A[:, cols]`` of shape ``(M, q)``, O(nnz): stored entries in
    other columns are dropped."""
    idx, vals = a.indices(), a.values()
    q = cols.shape[0]
    pc = _inverse(cols, a.shape[1])[idx[1]]
    keep = pc < q
    out = torch.zeros((a.shape[0], q), dtype=vals.dtype, device=vals.device)
    out[idx[0][keep], pc[keep]] = vals[keep]
    return out


def gather_rows_dense(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Dense ``A[rows, :]`` of shape ``(q, N)``, O(nnz)."""
    idx, vals = a.indices(), a.values()
    q = rows.shape[0]
    pr = _inverse(rows, a.shape[0])[idx[0]]
    keep = pr < q
    out = torch.zeros((q, a.shape[1]), dtype=vals.dtype, device=vals.device)
    out[pr[keep], idx[1][keep]] = vals[keep]
    return out


# ---------------------------------------------------------------------------
# Dual-ELL operator: gather-only products
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EllOperator:
    """Padded-row (ELL) layout of a sparse matrix in both orientations:
    ``out[i] = sum_w vals[i, w] * x[cols[i, w]]``, W the widest row.
    Padding slots hold value 0 and index 0 and contribute nothing."""

    row_vals: torch.Tensor    # (M, W)
    row_cols: torch.Tensor    # (M, W) int64
    col_vals: torch.Tensor    # (N, Wt) transpose orientation
    col_rows: torch.Tensor    # (N, Wt)

    @property
    def shape(self) -> tuple[int, int]:
        return int(self.row_vals.shape[0]), int(self.col_vals.shape[0])

    @property
    def dtype(self):
        return self.row_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.row_vals.device

    def to(self, device) -> EllOperator:
        return EllOperator(*(t.to(device) for t in dataclasses.astuple(self)))


def is_ell(a) -> bool:
    return isinstance(a, EllOperator)


class _EllSidePlan(NamedTuple):
    """Pattern half of one orientation: where each value lands."""

    dest_row: torch.Tensor   # (nnz,) destination row of each sorted value
    slot: torch.Tensor       # (nnz,) destination slot
    order: torch.Tensor      # (nnz,) stable sort permutation of the values
    ell_idx: torch.Tensor    # (m, width) gather indices
    m: int
    width: int


class EllPlan(NamedTuple):
    """Reusable pattern half of a COO -> dual-ELL conversion."""

    row: _EllSidePlan
    col: _EllSidePlan


def _ell_side(rows: torch.Tensor, cols: torch.Tensor, m: int) -> _EllSidePlan:
    counts = torch.bincount(rows, minlength=m)
    width = max(int(counts.max()) if rows.numel() else 0, 1)
    order = torch.sort(rows, stable=True).indices
    dest = rows[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.shape[0], device=rows.device) - starts[dest]
    ell_idx = torch.zeros((m, width), dtype=torch.int64, device=rows.device)
    ell_idx[dest, slot] = cols[order]
    return _EllSidePlan(dest, slot, order, ell_idx, m, width)


def _ell_side_vals(p: _EllSidePlan, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((p.m, p.width), dtype=torch.float32, device=vals.device)
    out[p.dest_row, p.slot] = vals[p.order].to(torch.float32)
    return out


def ell_plan(a: torch.Tensor) -> EllPlan:
    """Pattern half of the dual-ELL conversion (sorts, slots, widths)."""
    m, n = a.shape
    idx = a.indices()
    return EllPlan(row=_ell_side(idx[0], idx[1], m), col=_ell_side(idx[1], idx[0], n))


def ell_apply(plan: EllPlan, values: torch.Tensor) -> EllOperator:
    """Values half: scatter fresh values through a pattern plan."""
    return EllOperator(_ell_side_vals(plan.row, values), plan.row.ell_idx,
                       _ell_side_vals(plan.col, values), plan.col.ell_idx)


def to_ell(a: torch.Tensor, cache=None) -> EllOperator:
    """COO -> dual-ELL, O(nnz), through ``cache`` (a ``PatternCache``) when
    given."""
    validate_bcoo(a)
    if cache is None:
        return ell_apply(ell_plan(a), a.values())
    return cache.convert(
        a, ("ell",),
        plan_fn=lambda x: ((p := ell_plan(x)), ell_apply(p, x.values())),
        apply_fn=ell_apply)


def ell_matvec(a: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """``A @ x``: gather rows of ``x``, one multiply-reduce."""
    return torch.einsum("mw,mwr->mr", a.row_vals, x[a.row_cols])


def ell_rmatvec(a: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """``A.T @ x`` through the stored transpose orientation."""
    return torch.einsum("nw,nwr->nr", a.col_vals, x[a.col_rows])


def ell_abs_degree_sums(a: EllOperator) -> tuple[torch.Tensor, torch.Tensor]:
    """Bipartite degrees: padding is exact zero, so plain row sums."""
    return a.row_vals.abs().sum(1), a.col_vals.abs().sum(1)


def ell_scale_rows_cols(a: EllOperator, s1: torch.Tensor, s2: torch.Tensor) -> EllOperator:
    """``diag(s1) @ A @ diag(s2)`` in ELL form (both orientations)."""
    return dataclasses.replace(
        a, row_vals=a.row_vals * s1[:, None] * s2[a.row_cols],
        col_vals=a.col_vals * s2[:, None] * s1[a.col_rows])


# ---------------------------------------------------------------------------
# Tiled block-sparse operator
# ---------------------------------------------------------------------------


def is_tiled(a) -> bool:
    return isinstance(a, _spmm.BlockSparseMatrix)


def to_tiled(a: torch.Tensor, bm: int = 128, bk: int = 128, *, cache=None):
    """COO -> tile-level block-sparse (``kernels.spmm``), on ``a``'s device,
    through ``cache`` (a ``PatternCache``) when given."""
    validate_bcoo(a)

    def plan_fn(x):
        plan = _spmm.block_sparse_plan(x, bm, bk)
        return plan, _spmm.block_sparse_apply(plan, x.values())

    if cache is None:
        return plan_fn(a)[1]
    return cache.convert(a, ("tiled", bm, bk), plan_fn=plan_fn,
                         apply_fn=_spmm.block_sparse_apply)


def _tile_pad(v: torch.Tensor, tiles: int, width: int) -> torch.Tensor:
    """(L,) vector -> (tiles, width) grid, zero-padded."""
    return torch.nn.functional.pad(v, (0, tiles * width - v.shape[0])).reshape(tiles, width)


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Sums of the rows of ``vals (G, w)`` per segment id (``ids`` sorted,
    ``ptr`` the segment starts), in a fixed order: each segment is laid out
    in a zero-padded ``(n, longest, w)`` grid and summed over its middle
    axis, so the result is the same from run to run on the card too."""
    ptr = ptr.long()
    n = ptr.shape[0] - 1
    longest = int((ptr[1:] - ptr[:-1]).max()) if n else 0
    ids = ids.long()
    pos = torch.arange(ids.shape[0], device=ids.device) - ptr[ids]
    grid = torch.zeros((n, max(longest, 1), vals.shape[1]), dtype=vals.dtype,
                       device=vals.device)
    grid[ids, pos] = vals
    return grid.sum(1)


def tiled_abs_degree_sums(a) -> tuple[torch.Tensor, torch.Tensor]:
    """Bipartite degrees of the effective operator from its payload tiles."""
    a = a.materialize_scales()
    row_ptr, col_ptr = a.segments()
    per_row = torch.linalg.vector_norm(a.blocks, ord=1, dim=2)       # (G, bm)
    per_col = torch.linalg.vector_norm(a.blocks, ord=1, dim=1)       # (G, bk)
    order = a.t_order.long()
    d1 = _segment_sum(per_row, a.block_rows, row_ptr).reshape(-1)
    d2 = _segment_sum(per_col[order], a.block_cols[order], col_ptr).reshape(-1)
    return d1[: a.shape[0]], d2[: a.shape[1]]


def tiled_scale_rows_cols(a, s1: torch.Tensor, s2: torch.Tensor):
    """``diag(s1) @ A @ diag(s2)`` on the payload tiles (same tiling).

    On the card the scales stay lazy (``row_scale``/``col_scale`` grids the
    CUDA kernels apply to each tile as it is read), so the normalized
    operator never exists as a second 8 GiB stack. On the CPU they are
    folded into the payloads once, in the same multiply order, so both
    forms give the same bits under every product. Padding cells hold exact
    zeros, so the padded scale entries multiply nothing.
    """
    bm, bk = a.tile_shape
    n_tr, n_tc = a.n_tiles
    rs = _tile_pad(s1, n_tr, bm)
    cs = _tile_pad(s2, n_tc, bk)
    if _ops.tiled_scale_fusion(a):
        if a.has_scales:                                  # compose scalings
            rs, cs = a.row_scale * rs, a.col_scale * cs
        return a.with_scales(rs, cs)
    return a.materialize_scales().with_scales(rs, cs).materialize_scales()


# ---------------------------------------------------------------------------
# Operands and routes
# ---------------------------------------------------------------------------


def is_sparse_operand(a) -> bool:
    """A COO tensor, a dual-ELL or a tiled operator."""
    return is_bcoo(a) or is_ell(a) or is_tiled(a)


def operand_to(a, device: torch.device):
    """A sparse operand on ``device`` (the same object if it is there)."""
    if is_bcoo(a):
        return a.to(device=device, dtype=torch.float32)
    return a if a.device == device else a.to(device)


#: Values of the ``spmm_impl`` knob; ``auto`` resolves per matrix from its
#: density (``probability.spmm_route``).
SPMM_IMPLS = ("auto", "dense", "dual_ell", "tiled")


def validate_spmm_impl(impl: str) -> str:
    if impl not in SPMM_IMPLS:
        raise ValueError(f"spmm_impl must be one of {SPMM_IMPLS}, got {impl!r}")
    return impl


def prepare_operator(a: torch.Tensor, impl: str, *, bm: int = 128, bk: int = 128,
                     cache="default"):
    """The routed operand of a COO matrix, on its device.

    ``impl`` is a resolved route: ``dense`` (the densified matrix),
    ``dual_ell`` or ``tiled``. Conversions go through the process-wide
    pattern cache (``core.opcache``) by default; ``cache=None`` bypasses it
    and ``REPRO_TILED_CACHE=0`` disables it.
    """
    from . import opcache

    validate_bcoo(a)
    if cache == "default":
        cache = opcache.default_cache() if opcache.cache_enabled() else None
    if impl == "dense":
        return a.to_dense()
    if impl == "dual_ell":
        return to_ell(a, cache=cache)
    if impl == "tiled":
        return to_tiled(a, bm=bm, bk=bk, cache=cache)
    raise ValueError(f"impl must be a resolved route ('dense', 'dual_ell' or "
                     f"'tiled'), got {impl!r}")
