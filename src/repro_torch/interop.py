"""Carrying plans, random draws and results between the two packages.

The system has no weights: its state is the plan, the random draws and the
fitted result. JAX's threefry bits cannot be reproduced in torch, so the
tests take the reference's draws as numpy arrays and inject them here. This
module sees numpy arrays and plain values only; it imports neither JAX nor
the reference package.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.lamc import LAMCResult
from .core.partition import PartitionPlan
from .device import resolve_device
from .kernels.spmm import BlockSparseMatrix
from .streaming.model import CoclusterModel

__all__ = ["Draws", "draws_from_numpy", "plan_from_numpy", "result_to_numpy",
           "coo_from_numpy", "block_sparse_from_numpy", "model_from_numpy"]


@dataclasses.dataclass(frozen=True)
class Draws:
    """The random draws of one ``lamc_cocluster`` run.

    ``row_idx (T_p, m, phi)`` / ``col_idx (T_p, n, psi)``: each resample's
    block index maps. ``anchor_rows`` / ``anchor_cols``: the shared anchor
    indices. ``omega (T_p, B, psi, r)``: each block's SVD sketch.
    ``atom_seeds (T_p, B, k)``: each block's k-means++ draws as point
    indices into its stacked embedding ``Z``. ``row_merge_seeds`` /
    ``col_merge_seeds (restarts, K)``: the merge k-means++ draws as atom
    indices. A draw left None is drawn from the seeded generators.
    """

    row_idx: torch.Tensor
    col_idx: torch.Tensor
    anchor_rows: torch.Tensor
    anchor_cols: torch.Tensor
    omega: torch.Tensor | None = None
    atom_seeds: torch.Tensor | None = None
    row_merge_seeds: torch.Tensor | None = None
    col_merge_seeds: torch.Tensor | None = None

    def to(self, device: torch.device) -> Draws:
        return Draws(*(None if v is None else v.to(device)
                       for v in dataclasses.astuple(self)))

    def resample(self, t: int) -> dict:
        """Keyword overrides of ``lamc.run_resample`` for resample ``t``."""
        pick = lambda v: None if v is None else v[t]
        return dict(row_idx=self.row_idx[t], col_idx=self.col_idx[t],
                    omega=pick(self.omega), seeds=pick(self.atom_seeds))


def draws_from_numpy(row_idx, col_idx, anchor_rows, anchor_cols, omega=None,
                     atom_seeds=None, row_merge_seeds=None,
                     col_merge_seeds=None) -> Draws:
    """A :class:`Draws` from numpy arrays (indices become int64 tensors)."""
    idx = lambda v: None if v is None else torch.from_numpy(
        np.asarray(v).astype(np.int64))
    return Draws(
        row_idx=idx(row_idx), col_idx=idx(col_idx),
        anchor_rows=idx(anchor_rows), anchor_cols=idx(anchor_cols),
        omega=None if omega is None else torch.from_numpy(
            np.asarray(omega, dtype=np.float32)),
        atom_seeds=idx(atom_seeds), row_merge_seeds=idx(row_merge_seeds),
        col_merge_seeds=idx(col_merge_seeds))


def plan_from_numpy(fields) -> PartitionPlan:
    """A port :class:`PartitionPlan` from a mapping or any object carrying the
    plan's fields (for example the reference's plan dataclass)."""
    get = fields.get if isinstance(fields, Mapping) else (
        lambda name, default: getattr(fields, name, default))
    cast = {"int": int, "float": float, "str": str}
    values = {}
    for f in dataclasses.fields(PartitionPlan):
        v = get(f.name, f.default)
        if v is dataclasses.MISSING:
            raise ValueError(f"plan field {f.name!r} is missing")
        values[f.name] = cast[f.type](v)
    return PartitionPlan(**values)


def result_to_numpy(result: LAMCResult) -> dict:
    """Every field of an :class:`LAMCResult` as numpy arrays; the plan as a
    dict of its fields."""
    out = {}
    for name, v in result._asdict().items():
        if name == "plan":
            out[name] = dataclasses.asdict(v)
        else:
            out[name] = None if v is None else v.detach().cpu().numpy()
    return out


def coo_from_numpy(indices, data, shape) -> torch.Tensor:
    """A coalesced COO tensor (CPU) from a BCOO's numpy ``indices (nnz, 2)``,
    ``data (nnz,)`` and ``shape``. Raises unless the indices are sorted
    row-major and unique, the reference's unique-indices contract."""
    idx = np.asarray(indices).astype(np.int64).reshape(-1, 2)
    lin = idx[:, 0] * int(shape[1]) + idx[:, 1]
    if lin.size and not bool(np.all(np.diff(lin) > 0)):
        raise ValueError("indices must be sorted row-major and unique")
    return torch.sparse_coo_tensor(
        torch.from_numpy(np.ascontiguousarray(idx.T)),
        torch.from_numpy(np.array(data, dtype=np.float32)),
        tuple(int(s) for s in shape), is_coalesced=True, check_invariants=False)


def block_sparse_from_numpy(fields) -> BlockSparseMatrix:
    """A port ``BlockSparseMatrix`` (CPU) from any object carrying the
    reference's fields (``blocks``, ``block_rows``, ``block_cols``,
    ``t_order``, ``shape``, optional ``row_scale`` / ``col_scale``)."""
    f32 = lambda v: None if v is None else torch.from_numpy(
        np.array(v, dtype=np.float32))
    i32 = lambda v: torch.from_numpy(np.array(v, dtype=np.int32))
    return BlockSparseMatrix(
        f32(fields.blocks), i32(fields.block_rows), i32(fields.block_cols),
        i32(fields.t_order), tuple(fields.shape),
        row_scale=f32(getattr(fields, "row_scale", None)),
        col_scale=f32(getattr(fields, "col_scale", None)))


def model_from_numpy(arrays, device: str | torch.device = "cuda") -> CoclusterModel:
    """A port ``CoclusterModel`` on ``device`` from a mapping of its fields or
    any object carrying them (for example the reference's model, whose
    arrays ``np.asarray`` reads). Dtypes are kept as given."""
    dev = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, Mapping) else (
        lambda name: getattr(arrays, name))
    return CoclusterModel(*(torch.from_numpy(np.array(get(f))).to(dev)
                            for f in CoclusterModel._fields))
