"""Carrying plans, random draws, results and LM weights between the two packages.

The co-clustering system has no weights: its state is the plan, the random
draws and the fitted result. The LM substrate's weights come across as the
reference's ``model.init`` tree read with ``np.asarray``
(``lm_params_from_numpy``). JAX's threefry bits cannot be reproduced in torch, so the
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
from .models import transformer
from .streaming.fit import StreamDraws
from .streaming.model import CoclusterModel

__all__ = ["Draws", "draws_from_numpy", "stream_draws_from_numpy",
           "plan_from_numpy", "result_to_numpy",
           "coo_from_numpy", "block_sparse_from_numpy", "model_from_numpy",
           "lm_params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class Draws:
    """The random draws of one ``lamc_cocluster`` run.

    ``row_idx (T_p, m, phi)`` / ``col_idx (T_p, n, psi)``: each resample's
    block index maps. ``anchor_rows`` / ``anchor_cols``: the shared anchor
    indices. ``omega (T_p, B, psi, r)``: each block's SVD sketch.
    ``atom_seeds (T_p, B, k)``: each block's k-means++ draws as point
    indices into its stacked embedding ``Z``. ``row_merge_seeds`` /
    ``col_merge_seeds (restarts, K)``: the merge k-means++ draws as atom
    indices. ``nmtf_row_seeds (T_p, B, k)`` / ``nmtf_col_seeds (T_p, B, d)``:
    the NMTF atom's k-means++ draws as row and column indices of each
    block. A draw left None is drawn from the seeded generators.
    """

    row_idx: torch.Tensor
    col_idx: torch.Tensor
    anchor_rows: torch.Tensor
    anchor_cols: torch.Tensor
    omega: torch.Tensor | None = None
    atom_seeds: torch.Tensor | None = None
    row_merge_seeds: torch.Tensor | None = None
    col_merge_seeds: torch.Tensor | None = None
    nmtf_row_seeds: torch.Tensor | None = None
    nmtf_col_seeds: torch.Tensor | None = None

    def to(self, device: torch.device) -> Draws:
        return Draws(*(None if v is None else v.to(device)
                       for v in dataclasses.astuple(self)))

    def resample(self, t: int) -> dict:
        """Keyword overrides of ``lamc.run_resample`` for resample ``t``."""
        pick = lambda v: None if v is None else v[t]
        nmtf_init = None if self.nmtf_row_seeds is None else (
            self.nmtf_row_seeds[t], self.nmtf_col_seeds[t])
        return dict(row_idx=self.row_idx[t], col_idx=self.col_idx[t],
                    omega=pick(self.omega), seeds=pick(self.atom_seeds),
                    nmtf_init=nmtf_init)


def draws_from_numpy(row_idx, col_idx, anchor_rows, anchor_cols, omega=None,
                     atom_seeds=None, row_merge_seeds=None,
                     col_merge_seeds=None, nmtf_row_seeds=None,
                     nmtf_col_seeds=None) -> Draws:
    """A :class:`Draws` from numpy arrays (indices become int64 tensors)."""
    idx = lambda v: None if v is None else torch.from_numpy(
        np.asarray(v).astype(np.int64))
    return Draws(
        row_idx=idx(row_idx), col_idx=idx(col_idx),
        anchor_rows=idx(anchor_rows), anchor_cols=idx(anchor_cols),
        omega=None if omega is None else torch.from_numpy(
            np.asarray(omega, dtype=np.float32)),
        atom_seeds=idx(atom_seeds), row_merge_seeds=idx(row_merge_seeds),
        col_merge_seeds=idx(col_merge_seeds), nmtf_row_seeds=idx(nmtf_row_seeds),
        nmtf_col_seeds=idx(nmtf_col_seeds))


def stream_draws_from_numpy(perms, omega, atom_seeds, anchor_cols, align_seeds,
                            col_seeds) -> StreamDraws:
    """A streaming fit's :class:`~repro_torch.streaming.StreamDraws` from
    numpy arrays (indices become int64 tensors, the sketch float32); a pair
    of atom seeds stays a pair."""
    idx = lambda v: torch.from_numpy(np.asarray(v).astype(np.int64))
    return StreamDraws(
        perms=idx(perms), omega=torch.from_numpy(np.asarray(omega, dtype=np.float32)),
        atom_seeds=(tuple(idx(s) for s in atom_seeds) if isinstance(atom_seeds, tuple)
                    else idx(atom_seeds)),
        anchor_cols=idx(anchor_cols), align_seeds=idx(align_seeds),
        col_seeds=idx(col_seeds))


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


def _norm_leaves(prefix: str, tree: Mapping, index=None) -> dict:
    take = (lambda a: a) if index is None else (lambda a: a[index])
    return {f"{prefix}.{leaf}": take(tree[leaf]) for leaf in ("scale", "bias") if leaf in tree}


def _block_leaves(prefix: str, kind: str, tree: Mapping, index=None) -> dict:
    """One block's leaves (``index`` picks it from a stacked unit): ``ln1``,
    ``attn`` (``attn``, ``local``) or ``rec`` (``rglru``), ``ln2``, and
    ``mlp`` or ``moe`` (the router, the stacked experts, ``shared``)."""
    take = (lambda a: a) if index is None else (lambda a: a[index])
    out = {**_norm_leaves(f"{prefix}.ln1", tree["ln1"], index),
           **_norm_leaves(f"{prefix}.ln2", tree["ln2"], index)}
    if kind == "rglru":
        rec = tree["rec"]
        for name in ("w_x", "w_gate", "w_out"):
            out[f"{prefix}.rec.{name}"] = take(rec[name]["w"])
        for name in ("w_a", "b_a", "w_i", "b_i"):
            out[f"{prefix}.rec.gates.{name}"] = take(rec["gates"][name])
        out[f"{prefix}.rec.conv"] = take(rec["conv"])
        out[f"{prefix}.rec.lambda"] = take(rec["lambda"])
    else:
        attn = tree["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            out[f"{prefix}.attn.{name}"] = take(attn[name])
        for name in ("q_norm", "k_norm"):
            if name in attn:
                out.update(_norm_leaves(f"{prefix}.attn.{name}", attn[name], index))
    if "moe" in tree:
        experts = tree["moe"]
        out[f"{prefix}.moe.router"] = take(experts["router"]["w"])
        for name in ("w_in", "w_gate", "w_out"):
            out[f"{prefix}.moe.{name}"] = take(experts[name])
        ffn, mlp = f"{prefix}.moe.shared", experts.get("shared")
    else:
        ffn, mlp = f"{prefix}.mlp", tree["mlp"]
    if mlp is not None:
        for name in ("w_in", "w_gate", "w_out"):
            out[f"{ffn}.{name}"] = take(mlp[name]["w"])
    return out


def lm_params_from_numpy(cfg, params_np: Mapping, device: str | torch.device = "cuda",
                         param_dtype=torch.float32) -> transformer.Transformer:
    """The reference's ``model.init(key)`` tree (leaves as numpy arrays) as
    the port's weights: ``embed.table``, ``final_norm``, the leading dense
    ``head_layers``, the ``units`` (one subtree per pattern position, stacked
    along a leading ``n_units`` axis; block ``u * len(pattern) + j`` is
    position ``j`` of unit ``u``), the ``tail`` blocks after them and the
    optional ``lm_head``. Matrices are stored in ``param_dtype``, the leaves
    the reference keeps in float32 (``transformer.keeps_float32``: norms,
    gates, the MoE router) in float32; every leaf must be used and every
    weight given."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)
    n_units, tail = transformer.pattern_layout(cfg)
    leaves = {"embed": params_np["embed"]["table"],
              **_norm_leaves("final_norm", params_np["final_norm"])}
    if "lm_head" in params_np:
        leaves["lm_head"] = params_np["lm_head"]["w"]
    for i, blk in enumerate(params_np.get("head_layers", [])):
        leaves.update(_block_leaves(f"head_layers.{i}", "attn", blk))
    pattern = cfg.block_pattern
    for u in range(n_units):
        for j, kind in enumerate(pattern):
            leaves.update(_block_leaves(f"blocks.{u * len(pattern) + j}", kind,
                                        params_np["units"][str(j)], u))
    for j, (kind, blk) in enumerate(zip(tail, params_np.get("tail", []))):
        leaves.update(_block_leaves(f"blocks.{n_units * len(pattern) + j}", kind, blk))
    params = transformer.Transformer(cfg, device="meta")
    state = {}
    for name, value in leaves.items():
        dtype = torch.float32 if transformer.keeps_float32(name) else param_dtype
        state[name] = torch.as_tensor(np.array(value, dtype=np.float32), device=dev).to(dtype)
    params.load_state_dict(state, strict=True, assign=True)
    return params
