"""Distributed LAMC — the paper's parallel structure over a device mesh.

One process per rank of a ``torch.distributed`` process group; ``mesh`` is a
``DeviceMesh`` over them (``launch.mesh``). Each resample runs the
reference's three phases (DESIGN.md §2) as explicit steps:

  1. **Scatter.** The dense matrix lies sharded as the reference's
     ``a_spec``: rows over the leading block axes (data-major), columns over
     the last; each rank holds only its shard. Every rank draws the
     resample's permutations (the streams ``lamc_cocluster`` draws), cuts
     from its shard the part of every rank's blocks it owns, and one
     ``all_to_all`` over the block axes moves each element a rank's blocks
     need exactly once into that rank's ``(b_loc, phi, psi)`` stack. A COO
     matrix is replicated and each rank scatters its own blocks from the
     stored entries. The anchor slivers are gathered from the shards once.
  2. **Local atoms.** Each rank co-clusters its ``b_loc = B / n_dev``
     blocks (``spectral.scc``: kernels 3, 1 and 2 on the card; or NMTF) and
     summarizes them (``merging.atom_signatures``) with no communication.
     Its random draws are the whole resample's, of which it keeps its slice
     (``stack=``), so every block gets the draws it gets in
     ``lamc_cocluster``.
  3. **Merge.** Signatures and counts are gathered over the block axes,
     innermost first (so the blocks come out data-major), then over the
     resample axis; every rank runs the same replicated
     ``cluster_atoms_best`` from the merge stream, scatters the votes of its
     own atoms, and the vote tables are summed over the block and resample
     axes. Votes are small integer counts in float32, exact in any order,
     so labels, votes and memberships equal ``lamc_cocluster``'s.

On the wire per resample: the matrix elements the blocks take, each once
(the scatter), then ``B (k q_row + k + d q_col + d)`` floats of signatures
and counts and the two vote tables (the merge), independent of the
matrix's size. The distributed driver always densifies its blocks (the
single-block sparse operator route is ``lamc_cocluster``'s).

A gloo group takes CUDA tensors through host memory (ranks that share one
card cannot use NCCL); NCCL takes them where they lie.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import obs
from ..device import fp32_policy, resolve_device, seeded_generator
from ..runtime.shardings import axis_sizes
from . import merging, partition
from . import sparse as _sparse
from .lamc import (_ANCHOR_STREAM, _ATOM_STREAM, _MERGE_STREAM, LAMCConfig, LAMCResult,
                   _atom, anchor_features, validate_config)
from .spectral import no_timer

__all__ = ["distributed_lamc", "lamc_input_specs", "input_placements"]


def _validate_input_format(a, cfg: LAMCConfig) -> None:
    """The configuration and format checks of ``lamc_cocluster``, before any
    collective."""
    validate_config(cfg)
    if cfg.input_format == "bcoo":
        _sparse.validate_bcoo(a)
    elif _sparse.is_bcoo(a):
        raise ValueError("got a COO matrix with input_format='dense'; set "
                         "LAMCConfig(input_format='bcoo') for the sparse path")


def lamc_input_specs(plan: partition.PartitionPlan,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A ``meta`` tensor standing in for the data matrix (shape and dtype)."""
    return torch.empty((plan.n_rows, plan.n_cols), dtype=dtype, device="meta")


def input_placements(mesh, cfg: LAMCConfig,
                     block_axes: Sequence[str] = ("data", "model")) -> tuple:
    """DTensor placements of the data matrix on ``mesh`` (the reference's
    ``a_spec``): rows over the leading block axes, columns over the last
    (rows over the only one when there is one); a COO matrix replicates."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    if cfg.input_format != "bcoo":
        lead = block_axes[:-1] if len(block_axes) >= 2 else block_axes
        for ax in lead:
            out[names.index(ax)] = Shard(0)
        if len(block_axes) >= 2:
            out[names.index(block_axes[-1])] = Shard(1)
    return tuple(out)


def _bounds(n: int, parts: int, i: int) -> tuple[int, int]:
    """Shard ``i`` of ``parts`` of an axis of ``n``: ``torch.chunk``'s cut."""
    size = -(-n // parts)
    return min(i * size, n), min((i + 1) * size, n)


def _linear(coords: dict, sizes: dict, axes: Sequence[str]) -> int:
    """Data-major linear index of ``coords`` over ``axes``."""
    out = 0
    for ax in axes:
        out = out * sizes[ax] + coords[ax]
    return out


class _Layout:
    """Where every rank of the mesh sits: its coordinates, its blocks and
    its shard of the matrix."""

    def __init__(self, mesh, plan, block_axes, resample_axis):
        self.sizes = axis_sizes(mesh)
        self.block_axes = tuple(block_axes)
        self.resample_axis = resample_axis
        layout = mesh.mesh                                   # ranks, mesh-shaped
        names = list(self.sizes)
        self.coords = {}
        for pos in np.ndindex(*layout.shape):
            self.coords[int(layout[pos])] = dict(zip(names, pos))
        self.n_dev = math.prod(self.sizes[ax] for ax in self.block_axes)
        self.b_total = plan.blocks_per_resample
        self.b_loc = self.b_total // self.n_dev
        lead = self.block_axes[:-1] if len(self.block_axes) >= 2 else self.block_axes
        self.row_axes = lead
        self.col_axis = self.block_axes[-1] if len(self.block_axes) >= 2 else None
        self.n_row_shards = math.prod(self.sizes[ax] for ax in lead)
        self.n_col_shards = self.sizes[self.col_axis] if self.col_axis else 1
        self.n_rows, self.n_cols = plan.n_rows, plan.n_cols

    def block_start(self, rank: int) -> int:
        return _linear(self.coords[rank], self.sizes, self.block_axes) * self.b_loc

    def row_shard(self, rank: int) -> int:
        return _linear(self.coords[rank], self.sizes, self.row_axes)

    def col_shard(self, rank: int) -> int:
        return self.coords[rank][self.col_axis] if self.col_axis else 0

    def rows(self, rank: int) -> tuple[int, int]:
        return _bounds(self.n_rows, self.n_row_shards, self.row_shard(rank))

    def cols(self, rank: int) -> tuple[int, int]:
        return _bounds(self.n_cols, self.n_col_shards, self.col_shard(rank))


# ---------------------------------------------------------------- collectives


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _gather_axis(x: torch.Tensor, mesh, layout: _Layout, axis: str, dim: int) -> torch.Tensor:
    """``x`` of every rank along mesh ``axis``, concatenated on ``dim`` in
    the order of the axis coordinate (the reference's tiled ``all_gather``)."""
    if layout.sizes[axis] == 1:
        return x
    group = mesh.get_group(axis)
    stage = _staged(x, group)
    # repro: allow[R2] gloo moves CUDA tensors through host memory (the staged collective)
    src = x.cpu() if stage else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    order = [layout.coords[r][axis] for r in dist.get_process_group_ranks(group)]
    parts = [p for _, p in sorted(zip(order, parts), key=lambda op: op[0])]
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if stage else out


def _sum_axis(x: torch.Tensor, mesh, layout: _Layout, axis: str) -> torch.Tensor:
    """``x`` summed over mesh ``axis`` (the reference's ``psum``)."""
    if layout.sizes[axis] == 1:
        return x
    group = mesh.get_group(axis)
    if _staged(x, group):
        # repro: allow[R2] gloo moves CUDA tensors through host memory (the staged collective)
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    dist.all_reduce(x, group=group)
    return x


_FLAT_GROUPS: dict = {}


def _block_group(mesh, layout: _Layout):
    """The process group of this rank's block axes (the ranks that share its
    coordinates on every other axis), and its members in group-rank order."""
    if layout.n_dev == 1:
        return None, [dist.get_rank()]
    if len(layout.block_axes) == 1:
        group = mesh.get_group(layout.block_axes[0])
        return group, dist.get_process_group_ranks(group)
    key = (id(dist.group.WORLD), tuple(mesh.mesh.flatten().tolist()), layout.block_axes)
    if key not in _FLAT_GROUPS:
        names = list(layout.sizes)
        keep = [i for i, ax in enumerate(names) if ax not in layout.block_axes]
        order = keep + [names.index(ax) for ax in layout.block_axes]
        rows = mesh.mesh.permute(order).reshape(-1, layout.n_dev).tolist()
        me = dist.get_rank()
        mine = None
        for row in rows:                  # every rank makes every group, in order
            group = dist.new_group(sorted(row))
            if me in row:
                mine = group
        _FLAT_GROUPS[key] = mine
    group = _FLAT_GROUPS[key]
    return group, dist.get_process_group_ranks(group)


def _all_to_all(send: torch.Tensor, send_splits, recv_splits, group) -> torch.Tensor:
    recv_total = sum(recv_splits)
    stage = _staged(send, group)
    # repro: allow[R2] gloo moves CUDA tensors through host memory (the staged collective)
    src = send.cpu() if stage else send
    recv = torch.empty(recv_total, dtype=src.dtype, device=src.device)
    dist.all_to_all_single(recv, src, output_split_sizes=list(recv_splits),
                           input_split_sizes=list(send_splits), group=group)
    return recv.to(send.device) if stage else recv


# ----------------------------------------------------------------- phase 1


def _owned(idx: torch.Tensor, bounds: tuple[int, int]):
    """Positions of ``idx`` that fall in ``[lo, hi)`` (ascending) and those
    entries' ids local to the shard."""
    lo, hi = bounds
    pos = torch.nonzero((idx >= lo) & (idx < hi)).flatten()
    return pos, idx[pos] - lo


def _place(stack_block: torch.Tensor, pos_r, pos_c, piece: torch.Tensor) -> None:
    if piece.shape == stack_block.shape:         # the whole block: positions are arange
        stack_block.copy_(piece)
    else:
        stack_block[pos_r[:, None], pos_c[None, :]] = piece


def _scatter(a_loc, layout: _Layout, plan, row_idx, col_idx, me: int, members,
             group, dev, stats: dict) -> torch.Tensor:
    """This rank's ``(b_loc, phi, psi)`` block stack of one resample from
    the sharded matrix: one ``all_to_all`` over the block group."""
    n = plan.n
    # for each shard: the positions of every block-row's rows (every
    # block-col's columns) it owns, and their shard-local ids
    row_own = {s: [_owned(row_idx[i], _bounds(plan.n_rows, layout.n_row_shards, s))
                   for i in range(plan.m)] for s in {layout.row_shard(r) for r in members}}
    col_own = {s: [_owned(col_idx[j], _bounds(plan.n_cols, layout.n_col_shards, s))
                   for j in range(n)] for s in {layout.col_shard(r) for r in members}}

    def pieces(src: int, dst: int):
        rs, cs = layout.row_shard(src), layout.col_shard(src)
        b0 = layout.block_start(dst)
        for b in range(b0, b0 + layout.b_loc):
            (pr, lr), (pc, lc) = row_own[rs][b // n], col_own[cs][b % n]
            yield b - b0, pr, lr, pc, lc

    def cuts(src: int, dst: int):
        """``(block, positions, piece)`` of ``src``'s part of ``dst``'s blocks:
        one row gather per block-row and one column gather for all its
        blocks, so the row panel is read once."""
        pending: dict = {}
        for bl, pr, lr, pc, lc in pieces(src, dst):
            if len(pr) and len(pc):
                pending.setdefault(id(lr), (pr, lr, []))[2].append((bl, pc, lc))
        for pr, lr, blocks in pending.values():
            panel = a_loc.index_select(0, lr).index_select(
                1, torch.cat([lc for _, _, lc in blocks]))
            off = 0
            for bl, pc, _ in blocks:
                yield bl, pr, pc, panel[:, off:off + len(pc)]
                off += len(pc)

    stack = torch.empty((layout.b_loc, plan.phi, plan.psi), dtype=torch.float32,
                        device=dev)
    for bl, pr, pc, piece in cuts(me, me):     # this rank's own part: no buffer
        _place(stack[bl], pr, pc, piece)
    if len(members) == 1:
        return stack

    size = lambda pr, pc: len(pr) * len(pc)
    send_splits = [0 if d == me else sum(size(pr, pc) for _, pr, _, pc, _ in pieces(me, d))
                   for d in members]
    recv_splits = [0 if s == me else sum(size(pr, pc) for _, pr, _, pc, _ in pieces(s, me))
                   for s in members]
    send = torch.empty(sum(send_splits), dtype=torch.float32, device=dev)
    off = 0
    for d in members:
        if d == me:
            continue
        for _bl, pr, pc, piece in cuts(me, d):
            send[off:off + size(pr, pc)].view(len(pr), len(pc)).copy_(piece)
            off += size(pr, pc)
    recv = _all_to_all(send, send_splits, recv_splits, group)
    del send
    off = 0
    for s in members:
        if s == me:
            continue
        for bl, pr, _lr, pc, _lc in pieces(s, me):
            if size(pr, pc):
                _place(stack[bl], pr, pc, recv[off:off + size(pr, pc)].view(len(pr), len(pc)))
                off += size(pr, pc)
    stats["scatter_bytes_sent"] = stats.get("scatter_bytes_sent", 0) + 4 * sum(send_splits)
    stats["scatter_bytes_received"] = (stats.get("scatter_bytes_received", 0)
                                       + 4 * sum(recv_splits))
    return stack


def _gather_slivers(a_loc, layout: _Layout, me: int, members, group,
                    anchor_rows, anchor_cols, dev):
    """The anchor slivers ``(A[:, anchor_cols] (M, q), A[anchor_rows] (q, N))``
    assembled from every shard of the block group (exact copies)."""
    max_rows = -(-layout.n_rows // layout.n_row_shards)
    max_cols = -(-layout.n_cols // layout.n_col_shards)

    def own_anchor(rank):
        r0, r1 = layout.rows(rank)
        c0, c1 = layout.cols(rank)
        return ((anchor_cols >= c0) & (anchor_cols < c1), (anchor_rows >= r0) & (anchor_rows < r1),
                (r0, r1), (c0, c1))

    mc, mr, (r0, r1), (c0, c1) = own_anchor(me)
    row_part = torch.zeros((max_rows, len(anchor_cols)), dtype=torch.float32, device=dev)
    col_part = torch.zeros((len(anchor_rows), max_cols), dtype=torch.float32, device=dev)
    row_part[: r1 - r0, mc] = a_loc.index_select(1, anchor_cols[mc] - c0)
    col_part[mr, : c1 - c0] = a_loc.index_select(0, anchor_rows[mr] - r0)
    if len(members) == 1:
        return row_part[: r1 - r0], col_part[:, : c1 - c0]
    flat = torch.cat([row_part.flatten(), col_part.flatten()])
    stage = _staged(flat, group)
    # repro: allow[R2] gloo moves CUDA tensors through host memory (the staged collective)
    src = flat.cpu() if stage else flat
    parts = [torch.empty_like(src) for _ in members]
    dist.all_gather(parts, src, group=group)
    row_sliver = torch.empty((layout.n_rows, len(anchor_cols)), dtype=torch.float32, device=dev)
    col_sliver = torch.empty((len(anchor_rows), layout.n_cols), dtype=torch.float32, device=dev)
    for rank, part in zip(members, parts):
        part = part.to(dev)
        mc, mr, (r0, r1), (c0, c1) = own_anchor(rank)
        rp = part[: row_part.numel()].view(row_part.shape)
        cp = part[row_part.numel():].view(col_part.shape)
        row_sliver[r0:r1, mc] = rp[: r1 - r0, mc]
        col_sliver[mr, c0:c1] = cp[mr, : c1 - c0]
    return row_sliver, col_sliver


# ---------------------------------------------------------------- the driver


def _local_matrix(a, layout: _Layout, me: int, dev: torch.device) -> torch.Tensor:
    """This rank's shard of a dense input: a DTensor's local tensor, or the
    rank's part of a full (replicated) matrix."""
    (r0, r1), (c0, c1) = layout.rows(me), layout.cols(me)
    if isinstance(a, DTensor):
        if tuple(a.shape) != (layout.n_rows, layout.n_cols):
            raise ValueError(f"plan is for {layout.n_rows} x {layout.n_cols}, matrix is "
                             f"{tuple(a.shape)}")
        local = a.to_local()
        if tuple(local.shape) != (r1 - r0, c1 - c0):
            raise ValueError(
                f"this rank's shard is {tuple(local.shape)}, the layout "
                f"(input_placements) gives {(r1 - r0, c1 - c0)}")
        return local.to(device=dev, dtype=torch.float32)
    full = torch.as_tensor(a)
    if full.ndim != 2:
        raise ValueError(f"expected a dense (M, N) matrix, got {tuple(full.shape)}")
    if tuple(full.shape) != (layout.n_rows, layout.n_cols):
        raise ValueError(f"plan is for {layout.n_rows} x {layout.n_cols}, matrix is "
                         f"{tuple(full.shape)}")
    return full[r0:r1, c0:c1].to(device=dev, dtype=torch.float32)


def _slice(v, b0: int, count: int):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(x[b0:b0 + count] for x in v)
    return v[b0:b0 + count]


def distributed_lamc(mesh, a, cfg: LAMCConfig, plan: partition.PartitionPlan,
                     block_axes: Sequence[str] = ("data", "model"),
                     resample_axis: str | None = None, *, draws=None,
                     device: str | torch.device = "cuda", timer=no_timer,
                     stats: dict | None = None) -> LAMCResult:
    """Run LAMC on ``mesh`` (see the module docstring); every rank calls it
    and every rank gets the whole, replicated result.

    ``a``: a DTensor with :func:`input_placements`, or the full matrix on
    every rank (each takes its shard); a coalesced COO tensor with
    ``cfg.input_format="bcoo"`` (replicated). ``block_axes``: the mesh axes
    the blocks of a resample are split over; ``resample_axis``: an optional
    mesh axis the ``T_p`` resamples are split over (each pod its own
    resamples). ``draws`` (``interop.Draws``) replaces the seeded draws, as
    in ``lamc_cocluster``. ``timer(name)`` wraps ``scatter``, the atom's
    phases, ``signatures`` and ``merge``; ``stats`` (a dict) receives the
    bytes the scatter sent and received and the merge's gathered bytes.
    """
    _validate_input_format(a, cfg)
    sizes = axis_sizes(mesh)
    for ax in tuple(block_axes) + ((resample_axis,) if resample_axis else ()):
        if ax not in sizes:
            raise ValueError(f"{ax!r} is not an axis of the mesh {sizes}")
    if resample_axis in block_axes:
        raise ValueError(f"the resample axis {resample_axis!r} is also a block axis")
    n_dev = math.prod(sizes[ax] for ax in block_axes)
    b_total = plan.blocks_per_resample
    if b_total % n_dev != 0:
        raise ValueError(
            f"blocks per resample ({plan.m}x{plan.n}={b_total}) must be a "
            f"multiple of the device count {n_dev}; adjust the plan grid")
    if resample_axis is not None and plan.t_p % sizes[resample_axis] != 0:
        raise ValueError(
            f"T_p={plan.t_p} must be a multiple of the resample axis size "
            f"{sizes[resample_axis]}")
    dev = resolve_device(device)
    fp32_policy()
    stats = {} if stats is None else stats
    layout = _Layout(mesh, plan, block_axes, resample_axis)
    me = dist.get_rank()
    b0, b_loc = layout.block_start(me), layout.b_loc
    t_loc = plan.t_p // (sizes[resample_axis] if resample_axis else 1)
    t0 = layout.coords[me][resample_axis] * t_loc if resample_axis else 0
    group, members = _block_group(mesh, layout)
    q = cfg.signature_dim
    n = plan.n
    my_blocks = torch.arange(b0, b0 + b_loc, device=dev)

    with obs.span("distributed_lamc", devices=int(mesh.mesh.numel()), mesh=str(sizes),
                  block_axes="/".join(block_axes), resample_axis=resample_axis or "",
                  m=plan.m, n=plan.n, phi=plan.phi, psi=plan.psi, t_p=plan.t_p,
                  b_loc=b_loc, t_loc=t_loc) as root:
        if cfg.input_format == "bcoo":
            a_loc = _sparse.operand_to(a, dev)
        else:
            a_loc = _local_matrix(a, layout, me, dev)
        if draws is not None:
            draws = draws.to(dev)
            anchor_rows, anchor_cols = draws.anchor_rows, draws.anchor_cols
        else:
            gen = seeded_generator(dev, plan.seed, _ANCHOR_STREAM)
            anchor_rows = merging.anchor_indices(plan.n_rows, q, gen, dev)
            anchor_cols = merging.anchor_indices(plan.n_cols, q, gen, dev)
        outs = []
        with obs.span("pipeline", phases="scatter->atoms->merge") as pipe:
            with obs.span("scatter") as sp, timer("scatter"):
                if cfg.input_format == "bcoo":
                    slivers = anchor_features(a_loc, anchor_rows, anchor_cols)
                else:
                    slivers = _gather_slivers(a_loc, layout, me, members, group,
                                              anchor_rows, anchor_cols, dev)
                sp.fence(slivers)
            row_sliver, col_sliver = slivers
            for t in range(t0, t0 + t_loc):
                if draws is not None:
                    row_idx, col_idx = draws.row_idx[t], draws.col_idx[t]
                else:
                    row_idx, col_idx = partition.resample_indices(plan, t, dev)
                with obs.span("scatter", resample=t) as sp, timer("scatter"):
                    if cfg.input_format == "bcoo":
                        blocks, _, _ = partition.extract_blocks_sparse(
                            a_loc, plan, t, row_idx=row_idx, col_idx=col_idx,
                            block_range=(b0, b_loc))
                    else:
                        blocks = _scatter(a_loc, layout, plan, row_idx, col_idx, me,
                                          members, group, dev, stats)
                    sp.fence(blocks)
                inj = {} if draws is None else draws.resample(t)
                nmtf_init = inj.get("nmtf_init")
                with obs.span("atoms", resample=t) as sp:
                    row_labels, col_labels = _atom(
                        blocks, cfg, seeded_generator(dev, plan.seed, _ATOM_STREAM, t), dev,
                        _slice(inj.get("omega"), b0, b_loc), _slice(inj.get("seeds"), b0, b_loc),
                        None if nmtf_init is None else _slice(nmtf_init, b0, b_loc), timer,
                        stack=None if b_loc == b_total else (b0, b_total))
                    del blocks
                    with timer("signatures"):
                        row_feats = row_sliver[row_idx][my_blocks // n]       # (b_loc, phi, q)
                        col_feats = col_sliver[:, col_idx].permute(1, 2, 0)[my_blocks % n]
                        row_sigs, row_counts = merging.atom_signatures(
                            row_feats, row_labels, cfg.atom_k)
                        col_sigs, col_counts = merging.atom_signatures(
                            col_feats, col_labels, cfg.atom_d)
                    sp.fence(row_sigs)
                outs.append(dict(row_labels=row_labels, col_labels=col_labels,
                                 row_sigs=row_sigs, row_counts=row_counts,
                                 col_sigs=col_sigs, col_counts=col_counts,
                                 row_index=row_idx, col_index=col_idx))
            stk = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
            del outs
            with obs.span("merge") as sp, timer("merge"):
                row_votes, col_votes = _merge(stk, mesh, layout, cfg, plan, dev,
                                              b0, t0, draws, stats)
                sp.fence(row_votes)
            pipe.fence(col_votes)
        root.set(**{k: int(v) for k, v in stats.items()})
        with obs.span("finalize") as fs:
            row_labels, row_member = merging.finalize_assignment(
                row_votes, cfg.assignment, cfg.overlap_threshold, cfg.min_membership)
            col_labels, col_member = merging.finalize_assignment(
                col_votes, cfg.assignment, cfg.overlap_threshold, cfg.min_membership)
            row_sigs, row_mean, _ = merging.cluster_signatures(
                row_sliver, row_labels, cfg.n_row_clusters)
            col_sigs, col_mean, _ = merging.cluster_signatures(
                col_sliver.T, col_labels, cfg.n_col_clusters)
            return fs.fence(LAMCResult(
                row_labels, col_labels, row_votes, col_votes,
                dataclasses.replace(plan, spmm_route="dense"),
                row_sigs=row_sigs, col_sigs=col_sigs, row_mean=row_mean,
                col_mean=col_mean, anchor_rows=anchor_rows, anchor_cols=anchor_cols,
                row_membership=row_member, col_membership=col_member))


def _merge(stk: dict, mesh, layout: _Layout, cfg: LAMCConfig, plan, dev, b0: int,
           t0: int, draws, stats: dict):
    """Phase 3: gather the signatures, cluster the atoms replicated, vote
    locally and sum the vote tables. Returns ``(row_votes, col_votes)``."""
    t_loc, b_loc, k, q_row = stk["row_sigs"].shape
    d, q_col = stk["col_sigs"].shape[2:]
    # one packed gather per axis: signatures and counts of both sides
    packed = torch.cat([stk["row_sigs"].reshape(t_loc, b_loc, -1), stk["row_counts"],
                        stk["col_sigs"].reshape(t_loc, b_loc, -1), stk["col_counts"]], dim=2)
    for ax in reversed(layout.block_axes):       # innermost first: data-major blocks
        packed = _gather_axis(packed, mesh, layout, ax, dim=1)
    if layout.resample_axis is not None:
        packed = _gather_axis(packed, mesh, layout, layout.resample_axis, dim=0)
    stats["merge_bytes_gathered"] = stats.get("merge_bytes_gathered", 0) + 4 * packed.numel()
    row_sigs, row_counts, col_sigs, col_counts = torch.split(
        packed, [k * q_row, k, d * q_col, d], dim=2)
    gen = seeded_generator(dev, plan.seed, _MERGE_STREAM)
    votes = []
    for sigs, counts, labels, index, of_block, n_points, k_local, k_global, seeds in (
            (row_sigs, row_counts, stk["row_labels"], stk["row_index"],
             lambda b: b // plan.n, plan.n_rows, k, cfg.n_row_clusters,
             None if draws is None else draws.row_merge_seeds),
            (col_sigs, col_counts, stk["col_labels"], stk["col_index"],
             lambda b: b % plan.n, plan.n_cols, d, cfg.n_col_clusters,
             None if draws is None else draws.col_merge_seeds)):
        q_side = sigs.shape[2] // k_local
        atom_global = merging.cluster_atoms_best(
            sigs.reshape(-1, q_side).contiguous(), counts.reshape(-1).contiguous(),
            k_global, cfg.merge_kmeans_iters, cfg.merge_restarts, generator=gen,
            seeds=seeds).reshape(plan.t_p, layout.b_total, k_local)
        mine = atom_global[t0:t0 + t_loc, b0:b0 + b_loc]               # this rank's atoms
        point_global = torch.gather(mine, 2, labels)                   # (t_loc, b_loc, P)
        blocks = torch.arange(b0, b0 + b_loc, device=dev)
        points = index[:, of_block(blocks), :]
        table = torch.zeros((n_points, k_global), dtype=torch.float32, device=dev)
        table.index_put_((points.reshape(-1), point_global.reshape(-1)),
                         torch.ones(points.numel(), dtype=torch.float32, device=dev),
                         accumulate=True)
        for ax in layout.block_axes + ((layout.resample_axis,) if layout.resample_axis else ()):
            table = _sum_axis(table, mesh, layout, ax)
        votes.append(table)
    return votes[0], votes[1]
