"""LAMC driver — partition -> batched atom co-clustering -> hierarchical merge.

The dense path of the paper's Algorithm 1. Per resample ``t``:

  1. ``partition.extract_blocks`` gathers the ``(m*n, phi, psi)`` block stack.
  2. The atom runs on the whole stack at once (the reference vmaps it): SCC
     (normalization, randomized SVD and k-means, each batched over blocks)
     or, with ``atom="nmtf"``, NMTF's multiplicative updates as batched
     products.
  3. Atom signatures are computed over the shared anchor features.

Afterwards ``merging.signature_merge`` produces the consensus labels. The
reference's ``lax.scan`` over resamples is a Python loop here.

``LAMCConfig(input_format="bcoo")`` runs the sparse path (DESIGN.md §9) on a
coalesced COO tensor, which is never densified: the plan is priced at the
matrix's density, blocks and anchor slivers are scattered out of the
stored entries (``partition.extract_blocks_sparse``), and a single-block
plan covering the whole matrix on a non-dense route runs the atom straight
on the prepared sparse operator (``sparse.prepare_operator``: the tiled
block-sparse form, whose products are the CUDA SpMM kernels on the card,
or dual-ELL).

Randomness comes from ``torch.Generator`` streams seeded from ``plan.seed``;
``draws=`` replaces them with given index maps, anchors, sketches and
k-means++ seeds (``interop.Draws``), which is how the tests run the port on
the reference's random draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import fp32_policy, resolve_device, seeded_generator
from . import merging, partition, probability, spectral
from . import sparse as _sparse
from .nmtf import nmtf as _nmtf

__all__ = ["LAMCConfig", "LAMCResult", "lamc_cocluster", "run_resample",
           "anchor_features", "validate_config", "validate_assignment"]

# Stream ids of ``seeded_generator(device, plan.seed, stream, ...)``; stream 0
# is the resample permutations (``partition``).
_ATOM_STREAM = 1
_ANCHOR_STREAM = 7
_MERGE_STREAM = 8


@dataclasses.dataclass(frozen=True)
class LAMCConfig:
    """The reference's ``LAMCConfig``, field for field, so configurations
    carry across."""

    n_row_clusters: int
    n_col_clusters: int
    atom_row_clusters: int | None = None
    atom_col_clusters: int | None = None
    atom: str = "scc"
    min_cocluster_rows: int = 8
    min_cocluster_cols: int = 8
    p_thresh: float = 0.95
    workers: int = 1
    seed: int = 0
    svd_iters: int = 4
    kmeans_iters: int = 16
    nmtf_iters: int = 64
    merge_kmeans_iters: int = 25
    merge_restarts: int = 4
    signature_dim: int = 64
    expected_failed_blocks: int = 0
    grid_candidates: tuple = (1, 2, 4, 8, 16, 32)
    assign_impl: str = "jnp"        # "jnp" | "pallas" (the CUDA kernels)
    svd_method: str = "randomized"  # "randomized" | "exact"
    qr_method: str = "qr"           # "qr" | "cholesky"
    input_format: str = "dense"     # "dense" | "bcoo" (a coalesced COO tensor)
    spmm_impl: str = "auto"         # "auto" | "dense" | "dual_ell" | "tiled"
    assignment: str = "hard"        # "hard" | "overlap" (DESIGN.md §11)
    overlap_threshold: float = 0.25
    min_membership: int = 0

    @property
    def atom_k(self) -> int:
        return self.atom_row_clusters or self.n_row_clusters

    @property
    def atom_d(self) -> int:
        return self.atom_col_clusters or self.n_col_clusters


class LAMCResult(NamedTuple):
    row_labels: torch.Tensor
    col_labels: torch.Tensor
    row_votes: torch.Tensor
    col_votes: torch.Tensor
    plan: partition.PartitionPlan
    row_sigs: torch.Tensor | None = None     # (K_row, q_row) unit rows
    col_sigs: torch.Tensor | None = None     # (K_col, q_col)
    row_mean: torch.Tensor | None = None     # (q_row,)
    col_mean: torch.Tensor | None = None     # (q_col,)
    anchor_rows: torch.Tensor | None = None  # (q_col,) global row ids
    anchor_cols: torch.Tensor | None = None  # (q_row,) global col ids
    row_membership: torch.Tensor | None = None  # (M, K_row) bool
    col_membership: torch.Tensor | None = None  # (N, K_col) bool


def validate_assignment(cfg) -> None:
    """Raise on wrong assignment knobs. ``cfg`` is any configuration that
    carries them: an ``LAMCConfig`` or a ``streaming.StreamConfig``."""
    if cfg.assignment not in ("hard", "overlap"):
        raise ValueError(
            f"assignment must be 'hard' or 'overlap', got {cfg.assignment!r}")
    if not 0.0 < cfg.overlap_threshold <= 1.0:
        raise ValueError(
            f"overlap_threshold must be in (0, 1], got {cfg.overlap_threshold}")
    if not 0 <= cfg.min_membership <= min(cfg.n_row_clusters, cfg.n_col_clusters):
        raise ValueError(
            f"min_membership must be in [0, n_clusters], got {cfg.min_membership}")


def validate_config(cfg: LAMCConfig) -> None:
    """Raise on configurations that are wrong."""
    if cfg.input_format not in ("dense", "bcoo"):
        raise ValueError(f"unknown input_format {cfg.input_format!r}")
    _sparse.validate_spmm_impl(cfg.spmm_impl)
    if cfg.atom not in ("scc", "nmtf"):
        raise ValueError(f"unknown atom method {cfg.atom!r}")
    validate_assignment(cfg)


def anchor_features(a: torch.Tensor, anchor_rows: torch.Tensor,
                    anchor_cols: torch.Tensor):
    """Anchor slivers ``(A[:, anchor_cols] (M, q), A[anchor_rows] (q, N))``;
    a COO matrix scatters its stored entries straight into them, O(nnz)."""
    if _sparse.is_bcoo(a):
        return (_sparse.gather_cols_dense(a, anchor_cols),
                _sparse.gather_rows_dense(a, anchor_rows))
    return a.index_select(1, anchor_cols), a.index_select(0, anchor_rows)


def _operator_index(given, n_points: int, groups: int, size: int,
                    device: torch.device) -> torch.Tensor:
    """The operator path's index map, ``arange`` as ``(groups, size)``; an
    injected map must be that one (the path does not permute)."""
    natural = torch.arange(n_points, device=device).reshape(groups, size)
    # repro: allow[R2] checks an injected index map (draws= only); a seeded run passes None
    if given is not None and not torch.equal(given.to(device), natural):
        raise ValueError("the operator path does not permute: an injected "
                         "index map must be arange(n).reshape(groups, size)")
    return natural


def _atom(blocks, cfg: LAMCConfig, gen: torch.Generator, dev: torch.device,
          omega, seeds, nmtf_init, timer, stack=None):
    """The configured atom on the block stack (the reference's ``_atom_fn``):
    ``(row_labels (B, phi), col_labels (B, psi))``. NMTF shifts the stack in
    place: it is this resample's own. ``stack=(offset, total)``: the blocks
    are a slice of a resample's stack, drawn for as the whole stack."""
    if cfg.atom == "nmtf":
        with timer("nmtf"):
            res = _nmtf(blocks, cfg.atom_k, cfg.atom_d, n_iter=cfg.nmtf_iters,
                       init=nmtf_init, generator=gen, overwrite_a=True,
                       device=dev, timer=timer, stack=stack)
    else:
        res = spectral.scc(
            blocks, cfg.atom_k, cfg.atom_d, svd_iters=cfg.svd_iters,
            kmeans_iters=cfg.kmeans_iters, assign_impl=cfg.assign_impl,
            svd_method=cfg.svd_method, qr_method=cfg.qr_method, omega=omega,
            seeds=seeds, generator=gen, device=dev, timer=timer, stack=stack)
    return res.row_labels, res.col_labels


def run_resample(a: torch.Tensor, plan: partition.PartitionPlan,
                 cfg: LAMCConfig, slivers, t: int, *, row_idx=None,
                 col_idx=None, omega=None, seeds=None, nmtf_init=None,
                 operator=None, timer=spectral.no_timer):
    """One resample: extract blocks, co-cluster them (batched), summarize.

    ``slivers`` are the anchor features from :func:`anchor_features`.
    ``row_idx`` / ``col_idx`` / ``omega`` / ``seeds`` replace this
    resample's drawn permutations, sketches and SCC k-means++ seeds;
    ``nmtf_init = (row_seeds (B, k), col_seeds (B, d))`` the NMTF atom's.
    Returns the per-resample tensors ``merging.signature_merge`` consumes.

    ``operator`` (single-block plans only): the prepared sparse operand of
    the whole matrix (``sparse.prepare_operator``). The atom runs on it
    directly and the ``M x N`` block is never densified; the per-resample
    permutation is skipped (with one block it only reorders points inside
    the block), so the index maps are ``arange`` reshapes. The atom draws
    from block 0's stream of resample ``t``.
    """
    b = plan.blocks_per_resample
    if operator is not None:
        if b != 1:
            raise ValueError("the operator path needs a single-block plan")
        row_idx = _operator_index(row_idx, plan.n_rows, plan.m, plan.phi, a.device)
        col_idx = _operator_index(col_idx, plan.n_cols, plan.n, plan.psi, a.device)
        blocks = operator
    else:
        extract = (partition.extract_blocks_sparse if cfg.input_format == "bcoo"
                   else partition.extract_blocks)
        with timer("extract"):
            blocks, row_idx, col_idx = extract(a, plan, t, row_idx=row_idx,
                                               col_idx=col_idx)
    row_labels, col_labels = _atom(
        blocks, cfg, seeded_generator(a.device, plan.seed, _ATOM_STREAM, t),
        a.device, omega, seeds, nmtf_init, timer)
    del blocks
    with timer("signatures"):
        row_sliver, col_sliver = slivers
        blk = torch.arange(b, device=a.device)
        row_feats = row_sliver[row_idx]                           # (m, phi, q)
        col_feats = col_sliver[:, col_idx].permute(1, 2, 0)       # (n, psi, q)
        row_sigs, row_counts = merging.atom_signatures(
            row_feats[blk // plan.n], row_labels, cfg.atom_k)
        col_sigs, col_counts = merging.atom_signatures(
            col_feats[blk % plan.n], col_labels, cfg.atom_d)
    return dict(
        row_sigs=row_sigs, row_counts=row_counts, row_labels=row_labels,
        row_index=row_idx,
        col_sigs=col_sigs, col_counts=col_counts, col_labels=col_labels,
        col_index=col_idx,
    )


def lamc_cocluster(a, cfg: LAMCConfig,
                   plan: partition.PartitionPlan | None = None,
                   block_mask=None, *, draws=None,
                   device: str | torch.device = "cuda",
                   timer=spectral.no_timer) -> LAMCResult:
    """Full LAMC pipeline (Algorithm 1) on a matrix ``a (M, N)``: dense, or a
    coalesced COO tensor with ``cfg.input_format="bcoo"``.

    ``plan=None`` derives the plan from the probabilistic model, priced at
    the matrix's density; ``cfg.spmm_impl`` picks the sparse operator of a
    single-block plan, and the route that ran is ``result.plan.spmm_route``.
    ``block_mask`` (``(t_p, blocks_per_resample)`` bool, True = survived)
    drops the masked blocks' atoms from the merge. ``draws``
    (``interop.Draws``) replaces the seeded permutations, anchors, sketches
    and k-means++ seeds. ``a`` is moved to ``device``. ``timer(name)``
    returns a context manager around each phase (``prepare_operator``,
    ``extract``, ``normalize``, ``svd``, ``kmeans`` or ``nmtf`` (around
    ``nmtf_init`` and ``nmtf_updates``), ``signatures``, ``merge``).
    ``cfg.atom="nmtf"`` densifies the blocks of a COO input, as any
    multi-block plan does.
    """
    validate_config(cfg)
    dev = resolve_device(device)
    fp32_policy()
    if cfg.input_format == "bcoo":
        a = _sparse.operand_to(_sparse.validate_bcoo(a), dev)
        density = _sparse.density(a)
    elif _sparse.is_bcoo(a):
        raise ValueError("got a COO matrix with input_format='dense'; set "
                         "LAMCConfig(input_format='bcoo') for the sparse path")
    else:
        a = torch.as_tensor(a, dtype=torch.float32, device=dev)
        if a.ndim != 2:
            raise ValueError(f"expected a dense (M, N) matrix, got {tuple(a.shape)}")
        density = 1.0
    n_rows, n_cols = a.shape
    if plan is None:
        plan = partition.make_plan(
            n_rows, n_cols,
            min_cocluster_rows=cfg.min_cocluster_rows,
            min_cocluster_cols=cfg.min_cocluster_cols,
            p_thresh=cfg.p_thresh,
            workers=cfg.workers,
            seed=cfg.seed,
            k=cfg.atom_k,
            expected_failed_blocks=cfg.expected_failed_blocks,
            grid_candidates=cfg.grid_candidates,
            svd_method=cfg.svd_method,
            density=density,
            spmm_impl=cfg.spmm_impl,
        )
    if (plan.n_rows, plan.n_cols) != (n_rows, n_cols):
        raise ValueError(f"plan is for {plan.n_rows} x {plan.n_cols}, matrix is "
                         f"{n_rows} x {n_cols}")
    operator = None
    if cfg.input_format == "bcoo":
        # Only a single SCC block covering the whole matrix can run on the
        # sparse operator; every other plan densifies its blocks, so its
        # route is "dense" whatever the knob says. The plan search uses the
        # same resolver, so what runs is what was priced.
        single = (plan.blocks_per_resample == 1 and cfg.atom == "scc"
                  and plan.phi == plan.n_rows and plan.psi == plan.n_cols)
        route = probability.resolve_spmm_route(
            cfg.spmm_impl, density, float(plan.phi) * plan.psi, single=single,
            svd_method=cfg.svd_method)
        if plan.spmm_route != route:
            plan = dataclasses.replace(plan, spmm_route=route)
        if single and route != "dense":
            # One conversion, reused by every resample's products and served
            # from the pattern cache when the same matrix comes again.
            with timer("prepare_operator"):
                operator = _sparse.prepare_operator(a, route)
    if block_mask is not None:
        block_mask = torch.as_tensor(block_mask, dtype=torch.bool, device=dev)
        want = (plan.t_p, plan.blocks_per_resample)
        if tuple(block_mask.shape) != want:
            raise ValueError(
                f"block_mask must be (t_p, blocks_per_resample) = {want}, "
                f"got {tuple(block_mask.shape)}")

    q = cfg.signature_dim
    if draws is not None:
        draws = draws.to(dev)
        anchor_rows, anchor_cols = draws.anchor_rows, draws.anchor_cols
    else:
        gen = seeded_generator(dev, plan.seed, _ANCHOR_STREAM)
        anchor_rows = merging.anchor_indices(n_rows, q, gen, dev)
        anchor_cols = merging.anchor_indices(n_cols, q, gen, dev)
    slivers = anchor_features(a, anchor_rows, anchor_cols)

    outs = []
    for t in range(plan.t_p):
        injected = {} if draws is None else draws.resample(t)
        outs.append(run_resample(a, plan, cfg, slivers, t, operator=operator,
                                 timer=timer, **injected))
    stacked = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
    del outs

    with timer("merge"):
        row_sliver, col_sliver = slivers
        merged = merging.signature_merge(
            n_rows=n_rows, n_cols=n_cols,
            k_row=cfg.n_row_clusters, k_col=cfg.n_col_clusters,
            m=plan.m, n=plan.n,
            kmeans_iters=cfg.merge_kmeans_iters,
            n_restarts=cfg.merge_restarts,
            row_features=row_sliver, col_features=col_sliver.T,
            assignment=cfg.assignment,
            overlap_threshold=cfg.overlap_threshold,
            min_membership=cfg.min_membership,
            block_mask=block_mask,
            generator=seeded_generator(dev, plan.seed, _MERGE_STREAM),
            row_seeds=None if draws is None else draws.row_merge_seeds,
            col_seeds=None if draws is None else draws.col_merge_seeds,
            **stacked,
        )
    return LAMCResult(
        merged.row_labels, merged.col_labels,
        merged.row_votes, merged.col_votes, plan,
        row_sigs=merged.row_sigs, col_sigs=merged.col_sigs,
        row_mean=merged.row_mean, col_mean=merged.col_mean,
        anchor_rows=anchor_rows, anchor_cols=anchor_cols,
        row_membership=merged.row_membership,
        col_membership=merged.col_membership)
