"""Probabilistic partition model — Theorem 1 / Eqs. (1)-(4) of the LAMC paper.

The model bounds the probability of *failing* to detect a co-cluster ``C_k``
(of size ``M_k x N_k`` inside an ``M x N`` matrix) when the matrix is
partitioned into an ``m x n`` grid of uniform ``phi x psi`` blocks, and the
atom co-clusterer needs at least ``T_m`` rows and ``T_n`` columns of the
co-cluster to land inside one block.

All formulas follow the paper's Appendix:

    s(k) = M_k / M - (T_m - 1) / phi              (Eq. 16)
    t(k) = N_k / N - (T_n - 1) / psi
    P(omega_k) <= exp{-2 [phi m s^2 + psi n t^2]} (Eq. 17 / Thm. 1)
    P_detect  >= 1 - P(omega_k)^{T_p}             (Eq. 18 / Eq. 3)

and Eq. (4) is solved in closed form for the minimal number of resamples
``T_p`` achieving a target success probability.

Everything here is plain float math (host side): these quantities drive the
*plan*, not the on-device compute. This is a numpy copy of the reference
package's plan model with the cost constants unchanged, so both packages
resolve identical plans for identical arguments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = [
    "margin_terms",
    "failure_exponent",
    "failure_bound",
    "detection_probability",
    "min_resamples",
    "PlanCandidate",
    "plan_partition",
    "resamples_for_failures",
    "spmm_costs",
    "spmm_route",
    "resolve_spmm_route",
    "SPMM_GATHER_REL",
    "SPMM_TILED_OVERHEAD",
    "SPMM_ELL_CROSSOVER",
]


def margin_terms(
    cocluster_rows: float,
    cocluster_cols: float,
    n_rows: int,
    n_cols: int,
    phi: int,
    psi: int,
    t_m: int,
    t_n: int,
) -> tuple[float, float]:
    """``(s, t)`` margins of Eq. (16).

    ``s`` (resp. ``t``) is the gap between the co-cluster's row (col) density
    and the fraction of a block the atom method needs to see. Non-positive
    margins mean Theorem 1 gives a vacuous bound (block too small for the
    co-cluster to be reliably caught).
    """
    s = cocluster_rows / n_rows - (t_m - 1) / phi
    t = cocluster_cols / n_cols - (t_n - 1) / psi
    return s, t


def failure_exponent(
    s: float, t: float, phi: int, psi: int, m: int, n: int
) -> float:
    """Exponent ``2[phi m s^2 + psi n t^2]`` of Theorem 1 (clamped at 0)."""
    if s <= 0.0 or t <= 0.0:
        return 0.0
    return 2.0 * (phi * m * s * s + psi * n * t * t)


def failure_bound(
    cocluster_rows: float,
    cocluster_cols: float,
    n_rows: int,
    n_cols: int,
    m: int,
    n: int,
    t_m: int,
    t_n: int,
) -> float:
    """Upper bound on ``P(omega_k)`` — one resample failing to expose C_k.

    Uses uniform blocks ``phi = M/m``, ``psi = N/n`` (paper's final form).
    """
    phi = max(1, n_rows // m)
    psi = max(1, n_cols // n)
    s, t = margin_terms(cocluster_rows, cocluster_cols, n_rows, n_cols, phi, psi, t_m, t_n)
    return math.exp(-failure_exponent(s, t, phi, psi, m, n))


def detection_probability(
    t_p: int,
    cocluster_rows: float,
    cocluster_cols: float,
    n_rows: int,
    n_cols: int,
    m: int,
    n: int,
    t_m: int,
    t_n: int,
) -> float:
    """Lower bound on detection probability after ``T_p`` resamples (Eq. 3)."""
    fail = failure_bound(cocluster_rows, cocluster_cols, n_rows, n_cols, m, n, t_m, t_n)
    return 1.0 - fail**t_p


def min_resamples(
    p_thresh: float,
    cocluster_rows: float,
    cocluster_cols: float,
    n_rows: int,
    n_cols: int,
    m: int,
    n: int,
    t_m: int,
    t_n: int,
    max_resamples: int = 4096,
) -> int:
    """Closed-form solution of Eq. (4):

    ``T_p = ceil( ln(1 - P_thresh) / ln(P(omega_k)) )``

    Returns ``max_resamples`` when the Theorem-1 bound is vacuous (margin
    <= 0) — the caller should then grow the block sizes instead.
    """
    if not 0.0 < p_thresh < 1.0:
        raise ValueError(f"p_thresh must be in (0,1), got {p_thresh}")
    fail = failure_bound(cocluster_rows, cocluster_cols, n_rows, n_cols, m, n, t_m, t_n)
    if fail >= 1.0:  # vacuous bound
        return max_resamples
    if fail <= 0.0:
        return 1
    t_p = math.ceil(math.log(1.0 - p_thresh) / math.log(fail))
    return int(min(max(t_p, 1), max_resamples))


def resamples_for_failures(
    base_t_p: int,
    n_blocks: int,
    expected_failed_blocks: int,
) -> int:
    """Fault-tolerance margin: bump ``T_p`` so that losing
    ``expected_failed_blocks`` of ``n_blocks`` per resample keeps the same
    detection exponent.

    Losing a fraction ``f`` of blocks scales the Theorem-1 exponent by
    ``(1 - f)`` (fewer independent block trials), so the exponent is restored
    by ``T_p' = T_p / (1 - f)``. This is the paper's over-sampling knob
    repurposed as a resilience budget (DESIGN.md §3).
    """
    if expected_failed_blocks <= 0:
        return base_t_p
    f = min(expected_failed_blocks / max(n_blocks, 1), 0.9)
    return int(math.ceil(base_t_p / (1.0 - f)))


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One evaluated (m, n, T_p) configuration with its cost estimate."""

    m: int
    n: int
    phi: int
    psi: int
    t_p: int
    detection_p: float
    est_cost: float  # arbitrary units: block-work x blocks / workers
    # SpMM backend the cost model priced this candidate's blocks with
    # ("dense" | "dual_ell" | "tiled") — surfaced so callers/tests can
    # assert the density-adaptive dispatch decision.
    spmm_route: str = "dense"


# --------------------------------------------------------------------------
# SpMM backend cost model (DESIGN.md §9 routing policy)
#
# Calibrated against BENCH_sparse.json micro-benches (4096x2048, r=9, CPU):
# a dual-ELL gather product costs ~16 ns per stored nonzero while a tiled /
# dense tile-GEMM product costs ~1 ns per (occupied-tile) cell — per-element
# gathers pay the scatter/gather unit, batched tile contractions pay the
# BLAS/MXU unit. The ratio is the calibration constant below; the measured
# atom-phase crossover (dual-ELL wins at d = 0.05, loses by d = 0.2)
# brackets the derived parity point SPMM_ELL_CROSSOVER ~= 0.072.
# --------------------------------------------------------------------------

#: Relative cost of one gathered nonzero vs one contiguously-contracted
#: tile cell (measured: dual-ELL products ~16 ns/nnz vs tile GEMMs ~1
#: ns/cell on the bench machine; TPU scatter units are no cheaper).
SPMM_GATHER_REL = 16.0

#: Tile-format overhead vs one ideal dense cell at full occupancy (the
#: tile segment-sum + payload indirection).
SPMM_TILED_OVERHEAD = 0.15

#: Dense-operand overhead per cell for the *two-sided* subspace
#: iteration: the ``A.T @ Q`` products materialize a transposed copy of
#: the operand, which the tiled format's per-tile transpose contraction
#: avoids (measured atom ratio dense/tiled ~1.3 at d = 0.2).
SPMM_DENSE_REL = 1.3

#: Density above which the dual-ELL gather path loses to tile GEMMs —
#: derived from the cost-parity condition of the two models
#: (SPMM_GATHER_REL * d = 1 + SPMM_TILED_OVERHEAD at full occupancy,
#: ~= 0.072), so retuning either constant moves the published crossover
#: with the actual ``spmm_route`` decision. Sits inside the measured
#: (0.05, 0.2) win/loss bracket from BENCH_sparse.json.
SPMM_ELL_CROSSOVER = (1.0 + SPMM_TILED_OVERHEAD) / SPMM_GATHER_REL

#: Below this cell count a block is too small for any sparse format to
#: pay back its prep; route dense.
_SPMM_MIN_SPARSE_CELLS = 64 * 64


def _tile_occupancy(density: float, tile_cells: int) -> float:
    """Expected fraction of tiles holding >= 1 nonzero (uniform sparsity)."""
    d = max(min(density, 1.0), 0.0)
    return 1.0 - (1.0 - d) ** tile_cells


def spmm_costs(density: float, cells: float,
               tile_cells: int = 128 * 128) -> dict:
    """Per-product cost of each SpMM backend, in dense-cell units.

    ``cells`` is the block area ``phi * psi``; one unit is one cell of a
    dense matmul pass. Host-side plain float math like the rest of the
    plan model.
    """
    d = max(min(density, 1.0), 0.0)
    occ = _tile_occupancy(d, tile_cells)
    return {
        "dual_ell": SPMM_GATHER_REL * d * cells,
        "tiled": (1.0 + SPMM_TILED_OVERHEAD) * occ * cells,
        "dense": SPMM_DENSE_REL * cells,
    }


def resolve_spmm_route(spmm_impl: str, density: float, cells: float, *,
                       single: bool = True,
                       svd_method: str = "randomized") -> str:
    """The one routing decision tree — used by the plan search for both
    pricing and surfacing, and by the drivers for execution, so the three
    can never drift.

    ``single``: whether the candidate can actually run the sparse
    operator (a single SCC block covering the whole matrix); everything
    else densifies its blocks and is ``dense`` whatever the knob says,
    as are exact-SVD atoms and (near-)dense inputs.
    """
    if not single or svd_method == "exact" or density >= 1.0:
        return "dense"
    if spmm_impl == "auto":
        return spmm_route(density, cells)
    return spmm_impl


def spmm_route(density: float, cells: float = 4096 * 2048,
               tile_cells: int = 128 * 128) -> str:
    """Density-adaptive SpMM backend: ``dual_ell`` | ``tiled`` | ``dense``.

    Picks the cheapest backend under ``spmm_costs``; sub-``64x64`` blocks
    and (near-)dense matrices route ``dense`` outright — no sparse format
    pays back its host prep there. This is the ``spmm_impl="auto"``
    resolution rule used by ``lamc_cocluster`` and surfaced on
    ``PartitionPlan.spmm_route``, and it removes the measured d = 0.2
    regression by construction: past the dual-ELL crossover the route is
    a tile/dense contraction, never a per-nonzero gather.
    """
    if cells < _SPMM_MIN_SPARSE_CELLS or density >= 0.9:
        return "dense"
    costs = spmm_costs(density, cells, tile_cells)
    return min(costs, key=costs.get)


def _atom_cost(phi: int, psi: int, rank: int, svd_iters: int, kmeans_iters: int,
               k: int, svd_method: str = "randomized",
               density: float = 1.0, spmm_impl: str = "auto") -> float:
    """Napkin cost of spectral co-clustering one ``phi x psi`` block.

    ``randomized``: ``svd_iters`` passes of ``A @ Omega``-style matmuls
    (2*phi*psi*rank each) + k-means over phi+psi points in rank dims —
    linear in the block area, so partitioning pays off only via workers.
    ``exact``: LAPACK-style O(phi*psi*min(phi,psi)) — superlinear, so
    partitioning wins even serially (the paper's dense-matrix regime).

    ``density < 1`` prices the sparse path through the calibrated SpMM
    backend model (``spmm_costs``): ``spmm_impl`` fixes the backend, or
    ``"auto"`` takes the cheapest (= ``spmm_route``'s pick). Gather
    backends scale with nnz, tile backends with occupied tiles — this
    keeps the paper's dense-vs-sparse speedup asymmetry (~83% vs ~30%):
    on sparse data the atom phase is already nnz-/occupancy-bound, so
    partitioning has less superlinear cost to shave and the planner
    correctly expects a smaller win. ``exact`` ignores density — LAPACK
    SVD cannot exploit sparsity.
    """
    if svd_method == "exact":
        svd = float(phi) * psi * min(phi, psi)
    else:
        cells = float(phi) * psi
        d = max(min(density, 1.0), 1e-6)
        # "auto" prices the backend spmm_route actually picks — including
        # its small-block / near-dense guards — so est_cost and the
        # surfaced route always describe the same backend.
        impl = spmm_route(d, cells) if spmm_impl == "auto" else spmm_impl
        unit = spmm_costs(d, cells)[impl]
        svd = 4.0 * svd_iters * unit * rank
    km = 2.0 * kmeans_iters * (phi + psi) * rank * k
    return svd + km


def plan_partition(
    n_rows: int,
    n_cols: int,
    *,
    min_cocluster_rows: int,
    min_cocluster_cols: int,
    t_m: int = 2,
    t_n: int = 2,
    p_thresh: float = 0.95,
    workers: int = 1,
    rank: int = 8,
    svd_iters: int = 4,
    kmeans_iters: int = 16,
    k: int = 8,
    grid_candidates: Sequence[int] = (1, 2, 4, 8, 16, 32),
    max_resamples: int = 4096,
    expected_failed_blocks: int = 0,
    svd_method: str = "randomized",
    density: float = 1.0,
    spmm_impl: str = "auto",
    min_phi: int | None = None,
    min_psi: int | None = None,
) -> PlanCandidate:
    """Pick the (m, n, T_p) minimizing estimated wall-cost subject to
    ``P_detect >= p_thresh`` (paper §IV-B.2, Eq. 4).

    ``min_cocluster_{rows,cols}`` is the smallest co-cluster the caller
    still wants to detect — the adversarial ``C_k`` of Theorem 1.
    ``workers`` is the number of parallel processing units (devices); cost
    is total block work divided by workers, in waves of ``m*n`` blocks.
    ``density`` is the input's nnz fraction (1.0 = dense); it rescales the
    SVD term of the atom cost so sparse inputs are planned against their
    SpMM cost (see ``_atom_cost``). ``spmm_impl`` fixes the SpMM backend
    the blocks are priced with (``"auto"`` = cheapest per the calibrated
    model); the per-block route is surfaced on the returned candidate.

    Besides the Theorem-1 feasibility check, candidates must satisfy atom
    *resolvability*: a block needs at least ``min_phi x min_psi`` entries
    (default ``8k x 8k``) to host ``k`` separable clusters — degenerate
    sliver blocks pass the detection bound but starve the atom method of
    context, so they are pruned here.
    """
    if min_phi is None:
        min_phi = max(32, 8 * k)
    if min_psi is None:
        min_psi = max(32, 8 * k)
    best: PlanCandidate | None = None
    for m in grid_candidates:
        if m > n_rows:
            continue
        for n in grid_candidates:
            if n > n_cols:
                continue
            phi = max(1, n_rows // m)
            psi = max(1, n_cols // n)
            if (m, n) != (1, 1) and (phi < min_phi or psi < min_psi):
                continue
            # aspect cap: sliver blocks (m >> n or n >> m) minimize the
            # exact-SVD cost model but starve the atom method; bound the
            # grid anisotropy to 4x.
            if max(m, n) > 4 * min(m, n) and (m, n) != (1, 1):
                continue
            t_p = min_resamples(
                p_thresh,
                min_cocluster_rows,
                min_cocluster_cols,
                n_rows,
                n_cols,
                m,
                n,
                t_m,
                t_n,
                max_resamples=max_resamples,
            )
            t_p = resamples_for_failures(t_p, m * n, expected_failed_blocks)
            p = detection_probability(
                t_p, min_cocluster_rows, min_cocluster_cols,
                n_rows, n_cols, m, n, t_m, t_n,
            )
            if p < p_thresh and (m, n) != (1, 1):
                continue  # infeasible under the bound; (1,1) always "detects"
            blocks = m * n * t_p
            waves = math.ceil(blocks / max(workers, 1))
            # Only a single-block candidate can execute the sparse-operator
            # route (the driver enables it when blocks_per_resample == 1);
            # multi-block candidates densify their phi x psi blocks. One
            # resolver produces the route, and the cost is priced with
            # that same route, so est_cost and spmm_route always describe
            # the same backend.
            route = resolve_spmm_route(
                spmm_impl, density, float(phi) * psi,
                single=(m, n) == (1, 1), svd_method=svd_method)
            cost = waves * _atom_cost(phi, psi, rank, svd_iters, kmeans_iters, k,
                                      svd_method=svd_method, density=density,
                                      spmm_impl=route)
            cand = PlanCandidate(m=m, n=n, phi=phi, psi=psi, t_p=t_p,
                                 detection_p=p, est_cost=cost,
                                 spmm_route=route)
            if best is None or cand.est_cost < best.est_cost:
                best = cand
    assert best is not None, "grid_candidates produced no feasible plan"
    return best
