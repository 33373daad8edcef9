"""Tiled block-sparse format, its conversion, and the CUDA SpMM wrappers.

The sparse atom's products are ``A @ X`` / ``A.T @ Y`` with ``A`` sparse and
the other operand a tall-skinny dense sketch. The kernels take a tile-level
format: ``A`` is cut into a ``(M/bm, K/bk)`` grid and only tiles holding
nonzeros keep a dense payload:

  * ``blocks``     (G, bm, bk) f32 — payload of each surviving tile
  * ``block_rows`` (G,) i32        — tile-row of each payload, sorted
  * ``block_cols`` (G,) i32        — tile-col of each payload
  * ``t_order``    (G,) i32        — payload visit order for transposed
                                     products (sorted by tile-col, stable)
  * ``row_scale``  (n_tr, bm) f32  — optional pending diagonal scales,
    ``col_scale``  (n_tc, bk) f32    applied to each tile inside the kernel

Conversion splits into a pattern half (:func:`block_sparse_plan`: occupancy
bitmap, prefix scan, flat scatter offsets, all torch ops on the tensor's
device with 64-bit offsets) and a values half (:func:`block_sparse_apply`:
one flat scatter), so the pattern cache (``core.opcache``) can refresh
values only. :func:`bcoo_to_block_sparse_host` is the numpy oracle both are
held against. Every tile-row and tile-col holds at least one payload (a
zero "seed" tile where the matrix has none), so both product orientations
write every output row.

Three CUDA kernels (``csrc/spmm.cu``) replace the TPU kernels of
``src/repro/kernels/spmm.py``: :func:`spmm` (``spmm_pallas``, line 413),
:func:`spmm_t` (``spmm_t_pallas``, line 483) and :func:`spmm_ata`
(``spmm_ata_pallas``, line 585). Each takes the RHS width at run time (no
padding to 128 columns) and sums in a fixed order with no atomics on data,
so the result is the same from run to run. :func:`spmm` and :func:`spmm_t`
give every output tile-row (or tile-col) a fixed set of CTAs that walk its
payload segment and add split partial sums in chunk order. :func:`spmm_ata`
is one persistent grid that makes a single pass over the payloads: it walks
bands of rows and reduces each band's ``Y = A X`` across the grid
(:func:`ata_plan`). The
plain versions are in ``ref.py``; ``ops.py`` dispatches by the tensor's
device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["BlockSparseMatrix", "BlockSparsePlan", "bcoo_to_block_sparse_host",
           "block_sparse_plan", "block_sparse_apply", "bcoo_to_block_sparse",
           "spmm", "spmm_t", "spmm_ata", "segment_split", "MAX_TILE",
           "TARGET_CTAS", "AtaPlan", "ata_grid", "ata_plan", "ata_schedule"]

#: Largest tile edge the CUDA kernels take (16 warps x 8 rows; 32 lanes x 4 cols).
MAX_TILE = 128
#: CTAs a launch aims for: 4 per SM of an H100. A segment (tile-row or
#: tile-col) is split into enough chunks to reach it; the chunk partials are
#: added in chunk order by a second kernel.
TARGET_CTAS = 4 * 132

# spmm_ata's persistent kernel (csrc/spmm.cu: kRingBytes, kMaxSlots,
# kMaxTSlots, kMaxPieces, kMaxCap, kBandRows, kSlots, kRbufFloats, kLag): the
# shared memory of its ring of payload slices, its F and T band slots and
# pieces, the rows of a band, the device-memory slots of the band partials and
# Y, the floats of R's share of a band's partials, and the bands between a
# band's partial A X and its reduction (and again to its A.T Y).
ATA_RING_BYTES = 192 * 1024
ATA_MAX_SLOTS, ATA_MAX_T_SLOTS, ATA_MAX_PIECES, ATA_MAX_CAP = 8, 2, 32, 8
ATA_BAND_ROWS = 128
ATA_SLOTS = 8
ATA_RBUF_FLOATS = 4 * 320
ATA_LAG = 2

#: Launches of each kernel since the counters were last set to 0.
launches = {"spmm": 0, "spmm_t": 0, "spmm_ata": 0}


@dataclasses.dataclass
class BlockSparseMatrix:
    """Tile-level sparse operand of the SpMM kernels.

    ``row_scale``/``col_scale`` (attached together) carry a pending scaling
    ``diag(rs) @ A @ diag(cs)`` as ``(n_tr, bm)`` / ``(n_tc, bk)`` grids; the
    CUDA kernels apply them to each payload tile as it is read, and
    :meth:`materialize_scales` folds them into ``blocks`` in the same
    multiply order, so the two forms are bit-identical under every product.
    """

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    t_order: torch.Tensor
    shape: tuple
    row_scale: torch.Tensor | None = None
    col_scale: torch.Tensor | None = None
    # (row_ptr (n_tr + 1,), col_ptr (n_tc + 1,)) int32 segment starts, made at
    # first use and shared by scaled copies
    _segments: tuple | None = dataclasses.field(default=None, repr=False)
    # spmm_ata's schedules by (grid, band group): they depend on the pattern
    # only, so scaled copies and every operator of one BlockSparsePlan share
    # them
    _ata_schedules: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)

    @property
    def tile_shape(self) -> tuple[int, int]:
        return int(self.blocks.shape[1]), int(self.blocks.shape[2])

    @property
    def n_tiles(self) -> tuple[int, int]:
        """Tile-grid shape ``(ceil(M / bm), ceil(K / bk))``."""
        bm, bk = self.tile_shape
        return -(-self.shape[0] // bm), -(-self.shape[1] // bk)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def has_scales(self) -> bool:
        return self.row_scale is not None

    def segments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(row_ptr, col_ptr)``: payloads ``row_ptr[i]:row_ptr[i+1]`` are
        tile-row ``i``; ``t_order[col_ptr[j]:col_ptr[j+1]]`` tile-col ``j``."""
        if self._segments is None:
            n_tr, n_tc = self.n_tiles
            rows = self.block_rows
            cols = self.block_cols[self.t_order.long()]
            if bool((rows[1:] < rows[:-1]).any()) or bool((cols[1:] < cols[:-1]).any()):
                raise ValueError("block_rows must be sorted and t_order must visit "
                                 "the payloads in tile-col order")

            def ptr(ids, n):
                counts = torch.bincount(ids.long(), minlength=n)
                out = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
                out[1:] = torch.cumsum(counts, 0)
                return out.to(torch.int32)

            self._segments = (ptr(self.block_rows, n_tr), ptr(self.block_cols, n_tc))
        return self._segments

    def with_scales(self, row_scale, col_scale) -> BlockSparseMatrix:
        """The same payloads with pending scales ``row_scale``/``col_scale``."""
        return dataclasses.replace(self, row_scale=row_scale, col_scale=col_scale)

    def materialize_scales(self) -> BlockSparseMatrix:
        """Fold pending scales into a new payload stack,
        ``blk * rs[:, :, None] * cs[:, None, :]`` (row scale first, as the
        kernels apply it)."""
        if self.row_scale is None:
            return self
        rs = self.row_scale[self.block_rows.long()]            # (G, bm)
        cs = self.col_scale[self.block_cols.long()]            # (G, bk)
        return dataclasses.replace(
            self, blocks=self.blocks * rs[:, :, None] * cs[:, None, :],
            row_scale=None, col_scale=None)

    def to(self, device) -> BlockSparseMatrix:
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, blocks=move(self.blocks), block_rows=move(self.block_rows),
            block_cols=move(self.block_cols), t_order=move(self.t_order),
            row_scale=move(self.row_scale), col_scale=move(self.col_scale),
            _segments=None if self._segments is None
            else tuple(move(t) for t in self._segments), _ata_schedules={})


class BlockSparsePlan(NamedTuple):
    """Pattern half of a COO -> block-sparse conversion: the surviving-tile
    list, the transposed visit order and each nonzero's int64 flat offset
    into the ``(G * bm * bk,)`` payload stack."""

    block_rows: torch.Tensor    # (G,) i32, sorted
    block_cols: torch.Tensor    # (G,) i32
    t_order: torch.Tensor       # (G,) i32
    flat_idx: torch.Tensor      # (nnz,) i64
    g: int
    bm: int
    bk: int
    shape: tuple
    ata_schedules: dict         # spmm_ata's, shared by the operators it makes


def bcoo_to_block_sparse_host(a, bm: int = 128, bk: int = 128) -> BlockSparseMatrix:
    """Numpy conversion of a coalesced COO tensor — the oracle.

    ``union1d`` over the nonzeros' tile ids and zero seed tiles for every
    tile-row (tile-col 0) and tile-col (tile-row 0), then a fancy scatter.
    Returns CPU tensors.
    """
    m, k = a.shape
    idx = a.indices().cpu().numpy().astype(np.int64)
    rows, cols = idx[0], idx[1]
    vals = a.values().cpu().numpy().astype(np.float32)
    n_tr, n_tc = -(-m // bm), -(-k // bk)
    tile_of_nnz = (rows // bm) * n_tc + cols // bk
    seeds = np.concatenate([np.arange(n_tr, dtype=np.int64) * n_tc,
                            np.arange(n_tc, dtype=np.int64)])
    tile_ids = np.union1d(tile_of_nnz, seeds)
    g_of = np.searchsorted(tile_ids, tile_of_nnz)
    blocks = np.zeros((len(tile_ids), bm, bk), np.float32)
    blocks[g_of, rows % bm, cols % bk] = vals
    tile_rows = tile_ids // n_tc
    tile_cols = tile_ids % n_tc
    t_order = np.lexsort((tile_rows, tile_cols))      # tile-col-major order
    as_i32 = lambda v: torch.from_numpy(v.astype(np.int32))
    return BlockSparseMatrix(torch.from_numpy(blocks), as_i32(tile_rows),
                             as_i32(tile_cols), as_i32(t_order), (m, k))


def block_sparse_plan(a, bm: int = 128, bk: int = 128) -> BlockSparsePlan:
    """Pattern half of the conversion, on ``a``'s device.

    An occupancy bitmap over the tile grid (seeded in every tile-row and
    tile-col), its prefix scan as the tile id -> payload slot table, and
    every nonzero's int64 flat offset. The surviving-tile count ``G`` is the
    one value read back to the host.
    """
    m, k = a.shape
    n_tr, n_tc = -(-m // bm), -(-k // bk)
    idx = a.indices()
    rows, cols = idx[0], idx[1]
    dev = idx.device
    tile_of = torch.div(rows, bm, rounding_mode="floor") * n_tc \
        + torch.div(cols, bk, rounding_mode="floor")
    occ = torch.zeros(n_tr * n_tc, dtype=torch.bool, device=dev)
    occ[tile_of] = True
    occ[torch.arange(n_tr, device=dev) * n_tc] = True     # tile-row seeds
    occ[:n_tc] = True                                     # tile-col seeds
    lut = torch.cumsum(occ, 0, dtype=torch.int64) - 1     # tile id -> slot
    g = int(lut[-1]) + 1                                  # the one host sync
    flat_idx = lut[tile_of] * (bm * bk) + (rows % bm) * bk + cols % bk
    del tile_of
    tile_ids = torch.nonzero(occ).reshape(-1)
    tile_rows = torch.div(tile_ids, n_tc, rounding_mode="floor")
    tile_cols = tile_ids % n_tc
    # tile ids are row-major sorted, so a stable sort by tile-col alone is
    # lexsort((tile_rows, tile_cols))
    t_order = torch.sort(tile_cols, stable=True).indices
    return BlockSparsePlan(tile_rows.to(torch.int32), tile_cols.to(torch.int32),
                           t_order.to(torch.int32), flat_idx, g, bm, bk, (m, k), {})


def block_sparse_apply(plan: BlockSparsePlan, values: torch.Tensor) -> BlockSparseMatrix:
    """Values half: scatter ``values`` through a plan into a new stack. On
    the card it also makes ``spmm_ata``'s schedule for the pattern (for the
    band group of 8-column stripes), once per plan: in the conversion rather
    than in the first product, and not again for a refit of a cached
    pattern (PERF.md, section 6, has what it costs in each place)."""
    flat = torch.zeros(plan.g * plan.bm * plan.bk, dtype=torch.float32,
                       device=plan.flat_idx.device)
    flat[plan.flat_idx] = values.to(torch.float32)
    out = BlockSparseMatrix(flat.reshape(plan.g, plan.bm, plan.bk),
                            plan.block_rows, plan.block_cols, plan.t_order,
                            plan.shape, _ata_schedules=plan.ata_schedules)
    if out.device.type == "cuda":
        grid = ata_grid(out)
        ata_schedule(out, grid, ata_plan(out, grid, 8).grp)
    return out


def bcoo_to_block_sparse(a, bm: int = 128, bk: int = 128) -> BlockSparseMatrix:
    """Tile a coalesced COO tensor, keeping the tiles that hold nonzeros.
    ``core.sparse.to_tiled`` adds the pattern cache on top of this."""
    return block_sparse_apply(block_sparse_plan(a, bm, bk), a.values())


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def segment_split(n_segments: int, stripes: int) -> int:
    """Chunks per segment so that a launch has about ``TARGET_CTAS`` CTAs."""
    return max(1, -(-TARGET_CTAS // max(n_segments * stripes, 1)))


def _stripes(r: int) -> int:
    return -(-r // 8)


def _check(a: BlockSparseMatrix, rhs: torch.Tensor, rows: int, what: str) -> None:
    """Raise unless the operands are what the CUDA SpMM kernels take."""
    bm, bk = a.tile_shape
    if not (1 <= bm <= MAX_TILE and 4 <= bk <= MAX_TILE and bk % 4 == 0):
        raise ValueError(f"{what}: tiles must have 1 <= bm <= {MAX_TILE} and "
                         f"bk a multiple of 4 up to {MAX_TILE}, got {bm} x {bk}")
    if rhs.ndim != 2 or rhs.shape[0] != rows:
        raise ValueError(f"{what}: rhs must be ({rows}, r), got {tuple(rhs.shape)}")
    if rhs.shape[1] < 1:
        raise ValueError(f"{what}: rhs has no columns")
    g = a.blocks.shape[0]
    if g >= 2**31:
        raise ValueError(f"{what}: {g} payloads overflow the int32 payload ids")
    tensors = {"blocks": a.blocks, "block_rows": a.block_rows,
               "block_cols": a.block_cols, "t_order": a.t_order, "rhs": rhs,
               "row_scale": a.row_scale, "col_scale": a.col_scale}
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != rhs.device:
            raise ValueError(f"{what}: {name} must lie on the rhs's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        want = torch.int32 if name in ("block_rows", "block_cols", "t_order") \
            else torch.float32
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want}, got {t.dtype}")
    if a.blocks.data_ptr() % 16 or (a.col_scale is not None
                                    and a.col_scale.data_ptr() % 16):
        raise ValueError(f"{what}: blocks and col_scale must be 16-byte aligned")
    if a.has_scales:
        n_tr, n_tc = a.n_tiles
        if (tuple(a.row_scale.shape) != (n_tr, bm)
                or tuple(a.col_scale.shape) != (n_tc, bk)):
            raise ValueError(f"{what}: scales must be ({n_tr}, {bm}) and "
                             f"({n_tc}, {bk})")


def _raise_on_error(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.spmm_error_string(err).decode()}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_args(a: BlockSparseMatrix):
    n_tr, n_tc = a.n_tiles
    bm, bk = a.tile_shape
    return n_tr, n_tc, bm, bk, _ptr(a.row_scale), _ptr(a.col_scale)


def spmm(a: BlockSparseMatrix, b: torch.Tensor) -> torch.Tensor:
    """``A @ b`` for ``b (K, r)`` by the CUDA kernel: ``(M, r)`` float32."""
    _check(a, b, a.shape[1], "spmm")
    lib = _build.load("spmm")
    m, k = a.shape
    r = b.shape[1]
    n_tr, n_tc, bm, bk, rs, cs = _launch_args(a)
    row_ptr, _ = a.segments()
    split = segment_split(n_tr, _stripes(r))
    out = torch.empty((m, r), dtype=torch.float32, device=b.device)
    part = torch.empty((split, m, r) if split > 1 else (1,), dtype=torch.float32,
                       device=b.device)
    with torch.cuda.device(b.device):
        err = lib.spmm_f32(a.blocks.data_ptr(), a.block_cols.data_ptr(),
                           row_ptr.data_ptr(), rs, cs, n_tr, n_tc, bm, bk,
                           b.data_ptr(), k, r, out.data_ptr(), m, split,
                           part.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "spmm")
    launches["spmm"] += 1
    return out


def spmm_t(a: BlockSparseMatrix, b: torch.Tensor) -> torch.Tensor:
    """``A.T @ b`` for ``b (M, r)`` by the CUDA kernel: ``(K, r)`` float32,
    payloads visited through ``t_order`` (no transposed copy)."""
    _check(a, b, a.shape[0], "spmm_t")
    lib = _build.load("spmm")
    m, k = a.shape
    r = b.shape[1]
    n_tr, n_tc, bm, bk, rs, cs = _launch_args(a)
    _, col_ptr = a.segments()
    split = segment_split(n_tc, _stripes(r))
    out = torch.empty((k, r), dtype=torch.float32, device=b.device)
    part = torch.empty((split, k, r) if split > 1 else (1,), dtype=torch.float32,
                       device=b.device)
    with torch.cuda.device(b.device):
        err = lib.spmm_t_f32(a.blocks.data_ptr(), a.block_rows.data_ptr(),
                             a.t_order.data_ptr(), col_ptr.data_ptr(), rs, cs, n_tr,
                             n_tc, bm, bk, b.data_ptr(), m, r, out.data_ptr(), k, split,
                             part.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "spmm_t")
    launches["spmm_t"] += 1
    return out


class AtaPlan(NamedTuple):
    """Shape of one ``spmm_ata`` launch (``csrc/spmm.cu``, spmm_ata_kernel).

    A band is ``grp`` tile-rows (``grp > 1`` where ``bm <= 64``) or one of
    ``sub`` row slices of ``h`` rows of a tile-row; CTA ``c`` of ``grid`` owns
    tile-cols ``c n_tc // grid .. (c + 1) n_tc // grid - 1``. The ring holds
    ``nb`` F slots and ``tb`` T slots of ``cap`` slices each; R trails F by
    ``ATA_LAG`` bands and T by twice that."""

    grid: int
    grp: int
    sub: int
    h: int
    n_q: int        # band groups: ceil(n_tr / grp)
    n_bands: int    # n_q * sub
    nb: int         # F slots of the ring
    tb: int         # T slots of the ring
    cap: int        # pieces of a slot


def ata_schedule(a: BlockSparseMatrix, grid: int, grp: int):
    """``(sched, bptr)``: every payload once, as ``sched (G, 4)`` int32 rows
    ``(payload, tile-row, tile-col, 0)`` ordered by owning CTA, band group
    (``tile-row // grp``), tile-col and tile-row; CTA ``c``'s payloads of group
    ``q`` are ``sched[bptr[c n_q + q] : bptr[c n_q + q + 1]]``. Made on the
    device once per pattern and grid, with no host sync but the first
    :meth:`BlockSparseMatrix.segments` check, which the walks share."""
    key = (grid, grp)
    if key not in a._ata_schedules:
        a.segments()                      # validates the sort orders used here
        n_tr, n_tc = a.n_tiles
        n_q = -(-n_tr // grp)
        rows, cols = a.block_rows.long(), a.block_cols.long()
        t = a.t_order.long()              # payloads in (tile-col, tile-row) order
        owner = ((cols + 1) * grid - 1) // n_tc
        group = owner * n_q + torch.div(rows, grp, rounding_mode="floor")
        order = t[torch.sort(group[t], stable=True).indices]
        sched = torch.stack([order, rows[order], cols[order], torch.zeros_like(order)],
                            1).to(torch.int32).contiguous()
        bptr = torch.searchsorted(group[order], torch.arange(grid * n_q + 1,
                                                             device=order.device))
        a._ata_schedules[key] = (sched, bptr.to(torch.int32))
    return a._ata_schedules[key]


def ata_plan(a: BlockSparseMatrix, grid: int, rn: int) -> AtaPlan:
    """Bands and ring of ``spmm_ata`` on ``a`` for ``grid`` CTAs and stripes
    of ``rn`` columns: bands of at most ``ATA_BAND_ROWS`` rows (row slices of
    a tile-row where one CTA's share of R would not fit its buffer); ring
    slots sized to hold a band's slices for a CTA that owns the most
    tile-cols (capped by the ring, whose extra slices are read from device
    memory); as many F slots as fit, at most 8, beside one or two T slots.
    Reads only shapes: no host sync."""
    bm, bk = a.tile_shape
    n_tr, n_tc = a.n_tiles
    if bm <= ATA_BAND_ROWS // 2:
        grp, h = ATA_BAND_ROWS // bm, bm
    else:   # slices small enough for two F slots and a T slot
        grp, h = 1, bm
        while ATA_RING_BYTES // (h * bk * 4) < 3:
            h = -(-h // 2)

    def rbuf_floats(rows):   # R's share of all partials, whole 16-byte units
        units = -(-rows * rn // 4)
        return -(-units // grid) * grid * 4

    while rbuf_floats(grp * h) > ATA_RBUF_FLOATS:
        if grp > 1:
            grp //= 2
        else:
            h = -(-h // 2)
    sub = -(-bm // h)
    n_q = -(-n_tr // grp)
    most = -(-n_tc // grid) * grp      # a CTA's payloads of a band, at most
    ring = min(ATA_RING_BYTES // (h * bk * 4), ATA_MAX_PIECES)
    cap = max(1, min(most, ring // 3, ATA_MAX_CAP))
    tb = ATA_MAX_T_SLOTS if ring // cap >= 6 else 1
    nb = min(ATA_MAX_SLOTS, ring // cap - tb)
    return AtaPlan(grid, grp, sub, h, n_q, n_q * sub, nb, tb, cap)


def ata_grid(a: BlockSparseMatrix) -> int:
    """CTAs of ``spmm_ata`` on ``a``'s device: one per SM, at most one per
    tile-col (and 160)."""
    lib = _build.load("spmm")
    with torch.cuda.device(a.device):
        grid = lib.spmm_ata_grid(a.n_tiles[1])
    if grid < 1:
        raise RuntimeError("spmm_ata: cannot read the device's SM count")
    return grid


def spmm_ata(a: BlockSparseMatrix, x: torch.Tensor, with_gram: bool = False):
    """``A.T @ (A @ x)`` for ``x (K, r)`` by one persistent CUDA kernel that
    makes a single pass over the payloads: bands of rows stream through
    shared memory, and each band's ``Y = A x`` is reduced across the grid in a
    fixed order (so ``Y`` never exists whole) and applied to a second copy of
    the band's slices, taken a few bands later (meant to come from the L2;
    not measured). With ``with_gram`` each CTA forms ``Z.T @ Z`` over its
    rows and a second launch adds them in CTA order. Returns ``z`` or
    ``(z, gram)``."""
    _check(a, x, a.shape[1], "spmm_ata")
    plan = ata_plan(a, ata_grid(a), min(x.shape[1], 8))
    lib = _build.load("spmm")
    m, k = a.shape
    r = x.shape[1]
    n_tr, n_tc, bm, bk, rs, cs = _launch_args(a)
    sched, bptr = ata_schedule(a, plan.grid, plan.grp)
    dev = x.device
    es = -(-plan.grp * plan.h * min(r, 8) // 4) * 4   # whole 16-byte units
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out = empty(k, r)
    part, ybuf = empty(ATA_SLOTS, plan.grid, es), empty(ATA_SLOTS, es)
    cnt = torch.zeros(_stripes(r) * (plan.n_bands + 2 * ATA_LAG), dtype=torch.int32,
                      device=dev)
    gram = empty(r, r) if with_gram else None
    gram_part = empty(plan.grid, r, r) if with_gram else None
    with torch.cuda.device(dev):
        err = lib.spmm_ata_f32(
            a.blocks.data_ptr(), sched.data_ptr(), bptr.data_ptr(), rs, cs, n_tr, n_tc,
            bm, bk, x.data_ptr(), m, k, r, out.data_ptr(), part.data_ptr(), ybuf.data_ptr(),
            cnt.data_ptr(), _ptr(gram), _ptr(gram_part), *plan, es,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "spmm_ata")
    launches["spmm_ata"] += 1
    return (out, gram) if with_gram else out
