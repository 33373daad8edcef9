"""Out-of-core streaming co-clustering fit.

``fit(chunks, cfg)`` consumes the data matrix as a stream of **row chunks**
(dense tensors or arrays, or coalesced COO tensors, each ``(r, N)``) and
grows a :class:`~repro_torch.streaming.model.CoclusterModel` without ever
holding the ``M x N`` matrix: what stays resident is one chunk and
model-sized state.

Per chunk ``t``:

  1. **Atom phase.** The chunk is cut into ``col_blocks`` column blocks
     (``(r, psi)`` each) for each of ``chunk_resamples`` independent column
     permutations, and SCC runs on the ``(blocks_per_chunk, r, psi)`` stack
     at once (``spectral.scc``: the normalization, SVD and k-means batched
     over the blocks, the CUDA kernels on the card with
     ``assign_impl="pallas"``).
  2. **Signature fold.** Each block's atoms are reduced to anchor-column
     signatures (``merging.atom_signatures``) with member counts and raw
     anchor-feature sums. Those summaries and the ``(B, r)`` local labels —
     never the chunk — are copied to host numpy and kept.
  3. **Anchor-row reservoir.** A uniform reservoir sample (Algorithm R) of
     ``anchor_rows`` rows, kept with its ``(q, N)`` sliver on the host: the
     feature space in which columns are clustered and served.

``finalize()`` completes the merge as the batch pipeline does: one
best-of-restarts signature k-means over all chunks' atoms
(``merging.cluster_atoms_best``), per-row votes through each chunk's aligned
atoms, and column clustering with serving signatures in the reservoir
sliver's space.

**Resumable chunk steps.** Every draw of chunk ``t`` comes from ``(seed, t)``:
the column permutations from ``seeded_generator(device, seed, t,
resample)``, the atom stack's sketches and k-means++ seeds from
``seeded_generator(device, seed + 1, t)``, and the reservoir from
``np.random.default_rng([seed + 13, t])`` (the reference's own generator, so
the reservoir equals the reference's). The accumulator is host numpy and
checkpoints in the reference's ``FitState`` format (``state_tree`` /
``save_fit_state``, the same kind tag, metadata keys and leaf names), so a
fit interrupted by a ``SimulatedFailure`` or a killed process and resumed
from its latest checkpoint gives a model equal, leaf for leaf, to the
uninterrupted run's. That holds on one device type: the CPU's and the
card's generators draw different numbers, so a state saved on the card and
continued on the CPU is a valid fit but not the same one. To run the same
fit on both, inject the draws (``draws=``, a :class:`StreamDraws`).

Nothing on the fold or finalize path accumulates floats in a
device-scheduled order: the signature sums are one-hot products, the votes
and the serving-signature sums are host numpy.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict
from typing import Iterable, NamedTuple

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import obs
from ..core import merging as _merging
from ..core import probability as _prob
from ..core import sparse as _sparse
from ..core import spectral as _spectral
from ..core.lamc import LAMCConfig
from ..core.lamc import validate_assignment as _validate_assignment
from ..device import fp32_policy, resolve_device, seeded_generator
from ..runtime import fault_tolerance as _ft
from .model import CoclusterModel

__all__ = ["StreamConfig", "FitStats", "StreamingCocluster", "StreamDraws", "fit",
           "iter_row_chunks", "stream_config_from_lamc",
           "FIT_STATE_KIND", "save_fit_state", "load_fit_state"]

logger = logging.getLogger("repro_torch.streaming.fit")

#: extra_meta["kind"] of a FitState checkpoint: an in-progress fit, not a
#: servable CoclusterModel artifact.
FIT_STATE_KIND = "stream_fit_state"
_FIT_STATE_VERSION = 1

# Generator streams beside the per-chunk ones: seeded_generator(device,
# seed + _FIT_STREAM, n) with n = 1 for the anchor columns, 2 for the atom
# alignment, 3 for the column k-means; the reservoir's numpy generator is
# default_rng([seed + _RESERVOIR_STREAM, t]).
_FIT_STREAM = 7
_RESERVOIR_STREAM = 13


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The reference's ``StreamConfig``, field for field (a resume compares
    ``dataclasses.asdict`` of it with the checkpoint's)."""

    n_row_clusters: int
    n_col_clusters: int
    atom_row_clusters: int | None = None
    atom_col_clusters: int | None = None
    col_blocks: int = 4             # column blocks per chunk resample
    chunk_resamples: int = 1        # independent column permutations per chunk
    signature_dim: int = 64         # shared anchor columns q (row signatures)
    anchor_rows: int = 64           # row reservoir size (column features)
    seed: int = 0
    svd_iters: int = 4
    kmeans_iters: int = 16
    merge_kmeans_iters: int = 25
    merge_restarts: int = 4
    assign_impl: str = "jnp"        # "jnp" | "pallas" (the CUDA k-means kernels)
    qr_method: str = "qr"           # "qr" | "cholesky"
    # For COO chunks: a gather route ("dual_ell", or "auto" below the
    # probability.spmm_route crossover) scatters each resample's blocks
    # straight from the stored entries; any other verdict densifies the
    # chunk once. The block values are the same bits either way.
    spmm_impl: str = "auto"
    # Assignment knobs, applied at finalize() as the batch drivers do.
    assignment: str = "hard"
    overlap_threshold: float = 0.25
    min_membership: int = 0

    @property
    def atom_k(self) -> int:
        return self.atom_row_clusters or self.n_row_clusters

    @property
    def atom_d(self) -> int:
        return self.atom_col_clusters or self.n_col_clusters

    @property
    def blocks_per_chunk(self) -> int:
        return self.col_blocks * self.chunk_resamples


def stream_config_from_lamc(cfg: LAMCConfig, **overrides) -> StreamConfig:
    """Carry the shared knobs of a batch LAMCConfig into a StreamConfig."""
    base = dict(
        n_row_clusters=cfg.n_row_clusters, n_col_clusters=cfg.n_col_clusters,
        atom_row_clusters=cfg.atom_row_clusters,
        atom_col_clusters=cfg.atom_col_clusters,
        signature_dim=cfg.signature_dim, seed=cfg.seed,
        svd_iters=cfg.svd_iters, kmeans_iters=cfg.kmeans_iters,
        merge_kmeans_iters=cfg.merge_kmeans_iters,
        merge_restarts=cfg.merge_restarts, assign_impl=cfg.assign_impl,
        qr_method=cfg.qr_method, spmm_impl=cfg.spmm_impl,
        assignment=cfg.assignment, overlap_threshold=cfg.overlap_threshold,
        min_membership=cfg.min_membership,
    )
    base.update(overrides)
    return StreamConfig(**base)


class FitStats(NamedTuple):
    rows_seen: int
    n_cols: int
    chunks: int
    fit_seconds: float
    rows_per_s: float
    peak_chunk_bytes: int   # largest single chunk held resident
    state_bytes: int        # model-sized accumulator footprint at finalize


@dataclasses.dataclass(frozen=True)
class StreamDraws:
    """Every random draw of one streaming fit, replacing the seeded ones.

    Per chunk step ``t``: ``perms[t] (chunk_resamples, col_blocks * psi)``,
    each resample's column order; ``omega[t] (B, psi, r)``, each block's SVD
    sketch; ``atom_seeds[t] (B, k)``, each block's k-means++ seeds as point
    indices into its stacked embedding ``Z`` (rows, then columns), or a pair
    ``(row (T, B, k), col (T, B, d))`` when the atom's cluster counts differ.
    Once per fit: ``anchor_cols (q,)``; ``align_seeds (restarts, K_row)``,
    the atom alignment's seeds as indices into all chunks' atoms in fold
    order; ``col_seeds (restarts, K_col)``, the column k-means' seeds as
    column indices. Indices are int64 tensors, the sketch float32.
    """

    perms: torch.Tensor
    omega: torch.Tensor
    atom_seeds: torch.Tensor | tuple
    anchor_cols: torch.Tensor
    align_seeds: torch.Tensor
    col_seeds: torch.Tensor

    def atom(self, t: int, device: torch.device):
        """``(omega, seeds)`` of chunk ``t`` on ``device``."""
        seeds = self.atom_seeds
        seeds = (tuple(s[t].to(device) for s in seeds) if isinstance(seeds, tuple)
                 else seeds[t].to(device))
        return self.omega[t].to(device), seeds


def _nbytes(x) -> int:
    if _sparse.is_bcoo(x):
        vals, idx = x._values(), x._indices()
        return int(vals.numel() * vals.element_size() + idx.numel() * idx.element_size())
    if isinstance(x, torch.Tensor):
        return int(x.numel() * x.element_size())
    return int(np.asarray(x).nbytes)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _chunk_fingerprint(chunk) -> tuple[str, str]:
    """(format, value dtype name) of one chunk: what a stream must hold
    constant."""
    if _sparse.is_bcoo(chunk):
        return "bcoo", _dtype_name(chunk.dtype)
    return "dense", _dtype_name(chunk.dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class StreamingCocluster:
    """Stateful out-of-core fitter: ``partial_fit`` chunks, then ``finalize``.

    State is model-sized host numpy: per-chunk atom summaries (signatures,
    counts, anchor-feature sums, ``O(B * k * q)`` each), per-chunk local
    labels (``(B, r)`` int32), and the ``(anchor_rows, N)`` reservoir
    sliver. Chunks are never retained beyond the bounded prep cache. The
    accumulator serializes to a checkpointable tree (``state_tree``) and
    rebuilds from one (``from_state_tree``). Chunks are moved to ``device``;
    ``draws`` (a :class:`StreamDraws`) replaces the seeded draws.
    """

    def __init__(self, cfg: StreamConfig, *, draws: StreamDraws | None = None,
                 device: str | torch.device = "cuda"):
        _sparse.validate_spmm_impl(cfg.spmm_impl)
        _validate_assignment(cfg)
        self.device = resolve_device(device)
        fp32_policy()
        self.cfg = cfg
        self._draws = draws
        self._n_cols: int | None = None
        self._anchor_cols: torch.Tensor | None = None  # (q,) int64 on the device
        self._atom_sigs: list[np.ndarray] = []       # per chunk (B*k, q)
        self._atom_cnts: list[np.ndarray] = []       # per chunk (B*k,)
        self._atom_sums: list[np.ndarray] = []       # per chunk (B*k, q) raw
        self._chunk_labels: list[np.ndarray] = []    # per chunk (B, r) int32
        self._anchor_sum: np.ndarray | None = None   # (q,)
        self._res_ids: np.ndarray | None = None      # (q_res,) global row ids
        self._res_vals: np.ndarray | None = None     # (q_res, N)
        self._res_fill = 0
        self._chunk_format: str | None = None        # "dense" | "bcoo"
        self._chunk_dtype: str | None = None
        self.rows_seen = 0
        self.chunks = 0
        self._t0 = time.perf_counter()
        self._peak_chunk_bytes = 0
        # (t, id(chunk)) -> (chunk, blocks, feats): a recovery replay refolds
        # the same chunk objects the cursor kept, so its prep (move, densify
        # or gather, permute) is served from here. Session-local: a restored
        # fitter has no chunk objects.
        self._prep_cache: OrderedDict[tuple, tuple] = OrderedDict()

    # ------------------------------------------------------------------ setup

    def _init_state(self, n_cols: int) -> None:
        cfg, dev = self.cfg, self.device
        self._n_cols = n_cols
        if self._draws is not None:
            anchors = self._draws.anchor_cols
        else:
            anchors = _merging.anchor_indices(
                n_cols, cfg.signature_dim,
                seeded_generator(dev, cfg.seed + _FIT_STREAM, 1), dev)
        self._anchor_cols = anchors.to(dev, torch.int64)
        q = int(self._anchor_cols.shape[0])
        self._anchor_sum = np.zeros((q,), np.float32)
        self._res_ids = np.zeros((cfg.anchor_rows,), np.int64)
        self._res_vals = np.zeros((cfg.anchor_rows, n_cols), np.float32)

    def _chunk_route(self, chunk: torch.Tensor) -> str:
        """cfg.spmm_impl resolved for one COO chunk."""
        if self.cfg.spmm_impl != "auto":
            return self.cfg.spmm_impl
        r, n = chunk.shape
        return _prob.spmm_route(chunk._nnz() / float(max(r * n, 1)), float(r) * n)

    def _on_device(self, chunk) -> torch.Tensor:
        if _sparse.is_bcoo(chunk):
            return _sparse.operand_to(chunk, self.device)
        return torch.as_tensor(chunk, dtype=torch.float32, device=self.device)

    # --------------------------------------------------------------- validate

    def _validate_chunk(self, chunk, t: int) -> None:
        """Loud, chunk-indexed failure on a malformed mid-stream chunk: wrong
        rank or column count, value-dtype drift, a dense/COO flip."""
        if _sparse.is_bcoo(chunk):
            _sparse.validate_bcoo(chunk)
        shape = tuple(chunk.shape)
        if len(shape) != 2:
            raise ValueError(
                f"chunk {t}: must be 2-D (rows, n_cols), got shape {shape}")
        fmt, dtype = _chunk_fingerprint(chunk)
        if self._n_cols is None:
            return  # the first chunk defines the stream's fingerprint
        if int(shape[1]) != self._n_cols:
            raise ValueError(
                f"chunk {t}: chunk has {shape[1]} columns, stream started "
                f"with {self._n_cols} — expected shape "
                f"(rows, {self._n_cols}), got {shape}")
        if self._chunk_format is not None and fmt != self._chunk_format:
            raise ValueError(
                f"chunk {t}: stream started with {self._chunk_format} "
                f"chunks, got {fmt} — a dense/BCOO flip mid-stream; convert "
                "upstream (data.to_bcoo or .to_dense()) instead")
        if self._chunk_dtype is not None and dtype != self._chunk_dtype:
            raise ValueError(
                f"chunk {t}: value dtype drifted — stream started with "
                f"{self._chunk_dtype}, got {dtype}; cast the chunk before "
                "partial_fit")

    def check_replayed_chunk(self, chunk, t: int) -> None:
        """Check a chunk skipped on resume against the recorded fold: its
        shape must be the one checkpoint step ``t`` folded."""
        if t >= self.chunks:
            raise ValueError(
                f"chunk {t} replayed but only {self.chunks} chunks are in "
                "the restored state")
        want_rows = int(self._chunk_labels[t].shape[1])
        shape = tuple(chunk.shape)
        if shape != (want_rows, self._n_cols):
            raise ValueError(
                f"resumed stream does not match the checkpoint: chunk {t} "
                f"was folded with shape ({want_rows}, {self._n_cols}), the "
                f"replayed stream yields {shape} — resume requires the "
                "same chunking of the same stream")

    # -------------------------------------------------------------- reservoir

    def _reservoir_update(self, a: torch.Tensor, r: int, t: int) -> None:
        """Algorithm R over the arriving rows (uniform over the stream), one
        vectorized draw per chunk from ``default_rng([seed + 13, t])``.
        Duplicate slot hits within a chunk resolve to the last arriving row,
        as in the sequential formulation."""
        cap = self.cfg.anchor_rows
        rng = np.random.default_rng([self.cfg.seed + _RESERVOIR_STREAM, t])
        gids = self.rows_seen + np.arange(r, dtype=np.int64)
        n_fill = min(max(cap - self._res_fill, 0), r)
        fill_slots = np.arange(self._res_fill, self._res_fill + n_fill)
        j = rng.integers(0, gids[n_fill:] + 1)                  # (r - n_fill,)
        keep = j < cap
        rows = np.concatenate([np.arange(n_fill), n_fill + np.nonzero(keep)[0]])
        slots = np.concatenate([fill_slots, j[keep]])
        self._res_fill += n_fill
        if rows.size == 0:
            return
        self._res_ids[slots] = gids[rows]
        idx = torch.from_numpy(rows).to(a.device)
        vals = (_sparse.gather_rows_dense(a, idx) if _sparse.is_bcoo(a)
                else a.index_select(0, idx))
        self._res_vals[slots] = _host(vals)

    # ------------------------------------------------------------------- fold

    def _perms(self, t: int, n: int, width: int) -> torch.Tensor:
        """``(chunk_resamples, width)`` column orders of chunk ``t``."""
        cfg, dev = self.cfg, self.device
        if self._draws is not None:
            return self._draws.perms[t].to(dev, torch.int64)
        return torch.stack([
            torch.randperm(n, generator=seeded_generator(dev, cfg.seed, t, ri),
                           device=dev)[:width]
            for ri in range(cfg.chunk_resamples)])

    def _blocks_and_feats(self, chunk, a: torch.Tensor, t: int):
        """``(blocks_per_chunk, r, psi)`` block stack and ``(r, q)`` anchor
        features of chunk ``t`` (``a`` is ``chunk`` on the device).

        Each resample cuts the chunk's columns with its own permutation.
        Keyed by ``(t, chunk identity)`` in a small cache: a recovery replay
        refolds the same chunk object at the same step, so its prep is
        served from the first fold, the same bits by construction.
        """
        cfg = self.cfg
        ck = (t, id(chunk))
        hit = self._prep_cache.get(ck)
        prep = obs.get_registry().counter(
            "stream_chunk_prep", help="streaming chunk prep cache events")
        if hit is not None and hit[0] is chunk:
            prep.labels(event="hit").inc()
            return hit[1], hit[2]
        prep.labels(event="miss").inc()
        n = self._n_cols
        psi = n // cfg.col_blocks
        cb = cfg.col_blocks
        perms = self._perms(t, n, cb * psi)
        if _sparse.is_bcoo(a) and self._chunk_route(a) != "dual_ell":
            # no tiled route for chunks: any verdict but a gather densifies
            # the chunk once (each cell holds one stored value or zero)
            a = a.to_dense()
        r = a.shape[0]
        blocks = torch.empty((cfg.blocks_per_chunk, r, psi), dtype=torch.float32,
                             device=a.device)
        if _sparse.is_bcoo(a):
            # one gather per resample: gather_cols_dense needs duplicate-free
            # columns, true within one permutation
            for ri in range(cfg.chunk_resamples):
                sub = _sparse.gather_cols_dense(a, perms[ri])
                blocks[ri * cb:(ri + 1) * cb] = sub.reshape(r, cb, psi).transpose(0, 1)
            feats = _sparse.gather_cols_dense(a, self._anchor_cols)
        else:
            for i, cols in enumerate(perms.reshape(cfg.blocks_per_chunk, psi)):
                torch.index_select(a, 1, cols, out=blocks[i])
            feats = a.index_select(1, self._anchor_cols)
        self._prep_cache[ck] = (chunk, blocks, feats)
        # bounded by the cursor's replay window: older steps cannot refold
        while len(self._prep_cache) > 4:
            self._prep_cache.popitem(last=False)
        return blocks, feats

    def _chunk_atoms(self, blocks: torch.Tensor, feats: torch.Tensor, t: int):
        """Atom phase and signature reduce of chunk ``t``: per-block row
        labels (int32), centered unit atom signatures with member counts,
        and the raw per-atom anchor-feature sums (for the serving
        signatures, which are centered globally)."""
        cfg, dev = self.cfg, self.device
        omega = seeds = None
        if self._draws is not None:
            omega, seeds = self._draws.atom(t, dev)
        res = _spectral.scc(
            blocks, cfg.atom_k, cfg.atom_d, svd_iters=cfg.svd_iters,
            kmeans_iters=cfg.kmeans_iters, assign_impl=cfg.assign_impl,
            qr_method=cfg.qr_method, omega=omega, seeds=seeds,
            generator=seeded_generator(dev, cfg.seed + 1, t), device=dev)
        row_labels = res.row_labels                              # (B, r)
        b, r = row_labels.shape
        sigs, counts = _merging.atom_signatures(
            feats[None].expand(b, r, feats.shape[1]), row_labels, cfg.atom_k)
        onehot = (row_labels[..., None]
                  == torch.arange(cfg.atom_k, device=dev)).to(torch.float32)
        raw_sums = onehot.mT @ feats                             # (B, k, q)
        return row_labels.to(torch.int32), sigs, counts, raw_sums

    def partial_fit(self, chunk, *, replayed: bool = False) -> StreamingCocluster:
        """Fold one ``(r, N)`` row chunk (dense, or a coalesced COO tensor).

        ``replayed=True`` marks the chunk span as a refold after a recovery
        rolled the step counter back.
        """
        t = self.chunks
        self._validate_chunk(chunk, t)
        shape = tuple(chunk.shape)
        if self._n_cols is None:
            self._init_state(int(shape[1]))
        if self._chunk_format is None:
            # the first chunk, or a fitter rebuilt from a tree without the
            # stream's metadata: adopt this chunk's fingerprint
            self._chunk_format, self._chunk_dtype = _chunk_fingerprint(chunk)
        r = int(shape[0])
        if r == 0:
            return self  # not a step: no span either (one span per fold)
        self._peak_chunk_bytes = max(self._peak_chunk_bytes, _nbytes(chunk))

        with obs.span("chunk", t=t, rows=r, replayed=replayed):
            a = self._on_device(chunk)
            with obs.span("blocks") as bsp:
                blocks, feats = bsp.fence(self._blocks_and_feats(chunk, a, t))
            with obs.span("atoms") as asp:
                row_labels, sigs, counts, raw_sums = asp.fence(
                    self._chunk_atoms(blocks, feats, t))
            del blocks
            q = sigs.shape[-1]
            self._atom_sigs.append(_host(sigs).reshape(-1, q))
            self._atom_cnts.append(_host(counts).reshape(-1))
            self._atom_sums.append(_host(raw_sums).reshape(-1, q))
            self._chunk_labels.append(_host(row_labels))
            self._anchor_sum += _host(feats).sum(axis=0)

            with obs.span("reservoir"):
                self._reservoir_update(a, r, t)
        self.rows_seen += r
        self.chunks += 1
        return self

    # ------------------------------------------------------------- checkpoint

    def state_tree(self) -> dict:
        """The fit accumulator as a checkpointable tree of host arrays, in the
        reference's leaf names and dtypes.

        Atom summaries and local labels per chunk (keyed by zero-padded chunk
        index, so flattened names sort), the reservoir (ids, sliver, fill),
        the running anchor sum, and the integer counters packed into one
        ``scalars`` vector. No generator state: every draw is derived from
        ``(seed, chunk)``, so the counters are the provenance.
        """
        if self._n_cols is None:
            raise ValueError("no chunks folded yet — nothing to checkpoint")
        scalars = np.asarray(
            [self._n_cols, self.rows_seen, self.chunks, self._res_fill,
             self._peak_chunk_bytes], np.int64)
        return {
            "scalars": scalars,
            "anchor_cols": _host(self._anchor_cols).astype(np.int32),
            "anchor_sum": np.asarray(self._anchor_sum),
            "res_ids": np.asarray(self._res_ids),
            "res_vals": np.asarray(self._res_vals),
            "atom_sigs": {f"{i:06d}": a for i, a in enumerate(self._atom_sigs)},
            "atom_cnts": {f"{i:06d}": a for i, a in enumerate(self._atom_cnts)},
            "atom_sums": {f"{i:06d}": a for i, a in enumerate(self._atom_sums)},
            "chunk_labels": {f"{i:06d}": a
                             for i, a in enumerate(self._chunk_labels)},
        }

    @classmethod
    def from_state_tree(cls, cfg: StreamConfig, tree: dict,
                        chunk_format: str | None = None,
                        chunk_dtype: str | None = None, *,
                        draws: StreamDraws | None = None,
                        device: str | torch.device = "cuda"
                        ) -> StreamingCocluster:
        """Rebuild a fitter from a ``state_tree`` of host arrays, or of
        DTensors (``fault_tolerance.elastic_restore``), which are gathered
        whole here: the fitter's state lives on every rank."""
        from ..runtime.shardings import full_tensor

        def host(leaf):
            if isinstance(leaf, dict):
                return {k: host(v) for k, v in leaf.items()}
            leaf = full_tensor(leaf)
            return leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf

        tree = host(tree)
        self = cls(cfg, draws=draws, device=device)
        sc = np.asarray(tree["scalars"]).astype(np.int64)
        self._n_cols = int(sc[0])
        self.rows_seen = int(sc[1])
        self.chunks = int(sc[2])
        self._res_fill = int(sc[3])
        self._peak_chunk_bytes = int(sc[4])
        self._anchor_cols = torch.from_numpy(
            np.asarray(tree["anchor_cols"]).astype(np.int64)).to(self.device)
        # copies: partial_fit updates these in place
        self._anchor_sum = np.array(tree["anchor_sum"], np.float32)
        self._res_ids = np.array(tree["res_ids"], np.int64)
        self._res_vals = np.array(tree["res_vals"], np.float32)
        for field, dst in (("atom_sigs", self._atom_sigs),
                           ("atom_cnts", self._atom_cnts),
                           ("atom_sums", self._atom_sums),
                           ("chunk_labels", self._chunk_labels)):
            node = tree.get(field, {})
            for key in sorted(node):
                dst.append(np.asarray(node[key]))
            if len(dst) != self.chunks:
                raise ValueError(
                    f"fit state is inconsistent: {self.chunks} chunks "
                    f"recorded but {field} holds {len(dst)} entries — "
                    "partial or foreign checkpoint")
        if chunk_format is not None:
            self._chunk_format = chunk_format
        if chunk_dtype is not None:
            self._chunk_dtype = _dtype_name(chunk_dtype)
        return self

    # --------------------------------------------------------------- finalize

    def finalize(self) -> tuple[CoclusterModel, FitStats]:
        if self.rows_seen == 0:
            raise ValueError("no chunks were fit; stream was empty")
        cfg, dev = self.cfg, self.device
        k_row, k_col = cfg.n_row_clusters, cfg.n_col_clusters
        n = self._n_cols
        k = cfg.atom_k
        b = cfg.blocks_per_chunk
        align_seeds = col_seeds = None
        if self._draws is not None:
            align_seeds, col_seeds = self._draws.align_seeds, self._draws.col_seeds

        with obs.span("finalize", chunks=self.chunks, rows=self.rows_seen) as fin:
            # global atom alignment: the batch merge's count-weighted,
            # best-of-restarts signature k-means over all chunks' atoms
            with obs.span("align", atoms=sum(len(c) for c in self._atom_cnts)):
                flat_sigs = torch.from_numpy(np.concatenate(self._atom_sigs)).to(dev)
                flat_cnt = torch.from_numpy(np.concatenate(self._atom_cnts)).to(dev)
                atom_global = _host(_merging.cluster_atoms_best(
                    flat_sigs, flat_cnt, k_row, cfg.merge_kmeans_iters,
                    n_restarts=cfg.merge_restarts,
                    generator=seeded_generator(dev, cfg.seed + _FIT_STREAM, 2),
                    seeds=align_seeds))

            with obs.span("votes") as vsp:
                # each row's votes through its chunk's aligned atoms; counts
                # of small integers, exact in float32
                vote_rows = []
                for t, labels in enumerate(self._chunk_labels):
                    ag = atom_global[t * b * k:(t + 1) * b * k].reshape(b, k)
                    point_global = np.take_along_axis(ag, labels, axis=1)  # (B, r)
                    r = labels.shape[1]
                    cell = (np.arange(r)[None, :] * k_row + point_global).ravel()
                    vote_rows.append(np.bincount(cell, minlength=r * k_row)
                                     .reshape(r, k_row).astype(np.float32))
                row_votes = torch.from_numpy(np.concatenate(vote_rows)).to(dev)
                row_labels, _ = _merging.finalize_assignment(
                    row_votes, cfg.assignment, cfg.overlap_threshold,
                    cfg.min_membership)

                # row serving signatures: atom anchor-feature sums grouped by
                # the atoms' global cluster, centered by the global anchor mean
                row_mean = torch.from_numpy(
                    (self._anchor_sum / self.rows_seen).astype(np.float32)).to(dev)
                sums = np.concatenate(self._atom_sums)              # (A, q)
                cnts = np.concatenate(self._atom_cnts)              # (A,)
                sig_sum = np.zeros((k_row, sums.shape[1]), np.float32)
                sig_cnt = np.zeros((k_row,), np.float32)
                np.add.at(sig_sum, atom_global, sums)
                np.add.at(sig_cnt, atom_global, cnts)
                sig = (torch.from_numpy(sig_sum).to(dev)
                       / torch.from_numpy(sig_cnt).to(dev)[:, None].clamp_min(1.0)
                       - row_mean[None, :])
                row_sigs = sig / torch.linalg.vector_norm(
                    sig, dim=1, keepdim=True).clamp_min(1e-12)
                vsp.fence((row_labels, row_sigs))

            with obs.span("columns") as csp:
                # columns, clustered in the reservoir sliver's feature space
                # (the anchor-row features serving reads), centered and
                # unit-normalized, by the same best-of-restarts k-means
                fill = max(self._res_fill, 1)
                sliver = torch.from_numpy(self._res_vals[:fill]).to(dev)  # (q_res, N)
                feats_c = sliver.T
                feats_c = feats_c - torch.mean(feats_c, dim=0, keepdim=True)
                feats_c = feats_c / torch.linalg.vector_norm(
                    feats_c, dim=1, keepdim=True).clamp_min(1e-12)
                col_labels = _merging.cluster_atoms_best(
                    feats_c, torch.ones((n,), dtype=torch.float32, device=dev), k_col,
                    cfg.merge_kmeans_iters, n_restarts=cfg.merge_restarts,
                    generator=seeded_generator(dev, cfg.seed + _FIT_STREAM, 3),
                    seeds=col_seeds)
                col_votes = (col_labels[:, None]
                             == torch.arange(k_col, device=dev)).to(torch.float32)
                col_sigs, col_mean, _ = _merging.cluster_signatures(
                    sliver.T, col_labels, k_col)
                anchor_rows = torch.from_numpy(
                    self._res_ids[:fill].astype(np.int32)).to(dev)
                model = csp.fence(CoclusterModel(
                    row_labels=row_labels.to(torch.int32),
                    col_labels=col_labels.to(torch.int32),
                    row_votes=row_votes, col_votes=col_votes,
                    row_sigs=row_sigs, col_sigs=col_sigs,
                    row_mean=row_mean, col_mean=col_mean.to(torch.float32),
                    anchor_rows=anchor_rows,
                    anchor_cols=self._anchor_cols.to(torch.int32),
                ))
            fin.fence(model)
        dt = time.perf_counter() - self._t0
        state_bytes = int(
            sum(v.nbytes for vs in (self._atom_sigs, self._atom_cnts,
                                    self._atom_sums, self._chunk_labels)
                for v in vs)
            + self._res_vals.nbytes + self._anchor_sum.nbytes)
        stats = FitStats(
            rows_seen=self.rows_seen, n_cols=n, chunks=self.chunks,
            fit_seconds=dt, rows_per_s=self.rows_seen / max(dt, 1e-9),
            peak_chunk_bytes=self._peak_chunk_bytes, state_bytes=state_bytes)
        return model, stats


# ---------------------------------------------------------------------------
# FitState checkpoint round trip
# ---------------------------------------------------------------------------


def save_fit_state(ckpt_dir: str, fitter: StreamingCocluster) -> str:
    """Checkpoint an in-progress fit (atomic, hash-manifested commit). The
    step is the number of chunks folded, so ``checkpoint.latest_step`` is
    the resume point."""
    meta = {
        "kind": FIT_STATE_KIND,
        "version": _FIT_STATE_VERSION,
        "stream_config": dataclasses.asdict(fitter.cfg),
        "chunks": fitter.chunks,
        "rows_seen": fitter.rows_seen,
        "chunk_format": fitter._chunk_format,
        "chunk_dtype": fitter._chunk_dtype,
    }
    return _ckpt.save(ckpt_dir, fitter.chunks, fitter.state_tree(),
                      extra_meta=meta)


def load_fit_state(ckpt_dir: str, cfg: StreamConfig, step: int | None = None, *,
                   draws: StreamDraws | None = None,
                   device: str | torch.device = "cuda"
                   ) -> tuple[StreamingCocluster, int]:
    """Restore ``(fitter, chunks_folded)`` from a FitState checkpoint (either
    package's) onto ``device``.

    Raises ``FileNotFoundError`` when nothing is committed, ``ValueError``
    on a checkpoint of another kind and on a config that differs from the
    one the state was fit with (each differing field named), and
    ``checkpoint.CheckpointCorruptError`` naming a corrupt leaf.
    """
    if step is None:
        step = _ckpt.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(
            f"no committed fit state under {ckpt_dir!r} — nothing to resume "
            "from (the fit died before its first checkpoint, or the path is "
            "wrong); rerun without resume_from")
    tree, meta = _ckpt.restore_tree(ckpt_dir, step)
    meta = meta or {}
    if meta.get("kind") != FIT_STATE_KIND:
        raise ValueError(
            f"checkpoint at {ckpt_dir!r} step {step} is "
            f"kind={meta.get('kind')!r}, expected {FIT_STATE_KIND!r} — not "
            "an in-progress streaming fit (a finished CoclusterModel "
            "artifact loads via streaming.load_model instead)")
    saved_cfg = meta.get("stream_config") or {}
    want_cfg = dataclasses.asdict(cfg)
    diffs = sorted(k for k in want_cfg if saved_cfg.get(k) != want_cfg[k])
    if diffs:
        detail = ", ".join(
            f"{k}: checkpoint={saved_cfg.get(k)!r} vs resume={want_cfg[k]!r}"
            for k in diffs)
        raise ValueError(
            "resume config mismatch — recovery equivalence requires the "
            f"identical StreamConfig; differing fields: {detail}")
    fitter = StreamingCocluster.from_state_tree(
        cfg, tree, chunk_format=meta.get("chunk_format"),
        chunk_dtype=meta.get("chunk_dtype"), draws=draws, device=device)
    if fitter.chunks != int(meta.get("chunks", fitter.chunks)):
        raise ValueError(
            f"fit state at step {step} records {meta.get('chunks')} chunks "
            f"in its meta but {fitter.chunks} in its tree — corrupt or "
            "hand-edited checkpoint")
    return fitter, fitter.chunks


# ---------------------------------------------------------------------------
# fit driver: a plain loop, or resumable chunk steps through run_with_recovery
# ---------------------------------------------------------------------------


class _ChunkCursor:
    """Stream cursor with a bounded replay buffer.

    ``get(t)`` returns chunk ``t``: from the buffer when a recovery rolled
    the step counter back, else by advancing the iterator (strictly in
    order). The buffer keeps the last ``save_every + 2`` chunks, the window
    a restore from the latest checkpoint can need, so recovery never needs a
    rewindable stream. Raises ``StopIteration`` when the stream is done.
    """

    def __init__(self, it, start: int, keep: int):
        self._it = it
        self._next = start
        self._keep = max(keep, 1)
        self._buf: dict = {}

    def get(self, t: int):
        if t in self._buf:
            return self._buf[t]
        if t != self._next:
            raise RuntimeError(
                f"chunk {t} requested but the replay buffer holds "
                f"{sorted(self._buf)} and the stream cursor is at "
                f"{self._next} — the restore point fell behind the "
                f"{self._keep}-chunk buffer (save_every too large for the "
                "failure pattern?)")
        chunk = next(self._it)          # StopIteration: the stream is done
        while _skip_empty(chunk):
            chunk = next(self._it)      # empty chunks are not steps
        self._buf[t] = chunk
        if len(self._buf) > self._keep:
            del self._buf[min(self._buf)]
        self._next = t + 1
        return chunk


def _skip_empty(chunk) -> bool:
    return int(chunk.shape[0]) == 0 if len(chunk.shape) == 2 else False


def fit(chunks: Iterable, cfg: StreamConfig, *,
        ckpt_dir: str | None = None, save_every: int = 0,
        resume_from: str | None = None,
        failure_injector=None, max_retries: int = 8,
        draws: StreamDraws | None = None,
        device: str | torch.device = "cuda"
        ) -> tuple[CoclusterModel, FitStats]:
    """Out-of-core fit over an iterable of row chunks on ``device``.

    Rows get global ids in arrival order. Returns ``(model, stats)``.

    ``ckpt_dir`` + ``save_every``
        checkpoint the ``FitState`` every ``save_every`` chunks and at the
        stream's end (atomic, hash-manifested commits); the chunk loop runs
        through ``runtime.fault_tolerance.run_with_recovery``.
    ``resume_from``
        restore the latest committed ``FitState`` from this directory first;
        the chunks it folded are drawn off the iterable and shape-checked
        against the recorded folds. ``FileNotFoundError`` when nothing is
        committed there.
    ``failure_injector``
        a ``FailureInjector`` whose ``maybe_fail(t)`` runs after each fold;
        a ``SimulatedFailure`` restores the latest state this run saved and
        refolds the lost chunks from a bounded replay buffer. Needs
        ``ckpt_dir``.

    With the same seed, stream and device, an interrupted-and-resumed fit
    returns a model equal to the uninterrupted one, leaf for leaf.
    """
    dev = resolve_device(device)
    if save_every < 0:
        raise ValueError(f"save_every must be >= 0, got {save_every}")
    if (ckpt_dir is None) != (save_every == 0):
        raise ValueError(
            "checkpointing needs both knobs: pass ckpt_dir AND save_every "
            f">= 1 together (got ckpt_dir={ckpt_dir!r}, "
            f"save_every={save_every})")
    recovery = ckpt_dir is not None
    if failure_injector is not None and not recovery:
        raise ValueError(
            "failure_injector without ckpt_dir/save_every cannot recover — "
            "there is no checkpoint to restore from")

    def fresh() -> StreamingCocluster:
        if resume_from is not None:
            return load_fit_state(resume_from, cfg, draws=draws, device=dev)[0]
        return StreamingCocluster(cfg, draws=draws, device=dev)

    fitter = fresh()
    start = fitter.chunks
    if resume_from is not None:
        logger.info("resuming fit from %s at chunk %d (%d rows folded)",
                    resume_from, start, fitter.rows_seen)

    with obs.span("stream_fit", resumed=resume_from is not None,
                  resume_step=start, recovery=recovery) as root:
        it = iter(chunks)

        # draw the folded chunks off the stream, each checked against its
        # recorded fold, with a trivial span so the trace keeps one chunk
        # span per non-empty chunk
        skipped = 0
        while skipped < start:
            try:
                chunk = next(it)
            except StopIteration:
                raise ValueError(
                    f"resume_from state has {start} chunks folded but the "
                    f"stream ended after {skipped} — resuming needs the same "
                    "stream, re-chunked identically") from None
            if _skip_empty(chunk):
                continue
            with obs.span("chunk", t=skipped, rows=int(chunk.shape[0]),
                          replayed=True, skipped=True):
                fitter.check_replayed_chunk(chunk, skipped)
            skipped += 1

        if not recovery:
            for chunk in it:
                fitter.partial_fit(chunk)
            out = fitter.finalize()
            root.set(chunks=out[1].chunks, rows_seen=out[1].rows_seen)
            return out

        cursor = _ChunkCursor(it, start=start, keep=save_every + 2)
        hi = {"max": start}  # high-water step: steps below it are refolds

        def step_fn(t: int, f: StreamingCocluster) -> StreamingCocluster:
            f.partial_fit(cursor.get(t), replayed=t < hi["max"])
            hi["max"] = max(hi["max"], t + 1)
            if failure_injector is not None:
                # after the fold: the in-memory state is dirty, so recovery
                # must rebuild from the checkpoint
                failure_injector.maybe_fail(t)
            return f

        def restore_state(step: int) -> StreamingCocluster:
            if step < 0:
                return fresh()  # nothing committed yet: scratch or resume point
            return load_fit_state(ckpt_dir, cfg, step=step, draws=draws,
                                  device=dev)[0]

        fitter, loop_stats = _ft.run_with_recovery(
            total_steps=None, step_fn=step_fn, state=fitter,
            ckpt_dir=ckpt_dir, save_every=save_every,
            restore_state=restore_state, max_retries=max_retries,
            start_step=start,
            save_fn=lambda _step, f: save_fit_state(ckpt_dir, f))
        if loop_stats["failures"]:
            logger.info("fit recovered from %d injected failure(s); final "
                        "chunk step %d", loop_stats["failures"],
                        loop_stats["final_step"])
        out = fitter.finalize()
        root.set(chunks=out[1].chunks, rows_seen=out[1].rows_seen,
                 failures=loop_stats["failures"])
        return out


def iter_row_chunks(matrix, chunk_rows: int, format: str = "dense", *,
                    device: str | torch.device = "cuda"):
    """``(chunk_rows, N)`` row chunks of an in-memory matrix, on ``device``.

    A helper for tests and benchmarks: real out-of-core callers stream
    chunks from disk or the wire. ``matrix`` is a numpy array or a tensor;
    dense chunks of a tensor already on ``device`` are views of it.
    ``format='bcoo'`` converts each chunk (only the chunk) to a coalesced
    COO tensor. The chunking is deterministic, so the same call replays the
    same stream, which ``fit(resume_from=...)`` needs.
    """
    if format not in ("dense", "bcoo"):
        raise ValueError(f"format must be 'dense' or 'bcoo', got {format!r}")
    return _row_chunks(matrix, chunk_rows, format, resolve_device(device))


def _row_chunks(matrix, chunk_rows: int, format: str, dev: torch.device):
    from ..data.synthetic import to_bcoo

    for start in range(0, matrix.shape[0], chunk_rows):
        chunk = matrix[start: start + chunk_rows]
        if isinstance(chunk, torch.Tensor):
            chunk = chunk.to(device=dev, dtype=torch.float32)
            yield chunk.to_sparse().coalesce() if format == "bcoo" else chunk
        elif format == "bcoo":
            yield to_bcoo(np.asarray(chunk), dev)
        else:
            yield torch.as_tensor(np.asarray(chunk), dtype=torch.float32, device=dev)
