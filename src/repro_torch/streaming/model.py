"""Fitted co-cluster model artifact: everything serving needs, no data matrix.

A :class:`CoclusterModel` holds

  * consensus labels + vote tables (the batch result, for training-set
    lookups and confidence),
  * per-cluster *serving signatures* — unit-normalized cluster means over
    the globally shared anchor features (``merging.cluster_signatures``),
    plus the centering means,
  * the anchor index sets themselves (which coordinates of an incoming
    vector to read).

Every field is a tensor, so the model goes through ``checkpoint`` as it
is; the fit context (``LAMCConfig``, ``PartitionPlan``) rides along in the
checkpoint's extra metadata. Fields, their order and their dtypes are the
reference package's (int32 labels and anchors, float32 tables), so a model
saved by either package loads in the other. ``load_model`` fails loudly on
unfitted or foreign checkpoints instead of serving garbage.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import checkpoint as _ckpt
from ..core import merging as _merging
from ..core.lamc import LAMCConfig, LAMCResult
from ..core.partition import PartitionPlan
from ..device import resolve_device

__all__ = ["CoclusterModel", "model_from_result", "model_memberships",
           "save_model", "load_model", "ModelLoadError", "MODEL_KIND"]

MODEL_KIND = "cocluster_model"
_MODEL_VERSION = 1


class CoclusterModel(NamedTuple):
    """Serving artifact — tensor leaves only."""

    row_labels: torch.Tensor   # (M,) int32 consensus labels
    col_labels: torch.Tensor   # (N,) int32
    row_votes: torch.Tensor    # (M, K_row) f32 vote counts
    col_votes: torch.Tensor    # (N, K_col)
    row_sigs: torch.Tensor     # (K_row, q_row) unit-normalized cluster signatures
    col_sigs: torch.Tensor     # (K_col, q_col)
    row_mean: torch.Tensor     # (q_row,) centering mean of the anchor-col features
    col_mean: torch.Tensor     # (q_col,)
    anchor_rows: torch.Tensor  # (q_col,) int32 global row ids (features for cols)
    anchor_cols: torch.Tensor  # (q_row,) int32 global col ids (features for rows)

    @property
    def n_rows(self) -> int:
        return self.row_labels.shape[0]

    @property
    def n_cols(self) -> int:
        return self.col_labels.shape[0]

    @property
    def n_row_clusters(self) -> int:
        return self.row_sigs.shape[0]

    @property
    def n_col_clusters(self) -> int:
        return self.col_sigs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_sigs.device

    def to(self, device: torch.device) -> CoclusterModel:
        return CoclusterModel(*(t.to(device) for t in self))


#: dtype of each field, as the reference stores it.
_DTYPES = {"row_labels": torch.int32, "col_labels": torch.int32,
           "anchor_rows": torch.int32, "anchor_cols": torch.int32}


class ModelLoadError(RuntimeError):
    """A checkpoint exists but does not contain a servable fitted model."""


def model_from_result(result: LAMCResult) -> CoclusterModel:
    """Pack a fitted ``LAMCResult`` into the serving artifact.

    Requires the signature fields ``lamc_cocluster`` fills in; a result
    without them cannot assign out-of-sample points and is rejected here
    rather than at request time. Labels and anchors become int32, the
    reference's dtypes.
    """
    missing = [f for f in ("row_sigs", "col_sigs", "row_mean", "col_mean",
                           "anchor_rows", "anchor_cols")
               if getattr(result, f) is None]
    if missing:
        raise ValueError(
            f"LAMCResult is missing serving fields {missing}; re-fit with "
            "lamc_cocluster (a result without them carries labels only and "
            "cannot assign out-of-sample points)")
    return CoclusterModel(*(
        getattr(result, f).to(_DTYPES.get(f, torch.float32)).contiguous()
        for f in CoclusterModel._fields))


def model_memberships(model: CoclusterModel, overlap_threshold: float = 0.25,
                      min_membership: int = 0):
    """Overlap-mode membership matrices from the fitted vote tables:
    ``(row_membership (M, K_row) bool, col_membership (N, K_col) bool)``
    under the vote-share rule of ``merging.memberships_from_votes``, derived
    at load time with any knobs (the checkpoint schema stays fixed)."""
    return (_merging.memberships_from_votes(
                model.row_votes, overlap_threshold, min_membership),
            _merging.memberships_from_votes(
                model.col_votes, overlap_threshold, min_membership))


def save_model(ckpt_dir: str, model: CoclusterModel,
               cfg: LAMCConfig | None = None,
               plan: PartitionPlan | None = None,
               step: int = 0, extra: dict | None = None) -> str:
    """Persist the model through ``checkpoint`` (atomic commit)."""
    meta = {
        "kind": MODEL_KIND,
        "version": _MODEL_VERSION,
        "config": dataclasses.asdict(cfg) if cfg is not None else None,
        "plan": dataclasses.asdict(plan) if plan is not None else None,
    }
    if extra:
        meta.update(extra)
    return _ckpt.save(ckpt_dir, step, model, extra_meta=meta)


def _model_template(ckpt_dir: str, step: int) -> CoclusterModel:
    """The restore template, shapes and dtypes from the manifest (read
    through ``checkpoint.read_manifest``, so a missing or truncated manifest
    is a ``CheckpointCorruptError``)."""
    meta = _ckpt.read_manifest(ckpt_dir, step)
    leaves = meta["leaves"]
    # names from the checkpoint's own flattener, so they cannot drift from
    # the save side
    dummy = CoclusterModel(*([0] * len(CoclusterModel._fields)))
    names, _ = _ckpt.checkpoint._flatten_with_names(dummy)
    if sorted(leaves) != sorted(names):
        raise ModelLoadError(
            f"checkpoint at {ckpt_dir!r} step {step} has leaves "
            f"{sorted(leaves)} — not a CoclusterModel ({sorted(names)}); "
            "stale artifact from a different schema?")
    return CoclusterModel(*(
        np.zeros(tuple(leaves[name]["shape"]), dtype=np.dtype(leaves[name]["dtype"]))
        for name in names))


def load_model(ckpt_dir: str, step: int | None = None,
               device: str | torch.device = "cuda"
               ) -> tuple[CoclusterModel, dict]:
    """Restore ``(model, meta)`` from ``ckpt_dir`` onto ``device``.

    Raises :class:`ModelLoadError` when the directory holds no committed
    checkpoint (unfitted), or a checkpoint that is not a cocluster model
    (stale or foreign artifact); ``CheckpointCorruptError`` when a leaf
    fails its content hash.
    """
    dev = resolve_device(device)
    if step is None:
        step = _ckpt.latest_step(ckpt_dir)
    if step is None:
        raise ModelLoadError(
            f"no committed checkpoint under {ckpt_dir!r} — fit a model first "
            "(lamc_cocluster + model_from_result) and save_model() it")
    template = _model_template(ckpt_dir, step)
    model, meta = _ckpt.restore(ckpt_dir, step, template, device=dev)
    meta = meta or {}
    if meta.get("kind") != MODEL_KIND:
        raise ModelLoadError(
            f"checkpoint at {ckpt_dir!r} step {step} is "
            f"kind={meta.get('kind')!r}, expected {MODEL_KIND!r} — this is "
            "not a fitted co-cluster model (stale or foreign checkpoint)")
    return model, meta
