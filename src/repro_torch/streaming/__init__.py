"""Serving a fitted co-clustering: model artifact, assignment, registry, service.

    model.py    CoclusterModel artifact + checkpoint round-trip
    assign.py   online out-of-sample assignment (the cosine kernels)
    registry.py named, versioned model store (config hash + fingerprint
                + metrics per version)
    serve.py    multi-replica assignment service: admission queue,
                fixed-shape batch coalescing, load shedding, hot model swap

``launch/serve_lamc.py`` is the thin launcher on top. Names are the
reference package's. Its out-of-core fit (``fit``, ``StreamConfig``,
``StreamingCocluster``, ``iter_row_chunks``, ``save_fit_state`` /
``load_fit_state``, ``stream_config_from_lamc``) is not ported yet; a model
comes from ``lamc_cocluster`` + ``model_from_result``, or from a checkpoint
either package saved.
"""

from .assign import (
    AssignResult,
    TopKAssignResult,
    assign_cols,
    assign_cols_topk,
    assign_rows,
    assign_rows_topk,
)
from .model import (
    MODEL_KIND,
    CoclusterModel,
    ModelLoadError,
    load_model,
    model_from_result,
    model_memberships,
    save_model,
)
from .registry import (
    ModelRegistry,
    RegistryEntry,
    config_hash,
    model_fingerprint,
)
from .serve import (
    REJECT_REASONS,
    AssignService,
    ServeConfig,
    ServeResult,
    Ticket,
    validate_request,
)

__all__ = [
    "CoclusterModel", "ModelLoadError", "MODEL_KIND",
    "model_from_result", "model_memberships", "save_model", "load_model",
    "AssignResult", "TopKAssignResult", "assign_rows", "assign_cols",
    "assign_rows_topk", "assign_cols_topk",
    "ModelRegistry", "RegistryEntry", "config_hash", "model_fingerprint",
    "AssignService", "ServeConfig", "ServeResult", "Ticket",
    "validate_request", "REJECT_REASONS",
]
