"""Streaming co-clustering: out-of-core fit, model artifact, assignment, service.

    model.py    CoclusterModel artifact + checkpoint round-trip
    fit.py      out-of-core fit over row chunks (dense or COO), resumable
    assign.py   online out-of-sample assignment (the cosine kernels)
    registry.py named, versioned model store (config hash + fingerprint
                + metrics per version)
    serve.py    multi-replica assignment service: admission queue,
                fixed-shape batch coalescing, load shedding, hot model swap

``launch/serve_lamc.py`` is the thin launcher on top. Names are the
reference package's; ``StreamDraws`` (the fit's injectable draws) is the
port's own.
"""

from .assign import (
    AssignResult,
    TopKAssignResult,
    assign_cols,
    assign_cols_topk,
    assign_rows,
    assign_rows_topk,
)
from .fit import (
    FIT_STATE_KIND,
    FitStats,
    StreamConfig,
    StreamDraws,
    StreamingCocluster,
    fit,
    iter_row_chunks,
    load_fit_state,
    save_fit_state,
    stream_config_from_lamc,
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
    "StreamConfig", "StreamingCocluster", "FitStats", "fit",
    "iter_row_chunks", "stream_config_from_lamc",
    "FIT_STATE_KIND", "save_fit_state", "load_fit_state", "StreamDraws",
    "AssignResult", "TopKAssignResult", "assign_rows", "assign_cols",
    "assign_rows_topk", "assign_cols_topk",
    "ModelRegistry", "RegistryEntry", "config_hash", "model_fingerprint",
    "AssignService", "ServeConfig", "ServeResult", "Ticket",
    "validate_request", "REJECT_REASONS",
]
