"""Telemetry: spans, metrics and trace export, named as in the reference.

* ``trace``   — nestable ``span("phase")`` context managers that synchronize
  the card on fenced outputs at span exit, and structured ``event``s; off
  by default (``configure(enabled=True)`` or ``REPRO_OBS=1``).
* ``metrics`` — counters, gauges and fixed-bucket histograms in a global
  default :class:`Registry` (always on: host-side, O(1), bounded memory).
* ``export``  — per-run JSONL trace files in the reference's schema, their
  schema validator, and the flamegraph-text view (``render_trace``); the
  ``python -m repro_torch.obs trace.jsonl`` validate-and-render CLI.

:func:`kernel_dispatch` meters which tier each ``kernels.ops`` call took
(``cuda``, ``triton`` or ``ref``): a labeled counter, and an event on the
current span when spans are on.
"""

from .export import (
    read_trace_jsonl,
    render_rows,
    render_trace,
    trace_rows,
    validate_rows,
    validate_trace_jsonl,
    write_trace_jsonl,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_latency_buckets_us,
    get_registry,
    reset_metrics,
)
from .trace import (
    TRACE_SCHEMA_VERSION,
    Span,
    Trace,
    configure,
    current_trace,
    enabled,
    event,
    reset_trace,
    span,
)

__all__ = [
    "TRACE_SCHEMA_VERSION", "Span", "Trace", "span", "event", "configure",
    "enabled", "current_trace", "reset_trace",
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "reset_metrics", "default_latency_buckets_us",
    "trace_rows", "write_trace_jsonl", "read_trace_jsonl",
    "validate_trace_jsonl", "validate_rows", "render_rows", "render_trace",
    "kernel_dispatch",
]

# (registry generation, {(op, tier): labeled child}): the children are cached
# so a dispatch costs two dict lookups, not the registry's lock.
_dispatch = [-1, {}]


def kernel_dispatch(op: str, tier: str, **attrs) -> None:
    """Record one kernel-dispatch decision (which tier ran, and why).

    Increments ``kernel_dispatch{op=...,tier=...}`` in the default registry
    and, when spans are enabled, attaches a ``kernel_dispatch`` event
    (carrying ``attrs``) to the current span. All arguments are host values;
    nothing here touches the device.
    """
    reg = get_registry()
    if _dispatch[0] != reg.generation:
        _dispatch[0], _dispatch[1] = reg.generation, {}
    child = _dispatch[1].get((op, tier))
    if child is None:
        child = _dispatch[1][(op, tier)] = reg.counter(
            "kernel_dispatch", help="kernel tier decisions, by op (counted per call)",
        ).labels(op=op, tier=tier)
    child.inc()
    if enabled():
        event("kernel_dispatch", op=op, tier=tier, **attrs)
