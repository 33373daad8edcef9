"""Telemetry: spans, metrics and trace export, named as in the reference.

* ``trace``   — nestable ``span("phase")`` context managers that synchronize
  the card on fenced outputs at span exit, and structured ``event``s; off
  by default (``configure(enabled=True)`` or ``REPRO_OBS=1``).
* ``metrics`` — counters, gauges and fixed-bucket histograms in a global
  default :class:`Registry` (always on: host-side, O(1), bounded memory).
* ``export``  — per-run JSONL trace files in the reference's schema.
"""

from .export import trace_rows, write_trace_jsonl
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_latency_buckets_us,
    get_registry,
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
    "default_latency_buckets_us",
    "trace_rows", "write_trace_jsonl",
]
