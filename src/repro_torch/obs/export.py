"""Trace JSONL export.

Row schema (``TRACE_SCHEMA_VERSION`` 1), one JSON object per line:

* header — ``{"type": "trace", "version": 1}`` (always the first line)
* span   — ``{"type": "span", "name", "path", "depth", "t_start_s",
  "dur_s", "attrs"}`` with ``path`` the ``/``-joined ancestry, times in
  seconds relative to the trace epoch
* event  — ``{"type": "event", "name", "path", "t_s", "attrs"}`` where
  ``path`` names the span the event fired inside (``""`` = trace-level)

The schema is the reference package's, so traces of the two packages
compare row for row (the reference's validator accepts the port's files).
"""

from __future__ import annotations

import json

from .trace import TRACE_SCHEMA_VERSION, Trace, current_trace

__all__ = ["trace_rows", "write_trace_jsonl"]


def trace_rows(tr: Trace | None = None) -> list[dict]:
    """Flatten a trace to schema rows (header + spans + events)."""
    tr = tr if tr is not None else current_trace()
    rows: list[dict] = [{"type": "trace", "version": TRACE_SCHEMA_VERSION}]
    for sp, depth, path in tr.walk():
        rows.append({
            "type": "span", "name": sp.name, "path": path, "depth": depth,
            "t_start_s": round(sp.t_start - tr.t0, 9),
            "dur_s": round(sp.duration_s, 9),
            "attrs": sp.attrs,
        })
        for ev in sp.events:
            rows.append({"type": "event", "name": ev["name"], "path": path,
                         "t_s": round(ev["t"], 9), "attrs": ev["attrs"]})
    for ev in tr.events:
        rows.append({"type": "event", "name": ev["name"], "path": "",
                     "t_s": round(ev["t"], 9), "attrs": ev["attrs"]})
    return rows


def write_trace_jsonl(path: str, tr: Trace | None = None) -> str:
    """Write the trace as JSONL; returns ``path``.

    Attrs are serialized with ``default=str`` so a stray non-primitive
    degrades to its repr instead of killing the export.
    """
    with open(path, "w") as f:
        for row in trace_rows(tr):
            f.write(json.dumps(row, default=str) + "\n")
    return path
