"""Trace JSONL export, schema validation, and the text flamegraph view.

Row schema (``TRACE_SCHEMA_VERSION`` 1), one JSON object per line:

* header — ``{"type": "trace", "version": 1}`` (always the first line)
* span   — ``{"type": "span", "name", "path", "depth", "t_start_s",
  "dur_s", "attrs"}`` with ``path`` the ``/``-joined ancestry, times in
  seconds relative to the trace epoch
* event  — ``{"type": "event", "name", "path", "t_s", "attrs"}`` where
  ``path`` names the span the event fired inside (``""`` = trace-level)

The schema is the reference package's, so traces of the two packages
compare row for row and each package reads and validates the other's
files. ``render_rows`` is the flamegraph-text view of a trace's rows.
"""

from __future__ import annotations

import json

from .trace import TRACE_SCHEMA_VERSION, Trace, current_trace

__all__ = ["trace_rows", "write_trace_jsonl", "read_trace_jsonl",
           "validate_trace_jsonl", "validate_rows", "render_rows",
           "render_trace"]

_SPAN_KEYS = {"type", "name", "path", "depth", "t_start_s", "dur_s", "attrs"}
_EVENT_KEYS = {"type", "name", "path", "t_s", "attrs"}


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


def read_trace_jsonl(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_rows(rows: list[dict]) -> list[str]:
    """Schema errors in a row list (empty list = valid)."""
    errors: list[str] = []
    if not rows:
        return ["empty trace: no rows"]
    head = rows[0]
    if head.get("type") != "trace":
        errors.append(f"row 1: first row must be the trace header, "
                      f"got type={head.get('type')!r}")
    elif head.get("version") != TRACE_SCHEMA_VERSION:
        errors.append(f"row 1: unsupported schema version "
                      f"{head.get('version')!r} (expected "
                      f"{TRACE_SCHEMA_VERSION})")
    for i, row in enumerate(rows[1:], start=2):
        kind = row.get("type")
        if kind == "span":
            missing = _SPAN_KEYS - set(row)
            if missing:
                errors.append(f"row {i}: span missing {sorted(missing)}")
                continue
            if not isinstance(row["name"], str) or not row["name"]:
                errors.append(f"row {i}: span name must be a non-empty str")
            if not isinstance(row["depth"], int) or row["depth"] < 0:
                errors.append(f"row {i}: span depth must be an int >= 0")
            if not _is_num(row["dur_s"]) or row["dur_s"] < 0:
                errors.append(f"row {i}: span dur_s must be a number >= 0")
            if not _is_num(row["t_start_s"]):
                errors.append(f"row {i}: span t_start_s must be a number")
            if not isinstance(row["attrs"], dict):
                errors.append(f"row {i}: span attrs must be an object")
            if not isinstance(row["path"], str) or \
                    not row["path"].endswith(row.get("name", "")):
                errors.append(f"row {i}: span path must end with its name")
        elif kind == "event":
            missing = _EVENT_KEYS - set(row)
            if missing:
                errors.append(f"row {i}: event missing {sorted(missing)}")
                continue
            if not isinstance(row["name"], str) or not row["name"]:
                errors.append(f"row {i}: event name must be a non-empty str")
            if not _is_num(row["t_s"]):
                errors.append(f"row {i}: event t_s must be a number")
            if not isinstance(row["attrs"], dict):
                errors.append(f"row {i}: event attrs must be an object")
        elif kind == "trace":
            errors.append(f"row {i}: duplicate trace header")
        else:
            errors.append(f"row {i}: unknown row type {kind!r}")
    return errors


def validate_trace_jsonl(path: str) -> list[str]:
    """Schema errors in a JSONL file (bad JSON lines are errors too)."""
    rows = []
    errors = []
    with open(path) as f:
        for n, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError as e:
                errors.append(f"line {n}: not valid JSON ({e})")
    return errors + validate_rows(rows)


def _fmt_dur(s: float) -> str:
    if s >= 1.0:
        return f"{s:8.2f}s "
    if s >= 1e-3:
        return f"{s * 1e3:8.2f}ms"
    return f"{s * 1e6:8.1f}µs"


def _fmt_attrs(attrs: dict, limit: int = 60) -> str:
    if not attrs:
        return ""
    body = " ".join(f"{k}={v}" for k, v in attrs.items())
    return body if len(body) <= limit else body[: limit - 1] + "…"


def render_rows(rows: list[dict], bar_width: int = 24) -> str:
    """Flamegraph-text view: indented span tree with duration bars.

    Bars scale each span against its root span, so one glance shows
    where a phase's time went; events print as ``·`` lines under their
    span.
    """
    lines = []
    root_dur = 0.0
    for row in rows:
        if row.get("type") != "span":
            continue
        if row["depth"] == 0:
            root_dur = max(row["dur_s"], 1e-12)
            lines.append("")
        frac = min(row["dur_s"] / max(root_dur, 1e-12), 1.0)
        bar = "█" * max(int(round(frac * bar_width)), 1 if frac > 0 else 0)
        indent = "  " * row["depth"]
        name = f"{indent}{row['name']}"
        lines.append(f"{name:<38}{_fmt_dur(row['dur_s'])} {frac * 100:5.1f}% "
                     f"{bar:<{bar_width}} {_fmt_attrs(row['attrs'])}".rstrip())
    for row in rows:
        if row.get("type") == "event":
            where = f" in {row['path']}" if row["path"] else ""
            lines.append(f"· {row['name']} @{row['t_s']:.6f}s{where} "
                         f"{_fmt_attrs(row['attrs'], limit=80)}".rstrip())
    n_spans = sum(1 for r in rows if r.get("type") == "span")
    n_events = sum(1 for r in rows if r.get("type") == "event")
    header = (f"trace: {n_spans} span(s), {n_events} event(s) "
              f"(schema v{TRACE_SCHEMA_VERSION})")
    return "\n".join([header] + lines)


def render_trace(tr: Trace | None = None) -> str:
    """Render a live :class:`Trace` (default: the current one)."""
    return render_rows(trace_rows(tr))
