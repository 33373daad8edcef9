"""Phase-level tracing spans.

``span("phase", **attrs)`` opens a nestable timing span; spans form a
per-run tree (one :class:`Trace` per thread) exportable as JSONL
(``obs.export``). Span and event names are the reference package's, so the
two packages' traces compare.

Two rules make the numbers honest and the hot paths cheap:

* **Fencing.** CUDA launches are asynchronous — a wall clock around a
  kernel call measures the *enqueue*, not the work. A span that wraps
  device work registers its outputs via ``sp.fence(out)``; span exit calls
  ``torch.cuda.synchronize`` on the device of every fenced CUDA tensor
  *before* reading the clock (where the reference calls
  ``jax.block_until_ready``), so the span's duration includes the device
  time it claims to measure. ``fence`` returns its argument unchanged;
  CPU tensors need no fence.
* **Off by default.** When disabled (the default; enable with
  ``configure(enabled=True)`` or ``REPRO_OBS=1``), ``span`` returns a
  shared no-op singleton: no allocation, no clock reads, no fencing —
  instrumented code pays one dict lookup and one no-op ``with``.

Attrs must be host scalars, and nothing here synchronizes the device
except the explicit exit fence.
"""

from __future__ import annotations

import os
import threading
import time

import torch

__all__ = ["Span", "Trace", "span", "event", "configure", "enabled",
           "current_trace", "reset_trace", "fence_count", "TRACE_SCHEMA_VERSION"]

#: bumped when the JSONL row shape changes; validators check it.
TRACE_SCHEMA_VERSION = 1

_cfg = {"enabled": os.environ.get("REPRO_OBS", "") not in ("", "0")}
_tls = threading.local()
_fences = [0]    # torch.cuda.synchronize calls made by span exits


def fence_count() -> int:
    """The ``torch.cuda.synchronize`` calls span exits have made so far (the
    analyzer's sync audit subtracts them from an ``_obs`` entry's syncs)."""
    return _fences[0]


def configure(enabled: bool | None = None) -> None:
    """Flip the global span switch (``None`` leaves it unchanged)."""
    if enabled is not None:
        _cfg["enabled"] = bool(enabled)


def enabled() -> bool:
    return _cfg["enabled"]


class Span:
    """One timed phase: name, attrs, child spans, point events."""

    __slots__ = ("name", "attrs", "children", "events", "t_start", "t_end")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.children: list[Span] = []
        self.events: list[dict] = []
        self.t_start = 0.0
        self.t_end = 0.0

    @property
    def duration_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)

    def __repr__(self) -> str:  # debugging aid only
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.2f}ms, "
                f"{len(self.children)} children)")


class Trace:
    """Per-thread span forest plus free (out-of-span) events."""

    __slots__ = ("roots", "events", "t0")

    def __init__(self):
        self.roots: list[Span] = []
        self.events: list[dict] = []
        self.t0 = time.perf_counter()

    def walk(self):
        """Depth-first ``(span, depth, path)`` over the whole forest."""
        def rec(sp: Span, depth: int, prefix: str):
            path = f"{prefix}/{sp.name}" if prefix else sp.name
            yield sp, depth, path
            for c in sp.children:
                yield from rec(c, depth + 1, path)
        for root in self.roots:
            yield from rec(root, 0, "")


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_trace() -> Trace:
    tr = getattr(_tls, "trace", None)
    if tr is None:
        tr = _tls.trace = Trace()
    return tr


def reset_trace() -> Trace:
    """Start a fresh trace for this thread (returns it)."""
    _tls.trace = Trace()
    _tls.stack = []
    return _tls.trace


def _cuda_devices(value, found: set | None = None) -> set:
    """The CUDA devices of every tensor in a nest of containers."""
    found = set() if found is None else found
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, found)
    return found


class _ActiveSpan:
    """Context manager yielded by :func:`span` when obs is enabled."""

    __slots__ = ("_span", "_fenced")

    def __init__(self, name: str, attrs: dict):
        self._span = Span(name, attrs)
        self._fenced: list | None = None

    def __enter__(self) -> "_ActiveSpan":
        stack = _stack()
        parent = stack[-1] if stack else None
        (parent.children if parent is not None
         else current_trace().roots).append(self._span)
        stack.append(self._span)
        self._span.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        if self._fenced is not None:
            for dev in _cuda_devices(self._fenced):
                torch.cuda.synchronize(dev)
                _fences[0] += 1
            self._fenced = None
        sp.t_end = time.perf_counter()
        if exc_type is not None:
            sp.attrs.setdefault("error", exc_type.__name__)
        stack = _stack()
        if stack and stack[-1] is sp:
            stack.pop()
        return False

    def fence(self, value):
        """Register device outputs to synchronize on at span exit.

        Returns ``value`` unchanged so call sites stay expression-shaped.
        """
        if self._fenced is None:
            self._fenced = [value]
        else:
            self._fenced.append(value)
        return value

    def set(self, **attrs) -> "_ActiveSpan":
        """Attach/overwrite structured attributes (host scalars only)."""
        self._span.attrs.update(attrs)
        return self

    @property
    def span(self) -> Span:
        return self._span


class _NoopSpan:
    """Disabled-mode singleton: every method is a no-op passthrough."""

    __slots__ = ()
    span = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def fence(self, value):
        return value

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a span named ``name`` (no-op singleton when obs is disabled)."""
    if not _cfg["enabled"]:
        return _NOOP
    return _ActiveSpan(name, attrs)


def event(name: str, **attrs) -> None:
    """Record a point event on the current span (or the trace root).

    Structured sibling of a log line: recovery restores, stale-checkpoint
    warnings, kernel dispatch decisions. No-op when obs is disabled —
    callers that need the signal unconditionally should also log/count.
    """
    if not _cfg["enabled"]:
        return
    tr = current_trace()
    rec = {"name": name, "t": time.perf_counter() - tr.t0, "attrs": attrs}
    stack = _stack()
    (stack[-1].events if stack else tr.events).append(rec)
