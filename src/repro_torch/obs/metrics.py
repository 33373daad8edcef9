"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

Everything here is **host-side only** and O(1) per update with bounded
memory — a histogram is a fixed vector of bucket counts, never a list of
samples, so a flood of adversarial requests cannot grow the process
(``launch.serve_lamc``'s percentiles rely on this). Metrics are *always
active* (unlike spans, which are gated by ``obs.configure``): they are
cheap enough to leave on, and consumers like the serving error counters
are part of the product output, not optional telemetry.

Callers pass host ints/floats, never device tensors (reading one would
synchronize the card). Updates are plain attribute writes; the registry
takes a lock only on metric *creation*. Metric names are the reference
package's, so the two packages' snapshots compare key for key.

``Registry.snapshot()`` returns a JSON-able dict; ``Registry.diff``
subtracts two snapshots (counters/histograms by delta, gauges by the
newer value) so a caller can meter one phase of a long-lived process.
``to_rows`` flattens to ``{key: number}`` rows.
"""

from __future__ import annotations

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "default_latency_buckets_us"]


def default_latency_buckets_us(lo: float = 1.0, hi: float = 1e8,
                               ratio: float = 1.25) -> tuple[float, ...]:
    """Geometric latency buckets (µs): 1µs .. 100s at 25% resolution.

    The ratio bounds the percentile estimation error: a reported p99 is
    within one bucket (≤ 25% relative) of the exact order statistic.
    """
    out = []
    b = float(lo)
    while b < hi:
        out.append(b)
        b *= ratio
    return tuple(out)


def _series_key(kv: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(kv.items()))


class Counter:
    """Monotonic counter with optional label series."""

    kind = "counter"
    __slots__ = ("name", "help", "_value", "_series")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._series: dict[str, Counter] = {}

    def inc(self, n: float = 1.0) -> "Counter":
        if n < 0:
            raise ValueError(f"counter {self.name}: inc must be >= 0, got {n}")
        self._value += n
        return self

    @property
    def value(self) -> float:
        return self._value

    def labels(self, **kv) -> "Counter":
        """Child counter for one label combination (e.g. op=..., tier=...)."""
        key = _series_key(kv)
        child = self._series.get(key)
        if child is None:
            child = self._series[key] = Counter(f"{self.name}{{{key}}}")
        return child

    def snapshot(self) -> dict:
        out = {"type": "counter", "value": self._value}
        if self._series:
            out["series"] = {k: c._value for k, c in sorted(self._series.items())}
        return out


class Gauge:
    """Last-write-wins scalar (queue depth, resident bytes, final step)."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> "Gauge":
        self._value = v
        return self

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram with interpolated percentile estimates.

    ``buckets`` are ascending upper bounds; values above the last bound
    land in an implicit overflow bucket. Memory is ``len(buckets) + 1``
    ints regardless of sample count. ``percentile`` matches
    ``np.percentile`` (linear interpolation) to within one bucket span —
    the oracle test in ``tests/test_obs.py`` pins the tolerance.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, buckets=None, help: str = ""):
        self.name = name
        self.help = help
        bs = tuple(float(b) for b in (buckets if buckets is not None
                                      else default_latency_buckets_us()))
        if list(bs) != sorted(set(bs)):
            raise ValueError(
                f"histogram {name}: buckets must be strictly ascending")
        if not bs:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v) -> "Histogram":
        self._counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        return self

    def percentile(self, p: float) -> float:
        """Estimated ``p``-th percentile (NaN when empty).

        Linear-interpolated rank (the ``np.percentile`` default), located
        in bucket space and interpolated within the bucket; clamped to
        the observed [min, max] envelope so a one-sample histogram
        reports the sample, not a bucket edge.
        """
        if self.count == 0:
            return math.nan
        rank = p / 100.0 * (self.count - 1)  # 0-indexed fractional rank
        cum = 0.0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if rank < cum + c:
                lo = self.buckets[i - 1] if i > 0 else self.min
                hi = (self.buckets[i] if i < len(self.buckets) else self.max)
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - cum + 0.5) / c  # mid-rank within the bucket
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "buckets": list(self.buckets),
            "counts": list(self._counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }


class Registry:
    """Named metric store. Get-or-create accessors enforce one type per
    name; re-registering with a different type (or histogram bucket set)
    fails loudly instead of silently splitting the series."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
                return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, buckets=None, help: str = "") -> Histogram:
        h = self._get_or_create(name, Histogram, buckets=buckets, help=help)
        if buckets is not None and tuple(float(b) for b in buckets) != h.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                "buckets")
        return h

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-able ``{name: metric.snapshot()}`` of every metric."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}


_default = Registry()


def get_registry() -> Registry:
    """The process-global default registry."""
    return _default
