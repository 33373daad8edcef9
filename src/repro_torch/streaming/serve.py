"""Multi-replica assignment service with hot model swap.

The serving layer over ``streaming.assign``: callers
:meth:`AssignService.submit` variable-size request batches and get back a
:class:`Ticket`; worker replicas coalesce admitted requests into
**fixed-shape** batches of the requests' anchor features (gathered on the
host and zero-padded to ``ServeConfig.batch`` rows, so a batch moves
``(batch, q)`` floats to the device, not ``(batch, dim)``), score them
against the current :class:`_Engine` (the cosine kernels on the card), and
fulfil the tickets with host numpy results stamped with the model version
that served them.

Admission is load-shedding, not blocking: a request is rejected *at
submit* — with a machine-readable reason code counted per reason in
``obs`` (``serve_svc_rejected{reason=...}``) — when it is malformed
(rank/width/dtype/non-finite), larger than one batch (``oversize``), the
queue's bounded row budget is exhausted (``queue_full``), or the service
is closed (``shutdown``). An admitted request is never dropped: workers
drain the queue on close, and a swap never touches in-flight work.

Hot swap protocol: a new model (loaded in the background — see
:meth:`swap_async` and :class:`streaming.registry.ModelRegistry`) is
wrapped in a fresh engine, its scorers are **pre-warmed** at the service's
batch shape for every (axis, k) the old engine had served, and only then
is the engine reference swapped — one atomic assignment. Workers read the
reference once per batch, so every batch (and therefore every response)
is attributable to exactly one version; an engine is immutable after
construction, so there is no torn state to read.

Cluster-sharded tables (``ServeConfig.shard`` / ``mesh_axis``): with more
than one slice (``devices``: the visible cards by default, or any list, so
one card can hold several slices) each signature table is split by cluster
as ``runtime.shardings.serve_model_specs`` places it, every slice scores its
clusters with the cosine kernels, and the per-slice (score, global index)
results are merged in slice order, ties to the lower index: the answers
equal the unsharded engine's bit for bit (a score does not depend on how
many clusters are scored with it). A table whose cluster count does not
divide the slice count is replicated and scored whole.

Reason codes, metric names and the swap protocol are the reference
package's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import obs as _obs
from ..device import resolve_device
from ..runtime.shardings import serve_model_shardings
from .assign import AssignResult, TopKAssignResult, _assign, _assign_topk
from .model import CoclusterModel

__all__ = ["AssignService", "ServeConfig", "ServeResult", "Ticket",
           "validate_request", "REJECT_REASONS"]

#: admission reject reason codes (the ``reason`` label of
#: ``serve_svc_rejected``); ``internal_error`` is the post-admission
#: failure path (a batch that raised inside the scorer).
REJECT_REASONS = ("bad_rank", "bad_width", "bad_dtype", "non_finite",
                  "bad_k", "oversize", "queue_full", "shutdown",
                  "internal_error")

#: how often an idle worker wakes to look at the queue, seconds
_POLL_S = 0.05


def validate_request(x, dim: int) -> tuple[str, str] | None:
    """``(reason_code, detail)`` for one request batch, or None if servable.

    Checks are host-side and cheap relative to the assign kernel: rank
    and width (a wrong-width batch would fail deep in the scorer),
    non-float payloads, and non-finite values (NaN/Inf scores would
    win/lose every argmax and silently poison the labels).
    Zero-row batches are *valid* — the coalescer's flush can produce
    them and ``assign_rows``/``assign_cols`` return empty results.
    """
    shape = tuple(np.shape(x))
    if len(shape) != 2:
        return ("bad_rank",
                f"expected (batch, {dim}), got shape {shape}")
    if shape[1] != dim:
        return ("bad_width",
                f"model expects {dim} features, request has {shape[1]} "
                f"(shape {shape})")
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.issubdtype(arr.dtype, np.floating):
        return ("bad_dtype", f"expected float features, got {arr.dtype}")
    if not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        return ("non_finite", f"{bad} NaN/Inf values in the batch")
    return None


class ServeResult(NamedTuple):
    """Terminal state of one submitted request."""

    ok: bool
    labels: np.ndarray | None     # (r,) int32 for k=1, (r, k) for k>1
    scores: np.ndarray | None     # same leading shape, f32
    version: str | None           # model version that served it (ok only)
    reason: str | None = None     # reject code (one of REJECT_REASONS)
    detail: str | None = None     # human-readable reject detail


class Ticket:
    """Completion handle for one submitted request (thread-safe)."""

    __slots__ = ("_event", "_result")

    def __init__(self):
        self._event = threading.Event()
        self._result: ServeResult | None = None

    def _fulfill(self, result: ServeResult) -> None:
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request not served within {timeout}s (queue backlog or "
                "service stopped?)")
        assert self._result is not None
        return self._result


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service knobs (all static for the life of the service)."""

    batch: int = 64               # fixed batch rows; also max request size
    replicas: int = 1             # scoring worker threads
    max_queue_rows: int = 4096    # admission budget; beyond it -> queue_full
    shard: bool = True            # cluster-shard tables when >1 slice
    mesh_axis: str = "data"


class _Request(NamedTuple):
    seq: int
    x: np.ndarray                 # (r, dim) float32, host
    rows: int
    ticket: Ticket
    t_submit: float


class _Engine:
    """One immutable model version on one device + its per-(axis, k) scorers.

    Engines are constructed, warmed, and then only *read* — the swap
    protocol relies on that: a worker that grabbed an engine reference
    can keep scoring against it while the service reference already
    points at a successor. A scorer maps a batch of anchor features
    ``(batch, q)`` on the device to labels and scores; creation is
    get-or-create under a lock because any worker thread may ask first.
    The anchor ids are kept on the host too, where requests are gathered.
    """

    def __init__(self, model: CoclusterModel, version: str,
                 device: torch.device, devices=None, *, shard: bool = True,
                 mesh_axis: str = "data"):
        self.version = version
        self.device = device
        self.model = model.to(device)
        self._anchors = {"rows": model.anchor_cols.cpu().numpy(),
                         "cols": model.anchor_rows.cpu().numpy()}
        self._scorers: dict[tuple[str, int], Callable] = {}
        self._lock = threading.Lock()
        devices = [device] if devices is None else [resolve_device(d) for d in devices]
        # per axis: [(signatures, mean, first global cluster id)], one entry
        # per slice, or one for a replicated (unsharded) table
        self.slices = {}
        specs = (serve_model_shardings(model, {mesh_axis: len(devices)}, mesh_axis)
                 if shard and len(devices) > 1 else {})
        for axis, sigs, mean in (("rows", "row_sigs", "row_mean"),
                                 ("cols", "col_sigs", "col_mean")):
            table = getattr(self.model, sigs)
            if specs and specs[sigs][1][0] == mesh_axis:
                width = table.shape[0] // len(devices)
                self.slices[axis] = [
                    (table[i * width:(i + 1) * width].to(dev),
                     getattr(self.model, mean).to(dev), i * width)
                    for i, dev in enumerate(devices)]
            else:
                self.slices[axis] = [(table, getattr(self.model, mean), 0)]

    def dim(self, axis: str) -> int:
        return self.model.n_cols if axis == "rows" else self.model.n_rows

    def n_clusters(self, axis: str) -> int:
        return (self.model.n_row_clusters if axis == "rows"
                else self.model.n_col_clusters)

    def anchor_features(self, axis: str, reqs: list[_Request],
                        batch: int) -> np.ndarray:
        """The requests' anchor coordinates, stacked and zero-padded on the
        host to ``(batch, q)``."""
        anchors, dim = self._anchors[axis], self.dim(axis)
        out = np.zeros((batch, anchors.shape[0]), np.float32)
        off = 0
        for r in reqs:
            if r.x.shape[1] != dim:
                raise ValueError(f"request width {r.x.shape[1]} does not match "
                                 f"the model's {dim}")
            out[off:off + r.rows] = r.x[:, anchors]
            off += r.rows
        return out

    def scorer(self, axis: str, k: int) -> Callable:
        key = (axis, k)
        with self._lock:
            fn = self._scorers.get(key)
            if fn is not None:
                return fn
            slices = self.slices[axis]
            if len(slices) > 1:
                fn = lambda f: _sharded_score(f, slices, k, self.device)
            elif k == 1:
                fn = lambda f: _assign(f, slices[0][1], slices[0][0])
            else:
                fn = lambda f: _assign_topk(f, slices[0][1], slices[0][0], k)
            self._scorers[key] = fn
            return fn

    def warm(self, axis: str, k: int, batch: int) -> None:
        """Run the (axis, k) scorer once at the service's fixed batch shape
        (kernel build, allocator) — the pre-warm step of the swap protocol."""
        f = torch.zeros((batch, self._anchors[axis].shape[0]), device=self.device)
        self.scorer(axis, k)(f)[0].cpu()

    def warmed_keys(self) -> tuple[tuple[str, int], ...]:
        with self._lock:
            return tuple(self._scorers)


def _sharded_score(feats: torch.Tensor, slices, k: int, device: torch.device):
    """Score ``feats`` on every slice of a cluster-sharded table and merge
    the (score, global index) results in slice order, ties to the lower
    index: the unsharded answer, bit for bit."""
    outs = []
    for sigs, mean, first in slices:
        f = feats.to(sigs.device)
        if k == 1:
            labels, scores = _assign(f, mean, sigs)
        else:
            labels, scores = _assign_topk(f, mean, sigs, min(k, sigs.shape[0]))
        outs.append(((labels + first).to(device), scores.to(device)))
    if k == 1:
        labels, scores = outs[0]
        for lab, sc in outs[1:]:
            take = sc > scores                 # strictly better: ties stay lower
            labels, scores = torch.where(take, lab, labels), torch.where(take, sc, scores)
        return AssignResult(labels, scores)
    labels = torch.cat([lab for lab, _ in outs], dim=1)
    scores = torch.cat([sc for _, sc in outs], dim=1)
    # candidates lie in (slice, rank) order, i.e. by index among equal
    # scores, so a stable descending sort breaks ties to the lower index
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return TopKAssignResult(torch.gather(labels, 1, order)[:, :k], scores[:, :k])


class AssignService:
    """Multi-replica assignment service over one live ``CoclusterModel``.

    ``submit`` is the only request door; ``swap``/``swap_async`` replace
    the model without dropping anything; ``close`` drains and stops.
    Usable as a context manager. Scoring runs on ``device`` (the card
    unless the caller asks for the CPU); all results are host numpy.
    ``devices`` lists the slices the tables are cluster-sharded over
    (``config.shard``): by default every visible card for a CUDA ``device``,
    only ``device`` for the CPU; a device may appear more than once.
    """

    def __init__(self, model: CoclusterModel, *, version: str = "v1",
                 config: ServeConfig = ServeConfig(),
                 metrics: _obs.Registry | None = None,
                 device: str | torch.device = "cuda", devices=None):
        self.config = config
        self._device = resolve_device(device)
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if self._device.type == "cuda" else [self._device])
        self._devices = list(devices)
        if config.batch < 1:
            raise ValueError(f"batch must be >= 1, got {config.batch}")
        if config.replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {config.replicas}")
        self._metrics = metrics if metrics is not None else _obs.get_registry()
        self._rejected = self._metrics.counter(
            "serve_svc_rejected", help="rejected requests, by reason")
        self._submitted = self._metrics.counter(
            "serve_svc_submitted", help="requests admitted to the queue")
        self._rows_served = self._metrics.counter(
            "serve_svc_rows", help="rows scored and returned")
        self._batches = self._metrics.counter(
            "serve_svc_batches", help="batches scored")
        self._swaps = self._metrics.counter(
            "serve_svc_swaps", help="hot model swaps")
        self._queue_gauge = self._metrics.gauge(
            "serve_svc_queue_rows", help="rows waiting for a worker")
        self._batch_lat = self._metrics.histogram(
            "serve_svc_batch_latency_us", help="score+fulfill per batch, µs")
        self._req_lat = self._metrics.histogram(
            "serve_svc_request_latency_us", help="submit->fulfill, µs")
        self._batch_fill = self._metrics.histogram(
            "serve_svc_batch_fill_pct", buckets=tuple(range(5, 101, 5)),
            help="per-batch fill: coalesced rows / batch capacity, %")

        self._engine = self._new_engine(model, version)
        self._engine.warm("rows", 1, config.batch)

        self._cond = threading.Condition()
        self._queues: dict[tuple[str, int], deque[_Request]] = {}
        self._queued_rows = 0
        self._seq = 0
        self._closed = False
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"assign-serve-{i}")
            for i in range(config.replicas)]
        for w in self._workers:
            w.start()

    def _new_engine(self, model: CoclusterModel, version: str) -> _Engine:
        return _Engine(model, version, self._device, self._devices,
                       shard=self.config.shard, mesh_axis=self.config.mesh_axis)

    # -- admission -------------------------------------------------------
    def _reject(self, code: str, detail: str) -> Ticket:
        with self._cond:    # metrics are updated from many threads
            self._rejected.labels(reason=code).inc()
        _obs.event("serve_reject", reason=code, detail=detail)
        t = Ticket()
        t._fulfill(ServeResult(ok=False, labels=None, scores=None,
                               version=None, reason=code, detail=detail))
        return t

    def submit(self, x, axis: str = "rows", k: int = 1) -> Ticket:
        """Admit one request batch; never blocks on the queue.

        ``x``: ``(r, dim)`` float array (``r <= config.batch``); ``axis``
        picks row- vs column-cluster assignment; ``k`` the top-k width
        (``k=1`` returns flat ``(r,)`` labels/scores like
        ``assign_rows``). Returns a :class:`Ticket` — already fulfilled
        with a reject reason when admission fails.
        """
        if axis not in ("rows", "cols"):
            raise ValueError(f"axis must be 'rows' or 'cols', got {axis!r}")
        engine = self._engine
        if self._closed:
            return self._reject("shutdown", "service is closed")
        bad = validate_request(x, engine.dim(axis))
        if bad is not None:
            return self._reject(*bad)
        if not 1 <= k <= engine.n_clusters(axis):
            return self._reject(
                "bad_k", f"k must be in [1, {engine.n_clusters(axis)}] for "
                         f"axis={axis!r}, got {k}")
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(x), dtype=np.float32)
        rows = arr.shape[0]
        if rows > self.config.batch:
            return self._reject(
                "oversize", f"request has {rows} rows; one batch holds "
                            f"{self.config.batch} — split the request")
        if rows == 0:
            # legitimately empty (a coalescer flush upstream): complete
            # immediately with empty arrays of the served shapes
            shape = (0,) if k == 1 else (0, k)
            t = Ticket()
            with self._cond:
                self._submitted.inc()
            t._fulfill(ServeResult(
                ok=True, labels=np.zeros(shape, np.int32),
                scores=np.zeros(shape, np.float32), version=engine.version))
            return t
        ticket = Ticket()
        with self._cond:
            if self._closed:
                return self._reject("shutdown", "service is closed")
            if self._queued_rows + rows > self.config.max_queue_rows:
                return self._reject(
                    "queue_full",
                    f"{self._queued_rows} rows queued of "
                    f"{self.config.max_queue_rows} budget; shedding load")
            self._seq += 1
            req = _Request(self._seq, arr, rows, ticket, time.perf_counter())
            self._queues.setdefault((axis, k), deque()).append(req)
            self._queued_rows += rows
            self._queue_gauge.set(float(self._queued_rows))
            self._submitted.inc()
            self._cond.notify()
        return ticket

    # -- scoring workers -------------------------------------------------
    def _take_batch(self) -> tuple[tuple[str, int], list[_Request]] | None:
        """Pop a coalesced batch for the (axis, k) with the oldest head
        request. Caller holds ``self._cond``."""
        best_key, best_seq = None, None
        for key, q in self._queues.items():
            if q and (best_seq is None or q[0].seq < best_seq):
                best_key, best_seq = key, q[0].seq
        if best_key is None:
            return None
        q = self._queues[best_key]
        out: list[_Request] = []
        rows = 0
        while q and rows + q[0].rows <= self.config.batch:
            r = q.popleft()
            out.append(r)
            rows += r.rows
        self._queued_rows -= rows
        self._queue_gauge.set(float(self._queued_rows))
        return best_key, out

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not any(self._queues.values()):
                    self._cond.wait(_POLL_S)
                taken = self._take_batch()
                if taken is None:
                    if self._closed:
                        return
                    continue
            self._score_batch(*taken)

    def _score_batch(self, key: tuple[str, int], reqs: list[_Request]) -> None:
        axis, k = key
        # one reference read: the whole batch — and every response in it
        # — is served by exactly this engine/version
        engine = self._engine
        rows = sum(r.rows for r in reqs)
        t0 = time.perf_counter()
        try:
            # the gather is inside the guard: a swap to a model with a
            # different feature width turns queued old-width requests
            # into per-request internal_error rejects, never a dead
            # worker thread
            feats = engine.anchor_features(axis, reqs, self.config.batch)
            out = engine.scorer(axis, k)(torch.from_numpy(feats).to(engine.device))
            labels = out[0].cpu().numpy()
            scores = out[1].cpu().numpy()
        except Exception as e:  # noqa: BLE001 — a worker must survive any batch
            detail = f"scorer failed for axis={axis} k={k}: {e!r}"
            with self._cond:
                self._rejected.labels(reason="internal_error").inc(len(reqs))
            for r in reqs:
                r.ticket._fulfill(ServeResult(
                    ok=False, labels=None, scores=None, version=None,
                    reason="internal_error", detail=detail))
            return
        dt_us = (time.perf_counter() - t0) * 1e6
        now = time.perf_counter()
        # the replicas share these metrics: one update at a time, or an
        # increment can be lost; and before the tickets, so a caller holding
        # every result reads counts that include them
        with self._cond:
            for r in reqs:
                self._req_lat.observe((now - r.t_submit) * 1e6)
            self._batches.inc()
            self._rows_served.inc(rows)
            self._batch_lat.observe(dt_us)
            self._batch_fill.observe(100.0 * rows / self.config.batch)
        off = 0
        for r in reqs:
            sl = slice(off, off + r.rows)
            r.ticket._fulfill(ServeResult(
                ok=True, labels=labels[sl].copy(), scores=scores[sl].copy(),
                version=engine.version))
            off += r.rows

    # -- swap protocol ---------------------------------------------------
    @property
    def version(self) -> str:
        return self._engine.version

    @property
    def model(self) -> CoclusterModel:
        return self._engine.model

    def swap(self, model: CoclusterModel, version: str) -> str:
        """Warm-swap to ``model`` without dropping in-flight requests.

        Builds the successor engine on the service's device, runs every
        (axis, k) scorer the current engine has served once at the fixed
        batch shape, then publishes it with one atomic reference
        assignment. Returns the displaced version id.
        """
        old = self._engine
        new = self._new_engine(model, version)
        warmed = old.warmed_keys() or (("rows", 1),)
        for axis, k in warmed:
            if k <= new.n_clusters(axis):
                new.warm(axis, k, self.config.batch)
        self._engine = new
        with self._cond:
            self._swaps.inc()
        _obs.event("serve_swap", old=old.version, new=version)
        return old.version

    def swap_async(self, loader: Callable[[], CoclusterModel],
                   version: str) -> Ticket:
        """Fit/load a successor in the background, then warm-swap to it.

        ``loader`` runs on a daemon thread (a registry ``load``, a
        ``load_model``, ...); traffic keeps flowing on the current
        engine the whole time. The returned :class:`Ticket` resolves
        with ``version`` (ok) once the swap is published, or with
        ``reason='internal_error'`` if the loader raised.
        """
        ticket = Ticket()

        def _run():
            try:
                model = loader()
                old = self.swap(model, version)
                ticket._fulfill(ServeResult(
                    ok=True, labels=None, scores=None, version=version,
                    detail=f"swapped from {old}"))
            except Exception as e:  # noqa: BLE001 — surface via the ticket
                ticket._fulfill(ServeResult(
                    ok=False, labels=None, scores=None, version=None,
                    reason="internal_error", detail=repr(e)))

        threading.Thread(target=_run, daemon=True,
                         name=f"assign-swap-{version}").start()
        return ticket

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout: float | None = 30.0) -> None:
        """Stop admitting, drain the queue, join the workers.

        Every request admitted before ``close`` is still served (the
        zero-drop guarantee); submissions after it reject with
        ``shutdown``.
        """
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout)

    def __enter__(self) -> "AssignService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Point-in-time snapshot of this service's metric values."""
        with self._cond:
            return {
                "version": self.version,
                "queued_rows": self._queued_rows,
                "submitted": self._submitted.value,
                "rows_served": self._rows_served.value,
                "batches": self._batches.value,
                "swaps": self._swaps.value,
                "rejected": {key: c.value
                             for key, c in self._rejected._series.items()},
                "p50_request_us": self._req_lat.percentile(50),
                "p99_request_us": self._req_lat.percentile(99),
                "mean_batch_fill_pct": (self._batch_fill.sum
                                        / max(self._batch_fill.count, 1)),
            }
