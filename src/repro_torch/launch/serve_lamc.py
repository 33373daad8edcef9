"""Online co-cluster assignment server (thin launcher).

``python -m repro_torch.launch.serve_lamc --ckpt DIR`` loads a saved model
(``streaming.save_model`` of either package) onto the card and serves
batched ``assign_rows``/``assign_cols`` requests from it, reporting p50/p99
latency, QPS, rows served and rejected batches under the reference's keys
(``serve_assign_{axis}_p50_us`` ...). ``--service`` routes the same stream
through a full :class:`streaming.AssignService` (admission queue, coalescer,
worker replicas).

``--fit-demo`` first fits a small planted model out of core
(``streaming.fit`` over row chunks, on ``--device``) and saves it to
``--ckpt``, so the launcher runs end to end with no model at hand.

Request validation, admission and hot swap live in ``streaming.serve``.
Malformed requests (wrong width or rank, non-finite payloads) are rejected
per request and counted in ``serve_assign_*_errors``; ``--adversarial N``
interleaves N bad batches into the stream. Latencies are host clock around
one scoring call that ends in a device synchronization, folded into an
``obs.Histogram`` (bounded memory however long the stream runs).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import obs, streaming
from ..data import planted_cocluster_matrix
from ..device import resolve_device

__all__ = ["fit_demo_model", "validate_request", "serve", "serve_service", "main"]


def fit_demo_model(ckpt_dir: str, *, n_rows: int = 1024, n_cols: int = 512,
                   k: int = 5, chunk_rows: int = 256, seed: int = 0,
                   device: str | torch.device = "cuda") -> None:
    """Out-of-core fit of a planted matrix on ``device``; save the model."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = planted_cocluster_matrix(rng, n_rows, n_cols, k=k, d=k,
                                    signal=4.0, noise=0.6)
    cfg = streaming.StreamConfig(n_row_clusters=k, n_col_clusters=k, seed=seed)
    model, stats = streaming.fit(
        streaming.iter_row_chunks(data.matrix, chunk_rows, device=dev), cfg,
        device=dev)
    streaming.save_model(ckpt_dir, model, extra={
        "fit_stats": {"rows_seen": stats.rows_seen, "chunks": stats.chunks,
                      "rows_per_s": round(stats.rows_per_s, 1)}})
    print(f"fit-demo: {stats.rows_seen}x{stats.n_cols} in {stats.chunks} "
          f"chunks ({stats.rows_per_s:.0f} rows/s) -> saved to {ckpt_dir}")


def validate_request(x, dim: int) -> str | None:
    """Reject reason for one request batch, or None if servable: the
    service's reason-coded validator (``streaming.validate_request``) in
    the flat ``"code: detail"`` form."""
    bad = streaming.validate_request(x, dim)
    if bad is None:
        return None
    code, detail = bad
    return f"{code}: {detail}"


def _adversarial_batch(i: int, batch: int, dim: int):
    """Deterministic rotation of the malformed-request taxonomy."""
    kind = i % 3
    if kind == 0:
        return np.zeros((batch, dim + 3), np.float32)       # wrong width
    if kind == 1:
        x = np.zeros((batch, dim), np.float32)
        x[0, 0] = np.nan                                    # poisoned payload
        return x
    return np.zeros((batch * dim,), np.float32)             # wrong rank


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(ckpt_dir: str, *, batch: int = 64, requests: int = 32,
          rows: int | None = None, warmup: int = 3, axis: str = "rows",
          seed: int = 1, adversarial: int = 0,
          registry: obs.Registry | None = None,
          device: str | torch.device = "cuda") -> dict:
    """Serve a stream of synthetic request batches; report latency/QPS.

    The stream is ``requests`` full ``batch``-row batches, unless ``rows``
    is given — then exactly ``rows`` rows in ``batch``-row batches with a
    final partial batch, so QPS is computed from the rows actually served.
    ``adversarial`` malformed batches are interleaved and rejected (counted,
    never timed). Latencies fold into ``serve_assign_{axis}_latency_us`` on
    ``registry`` (default: a fresh :class:`obs.Registry` per call); the
    percentiles are NaN when every batch was rejected.
    """
    dev = resolve_device(device)
    reg = registry if registry is not None else obs.Registry()
    hist = reg.histogram(f"serve_assign_{axis}_latency_us",
                         help="per-batch assign latency, µs")
    err_ct = reg.counter(f"serve_assign_{axis}_errors",
                         help="rejected request batches")
    if rows is not None:
        sizes = [batch] * (rows // batch) + ([rows % batch] if rows % batch else [])
    else:
        sizes = [batch] * requests
    with obs.span("serve", axis=axis, batch=batch, requests=len(sizes),
                  adversarial=adversarial) as root:
        model, meta = streaming.load_model(ckpt_dir, device=dev)
        dim = model.n_cols if axis == "rows" else model.n_rows
        assign = streaming.assign_rows if axis == "rows" else streaming.assign_cols

        rng = np.random.default_rng(seed)
        reqs = torch.from_numpy(
            rng.normal(size=(batch, dim)).astype(np.float32)).to(dev)
        with obs.span("warmup", iters=warmup):
            for _ in range(warmup):
                assign(model, reqs)
            if sizes and sizes[-1] != batch:
                assign(model, reqs[:sizes[-1]])
            _sync(dev)

        # interleave adversarial batches roughly uniformly through the stream
        stream: list[tuple[int, int | None]] = list(enumerate(sizes))
        for i in range(adversarial):
            pos = min(len(stream), 1 + i * max(1, len(sizes) // max(adversarial, 1)))
            stream.insert(pos, (i, None))

        out = None
        rows_served = 0
        with obs.span("request_loop", total=len(stream)):
            for i, size in stream:
                x = (reqs[:size] + float(i) if size is not None
                     else _adversarial_batch(i, batch, dim))
                reason = validate_request(x, dim)
                if reason is not None:
                    err_ct.inc()
                    obs.event("request_rejected", reason=reason)
                    print(f"serve[{axis}]: rejected request: {reason}")
                    continue
                _sync(dev)
                t0 = time.perf_counter()
                out = assign(model, x)
                _sync(dev)
                hist.observe((time.perf_counter() - t0) * 1e6)
                rows_served += int(x.shape[0])

        p50 = hist.percentile(50)
        p99 = hist.percentile(99)
        qps = rows_served / max(hist.sum / 1e6, 1e-9) if hist.count else 0.0
        root.set(served=hist.count, rows=rows_served, errors=int(err_ct.value),
                 p50_us=None if math.isnan(p50) else round(p50, 1))
    return {
        f"serve_assign_{axis}_p50_us": p50,
        f"serve_assign_{axis}_p99_us": p99,
        f"serve_assign_{axis}_qps": qps,
        f"serve_assign_{axis}_rows": rows_served,
        f"serve_assign_{axis}_errors": int(err_ct.value),
        "_labels_sample": (out.labels[:8].cpu().tolist() if out is not None else []),
        "_model_kind": meta.get("kind"),
        "_batch": batch,
    }


def serve_service(ckpt_dir: str, *, batch: int = 64, requests: int = 32,
                  warmup: int = 3, axis: str = "rows", seed: int = 1,
                  replicas: int = 2, k: int = 1,
                  device: str | torch.device = "cuda") -> dict:
    """Drive the same synthetic stream through a full ``AssignService`` and
    report the service's submit → fulfil latency percentiles (queueing
    included). Requests are quarter-batch sized so the coalescer has work;
    every ticket is awaited, and a reject fails the call."""
    dev = resolve_device(device)
    model, meta = streaming.load_model(ckpt_dir, device=dev)
    reg = obs.Registry()
    cfg = streaming.ServeConfig(batch=batch, replicas=replicas)
    size = max(1, batch // 4)
    dim = model.n_cols if axis == "rows" else model.n_rows
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(size, dim)).astype(np.float32)
    with streaming.AssignService(model, version="serve_lamc", config=cfg,
                                 metrics=reg, device=dev) as svc:
        for _ in range(warmup):
            svc.submit(base, axis=axis, k=k).result(timeout=60.0)
        t_wall = time.perf_counter()
        tickets = [svc.submit(base + np.float32(i), axis=axis, k=k)
                   for i in range(requests)]
        rows_served = 0
        for t in tickets:
            res = t.result(timeout=60.0)
            if not res.ok:
                raise RuntimeError(f"service rejected a well-formed request: "
                                   f"{res.reason}: {res.detail}")
            rows_served += len(res.labels)
        wall_s = time.perf_counter() - t_wall
        stats = svc.stats()
    return {
        f"serve_svc_{axis}_p50_us": stats["p50_request_us"],
        f"serve_svc_{axis}_p99_us": stats["p99_request_us"],
        f"serve_svc_{axis}_qps": rows_served / max(wall_s, 1e-9),
        f"serve_svc_{axis}_rows": rows_served,
        f"serve_svc_{axis}_fill_pct": stats["mean_batch_fill_pct"],
        "_model_kind": meta.get("kind"),
        "_replicas": replicas,
        "_batch": batch,
        "_batches": int(stats["batches"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="model checkpoint directory")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--fit-demo", action="store_true",
                    help="fit + save a small planted model first (out of "
                         "core, on --device)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rows", type=int, default=None,
                    help="serve exactly this many rows (final batch may be "
                         "partial) instead of --requests full batches")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--axis", choices=["rows", "cols", "both"], default="both")
    ap.add_argument("--adversarial", type=int, default=0,
                    help="interleave N malformed request batches (rejected + "
                         "counted, never crash the loop)")
    ap.add_argument("--service", action="store_true",
                    help="route the stream through streaming.AssignService "
                         "(admission queue + coalescer + replicas)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="worker replicas for --service")
    ap.add_argument("--trace-out", default="",
                    help="write the serve span trace as JSONL here "
                         "(implies enabling obs spans)")
    args = ap.parse_args(argv)

    if args.trace_out:
        obs.configure(enabled=True)
    if obs.enabled():
        obs.reset_trace()
    if args.fit_demo:
        fit_demo_model(args.ckpt, device=args.device)
    axes = ["rows", "cols"] if args.axis == "both" else [args.axis]
    report = {}
    for axis in axes:
        if args.service:
            out = serve_service(args.ckpt, batch=args.batch, requests=args.requests,
                                warmup=args.warmup, axis=axis,
                                replicas=args.replicas, device=args.device)
        else:
            out = serve(args.ckpt, batch=args.batch, requests=args.requests,
                        rows=args.rows, warmup=args.warmup, axis=axis,
                        adversarial=args.adversarial, device=args.device)
        report.update(out)
    if args.trace_out:
        obs.write_trace_jsonl(args.trace_out)
        print(f"serve trace -> {args.trace_out}")
    rows = {k: v for k, v in report.items() if not k.startswith("_")}
    print(json.dumps({**rows, "batch": args.batch, "requests": args.requests},
                     indent=2))


if __name__ == "__main__":
    main()
