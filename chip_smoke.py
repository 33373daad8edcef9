#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LAMC on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device, the CUDA
toolkit and Triton::

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. ``device``: the card's name, count, power limit.
2. ``build``: nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` while the
   Triton kernel compiles; build seconds and the ptxas report.
3. ``kernel``: each hand-written kernel at the shapes the main path gives it,
   against its plain PyTorch version on the same inputs, then timed with
   CUDA events beside its bound and the plain version.
4. ``parity``: a small planted matrix through ``lamc_cocluster`` on the card
   and on the CPU with the same injected draws; the labels must agree.
5. ``e2e``: the dense cell ``lamc_dense_131k``, a 131,072 x 16,384 float32
   planted matrix (made on the card from ``--seed``) through
   ``lamc_cocluster`` with the plan search, per-phase CUDA-event times, peak
   memory, NMI/ARI against the planted truth, and the kernels' launch counts
   during that run.
6. ``kernel`` (sparse): the three SpMM kernels at the sparse cell's shapes
   (its 131,072 x 16,384 operator at density 0.1, rank 6), with and without
   the normalization's lazy scales (which must give the materialized
   operator's bits), against their plain versions, then timed beside their
   bound, the plain version and a ``torch.sparse_bsr_tensor`` product; and
   the k-means kernels at the sparse cell's shape.
7. ``parity_sparse``: a small planted COO matrix on a single-block tiled plan
   on the card and on the CPU with the same injected draws (labels agree),
   and a multi-block ``bcoo`` run whose labels equal the dense run's.
8. ``e2e_sparse``: the sparse cell ``lamc_sparse_131k_d0.1``, the same recipe
   with each entry kept with probability 0.1, drawn on the card as a
   coalesced COO tensor, through ``lamc_cocluster(input_format="bcoo")``:
   plan and route, per-phase times, peak memory, NMI/ARI, launch counts.
9. The card's line from nvidia-smi, the ``kernels`` summary, and last
   ``{"ok": true, "device": {...}}``.

Any failed check or error exits nonzero before the last line. Without a
CUDA device, or without the repository beside it, the script exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores

# The single-card LAMC cell: the repo's lamc_1m workload shape class at one
# eighth of its rows and one sixteenth of its columns, planted k = d = 16.
E2E_ROWS, E2E_COLS, E2E_K = 131_072, 16_384, 16
E2E_CONFIG = dict(n_row_clusters=16, n_col_clusters=16, min_cocluster_rows=1024,
                  min_cocluster_cols=256, workers=132, assign_impl="pallas")
E2E_PLAN = (16, 8, 8192, 2048, 1)          # m, n, phi, psi, t_p it resolves to
ATOM_SHAPE = (128, 10_240, 5, 16)          # B, P = phi + psi, D = l, K at that plan
MERGE_SHAPE = (4, 2048, 64, 16)            # restarts, atoms, signature dim, K
SCALE_SHAPE = (128, 8192, 2048)            # the block stack

# The single-card sparse LAMC cell: the dense cell's matrix with each entry
# kept with probability 0.1, on the planner's default workers=1.
SPARSE_DENSITY = 0.1
SPARSE_CONFIG = dict(n_row_clusters=16, n_col_clusters=16, min_cocluster_rows=1024,
                     min_cocluster_cols=256, assign_impl="pallas", input_format="bcoo")
SPARSE_PLAN = (1, 1, 131_072, 16_384, 1)   # m, n, phi, psi, t_p it resolves to
SPARSE_RANK = 6                            # l + 1 for k = 16
SPARSE_KMEANS_SHAPE = (1, 147_456, 5, 16)  # B, P = M + N, D = l, K
SPMM_RTOL = 1e-5                           # with an absolute floor of 1e-5 * max|plain|


class CheckFailed(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class PhaseTimer:
    """``timer(name)`` for ``lamc_cocluster``: CUDA events around each phase,
    summed per phase name."""

    def __init__(self):
        self.spans = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.spans[name].append((start, end))

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in spans)
                for name, spans in self.spans.items()}


def phase_build():
    import torch
    from repro_torch.kernels import _build, bipartite_normalize

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        # one nvcc per source, started together
        cuda = {name: pool.submit(lambda n=name: (_build.build(n), time.perf_counter() - t0))
                for name in ("kmeans", "spmm")}
        # compile the Triton kernel meanwhile, with the divisibility
        # specialization the main path's shapes get (sizes multiple of 16)
        a = torch.ones((1, 64, 256), device="cuda")
        s1, s2 = torch.ones((1, 64), device="cuda"), torch.ones((1, 256), device="cuda")
        compiled = torch.empty_like(a)
        _triton, kernel = bipartite_normalize.triton_kernel()
        binary = kernel[(64 // bipartite_normalize.BLOCK_M, 1, 1)](
            a, s1, s2, compiled, 64, 256, BLOCK_M=bipartite_normalize.BLOCK_M,
            BLOCK_N=bipartite_normalize.BLOCK_N, num_warps=4)
        torch.cuda.synchronize()
        triton_s = time.perf_counter() - t0
        built = {name: fut.result() for name, fut in cuda.items()}
    for name in built:
        _build.load(name)
    triton_info = {key: getattr(binary, key, None) for key in ("n_regs", "n_spills")}
    triton_info["shared"] = getattr(getattr(binary, "metadata", None), "shared", None)
    check(bool(torch.equal(compiled, a)), "scale_apply warm-up is wrong")
    emit("build", nvcc_seconds={name: round(sec, 3) for name, (_, sec) in built.items()},
         triton_seconds=round(triton_s, 3),
         build_dir=str(_build.BUILD_DIR.relative_to(ROOT)),
         ptxas={name: [ln.strip() for ln in ptxas.splitlines()
                       if any(w in ln for w in ("entry function", "registers", "spill"))]
                for name, ((_lib, ptxas), _) in built.items()},
         triton=triton_info)


def _label_check(x, c, labels, want):
    """Labels equal on >= 99.99 % of points; the rest near-ties within
    1e-5 * (|x|^2 + |c|^2)."""
    import torch

    differ = labels != want
    frac = differ.float().mean().item()
    if frac:
        d2 = ((x[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
        mine = torch.gather(d2, 2, labels.long()[..., None])[..., 0]
        theirs = torch.gather(d2, 2, want.long()[..., None])[..., 0]
        scale = (x * x).sum(-1) + (c * c).sum(-1).amax(-1, keepdim=True)
        check(bool(((mine - theirs).abs() <= 1e-5 * scale)[differ].all()),
              "k-means label differs beyond a near-tie")
    check(frac <= 1e-4, f"k-means labels differ on {frac:.2e} of points")
    return frac


def _kmeans_inputs(shape, weighted, gen):
    import torch

    b, p, d, k = shape
    x = torch.randn((b, p, d), generator=gen, device="cuda")
    pick = torch.randint(0, p, (b, k), generator=gen, device="cuda")
    c = torch.gather(x, 1, pick[..., None].expand(-1, -1, d)).contiguous()
    w = torch.rand((b, p), generator=gen, device="cuda") if weighted else None
    return x, c, w


def check_kmeans_update(shape, weighted, gen):
    """The fused Lloyd step against its plain version; returns max |err|."""
    import torch
    from repro_torch.kernels import kmeans_update, ref

    x, c, w = _kmeans_inputs(shape, weighted, gen)
    labels, d2, sums, counts = kmeans_update.kmeans_update(x, c, w)
    rl, rd, _, _ = ref.kmeans_update_ref(x, c, w)
    torch.cuda.synchronize()
    frac = _label_check(x, c, labels, rl)
    # sums/counts against the plain statistics of the kernel's own labels,
    # so a near-tie flip cannot show up as a sum error
    onehot = (labels.long()[..., None] == torch.arange(shape[3], device="cuda")).float()
    if w is not None:
        onehot = onehot * w[..., None]
    err = 0.0
    for mine, theirs in ((d2, rd), (sums, onehot.mT @ x), (counts, onehot.sum(1))):
        torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-4)
        err = max(err, (mine - theirs).abs().max().item())
    again = kmeans_update.kmeans_update(x, c, w)
    check(all(torch.equal(u, v) for u, v in zip(again, (labels, d2, sums, counts))),
          "kmeans_update is not deterministic")
    return x, c, w, err, frac


def kmeans_rows(shape, gen) -> dict:
    """``kmeans_update`` and ``kmeans_assign`` at ``(B, P, D, K)``: checked
    against their plain versions, then timed beside their bounds."""
    import torch
    from repro_torch.kernels import kmeans_assign, kmeans_update, ref

    rows = {}
    b, p, d, k = shape
    x, c, w, err, frac = check_kmeans_update(shape, False, gen)
    bms, bby = bound(4 * (b * p * d + b * k * d + 2 * b * p + b * k * d + b * k),
                   b * p * (k * (2 * d + 3) + 2 * d + d + 1))
    rows["kmeans_update"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans.cu",
        replaces="src/repro/kernels/kmeans_update.py:79", max_abs_err=err,
        label_mismatch=frac, shape=list(shape),
        ms=cuda_time(lambda: kmeans_update.kmeans_update(x, c), 200),
        plain_ms=cuda_time(lambda: ref.kmeans_update_ref(x, c), 50),
        bound_ms=bms, bound_by=bby, library_ms=None)

    labels, d2 = kmeans_assign.kmeans_assign(x, c)
    rl, rd = ref.kmeans_assign_ref(x, c)
    torch.cuda.synchronize()
    frac = _label_check(x, c, labels, rl)
    torch.testing.assert_close(d2, rd, rtol=1e-5, atol=1e-4)
    bms, bby = bound(4 * (b * p * d + b * k * d + 2 * b * p), b * p * (k * (2 * d + 3) + 2 * d))
    rows["kmeans_assign"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans.cu",
        replaces="src/repro/kernels/kmeans_assign.py:59",
        max_abs_err=(d2 - rd).abs().max().item(), label_mismatch=frac,
        shape=list(shape),
        ms=cuda_time(lambda: kmeans_assign.kmeans_assign(x, c), 200),
        plain_ms=cuda_time(lambda: ref.kmeans_assign_ref(x, c), 50),
        bound_ms=bms, bound_by=bby, library_ms=None)
    for name in ("kmeans_update", "kmeans_assign"):
        emit("kernel", name=name, **rows[name])
    return rows


def phase_kernels(gen) -> dict:
    import torch
    from repro_torch.kernels import bipartite_normalize, ref

    rows = kmeans_rows(ATOM_SHAPE, gen)

    # the merge k-means shape, weighted (the main path runs it on the plain
    # path, as the reference does; checked here so the weighted kernel is too)
    _, _, _, err, frac = check_kmeans_update(MERGE_SHAPE, True, gen)
    emit("kernel_check", name="kmeans_update", shape=list(MERGE_SHAPE), weighted=True,
         max_abs_err=err, label_mismatch=frac)

    bs, m, n = SCALE_SHAPE
    a = torch.randn(SCALE_SHAPE, generator=gen, device="cuda")
    s1 = torch.rand((bs, m), generator=gen, device="cuda")
    s2 = torch.rand((bs, n), generator=gen, device="cuda")
    out = bipartite_normalize.scale_apply(a, s1, s2)
    want = ref.scale_apply_ref(a, s1, s2)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(bool(torch.equal(out, want)), f"scale_apply is not bit-equal (max err {err})")
    del out, want
    bms, bby = bound(4 * (2 * bs * m * n + bs * m + bs * n), 2 * bs * m * n)
    rows["scale_apply"] = dict(
        route="triton", source="src/repro_torch/kernels/bipartite_normalize.py",
        replaces="src/repro/kernels/bipartite_normalize.py:35", max_abs_err=err,
        shape=list(SCALE_SHAPE),
        ms=cuda_time(lambda: bipartite_normalize.scale_apply(a, s1, s2), 10),
        plain_ms=cuda_time(lambda: ref.scale_apply_ref(a, s1, s2), 5),
        bound_ms=bms, bound_by=bby,
        library_ms=cuda_time(lambda: torch.einsum("bij,bi,bj->bij", a, s1, s2), 5))
    emit("kernel", name="scale_apply", **rows["scale_apply"])
    del a, s1, s2
    torch.cuda.empty_cache()
    return rows


def phase_parity():
    """A small planted matrix on the card and on the CPU, same draws."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi
    from repro_torch.data import planted_cocluster_matrix

    pc = planted_cocluster_matrix(np.random.default_rng(0), 512, 384, k=4)
    plan = lamc.partition.PartitionPlan(512, 384, 2, 2, 256, 192, 2, seed=0)
    rng = np.random.default_rng(1)
    draws = interop.draws_from_numpy(
        row_idx=np.stack([rng.permutation(512).reshape(2, 256) for _ in range(2)]),
        col_idx=np.stack([rng.permutation(384).reshape(2, 192) for _ in range(2)]),
        anchor_rows=rng.permutation(512)[:64], anchor_cols=rng.permutation(384)[:64],
        omega=rng.normal(size=(2, 4, 192, 4)),
        atom_seeds=np.stack([[rng.permutation(448)[:4] for _ in range(4)]
                             for _ in range(2)]),
        row_merge_seeds=np.stack([rng.permutation(32)[:4] for _ in range(4)]),
        col_merge_seeds=np.stack([rng.permutation(32)[:4] for _ in range(4)]))
    cfg = lamc.LAMCConfig(4, 4, assign_impl="pallas")
    out = {dev: lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws, device=dev)
           for dev in ("cuda", "cpu")}
    torch.cuda.synchronize()
    scores = {}
    for side, truth in (("row", pc.row_labels), ("col", pc.col_labels)):
        card = getattr(out["cuda"], f"{side}_labels").cpu().numpy()
        host = getattr(out["cpu"], f"{side}_labels").numpy()
        scores[f"{side}_nmi_card_vs_cpu"] = nmi(card, host)
        scores[f"{side}_nmi_truth"] = nmi(card, truth)
        check(scores[f"{side}_nmi_card_vs_cpu"] >= 0.95,
              f"{side} labels on the card disagree with the CPU path")
    emit("parity", **scores)


def planted_on_card(rows: int, cols: int, k: int, gen):
    """The planted recipe (shuffled balanced labels, checkerboard means
    U[0, 4], N(0, 1) noise) drawn on the card: building it in numpy would
    need ~30 GiB of host memory at this size."""
    import torch

    row_labels = (torch.arange(rows, device="cuda") % k)[
        torch.randperm(rows, generator=gen, device="cuda")]
    col_labels = (torch.arange(cols, device="cuda") % k)[
        torch.randperm(cols, generator=gen, device="cuda")]
    mu = torch.rand((k, k), generator=gen, device="cuda") * 4.0
    a = torch.randn((rows, cols), generator=gen, device="cuda")
    chunk = 8192
    for i in range(0, rows, chunk):
        a[i : i + chunk] += mu[row_labels[i : i + chunk]][:, col_labels]
    return a, row_labels, col_labels


def phase_e2e(seed: int) -> dict:
    import torch
    from repro_torch.core import lamc
    from repro_torch.core.metrics import ari, nmi
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # warm-up at a small size: library handles and allocator, not timed
    wa, _, _ = planted_on_card(8192, 2048, 4, gen)
    lamc.lamc_cocluster(wa, lamc.LAMCConfig(4, 4, assign_impl="pallas"),
                        plan=lamc.partition.PartitionPlan(8192, 2048, 2, 2, 4096, 1024, 1))
    del wa
    a, row_truth, col_truth = planted_on_card(E2E_ROWS, E2E_COLS, E2E_K, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    cfg = lamc.LAMCConfig(**E2E_CONFIG, seed=seed)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = lamc.lamc_cocluster(a, cfg, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    plan = res.plan
    row_pred, col_pred = res.row_labels.cpu().numpy(), res.col_labels.cpu().numpy()
    rt, ct = row_truth.cpu().numpy(), col_truth.cpu().numpy()
    scores = dict(row_nmi=nmi(row_pred, rt), col_nmi=nmi(col_pred, ct),
                  row_ari=ari(row_pred, rt), col_ari=ari(col_pred, ct))
    emit("e2e", rows=E2E_ROWS, cols=E2E_COLS, k=E2E_K, config=E2E_CONFIG,
         plan=dict(m=plan.m, n=plan.n, phi=plan.phi, psi=plan.psi, t_p=plan.t_p),
         wall_s=wall, phase_ms=timer.ms(),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, **scores)
    check((plan.m, plan.n, plan.phi, plan.psi, plan.t_p) == E2E_PLAN,
          f"plan resolved to {plan}, expected {E2E_PLAN}")
    want = {"kmeans_update": plan.t_p * cfg.kmeans_iters,
            "kmeans_assign": plan.t_p, "scale_apply": plan.t_p,
            "spmm": 0, "spmm_t": 0, "spmm_ata": 0}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(row_pred.shape == (E2E_ROWS,) and col_pred.shape == (E2E_COLS,),
          "label shapes")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8,
          f"NMI against the planted truth below 0.8: {scores}")
    return counts


def planted_sparse_on_card(rows: int, cols: int, k: int, density: float, gen):
    """The planted recipe with each entry kept with probability ``density``,
    drawn on the card in row chunks straight into a coalesced COO tensor
    (row-major ``nonzero`` order is sorted and unique); the dense draw never
    exists whole."""
    import torch

    row_labels = (torch.arange(rows, device="cuda") % k)[
        torch.randperm(rows, generator=gen, device="cuda")]
    col_labels = (torch.arange(cols, device="cuda") % k)[
        torch.randperm(cols, generator=gen, device="cuda")]
    mu = torch.rand((k, k), generator=gen, device="cuda") * 4.0
    indices, values = [], []
    chunk = 8192
    for i in range(0, rows, chunk):
        n = min(chunk, rows - i)
        block = torch.randn((n, cols), generator=gen, device="cuda")
        block += mu[row_labels[i : i + n]][:, col_labels]
        keep = torch.rand((n, cols), generator=gen, device="cuda") < density
        r, c = keep.nonzero(as_tuple=True)
        values.append(block[r, c])
        indices.append(torch.stack([r + i, c]))
        del block, keep, r, c
    a = torch.sparse_coo_tensor(torch.cat(indices, 1), torch.cat(values), (rows, cols),
                                is_coalesced=True, check_invariants=False)
    return a, row_labels, col_labels


def _bsr_library_ms(op, rhs, transpose: bool):
    """One ``torch.sparse_bsr_tensor`` product on the same payloads, as a
    yardstick; ``(ms, None)``, or ``(None, reason)`` where torch on this card
    has no such call."""
    import torch

    row_ptr, _ = op.segments()
    n_tr, n_tc = op.n_tiles
    bm, bk = op.tile_shape
    try:
        bsr = torch.sparse_bsr_tensor(row_ptr.long(), op.block_cols.long(), op.blocks,
                                      size=(n_tr * bm, n_tc * bk))
        pad = n_tr * bm - op.shape[0] if transpose else n_tc * bk - op.shape[1]
        rp = torch.nn.functional.pad(rhs, (0, 0, 0, pad))
        call = (lambda: bsr.t() @ rp) if transpose else (lambda: bsr @ rp)
        call()
        torch.cuda.synchronize()
        return cuda_time(call, 5), None
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"


def _spmm_close(got, want, what):
    import torch

    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool(((got - want).abs() <= 1e-5 * scale + SPMM_RTOL * want.abs()).all()),
          f"{what}: max |err| {err} against plain (max |plain| {scale})")
    return err


def phase_kernels_sparse(a, gen) -> dict:
    """The SpMM kernels at the sparse cell's shapes, on its own operator:
    unscaled, and with the normalization's scales lazy (the main path's
    form), each against its plain version; then timed. Also the k-means
    kernels at the cell's atom shape."""
    import torch
    from repro_torch.core import sparse, spectral
    from repro_torch.kernels import ref, spmm

    op = sparse.to_tiled(a)                      # no cache: the e2e run converts anew
    lazy, _, _ = spectral.normalize_bipartite(op)
    check(lazy.has_scales, "the normalized operator on the card must keep lazy scales")
    eager = lazy.materialize_scales()
    m, k = op.shape
    r = SPARSE_RANK
    x = torch.linalg.qr(torch.randn((k, r), generator=gen, device="cuda")).Q.contiguous()
    y = torch.linalg.qr(torch.randn((m, r), generator=gen, device="cuda")).Q.contiguous()
    g = op.blocks.shape[0]
    n_tr, n_tc = op.n_tiles
    bm, bk = op.tile_shape
    errs = {name: 0.0 for name in ("spmm", "spmm_t", "spmm_ata")}
    for label, operand in (("unscaled", op), ("scaled", lazy)):
        plain = eager if operand is lazy else op
        errs["spmm"] = max(errs["spmm"], _spmm_close(
            spmm.spmm(operand, x), ref.spmm_tiled_ref(plain, x), f"spmm {label}"))
        errs["spmm_t"] = max(errs["spmm_t"], _spmm_close(
            spmm.spmm_t(operand, y), ref.spmm_tiled_ref(plain, y, transpose=True),
            f"spmm_t {label}"))
        want_z, want_g = ref.spmm_ata_ref(plain, x, with_gram=True)
        z = spmm.spmm_ata(operand, x)
        zg, gram = spmm.spmm_ata(operand, x, with_gram=True)
        check(bool(torch.equal(z, zg)), f"spmm_ata {label}: with_gram changes z")
        errs["spmm_ata"] = max(errs["spmm_ata"], _spmm_close(z, want_z, f"spmm_ata {label}"))
        gerr = (gram - want_g).abs().max().item()
        check(gerr <= 1e-4 * want_g.abs().max().item(),
              f"spmm_ata {label}: Gram max |err| {gerr}")
        emit("kernel_check", name="spmm_ata_gram", operand=label, max_abs_err=gerr,
             max_abs_gram=want_g.abs().max().item())
    for name, call in (("spmm", lambda o: spmm.spmm(o, x)),
                       ("spmm_t", lambda o: spmm.spmm_t(o, y)),
                       ("spmm_ata", lambda o: spmm.spmm_ata(o, x, with_gram=True)[1])):
        check(bool(torch.equal(call(lazy), call(eager))),
              f"{name}: lazy scales are not bit-equal to the materialized operator")
        check(bool(torch.equal(call(lazy), call(lazy))), f"{name} is not deterministic")
    emit("kernel_check", name="spmm_family", lazy_equals_materialized=True,
         deterministic=True, payloads=g, tiles=[n_tr, n_tc], tile_shape=[bm, bk],
         rank=r, splits=dict(spmm=spmm.segment_split(n_tr, 1),
                             spmm_t=spmm.segment_split(n_tc, 1)))

    # bounds: payloads, ids and scales read once, the rhs read once, the
    # output written once; 2 flops per payload element and rhs column
    pay = 4.0 * g * bm * bk
    meta = 4.0 * (2 * g + n_tr + n_tc + 2) + 4.0 * (n_tr * bm + n_tc * bk)
    bounds = {
        "spmm": bound(pay + meta + 4.0 * (k * r + m * r), 2.0 * g * bm * bk * r),
        "spmm_t": bound(pay + meta + 4.0 * g + 4.0 * (m * r + k * r), 2.0 * g * bm * bk * r),
        "spmm_ata": bound(pay + meta + 4.0 * g + 4.0 * (2 * k * r + r * r),
                          4.0 * g * bm * bk * r + 2.0 * k * r * r),
    }
    rows = {}
    timed = {"spmm": (lambda: spmm.spmm(lazy, x), lambda: ref.spmm_tiled_ref(lazy, x),
                      _bsr_library_ms(eager, x, False)),
             "spmm_t": (lambda: spmm.spmm_t(lazy, y),
                        lambda: ref.spmm_tiled_ref(lazy, y, transpose=True),
                        _bsr_library_ms(eager, y, True)),
             "spmm_ata": (lambda: spmm.spmm_ata(lazy, x, with_gram=True),
                          lambda: ref.spmm_ata_ref(lazy, x, with_gram=True),
                          (None, "no single PyTorch call computes A.T (A X) and its Gram"))}
    lines = {"spmm": 413, "spmm_t": 483, "spmm_ata": 585}
    for name, (kernel, plain, (lib_ms, lib_note)) in timed.items():
        bms, bby = bounds[name]
        rows[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/spmm.cu",
            replaces=f"src/repro/kernels/spmm.py:{lines[name]}", max_abs_err=errs[name],
            shape=dict(m=m, k=k, r=r, payloads=g, tile=[bm, bk], scaled=True),
            ms=cuda_time(kernel, 20), plain_ms=cuda_time(plain, 3, warmup=1),
            bound_ms=bms, bound_by=bby, library_ms=lib_ms,
            **({"library_note": lib_note} if lib_note else {}))
        emit("kernel", name=name, **rows[name])
    del op, lazy, eager
    torch.cuda.empty_cache()
    kms = kmeans_rows(SPARSE_KMEANS_SHAPE, gen)
    return rows, kms


def phase_parity_sparse():
    """(1) A small planted COO matrix on a single-block tiled plan, on the
    card and on the CPU with the same injected draws: labels agree. (2) A
    multi-block ``bcoo`` run on the card equals the dense run exactly."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi
    from repro_torch.data import planted_cocluster_matrix, to_bcoo
    from repro_torch.kernels import ops

    pc = planted_cocluster_matrix(np.random.default_rng(0), 4096, 1024, k=4,
                                  density=SPARSE_DENSITY, diagonal_only=True)
    plan = lamc.partition.PartitionPlan(4096, 1024, 1, 1, 4096, 1024, 2, seed=0)
    rng = np.random.default_rng(1)
    draws = interop.draws_from_numpy(
        row_idx=np.stack([np.arange(4096).reshape(1, -1)] * 2),
        col_idx=np.stack([np.arange(1024).reshape(1, -1)] * 2),
        anchor_rows=rng.permutation(4096)[:64], anchor_cols=rng.permutation(1024)[:64],
        omega=rng.normal(size=(2, 1, 1024, 4)),
        atom_seeds=np.stack([rng.permutation(5120)[:4][None] for _ in range(2)]),
        row_merge_seeds=np.stack([rng.permutation(8)[:4] for _ in range(4)]),
        col_merge_seeds=np.stack([rng.permutation(8)[:4] for _ in range(4)]))
    cfg = lamc.LAMCConfig(4, 4, assign_impl="pallas", input_format="bcoo",
                          spmm_impl="tiled", qr_method="cholesky")
    ops.reset_launch_counts()
    card = lamc.lamc_cocluster(to_bcoo(pc.matrix, "cuda"), cfg, plan=plan, draws=draws)
    counts = ops.launch_counts()
    host = lamc.lamc_cocluster(to_bcoo(pc.matrix, "cpu"), cfg, plan=plan, draws=draws,
                               device="cpu")
    torch.cuda.synchronize()
    check(card.plan.spmm_route == "tiled", f"route {card.plan.spmm_route}")
    check(counts["spmm_ata"] == 2 * cfg.svd_iters and counts["spmm"] == 2
          and counts["spmm_t"] == 2, f"operator path launches {counts}")
    scores = {}
    for side, truth in (("row", pc.row_labels), ("col", pc.col_labels)):
        mine = getattr(card, f"{side}_labels").cpu().numpy()
        scores[f"{side}_nmi_card_vs_cpu"] = nmi(mine, getattr(host, f"{side}_labels").numpy())
        scores[f"{side}_nmi_truth"] = nmi(mine, truth)
        check(scores[f"{side}_nmi_card_vs_cpu"] >= 0.95,
              f"{side} labels of the sparse path on the card disagree with the CPU path")

    plan2 = lamc.partition.PartitionPlan(4096, 1024, 2, 2, 2048, 512, 2, seed=3)
    kw = dict(n_row_clusters=4, n_col_clusters=4, assign_impl="pallas", seed=3)
    sp = lamc.lamc_cocluster(to_bcoo(pc.matrix, "cuda"),
                             lamc.LAMCConfig(**kw, input_format="bcoo"), plan=plan2)
    dense = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**kw), plan=plan2)
    equal = all(bool(torch.equal(getattr(sp, f), getattr(dense, f)))
                for f in ("row_labels", "col_labels"))
    check(equal, "multi-block bcoo labels differ from the dense run's on the card")
    emit("parity_sparse", single_block_launches=counts, multi_block_equals_dense=equal,
         **scores)


def phase_e2e_sparse(a, row_truth, col_truth, seed: int) -> dict:
    """The sparse cell ``a`` (drawn by ``planted_sparse_on_card``) through
    the operator path, end to end."""
    import torch
    from repro_torch.core import lamc, opcache
    from repro_torch.core.metrics import ari, nmi
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    opcache.default_cache().clear()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    cfg = lamc.LAMCConfig(**SPARSE_CONFIG, seed=seed)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = lamc.lamc_cocluster(a, cfg, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    plan = res.plan
    row_pred, col_pred = res.row_labels.cpu().numpy(), res.col_labels.cpu().numpy()
    rt, ct = row_truth.cpu().numpy(), col_truth.cpu().numpy()
    scores = dict(row_nmi=nmi(row_pred, rt), col_nmi=nmi(col_pred, ct),
                  row_ari=ari(row_pred, rt), col_ari=ari(col_pred, ct))
    emit("e2e_sparse", cell="lamc_sparse_131k_d0.1", rows=E2E_ROWS, cols=E2E_COLS, k=E2E_K,
         nnz=a._nnz(), density=a._nnz() / (E2E_ROWS * E2E_COLS), config=SPARSE_CONFIG,
         plan=dict(m=plan.m, n=plan.n, phi=plan.phi, psi=plan.psi, t_p=plan.t_p,
                   spmm_route=plan.spmm_route),
         wall_s=wall, phase_ms=timer.ms(),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, **scores)
    opcache.default_cache().clear()      # the cached operator holds ~10 GB
    got = (plan.m, plan.n, plan.phi, plan.psi, plan.t_p)
    check(got == SPARSE_PLAN and plan.spmm_route == "tiled",
          f"plan resolved to {plan}, expected {SPARSE_PLAN} route tiled")
    want = {"kmeans_update": cfg.kmeans_iters, "kmeans_assign": 1, "scale_apply": 0,
            "spmm": 1, "spmm_t": 1, "spmm_ata": cfg.svd_iters}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(row_pred.shape == (E2E_ROWS,) and col_pred.shape == (E2E_COLS,), "label shapes")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8,
          f"NMI against the planted truth below 0.8: {scores}")
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import fp32_policy

    fp32_policy()
    try:
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
             torch=torch.__version__, cuda=torch.version.cuda)
        phase_build()
        rows = phase_kernels(torch.Generator(device="cuda").manual_seed(args.seed))
        phase_parity()
        dense_counts = phase_e2e(args.seed)
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        cell = planted_sparse_on_card(E2E_ROWS, E2E_COLS, E2E_K, SPARSE_DENSITY, gen)
        sparse_rows, sparse_kmeans = phase_kernels_sparse(cell[0], gen)
        phase_parity_sparse()
        sparse_counts = phase_e2e_sparse(*cell, args.seed)
        del cell
    except Exception:  # every failure ends the run with a nonzero exit
        traceback.print_exc()
        return 1
    rows.update(sparse_rows)
    cells = {"lamc_dense_131k": dense_counts, "lamc_sparse_131k_d0.1": sparse_counts}
    summary = []
    for name, row in rows.items():
        # launches: per run of the first cell that launches the kernel
        by_cell = {cell: counts[name] for cell, counts in cells.items()}
        entry = dict(name=name, launches=next((n for n in by_cell.values() if n), 0),
                     launches_by_cell=by_cell, **row)
        if name in sparse_kmeans:
            entry["at_sparse_cell"] = {key: sparse_kmeans[name][key] for key in
                                       ("shape", "ms", "plain_ms", "bound_ms", "max_abs_err")}
        summary.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
