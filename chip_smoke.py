#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LAMC on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device, the CUDA
toolkit and Triton::

    python3 chip_smoke.py [--seed 0]

``--time-kmeans SRC`` only times the k-means kernels of the tree whose
``src/`` is SRC (``time_kmeans`` below), and ``--time-spmm SRC`` its
``spmm_ata`` at the sparse cell (``time_spmm``), and ``--time-dispatch SRC``
its ``ops`` k-means calls and served latency at B = 1 (``time_dispatch``),
to compare two commits on one card.

Phases, each printing one JSON line:

1. ``device``: the card's name, count, power limit.
2. ``build``: nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` while the
   Triton kernel compiles; build seconds and the ptxas report.
2a. ``analysis``: the port's analyzer, both layers, strict, on the card
   (``python -m repro_torch.analysis --strict``): the AST lint; each entry
   point's op count, sync count (plain and ``_obs`` twin) and rebuilds on a
   repeat call at the same shapes (the entries launch kernels 1-8 through
   ``ops``); each kernel instance's shared-memory estimate beside what the
   card reports (static bytes, registers and spills from ptxas, dynamic
   bytes from the launcher); what ``obs.kernel_dispatch`` costs the host a
   call. Any finding, a kernel entry that syncs or a rebuild fails it.
3. ``kernel``: each hand-written kernel at the shapes the main path gives it,
   against its plain PyTorch version on the same inputs, then timed with
   CUDA events beside its bound and the plain version (the k-means rows
   also give ``device_ms``, from CUDA-graph replay); ``kernel_check``:
   both k-means kernels at the edges of their narrow and wide tiles
   (``KMEANS_EDGE_SHAPES``), deterministic, with equal labels and d2.
4. ``parity``: a small planted matrix through ``lamc_cocluster`` on the card
   and on the CPU with the same injected draws; the labels must agree.
5. ``e2e``: the dense cell ``lamc_dense_131k``, a 131,072 x 16,384 float32
   planted matrix (made on the card from ``--seed``) through
   ``lamc_cocluster`` with the plan search, per-phase CUDA-event times, peak
   memory, NMI/ARI against the planted truth, and the kernels' launch counts
   during that run, then one more fit, untimed, with its host syncs counted
   under ``torch.cuda.set_sync_debug_mode("warn")``; then ``kmeans_split``:
   its k-means phase at its shape
   on random points, k-means++ seeding apart from the Lloyd steps.
6. ``kernel`` (sparse): the three SpMM kernels at the sparse cell's shapes
   (its 131,072 x 16,384 operator at density 0.1, rank 6), with and without
   the normalization's lazy scales (which must give the materialized
   operator's bits), against their plain versions, then timed beside their
   bound, the plain version and a ``torch.sparse_bsr_tensor`` product; the
   ``spmm_ata`` row also gives its grid, bands and ring slots, and
   ``spmm_ata_band_cost`` what a band costs with one payload in it (checked
   against the plain version) and what a new operator's schedule costs; and
   the k-means kernels at the sparse cell's shape. ``syncs``: the host
   syncs of phase 5's extra fit and of this operator's conversion, by
   Python line, beside those of the audit's ``lamc_dense`` and
   ``tiled_convert`` entries (phase 2a), which run small shapes and plans.
7. ``parity_sparse``: a small planted COO matrix on a single-block tiled plan
   on the card and on the CPU with the same injected draws (labels agree),
   and a multi-block ``bcoo`` run whose labels equal the dense run's.
8. ``e2e_sparse``: the sparse cell ``lamc_sparse_131k_d0.1``, the same recipe
   with each entry kept with probability 0.1, drawn on the card as a
   coalesced COO tensor, through ``lamc_cocluster(input_format="bcoo")``:
   plan and route, per-phase times, peak memory, NMI/ARI, launch counts.
9. ``kernel`` (cosine): the two serving scorers at the served model's shape
   (q = 64 anchors, K = 16, batches of 1, 64 and 1,024 rows, k = 1, 4, 16),
   at the reference's envelope (q = K = 1024), at a ragged q = 70, K = 13,
   at K = 2000 (more signature tiles than a cluster scores in a pass), at
   k = 17 (above the running top-k's cap, through the scratch) and at a
   ragged P = 4000 of the envelope's width, with exact ties, against their
   plain versions, then timed beside
   their bound, the plain version and the library pair they replace
   (``torch.matmul`` + ``torch.max`` / ``topk``): ``ms`` is device time per
   call from CUDA-graph replay (at the served shape a call's host cost
   exceeds its device time), ``eager_ms`` the time per call launched one by
   one from Python. One more shape checks ``k_valid`` (padded signature
   rows that would win are never chosen), and rows whose scores are NaN,
   +inf or -inf must get the plain version's labels and scores exactly.
10. ``parity_serve``: a small model fitted, saved and loaded on the card and
   on the CPU with the same injected draws; the same request batches get
   equal labels, and the card's checkpoint loads on the CPU with equal leaf
   hashes.
11. ``e2e_serve``: the dense cell's fitted model (phase 5's result, not a
   second fit) saved, loaded on the card and served: ``serve_lamc.serve`` at
   row batches 1, 64, 1024 and column batches of 64, top-k and COO requests,
   a zero-row batch, and an ``AssignService`` with two replicas, 256 mixed
   requests and one hot swap to a version published through the
   ``ModelRegistry``. Held-out rows and re-assigned columns must recover the
   planted and fitted labels (NMI >= 0.8).
12. ``parity_nmtf``: the small case through ``lamc_cocluster(atom="nmtf")``,
   ``scc_full`` and ``nmtf_full`` on the card and on the CPU with the same
   injected draws; the labels must be equal.
13. ``e2e_nmtf``: the dense cell's matrix through ``lamc_cocluster`` with the
   NMTF atom (LAMC-PNMTF) on phase 5's plan: per-phase times (``nmtf`` around
   ``nmtf_init`` and ``nmtf_updates``), wall time, peak memory, NMI/ARI
   (NMI > 0.4, the reference's bar) and launch counts (none: the atom is
   plain batched products, as in the reference).
14. ``baseline``: ``scc_full`` and ``nmtf_full`` on the same whole matrix,
   twice each: wall times, the warm call's phases, peak memory, NMI/ARI
   (> 0.6 and > 0.5, the reference's bars), ``scale_apply`` launches (one
   for ``scc_full``) and phase 5's LAMC wall time over each (reported, not
   gated).
14a. ``parity_fit``: the out-of-core fit (``streaming.fit``) of a 600 x 500
   planted matrix in chunks of 150 on the card and on the CPU with the same
   injected draws (labels equal), COO chunks against dense ones on the card
   (labels equal), a run with ``FailureInjector((1, 2))`` and
   ``save_every=1`` against the uninterrupted run on the card (every model
   leaf equal), the card's FitState loaded on the CPU (leaf hashes equal),
   and ``serve_lamc.fit_demo_model`` then ``serve`` on the card.
14b. ``e2e_stream``: the cell ``lamc_stream_131k``, the dense cell's resident
   matrix streamed as 16 row chunks of 8,192 rows (views of it) through
   ``streaming.fit`` with ``col_blocks=8`` (8,192 x 2,048 atom blocks, as
   phase 5's plan cuts them): wall time, ``FitStats``, peak memory above
   the resident matrix, launches (256 / 16 / 16 for kernels 1 / 2 / 3),
   NMI against the planted truth (>= 0.8) and phase 5's labels, the wall
   time over phase 5's; a run with ``obs`` spans on before it gives the span
   times (and warms it up); then the same stream with ``save_every=4`` and
   ``FailureInjector((5, 11))`` must give the same model, leaf for leaf,
   after two failures.
14c. ``parity_dist``: the small case through ``core.distributed.
   distributed_lamc`` on a one-rank NCCL mesh (this process) with the same
   injected draws: labels, votes and memberships equal ``lamc_cocluster``'s
   on the card, labels equal the CPU path's.
14d. ``e2e_dist`` (cell ``lamc_dense_131k_dist``): phase 5's matrix and plan
   through ``distributed_lamc`` on that one-rank NCCL mesh: labels, votes
   and memberships equal phase 5's; NMI >= 0.8; wall, phase times, peak,
   launches 16 / 1 / 1.
14e. ``e2e_dist_shared4`` (``lamc_dense_131k_dist_shared4``): the same on
   four ranks spawned on the one card (gloo, which stages the collectives
   through host memory; NCCL refuses two ranks on one device), mesh (data =
   2, model = 2), each rank holding its own copy of its 2 GiB shard and 32
   blocks: the bytes the scatter moved, each rank's wall, phase times, peak
   and launches (16 / 1 / 1); labels equal phase 5's (or, where a batched
   library call gives other bits at 32 blocks than at 128, which the line
   then names, NMI >= 0.99 against them), NMI >= 0.8. Not a scaling
   figure: four ranks share one card and the scatter goes through the host.
14f. ``e2e_dist_pods`` (``lamc_dense_131k_dist_pods``): phase 5's matrix at
   t_p = 2 on two ranks, mesh (pod = 2, data = 1), one resample each
   (``resample_axis="pod"``), each holding the whole matrix: labels equal
   the one-process t_p = 2 fit's, NMI >= 0.8, launches 16 / 1 / 1 a rank.
14g. ``serve_sharded`` (``lamc_dense_131k_serve_sharded``): phase 5's model
   in an ``AssignService`` whose tables are cluster-sharded over four slices
   of the card: rows (B = 1, 64, 1,024) and columns, k = 1 and top-4, and COO
   features get the unsharded service's labels and score bits; p50 beside
   the unsharded p50.
14h. ``elastic`` (``lamc_stream_131k_elastic``): the stream of 14b
   checkpointed after 4 chunks, restored onto four ranks sharing the card
   (``fault_tolerance.elastic_restore`` with ``stream_state_specs``, each
   rank holding its shards) and continued: every rank's model equals 14b's,
   leaf for leaf; launches 192 / 12 / 12 a rank.
15a. ``e2e_stream_ooc``: the cell ``lamc_stream_1.5m_ooc``, a 1,572,864 x
   16,384 float32 planted stream (96 GiB, more than the card holds) drawn
   on the card chunk by chunk (192 chunks of 8,192 rows, chunk ``t`` from a
   generator seeded by ``(--seed, t)``), never held whole, through the same
   fit: rows/s, ``FitStats`` (1,572,864 rows, 192 chunks, 512 MiB a chunk),
   peak memory (< 16 GiB), launches (3,072 / 192 / 192), NMI (>= 0.8), and
   the span times of a run with spans on before it. The kernel lines also give
   kernels 1-3 at the stream's chunk shape (B = 8).
15. ``examples``: ``examples/torch_quickstart.py`` and
   ``examples/torch_text_coclustering.py`` at their default sizes, in this
   process, with their scores and launch counts; the quickstart's LAMC and
   held-out NMI must reach 0.8.
16. ``kernel`` (k-means at K = D = 128): both k-means kernels past one
   centroid and one feature slice, against their plain versions, timed.
17. ``kernel`` (flash): the flash-attention kernel at the served prefill's
   shape (B = 4, Hq = 32, Hkv = 8, S = 2048, Dh = 128, bf16), the same in
   float32, Dh = 64 (15/5 heads), Dh = 256, a ragged S = 1000, non-causal
   recurrentgemma-2b's windowed local attention (10/1 heads, Dh = 256,
   window 2,048, S = 4,096), the same at its served prefill (B = 4, a
   ragged S = 3,000) and deepseek-moe-16b's served prefill (B = 4,
   Hq = Hkv = 16, S = 2,048, Dh = 128, bf16: multi-head, no GQA), against
   its plain version, each through the
   kernel its dtype must take (``wgmma`` for bf16, ``f32_pipe`` for
   float32), then timed (CUDA events) beside its bound, the plain version
   and ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it).
18. ``parity_lm``: qwen3-4b at full width, depth cut to 2 layers, B = 1,
   S = 256, float32 compute, on the card (the kernel) and on the CPU (the
   plain version) with the same weights: prefill logits within 1e-3 of
   max|logit| and the same greedy tokens over 4 steps.
19. ``lm_qwen3_4b_serve``: ``launch.serve.generate`` of the full qwen3-4b
   (36 layers, random weights from ``--seed``), batch 4, prompt 2048, 32
   tokens: prefill ms, decode tokens/s, peak memory, one flash launch per
   layer, every logit finite.
19a. ``parity_lm_rg``: recurrentgemma-2b at full width (d = 2,560, 10/1
   heads, Dh = 256, window 2,048) cut to 5 layers (one (rglru, rglru, local)
   unit and two tail RG-LRU blocks, the reduced config's layout), B = 1, a
   2,100-token prompt, 8 tokens, float32 compute, card against CPU as in
   ``parity_lm``: one flash launch (the float32 pipe in window mode). The
   prompt passes the window and is no multiple of it, so the prefill cuts
   the local cache, ``grow_cache`` rolls it by 52 and decode evicts slots
   52-59.
19b. ``lm_recurrentgemma_2b_serve``: ``launch.serve.generate`` of the full
   recurrentgemma-2b (26 layers: 8 units and 2 tail RG-LRU blocks, seeded
   random weights), batch 4, prompt 3,000, 32 tokens, bf16: as phase 19,
   with the analytic and the built parameter counts; one flash launch per
   local layer (8), no other kernel.
19c. ``parity_lm_moe``: deepseek-moe-16b at full width (d = 2,048, 16/16
   heads, 64 experts top-6 of width 1,408, 2 shared, capacity factor
   1.25) cut to 3 layers (the dense first layer of width 10,944 and two MoE
   layers), B = 1, a 256-token prompt, 8 tokens, float32 compute, card
   against CPU as in ``parity_lm``: 3 flash launches, and the (token, k)
   pairs each MoE layer's prefill drops at capacity, equal on both.
19d. ``lm_deepseek_moe_16b_serve``: ``launch.serve.generate`` of the full
   deepseek-moe-16b (28 layers: the dense one and 27 MoE layers, seeded
   random weights stored in bf16, since float32 masters would need 97 GB),
   batch 4, prompt 2,048, 32 tokens, bf16: as phase 19, with the pairs
   each prefill layer drops (none at decode, where each row's six pairs
   take six experts of capacity 1); one flash launch per layer (28), no
   other kernel: routing, dispatch, the grouped expert products (cuBLAS)
   and the combine are plain PyTorch, as the reference's MoE has no
   Pallas kernel.
20. The card's line from nvidia-smi, the ``kernels`` summary, and last
   ``{"ok": true, "device": {...}}``.

Phases 9-14h run right after phase 5, while the dense cell's matrix is still
on the card (the multi-rank phases spawn their ranks with the ``spawn``
method after phase 2 built every kernel, and hand them the matrix through
CUDA IPC), and phases 15a and 15 once it is freed; the sparse cell (phases 6-8)
follows, and the LM phases run last, after the sparse cell is freed.

Any failed check or error exits nonzero before the last line. Without a
CUDA device, or without the repository beside it, the script exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores

# The single-card LAMC cell: the repo's lamc_1m workload shape class at one
# eighth of its rows and one sixteenth of its columns, planted k = d = 16.
E2E_ROWS, E2E_COLS, E2E_K = 131_072, 16_384, 16
E2E_CONFIG = dict(n_row_clusters=16, n_col_clusters=16, min_cocluster_rows=1024,
                  min_cocluster_cols=256, workers=132, assign_impl="pallas")
E2E_PLAN = (16, 8, 8192, 2048, 1)          # m, n, phi, psi, t_p it resolves to
ATOM_SHAPE = (128, 10_240, 5, 16)          # B, P = phi + psi, D = l, K at that plan
MERGE_SHAPE = (4, 2048, 64, 16)            # restarts, atoms, signature dim, K
SCALE_SHAPE = (128, 8192, 2048)            # the block stack

# The streaming cells: the dense cell's matrix as row chunks of 8,192 rows,
# each cut into 8 column blocks (the batch plan's 8,192 x 2,048 atom), and an
# out-of-core stream of 192 such chunks (96 GiB).
STREAM_CHUNK_ROWS, STREAM_COL_BLOCKS = 8192, 8
STREAM_KMEANS_SHAPE = (8, 10_240, 5, 16)   # B, P, D, K of one chunk's atoms
STREAM_SCALE_SHAPE = (8, 8192, 2048)       # one chunk's block stack
OOC_CHUNKS = 192                           # 1,572,864 rows
ELASTIC_AFTER = 4                          # chunks folded before the elastic checkpoint

# The distributed cells: ranks spawned on one card (gloo; NCCL refuses two
# ranks on one device) wait at most this long for each other; the results
# every distributed run must give exactly.
DIST_TIMEOUT_S = 600
DIST_EXACT = ("row_labels", "col_labels", "row_votes", "col_votes", "row_membership",
              "col_membership")
SERVE_SLICES = 4                           # cluster slices of the sharded service
SERVE_P50_REQUESTS = 50
OOC_PEAK_GIB = 16
STREAM_SPANS = ("blocks", "atoms", "reservoir", "align", "votes", "columns")

# The single-card sparse LAMC cell: the dense cell's matrix with each entry
# kept with probability 0.1, on the planner's default workers=1.
SPARSE_DENSITY = 0.1
SPARSE_CONFIG = dict(n_row_clusters=16, n_col_clusters=16, min_cocluster_rows=1024,
                     min_cocluster_cols=256, assign_impl="pallas", input_format="bcoo")
SPARSE_PLAN = (1, 1, 131_072, 16_384, 1)   # m, n, phi, psi, t_p it resolves to
SPARSE_RANK = 6                            # l + 1 for k = 16
SPARSE_KMEANS_SHAPE = (1, 147_456, 5, 16)  # B, P = M + N, D = l, K
SPMM_RTOL = 1e-5                           # with an absolute floor of 1e-5 * max|plain|

# The served model is the dense cell's: q = signature_dim = 64 anchors and
# K = 16 clusters on both axes. (P, q, K, k_top) of the cosine kernels: the
# served batches P = 1, 64, 1024 at k_top = 1, 4, 16; the reference's
# envelope (src/repro/analysis/vmem.py:209-222); a ragged q and K; K = 2000,
# more signature tiles (16 of 128) than a cluster scores in a pass (8); a
# k_top of 17, one above the running top-k's cap (cosine_max_k() = 16), so
# the scores go through the (P, K) scratch; a ragged P at the envelope's
# width. All are checked and timed; COSINE_PADDED is checked with k_valid < K.
COSINE_SHAPES = ([(p, 64, 16, kt) for p in (1, 64, 1024) for kt in (1, 4, 16)]
                 + [(4096, 1024, 1024, 8), (1024, 70, 13, 13), (4096, 1024, 2000, 8),
                    (1024, 64, 256, 17), (4000, 1024, 1000, 8)])
COSINE_PADDED = (1024, 64, 24, 16)      # 24 signature rows, the first 16 valid
COSINE_MAIN = {"cosine_assign": (64, 64, 16, 1), "cosine_topk": (64, 64, 16, 4)}
COSINE_ENVELOPE = {"cosine_assign": (4096, 1024, 1024, 1),
                   "cosine_topk": (4096, 1024, 1024, 8)}
COSINE_SCORE_RTOL = 1e-5       # of the dot product's scale sum_d |x_d s_kd|
COSINE_TIE_RTOL = 1e-6         # a label may differ only on a tie this near
SERVE_ROW_BATCHES = {1: 200, 64: 100, 1024: 40}   # batch rows -> requests
SERVE_COL_BATCH, SERVE_COL_REQUESTS = 64, 40
SERVICE_REQUESTS = 256

# k-means past one centroid slice and one feature slice (no K or D ceiling).
# d2 = |x|^2 - 2 x.c + |c|^2 cancels for a point that is a centroid; its
# float32 error is a few ulps of |x|^2 + |c|^2 ~ 2 D = 256 (ulp 3e-5), so the
# d2 check takes 1e-3 here where the D = 5 shapes take 1e-4.
KMEANS_WIDE_SHAPE = (8, 16_384, 128, 128)   # B, P, D, K
KMEANS_WIDE_D2_ATOL = 1e-3
# (B, P, D, K, weighted) at the edges of the two k-means tiles (narrow: D <= 16
# and K <= 32, 1,024 points a CTA; wide: 128 points x 128 centroids a pass):
# D = K = 1; P = 1 and 33 in each tile; one point past 10 narrow tiles; a
# ragged weighted wide shape (K = 100, D = 130); K = 300, three centroid passes.
KMEANS_EDGE_SHAPES = [(2, 3000, 1, 1, True), (3, 1, 5, 16, True), (3, 33, 5, 16, False),
                      (2, 10_241, 5, 16, True), (2, 1, 130, 100, True),
                      (2, 33, 130, 100, False), (2, 3000, 130, 100, True),
                      (2, 300, 128, 300, True)]

# Flash attention: (name, B, Hq, Hkv, S, Dh, dtype, causal, window); the
# first is the served prefill of lm_qwen3_4b_serve, the last two
# recurrentgemma-2b's local attention at full width (10/1 heads, Dh = 256,
# a 2,048-key window) over a 4,096-token prompt and at the served prefill of
# lm_recurrentgemma_2b_serve (window and ragged S together), then the served
# prefill of lm_deepseek_moe_16b_serve (16/16 heads).
FLASH_SHAPES = [("served", 4, 32, 8, 2048, 128, "bf16", True, 0),
                ("served_f32", 4, 32, 8, 2048, 128, "f32", True, 0),
                ("dh64_15_5", 4, 15, 5, 2048, 64, "bf16", True, 0),
                ("dh256", 4, 8, 1, 2048, 256, "bf16", True, 0),
                ("ragged_s1000", 4, 32, 8, 1000, 128, "bf16", True, 0),
                ("noncausal", 4, 32, 8, 2048, 128, "bf16", False, 0),
                ("rg2b_local", 1, 10, 1, 4096, 256, "bf16", True, 2048),
                ("rg2b_served", 4, 10, 1, 3000, 256, "bf16", True, 2048),
                ("ds16b_served", 4, 16, 16, 2048, 128, "bf16", True, 0)]
# The kernel each dtype must take: bf16 at Dh 64, 128 and 256 (aligned
# tensors) the wgmma kernel, float32 the float32 pipe.
FLASH_ROUTE = {"bf16": "wgmma", "f32": "f32_pipe"}
# (atol, rtol): float32 sums in another order; bf16 the reference's own
# tolerance for its bf16 flash test (an output rounds to bf16, one step of
# which is 2^-7 of its value, after P was rounded to bf16 for P V)
FLASH_TOL = {"f32": (1e-5, 0.0), "bf16": (2e-2, 2e-2)}

# The LM cell: qwen3-4b at full width and depth, batch 4, prompt 2048, 32 tokens.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen3-4b", 4, 2048, 32
LM_PARITY = dict(layers=2, batch=1, prompt=256, gen=4, logit_rtol=1e-3)
# The hybrid LM cell: recurrentgemma-2b at full width and depth, batch 4, a
# prompt of 3,000 (past the window and no multiple of it, so grow_cache's
# roll moves the local caches), 32 tokens; its parity run cut to the reduced
# config's 5 layers over 2,100 tokens (the roll moves them by 52).
LM_RG_ARCH, LM_RG_BATCH, LM_RG_PROMPT, LM_RG_GEN = "recurrentgemma-2b", 4, 3000, 32
LM_RG_PARITY = dict(layers=5, batch=1, prompt=2100, gen=8, logit_rtol=1e-3)
# The MoE LM cell: deepseek-moe-16b at full width and depth with its weights
# stored in bf16 (16.2 B parameters: float32 masters and a bf16 copy would
# need 97 GB), batch 4, prompt 2,048, 32 tokens; its parity run cut to the
# dense first layer and two MoE layers, float32 masters, 256 tokens (the
# prefill drops pairs at capacity factor 1.25).
LM_MOE_ARCH, LM_MOE_BATCH, LM_MOE_PROMPT, LM_MOE_GEN = "deepseek-moe-16b", 4, 2048, 32
LM_MOE_PARITY = dict(layers=3, batch=1, prompt=256, gen=8, logit_rtol=1e-3)


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


def graph_time(fn, iters: int, side) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed between CUDA events, so the host's cost of
    each call (argument checks, allocation, launch) is not in the time.
    Warm-up and capture run on the stream ``side``; callers pass the same
    one every time, since cuBLAS keeps a workspace for each stream it has
    run on."""
    import torch

    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()        # release the graph's memory pool before the next phase
    return start.elapsed_time(end) / (5 * iters)


def scratch_dir():
    """A temporary directory under the checkout's ``build/`` (which git
    ignores), removed on exit."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=ROOT / "build")


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


@contextlib.contextmanager
def call_events(module, name: str):
    """CUDA events around every call of ``module.name`` while open; yields
    the list of (start, end) pairs, to be read after a sync. A pair spans
    the call's device work and any wait of the stream for the host."""
    import torch

    pairs, inner = [], getattr(module, name)

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    setattr(module, name, timed)
    try:
        yield pairs
    finally:
        setattr(module, name, inner)


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
    with ThreadPoolExecutor(max_workers=4) as pool:
        # one nvcc per source, started together
        cuda = {name: pool.submit(lambda n=name: (_build.build(n), time.perf_counter() - t0))
                for name in ("kmeans", "spmm", "cosine", "flash_attention")}
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
    # the k-means entry points (their registers and spills follow each in
    # the report, which the build line prints)
    entries = [ln for ln in built["kmeans"][0][1].splitlines() if "entry function" in ln]
    for entry in ("kmeans_narrow_kernel", "kmeans_wide_kernel", "kmeans_reduce_kernel"):
        check(any(entry in ln for ln in entries), f"the ptxas report names no {entry}")
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


# The kernels the analysis phase's entry points launch (kernels 1-8).
ANALYSIS_KERNELS = ("kmeans_update", "kmeans_assign", "scale_apply", "cosine_assign",
                    "cosine_topk", "spmm", "spmm_t", "spmm_ata")
DISPATCH_COST_CALLS = 200_000


def phase_analysis(smi: str) -> tuple[dict, dict]:
    """``analysis`` (phase 2a); returns the launch counts of the audit's run
    and each entry's summary."""
    import torch
    from repro_torch import obs
    from repro_torch.analysis import ast_lint, cli, entry_points
    from repro_torch.kernels import ops

    lint, suppressed = ast_lint.run_ast_lint([str(ROOT / "src" / "repro_torch"),
                                             str(ROOT / "chip_smoke.py")])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    findings, details = cli.run_audits(None, "cuda")
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    # the host cost of one dispatch record (a cached labeled counter)
    t0 = time.perf_counter()
    for _ in range(DISPATCH_COST_CALLS):
        obs.kernel_dispatch("dispatch_cost", "cuda")
    dispatch_us = (time.perf_counter() - t0) / DISPATCH_COST_CALLS * 1e6
    entries = {rep.name: rep.summary() for rep in details["entries"]}
    emit("analysis", nvidia_smi=smi, audit_s=audit_s,
         findings=[f.to_dict() for f in lint + findings],
         lint_suppressed=[f"{f.path.split('src/')[-1]}:{f.line} [{f.rule}]"
                          for f in suppressed],
         entries=entries, recompiles=details["recompiles"], smem=details["smem"],
         launches=counts, kernel_dispatch_us=dispatch_us)
    check(not lint and not findings, f"{len(lint) + len(findings)} active findings")
    check(all(counts[name] > 0 for name in ANALYSIS_KERNELS),
          f"an analysis entry launched no kernel of {ANALYSIS_KERNELS}: {counts}")
    check(all(entries[name]["syncs"] == entries[name]["fences"]
              for name in entry_points.KERNEL_ENTRIES),
          "a kernel entry synchronized the card beyond its span fences")
    check(all(e["rebuilds"] == 0 for e in entries.values())
          and not any(details["recompiles"].values()), "a repeat call rebuilt")
    check(all(row.get("measured_static_bytes") is not None for row in details["smem"]),
          "an A4 row has no measurement")
    return counts, entries


def site_counts(sites: list) -> dict:
    """``{"file:line": syncs}`` of a ``dispatch_audit.count_syncs`` run."""
    return dict(sorted(Counter(sites).items()))


def _label_check(x, c, labels, want):
    """Labels equal on >= 99.99 % of points; the rest near-ties within
    1e-5 * (|x|^2 + |c|^2). Two labels that name equal centroid rows (the
    inputs draw centroids from the points, so at P < K some repeat) are the
    same answer: there the kernel must give the lower id, which its exact
    ties go to, and the plain version may give either."""
    import torch

    differ = labels != want
    if bool(differ.any()):
        rows = lambda ids: torch.gather(c, 1, ids.long()[..., None].expand(-1, -1, c.shape[2]))
        same_row = (rows(labels) == rows(want)).all(-1)
        check(bool((labels <= want)[differ & same_row].all()),
              "k-means label of a repeated centroid is not its lowest id")
        differ &= ~same_row
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


def check_kmeans_update(shape, weighted, gen, d2_atol: float = 1e-4):
    """The fused Lloyd step against its plain version, deterministic, its
    labels and d2 equal to ``kmeans_assign``'s; returns max |err|."""
    import torch
    from repro_torch.kernels import kmeans_assign, kmeans_update, ref

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
    for mine, theirs, atol in ((d2, rd, d2_atol), (sums, onehot.mT @ x, 1e-4),
                               (counts, onehot.sum(1), 1e-4)):
        torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=atol)
        err = max(err, (mine - theirs).abs().max().item())
    again = kmeans_update.kmeans_update(x, c, w)
    check(all(torch.equal(u, v) for u, v in zip(again, (labels, d2, sums, counts))),
          f"kmeans_update is not deterministic at {shape}")
    al, ad = kmeans_assign.kmeans_assign(x, c)
    check(bool(torch.equal(al, labels) and torch.equal(ad, d2)),
          f"kmeans_update's labels and d2 are not kmeans_assign's at {shape}")
    return x, c, w, err, frac


def check_kmeans_edges(gen) -> None:
    """Both k-means kernels at the edges of their two tiles
    (KMEANS_EDGE_SHAPES), against their plain versions."""
    import torch

    for b, p, d, k, weighted in KMEANS_EDGE_SHAPES:
        # d2 carries a few ulps of |x|^2 + |c|^2 ~ 2 D: the wide shapes take
        # the K = D = 128 row's 1e-3
        _, _, _, err, frac = check_kmeans_update((b, p, d, k), weighted, gen,
                                                 1e-4 if d <= 16 else KMEANS_WIDE_D2_ATOL)
        emit("kernel_check", name="kmeans_update+kmeans_assign", shape=[b, p, d, k],
             weighted=weighted, max_abs_err=err, label_mismatch=frac)
    torch.cuda.empty_cache()


def kmeans_rows(shape, gen, d2_atol: float = 1e-4) -> dict:
    """``kmeans_update`` and ``kmeans_assign`` at ``(B, P, D, K)``: checked
    against their plain versions, then timed beside their bounds. ``ms``,
    like the plain version's and the library call's, is the time per call
    launched one by one from Python between CUDA events, host cost included;
    ``device_ms`` is device time per call from CUDA-graph replay (at the
    atom and sparse shapes a call's host cost exceeds its device time)."""
    import torch
    from repro_torch.kernels import kmeans_assign, kmeans_update, ref

    rows = {}
    side = torch.cuda.Stream()
    b, p, d, k = shape
    x, c, w, err, frac = check_kmeans_update(shape, False, gen, d2_atol)
    bms, bby = bound(4 * (b * p * d + b * k * d + 2 * b * p + b * k * d + b * k),
                   b * p * (k * (2 * d + 3) + 2 * d + d + 1))
    rows["kmeans_update"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans.cu",
        replaces="src/repro/kernels/kmeans_update.py:79", max_abs_err=err,
        label_mismatch=frac, shape=list(shape),
        ms=cuda_time(lambda: kmeans_update.kmeans_update(x, c), 200),
        device_ms=graph_time(lambda: kmeans_update.kmeans_update(x, c), 200, side),
        plain_ms=cuda_time(lambda: ref.kmeans_update_ref(x, c), 50),
        bound_ms=bms, bound_by=bby, library_ms=None)

    labels, d2 = kmeans_assign.kmeans_assign(x, c)
    rl, rd = ref.kmeans_assign_ref(x, c)
    torch.cuda.synchronize()
    frac = _label_check(x, c, labels, rl)
    torch.testing.assert_close(d2, rd, rtol=1e-5, atol=d2_atol)
    bms, bby = bound(4 * (b * p * d + b * k * d + 2 * b * p), b * p * (k * (2 * d + 3) + 2 * d))
    rows["kmeans_assign"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans.cu",
        replaces="src/repro/kernels/kmeans_assign.py:59",
        max_abs_err=(d2 - rd).abs().max().item(), label_mismatch=frac,
        shape=list(shape),
        ms=cuda_time(lambda: kmeans_assign.kmeans_assign(x, c), 200),
        device_ms=graph_time(lambda: kmeans_assign.kmeans_assign(x, c), 200, side),
        plain_ms=cuda_time(lambda: ref.kmeans_assign_ref(x, c), 50),
        bound_ms=bms, bound_by=bby,
        library_ms=cuda_time(lambda: torch.cdist(x, c).argmin(-1), 50))
    for name in ("kmeans_update", "kmeans_assign"):
        emit("kernel", name=name, **rows[name])
    return rows


def phase_kernels(gen) -> dict:
    rows = kmeans_rows(ATOM_SHAPE, gen)

    # the merge k-means shape, weighted (the main path runs it on the plain
    # path, as the reference does; checked here so the weighted kernel is too)
    _, _, _, err, frac = check_kmeans_update(MERGE_SHAPE, True, gen)
    emit("kernel_check", name="kmeans_update", shape=list(MERGE_SHAPE), weighted=True,
         max_abs_err=err, label_mismatch=frac)
    check_kmeans_edges(gen)

    rows["scale_apply"] = scale_row(SCALE_SHAPE, gen)
    return rows


def scale_row(shape, gen) -> dict:
    """``scale_apply`` at ``(B, M, N)``: bit-equal to its plain version, then
    timed beside its bound, the plain version and ``einsum``."""
    import torch
    from repro_torch.kernels import bipartite_normalize, ref

    bs, m, n = shape
    a = torch.randn(shape, generator=gen, device="cuda")
    s1 = torch.rand((bs, m), generator=gen, device="cuda")
    s2 = torch.rand((bs, n), generator=gen, device="cuda")
    out = bipartite_normalize.scale_apply(a, s1, s2)
    want = ref.scale_apply_ref(a, s1, s2)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(bool(torch.equal(out, want)), f"scale_apply is not bit-equal (max err {err})")
    del out, want
    bms, bby = bound(4 * (2 * bs * m * n + bs * m + bs * n), 2 * bs * m * n)
    iters = max(10, 1280 // bs)
    row = dict(
        route="triton", source="src/repro_torch/kernels/bipartite_normalize.py",
        replaces="src/repro/kernels/bipartite_normalize.py:35", max_abs_err=err,
        shape=list(shape),
        ms=cuda_time(lambda: bipartite_normalize.scale_apply(a, s1, s2), iters),
        plain_ms=cuda_time(lambda: ref.scale_apply_ref(a, s1, s2), iters // 2),
        bound_ms=bms, bound_by=bby,
        library_ms=cuda_time(lambda: torch.einsum("bij,bi,bj->bij", a, s1, s2), iters // 2))
    emit("kernel", name="scale_apply", **row)
    del a, s1, s2
    torch.cuda.empty_cache()
    return row


def _cosine_inputs(p, q, k, gen):
    """Random points and unit signatures with an exact duplicate pair (ids 0
    and k - 1); the first points equal signature 0, so they tie exactly."""
    import torch

    x = torch.randn((p, q), generator=gen, device="cuda")
    s = torch.randn((k, q), generator=gen, device="cuda")
    s = s / torch.linalg.vector_norm(s, dim=1, keepdim=True)
    s[k - 1] = s[0]
    x[:8] = s[0]
    return x, s


def _cosine_check(x, s, labels, scores, want_labels, want_scores, what):
    """Scores within COSINE_SCORE_RTOL of the dot product's scale
    sum_d |x_d s_kd| (the bound its float32 rounding error grows with);
    labels equal except near ties, whose two plain scores lie within
    COSINE_TIE_RTOL of that scale. Returns (near ties, max |score err|)."""
    import torch

    p = x.shape[0]
    mine, want = labels.long().reshape(p, -1), want_labels.long().reshape(p, -1)
    full = x @ s.T
    scale = torch.gather(x.abs() @ s.abs().T, 1, want)
    err = (scores.reshape(scale.shape) - want_scores.reshape(scale.shape)).abs()
    check(bool((err <= COSINE_SCORE_RTOL * scale).all()),
          f"{what}: scores differ from plain beyond {COSINE_SCORE_RTOL} of the dot scale")
    differ = mine != want
    gap = (torch.gather(full, 1, mine) - torch.gather(full, 1, want)).abs()
    check(bool((gap <= COSINE_TIE_RTOL * scale)[differ].all()),
          f"{what}: a label differs from plain beyond a near tie")
    return int(differ.sum().item()), err.max().item()


def _cosine_padded(gen) -> dict:
    """k_valid < K: padded signature rows that would win every point are
    never chosen, and the labels are those of the unpadded signatures."""
    import torch
    from repro_torch.kernels import kmeans_assign, ref

    p, q, k, valid = COSINE_PADDED
    x, s = _cosine_inputs(p, q, valid, gen)
    pad = torch.cat([s, 10.0 * x[8:8 + k - valid]]).contiguous()
    got = {"assign": kmeans_assign.cosine_assign(x, pad, valid),
           "topk": kmeans_assign.cosine_topk(x, pad, valid, valid)}
    want = {"assign": ref.cosine_assign_ref(x, pad, valid),
            "topk": ref.cosine_topk_ref(x, pad, valid, valid)}
    unpadded = kmeans_assign.cosine_topk(x, s, valid)
    torch.cuda.synchronize()
    ties = 0
    for key in got:
        check(int(got[key][0].max()) < valid, f"cosine_{key}: a masked signature won")
        ties += _cosine_check(x, s, *got[key], *want[key], f"cosine_{key} k_valid")[0]
    check(torch.equal(got["topk"][0], unpadded[0]),
          "cosine_topk with k_valid differs from the unpadded signatures")
    return dict(shape=dict(P=p, q=q, K=k, k_valid=valid), near_ties=ties)


def _cosine_non_finite(gen) -> None:
    """Rows whose scores are NaN (a NaN feature), +inf/NaN/-inf (an inf
    feature against signatures whose first feature is positive, zero or
    negative) or all -inf: labels and scores equal the plain version's
    (NaN first, equal values to the lower id), every id in range and none
    twice in a row."""
    import torch
    from repro_torch.kernels import kmeans_assign, ref

    x, s = _cosine_inputs(64, 64, 16, gen)
    s[:, 0] = torch.tensor([0.5, 0.0, -0.5, 0.25] * 4, device="cuda")
    x[0, 3], x[1, 0], x[2, 0] = float("nan"), float("inf"), float("-inf")
    pos = s.clone()
    pos[:, 0] = 0.5
    for sigs in (s, pos):
        got = [kmeans_assign.cosine_assign(x, sigs)] + [
            kmeans_assign.cosine_topk(x, sigs, kt) for kt in (4, 16)]
        want = [ref.cosine_assign_ref(x, sigs)] + [
            ref.cosine_topk_ref(x, sigs, kt) for kt in (4, 16)]
        for (labels, scores), (wl, ws) in zip(got, want):
            check(torch.equal(labels[:3], wl[:3]) and torch.allclose(
                scores[:3], ws[:3], rtol=0, atol=0, equal_nan=True),
                  "cosine kernels: non-finite scores out of the plain order")
            _cosine_check(x[3:], sigs, labels[3:], scores[3:], wl[3:], ws[3:],
                          "cosine kernels beside non-finite rows")
        every = torch.arange(16, dtype=torch.int32, device="cuda").expand(64, 16)
        check(torch.equal(got[2][0].sort(dim=1).values, every),
              "cosine_topk: an id out of range or chosen twice")


def phase_kernels_cosine(gen) -> dict:
    """The serving scorers against their plain versions at every shape of
    COSINE_SHAPES (served, envelope, ragged, past a cluster, past the
    running top-k's cap), then timed beside bound, plain and library; one
    more shape checks k_valid."""
    import torch
    from repro_torch.kernels import _build, kmeans_assign, ref

    cap = _build.load("cosine").cosine_max_k()
    check(any(kt == cap + 1 for *_, kt in COSINE_SHAPES),
          f"no cosine shape has k_top = {cap + 1}, one above the running top-k's cap")
    rows = {name: dict(route="cuda", source="src/repro_torch/kernels/csrc/cosine.cu",
                       replaces=f"src/repro/kernels/kmeans_assign.py:{line}",
                       max_abs_err=0.0, near_ties=0, at_shapes=[])
            for name, line in (("cosine_assign", 168), ("cosine_topk", 132))}
    assign_done = set()
    side = torch.cuda.Stream()
    for shape in COSINE_SHAPES:
        p, q, k, k_top = shape
        x, s = _cosine_inputs(p, q, k, gen)
        labels, score = kmeans_assign.cosine_assign(x, s)
        top, top_s = kmeans_assign.cosine_topk(x, s, k_top)
        rl, rs = ref.cosine_assign_ref(x, s)
        tl, ts = ref.cosine_topk_ref(x, s, k_top)
        torch.cuda.synchronize()
        check(bool(torch.equal(top[:, 0], labels) and torch.equal(top_s[:, 0], score)),
              f"cosine_topk[:, 0] is not cosine_assign bit for bit at {shape}")
        check(bool((labels[:8] == 0).all()), f"exact ties did not go to the lower id at {shape}")
        check(bool((top_s[:, :-1] >= top_s[:, 1:]).all()),
              f"cosine_topk scores do not descend at {shape}")
        again = kmeans_assign.cosine_topk(x, s, k_top)
        check(bool(torch.equal(again[0], top) and torch.equal(again[1], top_s)),
              f"cosine_topk is not deterministic at {shape}")
        iters = 20 if q * k > 100_000 else 200
        for name, got, want, kt in (("cosine_assign", (labels, score), (rl, rs), 1),
                                    ("cosine_topk", (top, top_s), (tl, ts), k_top)):
            if name == "cosine_assign":
                if (p, q, k) in assign_done:
                    continue
                assign_done.add((p, q, k))
                kernel = lambda: kmeans_assign.cosine_assign(x, s)
                plain = lambda: ref.cosine_assign_ref(x, s)
                # the library pair: the product, then argmax with its score
                library = lambda: torch.max(torch.matmul(x, s.T), dim=1)
            else:
                kernel = lambda: kmeans_assign.cosine_topk(x, s, kt)
                plain = lambda: ref.cosine_topk_ref(x, s, kt)
                library = lambda: torch.topk(torch.matmul(x, s.T), kt, dim=1)
            ties, err = _cosine_check(x, s, *got, *want, f"{name} {shape}")
            row = rows[name]
            row["near_ties"] += ties
            row["max_abs_err"] = max(row["max_abs_err"], err)
            # bound: x and the signatures read once, labels and scores
            # written once; 2 P q K flops
            bms, bby = bound(4.0 * (p * q + k * q) + 8.0 * p * kt, 2.0 * p * q * k)
            row["at_shapes"].append(dict(
                shape=dict(P=p, q=q, K=k, k_top=kt), near_ties=ties, max_abs_err=err,
                ms=graph_time(kernel, iters, side), plain_ms=graph_time(plain, iters, side),
                library_ms=graph_time(library, iters, side), bound_ms=bms, bound_by=bby,
                eager_ms=cuda_time(kernel, iters), eager_plain_ms=cuda_time(plain, iters),
                eager_library_ms=cuda_time(library, iters)))
        del x, s
    padded = _cosine_padded(gen)
    _cosine_non_finite(gen)
    def entry(shape):
        p, q, k, kt = shape
        return next(e for e in row["at_shapes"] if e["shape"] == dict(P=p, q=q, K=k, k_top=kt))

    for name, row in rows.items():
        main, envelope = entry(COSINE_MAIN[name]), entry(COSINE_ENVELOPE[name])
        row["near_ties"] += padded["near_ties"]
        row.update(shape=main["shape"], k_valid_check=padded["shape"],
                   **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "eager_ms")},
                   at_envelope={key: envelope[key] for key in
                                ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")})
        emit("kernel", name=name, **row)
    torch.cuda.empty_cache()
    return rows


def _small_case():
    """A 512 x 384 planted matrix, a 2 x 2 plan and fixed random draws."""
    import numpy as np
    from repro_torch import interop
    from repro_torch.core import lamc
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
    return pc, plan, draws, lamc.LAMCConfig(4, 4, assign_impl="pallas")


def phase_parity():
    """A small planted matrix on the card and on the CPU, same draws."""
    import torch
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi

    pc, plan, draws, cfg = _small_case()
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


def phase_parity_serve():
    """The small case fitted, saved and loaded on the card and on the CPU:
    the same request batches get equal labels, and the checkpoint the card
    wrote loads on the CPU with the leaf hashes the CPU writes."""
    import numpy as np
    import torch
    from repro_torch import checkpoint, streaming
    from repro_torch.core import lamc

    pc, plan, draws, cfg = _small_case()
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(300, 384)).astype(np.float32) + pc.matrix[:300]
    cols = rng.normal(size=(200, 512)).astype(np.float32) + pc.matrix.T[:200]
    labels = {}
    with scratch_dir() as tmp:
        for dev in ("cuda", "cpu"):
            res = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws, device=dev)
            streaming.save_model(f"{tmp}/{dev}", streaming.model_from_result(res),
                                 cfg=cfg, plan=res.plan)
            model, _ = streaming.load_model(f"{tmp}/{dev}", device=dev)
            labels[dev] = [streaming.assign_rows(model, rows).labels.cpu(),
                           streaming.assign_cols(model, cols).labels.cpu(),
                           streaming.assign_rows_topk(model, rows, k=3).labels.cpu(),
                           streaming.assign_cols_topk(model, cols, k=4).labels.cpu()]
        torch.cuda.synchronize()
        host, _ = streaming.load_model(f"{tmp}/cuda", device="cpu")
        streaming.save_model(f"{tmp}/again", host, cfg=cfg, plan=plan)
        card_leaves = checkpoint.read_manifest(f"{tmp}/cuda", 0)["leaves"]
        again_leaves = checkpoint.read_manifest(f"{tmp}/again", 0)["leaves"]
    equal = [bool(torch.equal(a, b)) for a, b in zip(labels["cuda"], labels["cpu"])]
    emit("parity_serve", labels_equal=dict(zip(("rows", "cols", "rows_top3", "cols_top4"),
                                               equal)),
         leaf_hashes_equal=card_leaves == again_leaves)
    check(all(equal), f"serving labels on the card differ from the CPU path: {equal}")
    check(card_leaves == again_leaves,
          "the card's checkpoint does not load on the CPU with equal leaf hashes")


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
    return a, row_labels, col_labels, mu


def phase_e2e(seed: int):
    import torch
    from repro_torch.analysis import dispatch_audit
    from repro_torch.core import lamc
    from repro_torch.core.metrics import ari, nmi
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # warm-up at a small size: library handles and allocator, not timed
    wa, _, _, _ = planted_on_card(8192, 2048, 4, gen)
    lamc.lamc_cocluster(wa, lamc.LAMCConfig(4, 4, assign_impl="pallas"),
                        plan=lamc.partition.PartitionPlan(8192, 2048, 2, 2, 4096, 1024, 1))
    del wa
    a, row_truth, col_truth, mu = planted_on_card(E2E_ROWS, E2E_COLS, E2E_K, gen)
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
            "spmm": 0, "spmm_t": 0, "spmm_ata": 0, "cosine_assign": 0, "cosine_topk": 0,
            "flash_attention": 0}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(row_pred.shape == (E2E_ROWS,) and col_pred.shape == (E2E_COLS,),
          "label shapes")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8,
          f"NMI against the planted truth below 0.8: {scores}")
    # the implicit syncs of one fit at the cell's plan (untimed, after the
    # launch counts are read)
    _, sync_sites = dispatch_audit.count_syncs(lamc.lamc_cocluster, a, cfg)
    torch.cuda.synchronize()
    return counts, dict(result=res, config=cfg, matrix=a, row_truth=row_truth,
                        col_truth=col_truth, mu=mu, wall_s=wall, sync_sites=sync_sites)


def phase_kmeans_split(gen) -> dict:
    """The dense cell's k-means phase at its shape (ATOM_SHAPE: the fit's
    16 Lloyd steps over 128 blocks) on random points, split into the
    k-means++ seeding and the Lloyd steps with the final assignment:
    elapsed time between CUDA events around each part (so idle gaps while
    the host enqueues count), and the host's time to enqueue it. The second
    of two runs is reported."""
    import torch
    from repro_torch.core import kmeans as km
    from repro_torch.core import lamc
    from repro_torch.kernels import ops

    b, p, d, k = ATOM_SHAPE
    iters = lamc.LAMCConfig(**E2E_CONFIG).kmeans_iters
    x = torch.randn((b, p, d), generator=gen, device="cuda")
    for _ in range(2):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        seeds = km.kmeanspp_init(x, k, gen)
        events[1].record()
        t1 = time.perf_counter()
        res = km.kmeans(x, k, n_iter=iters, assign_impl="pallas", init=seeds, device=x.device)
        events[2].record()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    out = dict(shape=list(ATOM_SHAPE), iters=iters,
               seeding_ms=events[0].elapsed_time(events[1]),
               lloyd_and_assign_ms=events[1].elapsed_time(events[2]),
               host_enqueue_ms=dict(seeding=(t1 - t0) * 1e3, lloyd_and_assign=(t2 - t1) * 1e3),
               launches={name: counts[name] for name in ("kmeans_update", "kmeans_assign")})
    emit("kmeans_split", **out)
    check(out["launches"] == {"kmeans_update": iters, "kmeans_assign": 1},
          f"k-means launches {out['launches']}")
    check(bool(torch.isfinite(res.inertia).all()) and res.labels.shape == (b, p),
          "k-means split run gave no finite inertia")
    del x
    return out


def _service_request(i: int, rows_np, cols_np):
    """Request ``i`` of the mixed service stream: 16 rows (k = 1), 4 columns
    (k = 1) or 8 rows (top 4), in turn."""
    kind = i % 3
    if kind == 0:
        return "rows", 1, rows_np[(16 * i) % 4096:][:16]
    if kind == 1:
        return "cols", 1, cols_np[(4 * i) % 1024:][:4]
    return "rows", 4, rows_np[(8 * i) % 4096:][:8]


def phase_e2e_serve(cell: dict, seed: int, smi: str) -> dict:
    """Serve the dense cell's fitted model on the card (see the module doc)."""
    import threading

    import torch
    from repro_torch import obs, streaming
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lamc

    res, cfg, a = cell["result"], cell["config"], cell["matrix"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    # held-out rows drawn from the cell's own block means and column truth,
    # and 1,024 columns of the fitted matrix as column requests
    held_truth = torch.randint(0, E2E_K, (4096,), generator=gen, device="cuda")
    held = torch.randn((4096, E2E_COLS), generator=gen, device="cuda")
    held += cell["mu"][held_truth][:, cell["col_truth"]]
    pick = torch.randperm(E2E_COLS, generator=gen, device="cuda")[:1024]
    cols = a[:, pick].T.contiguous()
    keep = torch.rand((1024, E2E_COLS), generator=gen, device="cuda") < SPARSE_DENSITY
    sparse_rows = torch.where(keep, held[:1024], 0.0)
    coo = sparse_rows.to_sparse().coalesce()
    rows_np, cols_np = held.cpu().numpy(), cols.cpu().numpy()
    name = "lamc_dense_131k"
    calls = {"cosine_assign": 0, "cosine_topk": 0}
    lock = threading.Lock()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    ops.reset_launch_counts()
    with scratch_dir() as tmp:
        path = f"{tmp}/model"
        streaming.save_model(path, streaming.model_from_result(res), cfg=cfg, plan=res.plan)
        model, meta = streaming.load_model(path)
        latency = {}
        streams = [("rows", b, n) for b, n in SERVE_ROW_BATCHES.items()]
        streams.append(("cols", SERVE_COL_BATCH, SERVE_COL_REQUESTS))
        for axis, batch, requests in streams:
            out = serve_lamc.serve(path, batch=batch, requests=requests, warmup=3,
                                   axis=axis, seed=seed, adversarial=3 if axis == "rows" else 0)
            calls["cosine_assign"] += 3 + requests
            check(out[f"serve_assign_{axis}_rows"] == batch * requests,
                  f"serve {axis} b{batch}: rows served {out}")
            check(out[f"serve_assign_{axis}_errors"] == (3 if axis == "rows" else 0),
                  f"serve {axis} b{batch}: errors {out}")
            latency[f"{axis}_b{batch}"] = {
                key.split(f"serve_assign_{axis}_")[1]: value for key, value in out.items()
                if key.startswith("serve_assign_")}
        out = serve_lamc.serve_service(path, batch=64, requests=32, warmup=3, replicas=2)
        calls["cosine_assign"] += 1 + out["_batches"]     # its warm-up and its batches
        check(out["serve_svc_rows_rows"] == 32 * 16, f"serve_service: {out}")
        latency["service_rows_b64"] = {key.split("serve_svc_rows_")[1]: value
                                       for key, value in out.items()
                                       if key.startswith("serve_svc_rows_")}
        direct = dict(rows=streaming.assign_rows(model, held),
                      cols=streaming.assign_cols(model, cols),
                      rows_top4=streaming.assign_rows_topk(model, held, k=4),
                      cols_top16=streaming.assign_cols_topk(model, cols, k=16),
                      coo=streaming.assign_rows(model, coo),
                      coo_dense=streaming.assign_rows(model, sparse_rows),
                      empty=streaming.assign_rows(model, torch.zeros((0, E2E_COLS),
                                                                     device="cuda")))
        calls["cosine_assign"] += 4
        calls["cosine_topk"] += 2

        registry = streaming.ModelRegistry(f"{tmp}/registry")
        v1 = registry.publish(name, model, cfg=cfg)
        model2 = model._replace(row_sigs=torch.roll(model.row_sigs, 1, 0),
                                col_sigs=torch.roll(model.col_sigs, 1, 0))
        v2 = registry.publish(name, model2, cfg=cfg)
        first, _ = registry.load(name, v1.version)
        config = streaming.ServeConfig(batch=64, replicas=2)
        svc_metrics = obs.Registry()
        with streaming.AssignService(first, version=v1.version, config=config,
                                     metrics=svc_metrics) as svc:
            calls["cosine_assign"] += 1                  # warm-up of (rows, 1)
            score = svc._score_batch

            def counted(key, reqs):
                with lock:
                    calls["cosine_topk" if key[1] > 1 else "cosine_assign"] += 1
                score(key, reqs)

            def submit(i):
                axis, k, x = _service_request(i, rows_np, cols_np)
                return svc.submit(x, axis=axis, k=k)

            svc._score_batch = counted
            t0 = time.perf_counter()
            half = SERVICE_REQUESTS // 2
            tickets = [submit(i) for i in range(half)]
            for t in tickets[:3]:             # each kind scored: its scorer exists
                t.result(timeout=120.0)
            swap = svc.swap_async(lambda: registry.load(name, v2.version)[0], v2.version)
            tickets += [submit(i) for i in range(half, half + half // 2)]
            swapped = swap.result(timeout=120.0)
            tickets += [submit(i) for i in range(half + half // 2, SERVICE_REQUESTS)]
            results = [t.result(timeout=120.0) for t in tickets]
            service_s = time.perf_counter() - t0
            stats = svc.stats()
        # the swap warmed the three (axis, k) the old engine had served
        calls["cosine_assign"] += 2
        calls["cosine_topk"] += 1
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30

        check(meta["kind"] == streaming.MODEL_KIND, f"model kind {meta.get('kind')}")
        check(swapped.ok, f"swap failed: {swapped.detail}")
        models = {v1.version: first, v2.version: model2}
        by_version = {v1.version: 0, v2.version: 0}
        for i, r in enumerate(results):
            check(r.ok and r.version in models, f"service request {i}: {r.reason} {r.detail}")
            by_version[r.version] += 1
            axis, k, x = _service_request(i, rows_np, cols_np)
            fn = {("rows", True): streaming.assign_rows, ("cols", True): streaming.assign_cols,
                  ("rows", False): lambda m, v: streaming.assign_rows_topk(m, v, k=k)}
            want = fn[(axis, k == 1)](models[r.version], x).labels.cpu().numpy()
            check((r.labels == want).all(), f"service request {i} labels differ from "
                                            f"a direct call on {r.version}")
    check(by_version[v2.version] > 0 and by_version[v1.version] > 0,
          f"the swap was not mid-stream: {by_version}")

    labels = {key: r.labels for key, r in direct.items()}
    scores = dict(
        heldout_row_nmi=nmi(labels["rows"].cpu().numpy(), held_truth.cpu().numpy()),
        col_nmi_vs_fit=nmi(labels["cols"].cpu().numpy(),
                           res.col_labels[pick].cpu().numpy()))
    want = {"kmeans_update": 0, "kmeans_assign": 0, "scale_apply": 0, "spmm": 0,
            "spmm_t": 0, "spmm_ata": 0, "flash_attention": 0, **calls}
    emit("e2e_serve", cell=name, nvidia_smi=smi, model=dict(
        rows=model.n_rows, cols=model.n_cols, k_row=model.n_row_clusters,
        k_col=model.n_col_clusters, q_row=int(model.row_sigs.shape[1]),
        q_col=int(model.col_sigs.shape[1])),
         latency_us=latency, service=dict(
             requests=SERVICE_REQUESTS, replicas=2, batch=64, wall_s=service_s,
             qps_rows=stats["rows_served"] / service_s, p50_request_us=stats["p50_request_us"],
             p99_request_us=stats["p99_request_us"], batches=stats["batches"],
             mean_batch_fill_pct=stats["mean_batch_fill_pct"], by_version=by_version,
             **{f"batch_p{p}_us": svc_metrics.histogram(
                 "serve_svc_batch_latency_us").percentile(p) for p in (50, 99)}),
         max_memory_allocated_gib=peak, resident_at_start_gib=resident, launches=counts,
         **scores)
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(scores["heldout_row_nmi"] >= 0.8 and scores["col_nmi_vs_fit"] >= 0.8,
          f"serving quality below 0.8 NMI: {scores}")
    check(torch.equal(labels["rows_top4"][:, 0], labels["rows"])
          and torch.equal(labels["cols_top16"][:, 0], labels["cols"]),
          "top-k column 0 differs from the k = 1 labels")
    check(torch.equal(labels["coo"], labels["coo_dense"]),
          "a COO batch got other labels than its dense twin")
    check(tuple(labels["empty"].shape) == (0,), "zero-row batch")
    return counts


def _nmtf_small_case():
    """The small case with the NMTF atom's draws (each block's k-means++
    seeds as row and column indices) and the baselines' draws on the whole
    matrix (an SCC sketch and seeds into Z, NMTF row and column seeds)."""
    import dataclasses

    import numpy as np
    import torch

    pc, plan, draws, cfg = _small_case()
    rng = np.random.default_rng(3)
    seeds = lambda n: torch.from_numpy(np.stack(
        [[rng.permutation(n)[:4] for _ in range(4)] for _ in range(2)]))
    draws = dataclasses.replace(draws, omega=None, atom_seeds=None,
                                nmtf_row_seeds=seeds(256), nmtf_col_seeds=seeds(192))
    full = dict(omega=rng.normal(size=(384, 4)).astype(np.float32),
                seeds=rng.permutation(512 + 384)[:4],
                init=(rng.permutation(512)[:4], rng.permutation(384)[:4]))
    return pc, plan, draws, dataclasses.replace(cfg, atom="nmtf"), full


def phase_parity_nmtf():
    """LAMC with the NMTF atom, ``scc_full`` and ``nmtf_full`` on the small
    case, on the card and on the CPU with the same injected draws: the labels
    must be equal."""
    import torch
    from repro_torch.core import baselines, lamc
    from repro_torch.core.metrics import nmi

    pc, plan, draws, cfg, full = _nmtf_small_case()
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = {
            "lamc_nmtf": lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws,
                                             device=dev),
            "scc_full": baselines.scc_full(pc.matrix, 4, omega=full["omega"],
                                           seeds=full["seeds"], device=dev),
            "nmtf_full": baselines.nmtf_full(pc.matrix, 4, init=full["init"], device=dev)}
    torch.cuda.synchronize()
    out, equal = {}, {}
    for name in runs["cuda"]:
        for side, truth in (("row", pc.row_labels), ("col", pc.col_labels)):
            card = getattr(runs["cuda"][name], f"{side}_labels").cpu()
            host = getattr(runs["cpu"][name], f"{side}_labels")
            equal[f"{name}_{side}"] = bool(torch.equal(card, host))
            out[f"{name}_{side}_nmi_truth"] = nmi(card.numpy(), truth)
    emit("parity_nmtf", labels_equal=equal, **out)
    check(all(equal.values()), f"labels on the card differ from the CPU path: {equal}")


def _scores(row_pred, col_pred, row_truth, col_truth) -> dict:
    from repro_torch.core.metrics import cocluster_scores

    return cocluster_scores(row_pred.cpu().numpy(), col_pred.cpu().numpy(),
                            row_truth.cpu().numpy(), col_truth.cpu().numpy())


def phase_e2e_nmtf(cell: dict, seed: int) -> dict:
    """The dense cell's matrix through ``lamc_cocluster`` with the NMTF atom
    (the LAMC-PNMTF row of the paper's Table II), on phase 5's plan."""
    import torch
    from repro_torch.core import lamc
    from repro_torch.kernels import ops

    a = cell["matrix"]
    cfg = lamc.LAMCConfig(**E2E_CONFIG, atom="nmtf", seed=seed)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = lamc.lamc_cocluster(a, cfg, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    plan = res.plan
    scores = _scores(res.row_labels, res.col_labels, cell["row_truth"], cell["col_truth"])
    emit("e2e_nmtf", rows=E2E_ROWS, cols=E2E_COLS, k=E2E_K, config=dict(E2E_CONFIG, atom="nmtf"),
         plan=dict(m=plan.m, n=plan.n, phi=plan.phi, psi=plan.psi, t_p=plan.t_p),
         wall_s=wall, phase_ms=timer.ms(), held_before_gib=held,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, **scores)
    check((plan.m, plan.n, plan.phi, plan.psi, plan.t_p) == E2E_PLAN,
          f"plan resolved to {plan}, expected {E2E_PLAN}")
    # the NMTF atom is plain batched products and the "jnp" k-means, as in
    # the reference: no kernel of this slice's path runs in it
    check(not any(counts.values()), f"launch counts {counts}, expected none")
    check(res.row_labels.shape == (E2E_ROWS,) and res.col_labels.shape == (E2E_COLS,),
          "label shapes")
    check(scores["nmi"] > 0.4, f"LAMC-NMTF NMI against the planted truth <= 0.4: {scores}")
    return counts


def phase_baselines(cell: dict) -> dict:
    """``scc_full`` and ``nmtf_full`` on the dense cell's whole matrix: the
    paper's unpartitioned baselines, twice each (the second call is the warm
    one, whose phases are reported), beside phase 5's LAMC wall time."""
    import torch
    from repro_torch.core import baselines
    from repro_torch.kernels import ops

    a = cell["matrix"]
    out, counts = {}, {}
    for name, fn, bar in (("scc_full", baselines.scc_full, 0.6),
                          ("nmtf_full", baselines.nmtf_full, 0.5)):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            timer = PhaseTimer()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn(a, E2E_K, timer=timer)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts[name] = ops.launch_counts()
        scores = _scores(res.row_labels, res.col_labels, cell["row_truth"],
                         cell["col_truth"])
        out[name] = dict(wall_s=walls, phase_ms=timer.ms(), held_before_gib=held,
                         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                         lamc_wall_over_baseline=cell["wall_s"] / walls[-1],
                         launches=counts[name], **scores)
        emit("baseline", name=name, rows=E2E_ROWS, cols=E2E_COLS, k=E2E_K,
             lamc_wall_s=cell["wall_s"], **out[name])
        check(scores["nmi"] > bar, f"{name} NMI against the planted truth <= {bar}: {scores}")
    want = dict.fromkeys(counts["scc_full"], 0)
    check(counts["scc_full"] == dict(want, scale_apply=1),
          f"scc_full launch counts {counts['scc_full']}, expected one scale_apply")
    check(counts["nmtf_full"] == want, f"nmtf_full launch counts {counts['nmtf_full']}")
    return {name: counts["scc_full"][name] + counts["nmtf_full"][name] for name in want}


def _fit_small_case():
    """A 600 x 500 planted matrix, a stream config with chunks of 150 (two
    resamples of four column blocks each) and fixed random draws."""
    import numpy as np
    from repro_torch import interop, streaming
    from repro_torch.data import planted_cocluster_matrix

    pc = planted_cocluster_matrix(np.random.default_rng(0), 600, 500, k=5, d=5,
                                  signal=4.0, noise=0.6)
    cfg = streaming.StreamConfig(5, 5, chunk_resamples=2, seed=0, assign_impl="pallas")
    chunks, b, psi, rank = 4, cfg.blocks_per_chunk, 125, 4     # rank: l + 1 for k = 5
    rng = np.random.default_rng(4)
    draws = interop.stream_draws_from_numpy(
        perms=np.stack([[rng.permutation(500) for _ in range(2)] for _ in range(chunks)]),
        omega=rng.normal(size=(chunks, b, psi, rank)),
        atom_seeds=np.stack([[rng.permutation(150 + psi)[:5] for _ in range(b)]
                             for _ in range(chunks)]),
        anchor_cols=rng.permutation(500)[:64],
        align_seeds=np.stack([rng.permutation(chunks * b * 5)[:5] for _ in range(4)]),
        col_seeds=np.stack([rng.permutation(500)[:5] for _ in range(4)]))
    return pc, cfg, draws


def _models_equal(a, b) -> bool:
    import torch

    return all(x.dtype == y.dtype and bool(torch.equal(x, y)) for x, y in zip(a, b))


def phase_parity_fit():
    """The out-of-core fit on the small case (see the module doc)."""
    import io

    import torch
    from repro_torch import checkpoint, streaming
    from repro_torch.core.metrics import nmi
    from repro_torch.launch import serve_lamc
    from repro_torch.runtime.fault_tolerance import FailureInjector

    pc, cfg, draws = _fit_small_case()
    chunks = lambda dev, fmt="dense": streaming.iter_row_chunks(pc.matrix, 150, format=fmt,
                                                                 device=dev)
    models = {dev: streaming.fit(chunks(dev), cfg, draws=draws, device=dev)[0]
              for dev in ("cuda", "cpu")}
    coo, _ = streaming.fit(chunks("cuda", "bcoo"), cfg, draws=draws)
    plain, _ = streaming.fit(chunks("cuda"), cfg)
    torch.cuda.synchronize()
    equal = {f"{side}_card_vs_cpu": bool(torch.equal(
        getattr(models["cuda"], f"{side}_labels").cpu(), getattr(models["cpu"], f"{side}_labels")))
        for side in ("row", "col")}
    equal.update({f"{side}_coo_vs_dense": bool(torch.equal(
        getattr(coo, f"{side}_labels"), getattr(models["cuda"], f"{side}_labels")))
        for side in ("row", "col")})
    with scratch_dir() as tmp:
        inj = FailureInjector((1, 2))
        recovered, _ = streaming.fit(chunks("cuda"), cfg, ckpt_dir=f"{tmp}/fit", save_every=1,
                                     failure_injector=inj)
        host, folded = streaming.load_fit_state(f"{tmp}/fit", cfg, device="cpu")
        streaming.save_fit_state(f"{tmp}/again", host)
        hashes_equal = (checkpoint.read_manifest(f"{tmp}/fit", folded)["leaves"]
                        == checkpoint.read_manifest(f"{tmp}/again", folded)["leaves"])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            serve_lamc.fit_demo_model(f"{tmp}/demo")
        served = serve_lamc.serve(f"{tmp}/demo", batch=8, requests=4, warmup=1)
    recovered_equal = _models_equal(recovered, plain)
    emit("parity_fit", labels_equal=equal, recovered_equal=recovered_equal,
         failures_fired=sorted(inj._fired), fit_state_chunks=folded,
         leaf_hashes_equal=hashes_equal,
         row_nmi_truth=nmi(models["cuda"].row_labels.cpu().numpy(), pc.row_labels),
         col_nmi_truth=nmi(models["cuda"].col_labels.cpu().numpy(), pc.col_labels),
         fit_demo=printed.getvalue().strip(),
         fit_demo_serve=dict(rows=served["serve_assign_rows_rows"],
                             p50_us=served["serve_assign_rows_p50_us"]))
    check(all(equal.values()), f"fit labels differ: {equal}")
    check(recovered_equal and inj._fired == {1, 2},
          "the recovered fit on the card differs from the uninterrupted one")
    check(folded == 4 and hashes_equal,
          "the card's FitState does not load on the CPU with equal leaf hashes")
    check(served["serve_assign_rows_rows"] == 32, f"fit-demo serve: {served}")


def _span_ms(trace) -> dict:
    """Milliseconds per span name over a trace, for STREAM_SPANS."""
    out = dict.fromkeys(STREAM_SPANS, 0.0)
    for sp, _, _ in trace.walk():
        if sp.name in out:
            out[sp.name] += sp.duration_s * 1e3
    return out


def _stream_spans(fit_once) -> dict:
    """``fit_once()`` with ``obs`` spans on (each ``blocks``, ``atoms`` and
    finalize span ends in a device synchronization): span times, the wall
    time of that run. It runs before the timed run and warms it up (library
    handles, the allocator's pool)."""
    import torch
    from repro_torch import obs

    obs.configure(enabled=True)
    try:
        obs.reset_trace()
        t0 = time.perf_counter()
        fit_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = _span_ms(obs.current_trace())
    finally:
        obs.configure(enabled=False)
        obs.reset_trace()
    return dict(span_ms=spans, wall_s_with_spans=wall)


def _stream_config(seed: int):
    from repro_torch import streaming
    from repro_torch.core import lamc

    return streaming.stream_config_from_lamc(lamc.LAMCConfig(**E2E_CONFIG, seed=seed),
                                             col_blocks=STREAM_COL_BLOCKS)


def _stream_launches(chunks: int) -> dict:
    from repro_torch.core import lamc

    iters = lamc.LAMCConfig(**E2E_CONFIG).kmeans_iters
    return {"kmeans_update": chunks * iters, "kmeans_assign": chunks, "scale_apply": chunks,
            "spmm": 0, "spmm_t": 0, "spmm_ata": 0, "cosine_assign": 0, "cosine_topk": 0,
            "flash_attention": 0}


def phase_e2e_stream(cell: dict, seed: int, smi: str) -> dict:
    """The dense cell's resident matrix through the out-of-core fit (see the
    module doc)."""
    import torch
    from repro_torch import obs, streaming
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault_tolerance import FailureInjector

    a, res = cell["matrix"], cell["result"]
    cfg = _stream_config(seed)
    chunks = lambda: streaming.iter_row_chunks(a, STREAM_CHUNK_ROWS)
    first = next(chunks())
    check(first.untyped_storage().data_ptr() == a.untyped_storage().data_ptr(),
          "the stream's chunks are copies, not views of the resident matrix")
    del first
    spans = _stream_spans(lambda: streaming.fit(chunks(), cfg))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, stats = streaming.fit(chunks(), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_above = (torch.cuda.max_memory_allocated() - resident) / 2**30

    registry = obs.get_registry()
    failed_before = registry.counter("recovery_failures").value
    inj = FailureInjector((5, 11))
    with scratch_dir() as tmp:
        t0 = time.perf_counter()
        recovered, _ = streaming.fit(chunks(), cfg, ckpt_dir=f"{tmp}/fit", save_every=4,
                                     failure_injector=inj)
        torch.cuda.synchronize()
        recovered_wall = time.perf_counter() - t0
    failures = registry.counter("recovery_failures").value - failed_before
    recovered_equal = _models_equal(recovered, model)

    row_pred, col_pred = model.row_labels.cpu().numpy(), model.col_labels.cpu().numpy()
    scores = _scores(model.row_labels, model.col_labels, cell["row_truth"], cell["col_truth"])
    scores.update(row_nmi_vs_batch=nmi(row_pred, res.row_labels.cpu().numpy()),
                  col_nmi_vs_batch=nmi(col_pred, res.col_labels.cpu().numpy()))
    emit("e2e_stream", cell="lamc_stream_131k", nvidia_smi=smi, rows=E2E_ROWS, cols=E2E_COLS,
         k=E2E_K, chunk_rows=STREAM_CHUNK_ROWS, config=dataclasses.asdict(cfg),
         wall_s=wall, batch_wall_s=cell["wall_s"], wall_over_batch=wall / cell["wall_s"],
         fit_stats=stats._asdict(), peak_above_resident_gib=peak_above,
         resident_gib=resident / 2**30, launches=counts, **spans,
         recovery=dict(save_every=4, fail_at=[5, 11], failures=failures,
                       model_equal=recovered_equal, wall_s=recovered_wall),
         **scores)
    want = _stream_launches(E2E_ROWS // STREAM_CHUNK_ROWS)
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(stats.rows_seen == E2E_ROWS and stats.chunks == E2E_ROWS // STREAM_CHUNK_ROWS,
          f"fit stats {stats}")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8,
          f"stream NMI against the planted truth below 0.8: {scores}")
    check(recovered_equal and failures == 2 and inj._fired == {5, 11},
          f"the recovered stream differs from the uninterrupted one "
          f"(failures {failures}, fired {sorted(inj._fired)})")
    cell["stream_model"] = model
    return counts


# ----------------------------------------------------------- distributed LAMC


def _rank_main(fn, rank, world, store_path, args, out):
    """One spawned rank: join a gloo group through a FileStore, run ``fn``."""
    import datetime

    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        try:
            out.put((rank, "ok", fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the parent reports it and fails the phase
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, *args) -> list:
    """``fn(rank, *args)`` in ``world`` ranks spawned with the ``spawn``
    method (this process holds a CUDA context), joined in one gloo group:
    they share the card, which NCCL refuses. CUDA tensors in ``args`` reach
    the ranks through CUDA IPC; a rank takes the matrix out of its one-item
    list, so the last reference to it dies with the rank's function and the
    card's memory is released to this process. Returns the results in rank
    order; raises if a rank failed or gave nothing within
    ``DIST_TIMEOUT_S``; every rank is joined (or killed) before it
    returns."""
    import multiprocessing as mp
    import queue

    import torch

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with scratch_dir() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, f"{tmp}/store", args, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            for _ in range(world):
                try:
                    rank, status, value = out.get(timeout=DIST_TIMEOUT_S)
                except queue.Empty:
                    raise CheckFailed(f"{fn.__name__}: a rank gave no result within "
                                      f"{DIST_TIMEOUT_S} s") from None
                (results.__setitem__(rank, value) if status == "ok"
                 else errors.append(f"rank {rank}: {value}"))
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    torch.cuda.ipc_collect()
    check(not errors, "\n".join(errors))
    return [results[r] for r in range(world)]


def _result_arrays(res) -> dict:
    return {key: getattr(res, key).cpu().numpy() for key in DIST_EXACT}


def _dist_lamc_rank(rank, holder, mesh_shape, axes, block_axes, resample_axis, cfg_fields,
                    plan_fields, warm_fields):
    """One rank of a shared-card mesh: its own copy of its shard of ``a``, a
    small warm-up, then the timed ``distributed_lamc``."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.core import distributed, lamc
    from repro_torch.device import fp32_policy
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as _mesh
    from repro_torch.runtime import shardings

    fp32_policy()
    mesh = _mesh.make_test_mesh(*mesh_shape, device="cuda", shared_card=True, axes=axes)
    cfg = lamc.LAMCConfig(**cfg_fields)
    plan = lamc.partition.PartitionPlan(**plan_fields)
    places = distributed.input_placements(mesh, cfg, block_axes)
    a = holder.pop()
    local = shardings.local_shard(a, mesh, places).clone(memory_format=torch.contiguous_format)
    full_shape = tuple(a.shape)
    del a
    x = DTensor.from_local(local, mesh, places, run_check=False, shape=full_shape,
                           stride=(full_shape[1], 1))
    # warm-up at a small size: library handles, collectives, the allocator
    warm = lamc.partition.PartitionPlan(**warm_fields)
    w = torch.randn((warm.n_rows, warm.n_cols), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(rank + 7))
    distributed.distributed_lamc(mesh, w, lamc.LAMCConfig(4, 4, assign_impl="pallas"), warm,
                                 block_axes, resample_axis)
    del w
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    timer, stats = PhaseTimer(), {}
    t0 = time.perf_counter()
    res = distributed.distributed_lamc(mesh, x, cfg, plan, block_axes, resample_axis,
                                       timer=timer, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(result=_result_arrays(res), wall_s=wall, phase_ms=timer.ms(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                shard_gib=local.numel() * 4 / 2**30, shard_shape=list(local.shape),
                launches=ops.launch_counts(), stats=stats)


def _dist_launches(t_loc: int) -> dict:
    from repro_torch.core import lamc

    want = _stream_launches(t_loc)
    want["kmeans_update"] = t_loc * lamc.LAMCConfig(**E2E_CONFIG).kmeans_iters
    return want


def _equal_results(got: dict, want) -> dict:
    import numpy as np

    return {key: bool(np.array_equal(got[key], want[key] if isinstance(want, dict)
                                     else getattr(want, key).cpu().numpy()))
            for key in DIST_EXACT}


def phase_parity_dist_and_e2e(cell: dict, smi: str) -> dict:
    """``parity_dist`` and ``e2e_dist``: ``distributed_lamc`` on a one-rank
    NCCL mesh in this process (see the module doc)."""
    import torch.distributed as dist

    with scratch_dir() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            return _one_rank_phases(cell, smi)
        finally:
            dist.destroy_process_group()


def _one_rank_phases(cell: dict, smi: str) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed, lamc
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as _mesh

    mesh = _mesh.make_test_mesh(1, 1, device="cuda")
    check(dist.get_backend() == "nccl", "the one-rank mesh is not on NCCL")
    pc, plan, draws, cfg = _small_case()
    card = distributed.distributed_lamc(mesh, pc.matrix, cfg, plan, draws=draws)
    one = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws)
    host = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws, device="cpu")
    equal_card = _equal_results(_result_arrays(card), one)
    equal_cpu = {side: bool(torch.equal(getattr(card, f"{side}_labels").cpu(),
                                        getattr(host, f"{side}_labels")))
                 for side in ("row", "col")}
    emit("parity_dist", backend="nccl", mesh={"data": 1, "model": 1},
         equal_to_card_lamc=equal_card, labels_equal_to_cpu=equal_cpu)
    check(all(equal_card.values()), f"one-rank mesh against lamc_cocluster: {equal_card}")
    check(all(equal_cpu.values()), f"one-rank mesh labels against the CPU: {equal_cpu}")

    a, res = cell["matrix"], cell["result"]
    cfg = cell["config"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    timer, stats = PhaseTimer(), {}
    t0 = time.perf_counter()
    out = distributed.distributed_lamc(mesh, a, cfg, res.plan, timer=timer, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    equal = _equal_results(_result_arrays(out), res)
    scores = _scores(out.row_labels, out.col_labels, cell["row_truth"], cell["col_truth"])
    emit("e2e_dist", cell="lamc_dense_131k_dist", nvidia_smi=smi, backend="nccl",
         mesh={"data": 1, "model": 1}, plan=dataclasses.asdict(res.plan), wall_s=wall,
         batch_wall_s=cell["wall_s"], phase_ms=timer.ms(),
         peak_above_resident_gib=(torch.cuda.max_memory_allocated() - resident) / 2**30,
         resident_gib=resident / 2**30, launches=counts, equal_to_lamc_cocluster=equal,
         stats=stats, **scores)
    check(all(equal.values()), f"e2e_dist differs from lamc_cocluster: {equal}")
    check(counts == _dist_launches(res.plan.t_p), f"launch counts {counts}")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8, f"NMI: {scores}")
    return counts


def _batch_bits(a, plan, cfg, b_loc: int) -> dict:
    """Which batched library call of the atom gives other bits on the first
    ``b_loc`` blocks alone than inside the whole stack: the SVD's products,
    QR and small SVD, at the dense cell's first resample."""
    import torch
    from repro_torch.core import partition
    from repro_torch.kernels import ops

    blocks, _, _ = partition.extract_blocks(a, plan, 0)
    a_n, _, _ = ops.bipartite_normalize(blocks)
    del blocks
    r = cfg.atom_k.bit_length() + 1
    omega = torch.randn((a_n.shape[0], a_n.shape[2], r), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    out = {}
    y_all, y_part = a_n @ omega, a_n[:b_loc] @ omega[:b_loc]
    out["torch.matmul (bmm, A @ omega)"] = bool(torch.equal(y_all[:b_loc], y_part))
    q_all, q_part = torch.linalg.qr(y_all).Q, torch.linalg.qr(y_all[:b_loc]).Q
    out["torch.linalg.qr"] = bool(torch.equal(q_all[:b_loc], q_part))
    z_all, z_part = a_n.mT @ q_all, a_n[:b_loc].mT @ q_all[:b_loc]
    out["torch.matmul (bmm, A.T @ Q)"] = bool(torch.equal(z_all[:b_loc], z_part))
    p_all = q_all.mT @ a_n
    s_all, s_part = torch.linalg.svd(p_all, full_matrices=False), \
        torch.linalg.svd(p_all[:b_loc], full_matrices=False)
    out["torch.linalg.svd"] = all(bool(torch.equal(x[:b_loc], y)) for x, y in zip(s_all, s_part))
    del a_n
    torch.cuda.empty_cache()
    return {name: same for name, same in out.items()}


def phase_e2e_dist_shared4(cell: dict, smi: str) -> dict:
    """``e2e_dist_shared4``: the dense cell on four ranks sharing the card
    (see the module doc)."""
    import torch
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi

    a, res, cfg = cell["matrix"], cell["result"], cell["config"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    warm = lamc.partition.PartitionPlan(2048, 1024, 4, 2, 512, 512, 1)
    ranks = run_ranks(_dist_lamc_rank, 4, [a], (2, 2), ("data", "model"), ("data", "model"),
                      None, dataclasses.asdict(cfg), dataclasses.asdict(res.plan),
                      dataclasses.asdict(warm))
    phase_wall = time.perf_counter() - t0
    got = ranks[0]["result"]
    equal = _equal_results(got, res)
    same_on_ranks = all(_equal_results(r["result"], got) == dict.fromkeys(DIST_EXACT, True)
                        for r in ranks)
    nmi_vs_one = {side: nmi(got[f"{side}_labels"], getattr(res, f"{side}_labels").cpu().numpy())
                  for side in ("row", "col")}
    bits = None
    if not all(equal.values()):
        bits = _batch_bits(a, res.plan, cfg, 32)
    scores = _scores(torch.from_numpy(got["row_labels"]), torch.from_numpy(got["col_labels"]),
                     cell["row_truth"], cell["col_truth"])
    emit("e2e_dist_shared4", cell="lamc_dense_131k_dist_shared4", nvidia_smi=smi,
         backend="gloo (four ranks share one card, which NCCL refuses; collectives staged "
                 "through host memory, kernels on the card)",
         mesh={"data": 2, "model": 2}, b_loc=res.plan.blocks_per_resample // 4,
         phase_wall_s=phase_wall,
         ranks=[{key: r[key] for key in ("wall_s", "phase_ms", "peak_gib", "shard_gib",
                                         "shard_shape", "launches", "stats")} for r in ranks],
         scatter_bytes=sum(r["stats"].get("scatter_bytes_sent", 0) for r in ranks),
         equal_to_one_process=equal, same_on_every_rank=same_on_ranks,
         nmi_vs_one_process=nmi_vs_one, bits_at_b_loc_32_vs_128=bits, **scores)
    for r in ranks:
        check(r["launches"] == _dist_launches(1), f"rank launch counts {r['launches']}")
    check(same_on_ranks, "the ranks' results differ")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8, f"NMI: {scores}")
    if not all(equal.values()):
        # allowed only where a batched library call gives other bits at 32
        # blocks than at 128; the labels must then still agree closely
        check(bits is not None and not all(bits.values()),
              f"shared4 differs from the one-process run with no batched call to blame: {equal}")
        check(min(nmi_vs_one.values()) >= 0.99, f"shared4 against one process: {nmi_vs_one}")
    return ranks[0]["launches"]


def phase_e2e_dist_pods(cell: dict, smi: str) -> dict:
    """``e2e_dist_pods``: the dense cell at t_p = 2, one resample on each of
    two ranks sharing the card (see the module doc)."""
    import torch
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi

    a, res, cfg = cell["matrix"], cell["result"], cell["config"]
    plan = dataclasses.replace(res.plan, t_p=2)
    one = lamc.lamc_cocluster(a, cfg, plan=plan)
    one_arrays = _result_arrays(one)
    del one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    warm = lamc.partition.PartitionPlan(2048, 1024, 2, 1, 1024, 1024, 2)
    ranks = run_ranks(_dist_lamc_rank, 2, [a], (2, 1), ("pod", "data"), ("data",), "pod",
                      dataclasses.asdict(cfg), dataclasses.asdict(plan),
                      dataclasses.asdict(warm))
    phase_wall = time.perf_counter() - t0
    got = ranks[0]["result"]
    equal = _equal_results(got, one_arrays)
    nmi_vs_one = {side: nmi(got[f"{side}_labels"], one_arrays[f"{side}_labels"])
                  for side in ("row", "col")}
    scores = _scores(torch.from_numpy(got["row_labels"]), torch.from_numpy(got["col_labels"]),
                     cell["row_truth"], cell["col_truth"])
    emit("e2e_dist_pods", cell="lamc_dense_131k_dist_pods", nvidia_smi=smi,
         backend="gloo (two ranks share one card)", mesh={"pod": 2, "data": 1},
         resample_axis="pod", t_p=2, phase_wall_s=phase_wall,
         ranks=[{key: r[key] for key in ("wall_s", "phase_ms", "peak_gib", "shard_gib",
                                         "launches", "stats")} for r in ranks],
         equal_to_one_process=equal, nmi_vs_one_process=nmi_vs_one, **scores)
    for r in ranks:
        check(r["launches"] == _dist_launches(1), f"rank launch counts {r['launches']}")
        check(_equal_results(r["result"], got) == dict.fromkeys(DIST_EXACT, True),
              "the ranks' results differ")
    check(all(equal.values()), f"pods against the one-process t_p = 2 fit: {equal}")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8, f"NMI: {scores}")
    return ranks[0]["launches"]


def phase_serve_sharded(cell: dict, smi: str) -> dict:
    """``serve_sharded``: the dense cell's model in a service whose tables
    are cluster-sharded over four slices of the card (see the module doc)."""
    import numpy as np
    import torch
    from repro_torch import streaming
    from repro_torch.data import to_bcoo
    from repro_torch.kernels import ops
    from repro_torch.streaming import assign

    a = cell["matrix"]
    model = streaming.model_from_result(cell["result"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = (a[:1024] + torch.randn((1024, a.shape[1]), generator=gen, device="cuda")).cpu().numpy()
    cols = a[:, :64].T.contiguous().cpu().numpy()
    traffic = [(rows[:b], "rows", k) for b in (1, 64, 1024) for k in (1, 4)] + \
              [(cols, "cols", k) for k in (1, 4)]
    cfg = streaming.ServeConfig(batch=1024, replicas=1)
    answers, p50 = {}, {}
    counts = None
    for name, devices in (("unsharded", ["cuda:0"]), ("sharded", ["cuda:0"] * SERVE_SLICES)):
        with streaming.AssignService(model, config=cfg, devices=devices) as svc:
            for req in traffic:                                   # warm every scorer
                svc.submit(*req).result(timeout=60)
            ops.reset_launch_counts()
            answers[name] = [svc.submit(*req).result(timeout=60) for req in traffic]
            if name == "sharded":
                counts = ops.launch_counts()
            coo = assign._gather_anchor(to_bcoo(rows[:64], "cuda"), model.anchor_cols)
            answers[name] += [svc._engine.scorer("rows", k)(coo) for k in (1, 4)]
            lat = {}
            for b in (1, 64, 1024):
                times = []
                for _ in range(SERVE_P50_REQUESTS):
                    t0 = time.perf_counter()
                    svc.submit(rows[:b]).result(timeout=60)
                    times.append((time.perf_counter() - t0) * 1e6)
                lat[b] = float(np.percentile(times, 50))
            p50[name] = lat
            slices = [len(svc._engine.slices[axis]) for axis in ("rows", "cols")]
    equal = []
    for x, y in zip(answers["unsharded"], answers["sharded"]):
        if isinstance(x, streaming.ServeResult):
            equal.append(bool(x.ok and y.ok and np.array_equal(x.labels, y.labels)
                              and np.array_equal(x.scores.view(np.int32),
                                                 y.scores.view(np.int32))))
        else:
            equal.append(all(bool(torch.equal(u, v)) for u, v in zip(x, y)))
    emit("serve_sharded", cell="lamc_dense_131k_serve_sharded", nvidia_smi=smi,
         slices=SERVE_SLICES, slices_per_axis=slices,
         requests=[dict(rows=len(r[0]), axis=r[1], k=r[2]) for r in traffic] + ["coo k=1",
                                                                                "coo k=4"],
         answers_equal=equal, p50_us=p50, launches=counts)
    check(slices == [SERVE_SLICES, SERVE_SLICES], f"tables not sharded: {slices}")
    check(all(equal), f"sharded answers differ from the unsharded engine's: {equal}")
    check(counts["cosine_assign"] > 0 and counts["cosine_topk"] > 0,
          f"the sharded engine launched no scorer: {counts}")
    return counts


def _elastic_rank(rank, holder, ckpt_dir, cfg_fields, first_chunk):
    """Restore the FitState onto a 4-rank ``data`` mesh (each rank its
    shards), continue the fit over the rest of ``a``'s chunks."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import checkpoint, streaming
    from repro_torch.device import fp32_policy
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as _mesh
    from repro_torch.runtime import fault_tolerance, shardings

    fp32_policy()
    _mesh.ensure_process_group("cuda", shared_card=True)
    mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("data",))
    step = checkpoint.latest_step(ckpt_dir)
    template, _ = checkpoint.restore_tree(ckpt_dir, step)
    specs = shardings.stream_state_specs(template, mesh)
    tree, extra = fault_tolerance.elastic_restore(ckpt_dir, step, template, mesh, specs)
    sharded = {name: list(leaf.to_local().shape) for name, leaf in tree.items()
               if isinstance(leaf, DTensor) and any(p.is_shard() for p in leaf.placements)}
    cfg = streaming.StreamConfig(**cfg_fields)
    a = holder.pop()
    ops.reset_launch_counts()
    fitter = streaming.StreamingCocluster.from_state_tree(
        cfg, tree, chunk_format=extra["chunk_format"], chunk_dtype=extra["chunk_dtype"])
    for i, chunk in enumerate(streaming.iter_row_chunks(a, STREAM_CHUNK_ROWS)):
        if i >= first_chunk:
            fitter.partial_fit(chunk)
    model, _ = fitter.finalize()
    torch.cuda.synchronize()
    return dict(model={f: getattr(model, f).cpu().numpy() for f in model._fields},
                sharded_local_shapes=sharded, step=step, launches=ops.launch_counts())


def phase_elastic(cell: dict, seed: int, smi: str) -> dict:
    """``elastic``: the ``lamc_stream_131k`` fit checkpointed after 4
    chunks, restored onto four ranks sharing the card and continued (see the
    module doc)."""
    import numpy as np
    from repro_torch import streaming

    a, want = cell["matrix"], cell["stream_model"]
    cfg = _stream_config(seed)
    fitter = streaming.StreamingCocluster(cfg)
    for i, chunk in enumerate(streaming.iter_row_chunks(a, STREAM_CHUNK_ROWS)):
        if i == ELASTIC_AFTER:
            break
        fitter.partial_fit(chunk)
    with scratch_dir() as tmp:
        streaming.save_fit_state(f"{tmp}/fit", fitter)
        del fitter
        t0 = time.perf_counter()
        ranks = run_ranks(_elastic_rank, 4, [a], f"{tmp}/fit", dataclasses.asdict(cfg),
                          ELASTIC_AFTER)
        wall = time.perf_counter() - t0
    equal = [{f: bool(np.array_equal(r["model"][f], getattr(want, f).cpu().numpy()))
              for f in want._fields} for r in ranks]
    emit("elastic", cell="lamc_stream_131k_elastic", nvidia_smi=smi,
         backend="gloo (four ranks share one card)", restored_step=ranks[0]["step"],
         sharded_local_shapes=ranks[0]["sharded_local_shapes"], phase_wall_s=wall,
         launches=[r["launches"] for r in ranks],
         model_equal_on_every_rank=[all(e.values()) for e in equal])
    check(ranks[0]["step"] == ELASTIC_AFTER, f"restored step {ranks[0]['step']}")
    check(ranks[0]["sharded_local_shapes"], "no leaf was sharded over the mesh")
    check(all(all(e.values()) for e in equal), f"elastic models differ: {equal}")
    want_counts = _stream_launches(E2E_ROWS // STREAM_CHUNK_ROWS - ELASTIC_AFTER)
    for r in ranks:
        check(r["launches"] == want_counts, f"elastic launch counts {r['launches']}")
    return ranks[0]["launches"]


def phase_e2e_stream_ooc(seed: int, smi: str) -> dict:
    """A 96 GiB planted stream drawn on the card chunk by chunk through the
    out-of-core fit (see the module doc)."""
    import torch
    from repro_torch import streaming
    from repro_torch.device import seeded_generator
    from repro_torch.kernels import ops

    cfg = _stream_config(seed)
    rows, cols, k = STREAM_CHUNK_ROWS, E2E_COLS, E2E_K
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    col_truth = (torch.arange(cols, device="cuda") % k)[
        torch.randperm(cols, generator=gen, device="cuda")]
    mu = torch.rand((k, k), generator=gen, device="cuda") * 4.0
    truth, draw_events = [], []

    def stream():
        """Chunk ``t``: balanced-in-expectation row labels, checkerboard means
        and N(0, 1) noise from a generator seeded by ``(seed, t)``."""
        truth.clear()
        draw_events.clear()
        for t in range(OOC_CHUNKS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            g = seeded_generator(dev, seed, t)
            labels = torch.randint(0, k, (rows,), generator=g, device="cuda")
            chunk = torch.randn((rows, cols), generator=g, device="cuda")
            chunk += mu[labels][:, col_truth]
            end.record()
            truth.append(labels)
            draw_events.append((start, end))
            yield chunk

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spans = _stream_spans(lambda: streaming.fit(stream(), cfg))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, stats = streaming.fit(stream(), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    draw_ms = sum(s.elapsed_time(e) for s, e in draw_events)
    scores = _scores(model.row_labels, model.col_labels, torch.cat(truth), col_truth)
    stream_gib = OOC_CHUNKS * rows * cols * 4 / 2**30
    emit("e2e_stream_ooc", cell="lamc_stream_1.5m_ooc", nvidia_smi=smi,
         rows=OOC_CHUNKS * rows, cols=cols, k=k, chunk_rows=rows, stream_gib=stream_gib,
         card_gib=torch.cuda.get_device_properties(0).total_memory / 2**30,
         config=dataclasses.asdict(cfg), wall_s=wall,
         rows_per_s=OOC_CHUNKS * rows / wall, draw_ms=draw_ms,
         fit_stats=stats._asdict(), max_memory_allocated_gib=peak,
         held_before_gib=held / 2**30, launches=counts, **spans, **scores)
    want = _stream_launches(OOC_CHUNKS)
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(stats.rows_seen == OOC_CHUNKS * rows and stats.chunks == OOC_CHUNKS
          and stats.peak_chunk_bytes == rows * cols * 4, f"fit stats {stats}")
    check(peak < OOC_PEAK_GIB, f"peak device memory {peak:.2f} GiB, limit {OOC_PEAK_GIB}")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8,
          f"out-of-core NMI against the planted truth below 0.8: {scores}")
    torch.cuda.empty_cache()
    return counts


def phase_kernels_stream(gen) -> dict:
    """Kernels 1-3 at the stream's chunk shape (B = 8)."""
    rows = kmeans_rows(STREAM_KMEANS_SHAPE, gen)
    rows["scale_apply"] = scale_row(STREAM_SCALE_SHAPE, gen)
    return rows


def _load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> dict:
    """Both example scripts on the card at their default sizes, in this
    process; each ``main`` returns the scores it prints."""
    import torch
    from repro_torch.kernels import ops

    out, counts = {}, {}
    for name in ("torch_quickstart", "torch_text_coclustering"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out[name] = _load_example(name).main([])
        torch.cuda.synchronize()
        out[name]["wall_s"] = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        out[name]["launches"] = counts[name]
    emit("examples", **out)
    quick = out["torch_quickstart"]
    check(quick["lamc_nmi"] >= 0.8 and quick["heldout_nmi"] >= 0.8,
          f"quickstart NMI below 0.8: {quick}")
    for name, c in counts.items():
        # the LAMC fit normalizes through scale_apply, assign_rows scores
        # through cosine_assign
        check(c["scale_apply"] >= 1 and c["cosine_assign"] == 1,
              f"{name} launch counts {c}")
    return {k: sum(c[k] for c in counts.values()) for k in counts["torch_quickstart"]}


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


def spmm_ata_band_cost(lazy, x, plan, cell_ms: float) -> dict:
    """What a band of ``spmm_ata`` costs with almost no bytes to move: the
    cell's bands and grid with one payload each (tile-row i at tile-col i mod
    n_tc), checked against the plain version, then timed beside the cell's
    time per band. Also the time to make a new operator's schedule (the work
    its first ``spmm_ata`` call adds)."""
    import torch
    from repro_torch.kernels import ref, spmm

    n_tr, n_tc = lazy.n_tiles
    rn = min(x.shape[1], 8)
    pick = torch.nonzero(lazy.block_cols.long() == lazy.block_rows.long() % n_tc).squeeze(1)
    check(pick.numel() == n_tr, "the sparse cell must occupy every tile")
    rows, cols = lazy.block_rows[pick], lazy.block_cols[pick]
    lone = spmm.BlockSparseMatrix(
        lazy.blocks[pick], rows, cols,
        torch.argsort(cols.long() * n_tr + rows.long()).to(torch.int32), lazy.shape,
        lazy.row_scale, lazy.col_scale)
    lone_plan = spmm.ata_plan(lone, spmm.ata_grid(lone), rn)
    check(lone_plan.n_bands == plan.n_bands and lone_plan.grid == plan.grid,
          f"one payload a band: plan {lone_plan} against the cell's {plan}")
    z, gram = spmm.spmm_ata(lone, x, with_gram=True)
    want_z, want_g = ref.spmm_ata_ref(lone, x, with_gram=True)
    err = _spmm_close(z, want_z, "spmm_ata, one payload a band")
    gerr = (gram - want_g).abs().max().item()
    check(gerr <= 1e-4 * want_g.abs().max().item(),
          f"spmm_ata, one payload a band: Gram max |err| {gerr}")
    ms = cuda_time(lambda: spmm.spmm_ata(lone, x, with_gram=True), 20)

    def new_schedule():
        lazy._ata_schedules.clear()
        spmm.ata_plan(lazy, plan.grid, rn)
        spmm.ata_schedule(lazy, plan.grid, plan.grp)

    return dict(bands=plan.n_bands, grid=plan.grid, payloads=n_tr, max_abs_err=err,
                max_abs_err_gram=gerr, ms=ms, us_per_band=1e3 * ms / plan.n_bands,
                cell_us_per_band=1e3 * cell_ms / plan.n_bands,
                schedule_ms=cuda_time(new_schedule, 5, warmup=1))


def phase_kernels_sparse(a, gen) -> tuple[dict, dict, list]:
    """The SpMM kernels at the sparse cell's shapes, on its own operator:
    unscaled, and with the normalization's scales lazy (the main path's
    form), each against its plain version; then timed. Also the k-means
    kernels at the cell's atom shape. Returns the rows, the k-means rows
    and the sync sites of the operator's conversion."""
    import torch
    from repro_torch.analysis import dispatch_audit
    from repro_torch.core import sparse, spectral
    from repro_torch.kernels import ref, spmm

    # no cache: the e2e run converts anew
    op, sync_sites = dispatch_audit.count_syncs(sparse.to_tiled, a)
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
                       ("spmm_ata", lambda o: torch.cat(spmm.spmm_ata(o, x, with_gram=True)))):
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
    plan = spmm.ata_plan(lazy, spmm.ata_grid(lazy), min(r, 8))
    for name, (kernel, plain, (lib_ms, lib_note)) in timed.items():
        bms, bby = bounds[name]
        rows[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/spmm.cu",
            replaces=f"src/repro/kernels/spmm.py:{lines[name]}", max_abs_err=errs[name],
            shape=dict(m=m, k=k, r=r, payloads=g, tile=[bm, bk], scaled=True),
            ms=cuda_time(kernel, 20), plain_ms=cuda_time(plain, 3, warmup=1),
            bound_ms=bms, bound_by=bby, library_ms=lib_ms,
            **({"library_note": lib_note} if lib_note else {}),
            **({"grid": plan.grid, "bands": plan.n_bands, "band_rows": plan.grp * plan.h,
                "lag": spmm.ATA_LAG, "ring_slots": dict(f=plan.nb, t=plan.tb, pieces=plan.cap)}
               if name == "spmm_ata" else {}))
        emit("kernel", name=name, **rows[name])
    emit("kernel_check", name="spmm_ata_band_cost",
         **spmm_ata_band_cost(lazy, x, plan, rows["spmm_ata"]["ms"]))
    del op, lazy, eager
    torch.cuda.empty_cache()
    kms = kmeans_rows(SPARSE_KMEANS_SHAPE, gen)
    return rows, kms, sync_sites


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
    from repro_torch.kernels import ops, spmm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    opcache.default_cache().clear()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    cfg = lamc.LAMCConfig(**SPARSE_CONFIG, seed=seed)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with call_events(spmm, "spmm_ata") as ata_calls, \
            call_events(spmm, "ata_schedule") as schedule_calls:   # inside the svd phase
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
         spmm_ata_call_ms=[start.elapsed_time(end) for start, end in ata_calls],
         ata_schedule_call_ms=[start.elapsed_time(end) for start, end in schedule_calls],
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, **scores)
    opcache.default_cache().clear()      # the cached operator holds ~10 GB
    got = (plan.m, plan.n, plan.phi, plan.psi, plan.t_p)
    check(got == SPARSE_PLAN and plan.spmm_route == "tiled",
          f"plan resolved to {plan}, expected {SPARSE_PLAN} route tiled")
    want = {"kmeans_update": cfg.kmeans_iters, "kmeans_assign": 1, "scale_apply": 0,
            "spmm": 1, "spmm_t": 1, "spmm_ata": cfg.svd_iters, "cosine_assign": 0,
            "cosine_topk": 0, "flash_attention": 0}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(row_pred.shape == (E2E_ROWS,) and col_pred.shape == (E2E_COLS,), "label shapes")
    check(scores["row_nmi"] >= 0.8 and scores["col_nmi"] >= 0.8,
          f"NMI against the planted truth below 0.8: {scores}")
    return counts


def phase_kernels_kmeans_wide(gen) -> dict:
    """Both k-means kernels at K = D = 128: several centroid and feature
    slices per CTA, against their plain versions, then timed."""
    import torch

    rows = kmeans_rows(KMEANS_WIDE_SHAPE, gen, KMEANS_WIDE_D2_ATOL)
    torch.cuda.empty_cache()
    return rows


def time_kmeans(src: Path, seed: int) -> int:
    """``--time-kmeans SRC``: the k-means wrappers of the tree whose ``src/``
    is SRC (they build into the ``build/`` beside it), timed as the
    ``kernel`` rows time them (``ms`` eager, ``device_ms`` by CUDA-graph
    replay) at ATOM_SHAPE, SPARSE_KMEANS_SHAPE and KMEANS_WIDE_SHAPE, on
    inputs from ``seed``; no check, no other phase. To compare two commits
    on one card, unpack the older one's tree under ``build/`` and run this
    for both trees in one call, in the order old, new, new, old."""
    import torch
    from repro_torch.kernels import kmeans_assign, kmeans_update

    gen = torch.Generator(device="cuda").manual_seed(seed)
    side = torch.cuda.Stream()
    for shape in (ATOM_SHAPE, SPARSE_KMEANS_SHAPE, KMEANS_WIDE_SHAPE):
        x, c, _ = _kmeans_inputs(shape, False, gen)
        for name, fn in (("kmeans_update", lambda: kmeans_update.kmeans_update(x, c)),
                         ("kmeans_assign", lambda: kmeans_assign.kmeans_assign(x, c))):
            emit("time_kmeans", src=str(src), name=name, shape=list(shape),
                 ms=cuda_time(fn, 200), device_ms=graph_time(fn, 200, side))
        del x, c
        torch.cuda.empty_cache()
    print(nvidia_smi(), flush=True)
    return 0


def time_dispatch(src: Path, seed: int) -> int:
    """``--time-dispatch SRC``: the two places where a dispatch record is
    paid, in the tree whose ``src/`` is SRC (it builds into the ``build/``
    beside it): ``ops.kmeans_update`` and ``ops.kmeans_assign`` eager at
    ATOM_SHAPE (through ``ops``, which meters each call's tier where the
    tree has ``obs.kernel_dispatch``), each three times in turn with its
    wrapper called directly, so that ``ops_ms - wrapper_ms`` is the ``ops``
    layer's host cost a call in one process; and the served latency at B = 1
    (``serve_lamc.serve``, SERVE_ROW_BATCHES[1] requests) of a model fitted
    on the dense cell's matrix from ``seed``; no check, no other phase. To
    compare two commits on one card, unpack the older one's tree under
    ``build/`` and run this for both trees in one call, in the order old,
    new, new, old."""
    import torch
    from repro_torch import streaming
    from repro_torch.core import lamc
    from repro_torch.kernels import kmeans_assign, kmeans_update, ops
    from repro_torch.launch import serve_lamc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, c, _ = _kmeans_inputs(ATOM_SHAPE, False, gen)
    for name, wrapper, via_ops in (
            ("kmeans_update", lambda: kmeans_update.kmeans_update(x, c),
             lambda: ops.kmeans_update(x, c)),
            ("kmeans_assign", lambda: kmeans_assign.kmeans_assign(x, c),
             lambda: ops.kmeans_assign(x, c))):
        times = {"wrapper_ms": [], "ops_ms": []}
        for _ in range(3):
            times["wrapper_ms"].append(cuda_time(wrapper, 200))
            times["ops_ms"].append(cuda_time(via_ops, 200))
        emit("time_dispatch", src=str(src), name=name, shape=list(ATOM_SHAPE), **times)
    del x, c
    a, _, _, _ = planted_on_card(E2E_ROWS, E2E_COLS, E2E_K, gen)
    cfg = lamc.LAMCConfig(**E2E_CONFIG, seed=seed)
    res = lamc.lamc_cocluster(a, cfg)
    del a
    with scratch_dir() as tmp:
        path = f"{tmp}/model"
        streaming.save_model(path, streaming.model_from_result(res), cfg=cfg, plan=res.plan)
        out = serve_lamc.serve(path, batch=1, requests=SERVE_ROW_BATCHES[1], warmup=3,
                               axis="rows", seed=seed)
    emit("time_dispatch", src=str(src), name="serve_rows_b1",
         **{key.split("serve_assign_rows_")[1]: value for key, value in out.items()
            if key.startswith("serve_assign_rows_") and key.endswith("_us")})
    print(nvidia_smi(), flush=True)
    return 0


def time_spmm(src: Path, seed: int) -> int:
    """``--time-spmm SRC``: ``spmm_ata(lazy, x, with_gram=True)`` of the tree
    whose ``src/`` is SRC (it builds into the ``build/`` beside it) at the
    sparse cell's operator (131,072 x 16,384 at density 0.1, lazy scales,
    rank 6), timed as the ``kernel`` rows time it (``ms`` eager, ``device_ms``
    by CUDA-graph replay), and one call from an idle card on a new operator
    over the same tensors (``first_call_ms``, what a fit's first call pays)
    and on this one (``idle_call_ms``), each the median of three; no check,
    no other phase. To compare two commits
    on one card, unpack the older one's tree under ``build/`` and run this for
    both trees in one call, in the order old, new, new, old."""
    import torch
    from repro_torch.core import sparse, spectral
    from repro_torch.kernels import spmm

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    coo, _, _ = planted_sparse_on_card(E2E_ROWS, E2E_COLS, E2E_K, SPARSE_DENSITY, gen)
    lazy, _, _ = spectral.normalize_bipartite(sparse.to_tiled(coo))
    del coo
    x = torch.linalg.qr(torch.randn((E2E_COLS, SPARSE_RANK), generator=gen,
                                    device="cuda")).Q.contiguous()
    fn = lambda: spmm.spmm_ata(lazy, x, with_gram=True)

    def one_call(new: bool) -> float:
        op = lazy
        if new:   # its segments made, as the fit's normalization makes them
            op = spmm.BlockSparseMatrix(lazy.blocks, lazy.block_rows, lazy.block_cols,
                                        lazy.t_order, lazy.shape, lazy.row_scale,
                                        lazy.col_scale)
            op.segments()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        spmm.spmm_ata(op, x, with_gram=True)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    emit("time_spmm", src=str(src), name="spmm_ata", shape=[E2E_ROWS, E2E_COLS, SPARSE_RANK],
         ms=cuda_time(fn, 20), device_ms=graph_time(fn, 20, torch.cuda.Stream()),
         first_call_ms=sorted(one_call(True) for _ in range(3))[1],
         idle_call_ms=sorted(one_call(False) for _ in range(3))[1])
    print(nvidia_smi(), flush=True)
    return 0


def live_pairs(sq: int, skv: int, causal: bool, kv_len: int | None = None,
               window: int = 0, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: the work the attention must do."""
    import numpy as np

    kv_len = skv if kv_len is None else kv_len
    qp = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(kv_len, qp + 1) if causal else np.full(sq, kv_len, np.int64)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def phase_kernels_flash(gen) -> dict:
    """The flash kernel against its plain version at FLASH_SHAPES, each timed
    beside its bound, the plain version and scaled_dot_product_attention
    (with an explicit mask where the shape has a window)."""
    import torch
    from repro_torch.kernels import flash_attention, ref

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    row = dict(route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:84", max_abs_err=0.0,
               at_shapes=[])
    for name, b, hq, hkv, s, dh, dt, causal, window in FLASH_SHAPES:
        dtype = dtypes[dt]
        kw = dict(causal=causal, window=window)
        q = torch.randn((b, hq, s, dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, dh), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, dh), generator=gen, device="cuda").to(dtype)
        got = flash_attention.flash_attention(q, k, v, **kw)
        route = flash_attention.last_route
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        atol, rtol = FLASH_TOL[dt]
        check(route == FLASH_ROUTE[dt], f"flash {name}: launched the {route} kernel, "
                                        f"expected {FLASH_ROUTE[dt]}")
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
        check(bool((diff <= atol + rtol * want.float().abs()).all()),
              f"flash {name}: max |err| {err} beyond atol {atol}, rtol {rtol}")
        again = flash_attention.flash_attention(q, k, v, **kw)
        check(bool(torch.equal(again, got)), f"flash {name} is not deterministic")
        del got, want, again
        # bound: q and o at Hq heads, k and v at Hkv heads, each moved once;
        # 4 Dh flops per live (query, key) pair (two products)
        elem = q.element_size()
        nbytes = elem * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)
        flops = 4.0 * b * hq * dh * live_pairs(s, s, causal, window=window)
        bms, bby = bound(nbytes, flops, BF16_FLOPS if dt == "bf16" else FP32_FLOPS)
        if window:
            pos = torch.arange(s, device="cuda")
            mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
            library = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            library = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        entry = dict(shape=dict(name=name, B=b, Hq=hq, Hkv=hkv, S=s, Dh=dh, dtype=dt,
                                causal=causal, window=window),
                     kernel=route, max_abs_err=err, bound_ms=bms, bound_by=bby,
                     ms=cuda_time(lambda: flash_attention.flash_attention(q, k, v, **kw), 5),
                     plain_ms=cuda_time(lambda: ref.flash_attention_ref(q, k, v, **kw),
                                        2, warmup=1),
                     library_ms=cuda_time(library, 5))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["at_shapes"].append(entry)
        emit("kernel_check", name="flash_attention", **entry)
        del q, k, v
        torch.cuda.empty_cache()
    main = row["at_shapes"][0]
    row.update({key: main[key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")})
    emit("kernel", name="flash_attention", **row)
    return {"flash_attention": row}


def _attention_layers(cfg) -> int:
    """The layers that launch the flash kernel in a prefill: the leading
    dense layers and the pattern's attention blocks."""
    from repro_torch.models import transformer

    return cfg.n_dense_layers + sum(kind != "rglru" for kind in transformer.block_kinds(cfg))


def phase_parity_lm(seed: int, arch: str = LM_ARCH, spec: dict = LM_PARITY,
                    phase: str = "parity_lm") -> None:
    """``arch`` at full width, cut to ``spec["layers"]`` layers, float32
    compute, on the card and on the CPU with the same weights: one flash
    launch per attention layer, prefill logits within ``spec["logit_rtol"]``
    of max|logit|, the same greedy tokens, and in an MoE model the same
    count of (token, k) pairs dropped by each MoE layer's prefill."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, moe

    cfg = dataclasses.replace(get_arch(arch), n_layers=spec["layers"])
    host = build_model(cfg, dtype=torch.float32, device="cpu")
    card = build_model(cfg, dtype=torch.float32, device="cuda")
    params_host = host.init(seed)
    params_card = copy.deepcopy(params_host).to("cuda")     # Module.to moves in place
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (spec["batch"], spec["prompt"])))
    ops.reset_launch_counts()
    with moe.count_dropped() as dropped_card:
        logits_card, _ = card.prefill(params_card, prompts.cuda())
    launches = ops.launch_counts()["flash_attention"]
    with moe.count_dropped() as dropped_host:
        logits_host, _ = host.prefill(params_host, prompts)
    torch.cuda.synchronize()
    dropped_card = [int(n) for n in dropped_card]
    dropped_host = [int(n) for n in dropped_host]
    scale = logits_host.abs().max().item()
    err = (logits_card.cpu() - logits_host).abs().max().item()
    out_card = serve._generate(card, params_card, prompts.cuda(), spec["gen"])
    out_host = serve._generate(host, params_host, prompts, spec["gen"])
    equal = bool((out_card["tokens"] == out_host["tokens"]).all())
    want = _attention_layers(cfg)
    emit(phase, arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
         batch=spec["batch"], prompt=spec["prompt"], compute="float32",
         max_abs_logit_err=err, max_abs_logit=scale, flash_launches=launches,
         tokens_card=out_card["tokens"].tolist(), tokens_cpu=out_host["tokens"].tolist(),
         **(dict(dropped_pairs_card=dropped_card, dropped_pairs_cpu=dropped_host,
                 pairs_per_layer=spec["batch"] * spec["prompt"] * cfg.experts_per_token)
            if cfg.is_moe else {}))
    check(launches == want, f"{phase}: {launches} flash launches, expected {want}")
    moe_layers = cfg.n_layers - cfg.n_dense_layers if cfg.is_moe else 0
    check(len(dropped_card) == moe_layers and dropped_card == dropped_host,
          f"{phase}: dropped pairs {dropped_card} on the card, {dropped_host} on the CPU")
    check(err <= spec["logit_rtol"] * scale,
          f"{phase}: logits differ by {err} (> {spec['logit_rtol']} x {scale})")
    check(equal, f"{phase}: greedy tokens on the card differ from the CPU's")
    check(out_card["logits_finite"] and out_host["logits_finite"], f"{phase}: logits")
    del params_card
    torch.cuda.empty_cache()


def phase_lm_serve(seed: int, smi: str, arch: str = LM_ARCH, batch: int = LM_BATCH,
                   prompt: int = LM_PROMPT, gen: int = LM_GEN,
                   cell: str = "lm_qwen3_4b_serve", param_dtype: str = "float32") -> dict:
    """An LM cell: the full ``arch`` served through ``launch.serve.generate``,
    its weights stored in ``param_dtype``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer

    cfg = get_arch(arch)
    built = sum(p.numel() for p in transformer.Transformer(cfg, device="meta").parameters())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with moe.count_dropped() as dropped:
        out = serve.generate(arch=arch, batch=batch, prompt_len=prompt, gen_len=gen,
                             use_reduced=False, seed=seed,
                             param_dtype=serve.PARAM_DTYPES[param_dtype])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    moe_layers = cfg.n_layers - cfg.n_dense_layers if cfg.is_moe else 0
    dropped = [int(n) for n in dropped]
    routing = dict(prefill_dropped_pairs=dropped[:moe_layers],
                   pairs_per_layer=batch * prompt * cfg.experts_per_token,
                   decode_dropped_pairs=sum(dropped[moe_layers:])) if moe_layers else {}
    emit(cell, cell=cell, nvidia_smi=smi, arch=arch,
         layers=cfg.n_layers, params=cfg.param_count(), params_built=built, batch=batch,
         prompt=prompt, gen=gen, compute="bfloat16",
         weights=("bf16" if param_dtype == "bfloat16" else "float32 masters + bf16 copy"),
         **routing,
         prefill_ms=out["prefill_s"] * 1e3, decode_s=out["decode_s"],
         decode_ms_per_step=out["decode_s"] * 1e3 / (gen - 1),
         decode_tokens_per_s=out["tokens_per_s"], wall_s=wall,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         logits_finite=out["logits_finite"], launches=counts,
         sample_tokens=out["tokens"][0][:8].tolist())
    want = {name: 0 for name in counts}
    want["flash_attention"] = _attention_layers(cfg)   # one prefill: one a layer
    check(counts == want, f"{cell}: launch counts {counts}, expected {want}")
    if moe_layers:     # one prefill call and gen - 1 decode calls a MoE layer
        check(len(dropped) == moe_layers * gen and routing["decode_dropped_pairs"] == 0,
              f"{cell}: dropped pairs {dropped}")
    check(out["tokens"].shape == (batch, gen), f"{cell}: tokens {out['tokens'].shape}")
    check(out["logits_finite"], f"{cell}: a logit is not finite")
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--time-kmeans", type=Path, metavar="SRC",
                        help="only time the k-means kernels of the tree whose src/ is SRC")
    parser.add_argument("--time-spmm", type=Path, metavar="SRC",
                        help="only time spmm_ata of the tree whose src/ is SRC")
    parser.add_argument("--time-dispatch", type=Path, metavar="SRC",
                        help="only time the ops k-means calls and the served p50 at "
                             "B = 1 of the tree whose src/ is SRC")
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
    sys.path.insert(0, str((args.time_kmeans or args.time_spmm or args.time_dispatch
                            or ROOT / "src").resolve()))
    from repro_torch.device import fp32_policy

    fp32_policy()
    if args.time_kmeans:
        return time_kmeans(args.time_kmeans, args.seed)
    if args.time_spmm:
        return time_spmm(args.time_spmm, args.seed)
    if args.time_dispatch:
        return time_dispatch(args.time_dispatch, args.seed)
    try:
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
             torch=torch.__version__, cuda=torch.version.cuda)
        phase_build()
        analysis_counts, audit_entries = phase_analysis(smi)
        rows = phase_kernels(torch.Generator(device="cuda").manual_seed(args.seed))
        phase_parity()
        dense_counts, dense_cell = phase_e2e(args.seed)
        phase_kmeans_split(torch.Generator(device="cuda").manual_seed(args.seed + 4))
        rows.update(phase_kernels_cosine(
            torch.Generator(device="cuda").manual_seed(args.seed + 3)))
        phase_parity_serve()
        serve_counts = phase_e2e_serve(dense_cell, args.seed, smi)
        phase_parity_nmtf()
        nmtf_counts = phase_e2e_nmtf(dense_cell, args.seed)
        baseline_counts = phase_baselines(dense_cell)
        phase_parity_fit()
        stream_counts = phase_e2e_stream(dense_cell, args.seed, smi)
        dist_counts = phase_parity_dist_and_e2e(dense_cell, smi)
        shared4_counts = phase_e2e_dist_shared4(dense_cell, smi)
        pods_counts = phase_e2e_dist_pods(dense_cell, smi)
        serve_sharded_counts = phase_serve_sharded(dense_cell, smi)
        elastic_counts = phase_elastic(dense_cell, args.seed, smi)
        dense_syncs = dense_cell["sync_sites"]
        del dense_cell
        torch.cuda.empty_cache()
        ooc_counts = phase_e2e_stream_ooc(args.seed, smi)
        stream_rows = phase_kernels_stream(
            torch.Generator(device="cuda").manual_seed(args.seed + 5))
        example_counts = phase_examples()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        cell = planted_sparse_on_card(E2E_ROWS, E2E_COLS, E2E_K, SPARSE_DENSITY, gen)
        sparse_rows, sparse_kmeans, conversion_syncs = phase_kernels_sparse(cell[0], gen)
        # the main path's implicit syncs beside the audit's (whose entries
        # run the reference's small shapes and plans)
        emit("syncs", nvidia_smi=smi,
             lamc_dense_131k_fit=dict(plan=E2E_PLAN, syncs=len(dense_syncs),
                                      sites=site_counts(dense_syncs)),
             lamc_sparse_131k_conversion=dict(syncs=len(conversion_syncs),
                                              sites=site_counts(conversion_syncs)),
             audit={name: dict(syncs=audit_entries[name]["syncs"],
                               sites=audit_entries[name].get("sync_sites", {}))
                    for name in ("lamc_dense", "tiled_convert")})
        phase_parity_sparse()
        sparse_counts = phase_e2e_sparse(*cell, args.seed)
        del cell
        torch.cuda.empty_cache()
        wide_kmeans = phase_kernels_kmeans_wide(gen)
        rows.update(phase_kernels_flash(gen))
        phase_parity_lm(args.seed)
        lm_counts = phase_lm_serve(args.seed, smi)
        phase_parity_lm(args.seed, LM_RG_ARCH, LM_RG_PARITY, "parity_lm_rg")
        lm_rg_counts = phase_lm_serve(args.seed, smi, LM_RG_ARCH, LM_RG_BATCH, LM_RG_PROMPT,
                                      LM_RG_GEN, "lm_recurrentgemma_2b_serve")
        phase_parity_lm(args.seed, LM_MOE_ARCH, LM_MOE_PARITY, "parity_lm_moe")
        lm_moe_counts = phase_lm_serve(args.seed, smi, LM_MOE_ARCH, LM_MOE_BATCH,
                                       LM_MOE_PROMPT, LM_MOE_GEN, "lm_deepseek_moe_16b_serve",
                                       param_dtype="bfloat16")
    except Exception:  # every failure ends the run with a nonzero exit
        traceback.print_exc()
        return 1
    rows.update(sparse_rows)
    cells = {"lamc_dense_131k": dense_counts, "lamc_sparse_131k_d0.1": sparse_counts,
             "lamc_dense_131k_serve": serve_counts, "lm_qwen3_4b_serve": lm_counts,
             "lm_recurrentgemma_2b_serve": lm_rg_counts,
             "lm_deepseek_moe_16b_serve": lm_moe_counts,
             "lamc_dense_131k_nmtf": nmtf_counts, "baselines_131k": baseline_counts,
             "examples": example_counts, "lamc_stream_131k": stream_counts,
             "lamc_stream_1.5m_ooc": ooc_counts, "lamc_dense_131k_dist": dist_counts,
             "lamc_dense_131k_dist_shared4": shared4_counts,
             "lamc_dense_131k_dist_pods": pods_counts,
             "lamc_dense_131k_serve_sharded": serve_sharded_counts,
             "lamc_stream_131k_elastic": elastic_counts,
             "analysis_audit": analysis_counts}
    summary = []
    for name, row in rows.items():
        # launches: per run of the first cell that launches the kernel
        by_cell = {cell: counts[name] for cell, counts in cells.items()}
        entry = dict(name=name, launches=next((n for n in by_cell.values() if n), 0),
                     launches_by_cell=by_cell, **row)
        if name in sparse_kmeans:
            entry["at_sparse_cell"] = {key: sparse_kmeans[name][key] for key in
                                       ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                        "max_abs_err", "library_ms")}
            entry["at_k128_d128"] = {key: wide_kmeans[name][key] for key in
                                     ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                      "max_abs_err", "library_ms", "label_mismatch")}
        if name in stream_rows:
            entry["at_stream_chunk"] = {key: stream_rows[name].get(key) for key in
                                        ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                         "max_abs_err", "library_ms")}
        summary.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
