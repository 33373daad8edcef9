"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written kernel computes: the k-means and
scale kernels batched over a leading block dimension ``B``, the cosine
scorers on one ``(P, q)`` request batch, the SpMM family on one tile-level
sparse matrix, flash attention on ``(B, H, S, Dh)`` heads. ``ops.py`` runs them for tensors that lie on
the CPU; on the card they are the oracle the tests and ``chip_smoke.py``
hold the kernels against. They mirror the reference package's
``kernels/ref.py`` oracles.
"""

from __future__ import annotations

import torch

__all__ = ["kmeans_assign_ref", "kmeans_update_ref", "cosine_assign_ref",
           "cosine_topk_ref", "scale_apply_ref",
           "bipartite_normalize_ref", "spmm_ref", "spmm_block_ref", "sddmm_ref",
           "spmm_tiled_ref", "spmm_ata_ref", "flash_attention_ref"]


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment of ``x (B, P, D)`` to ``centroids (B, K, D)``.

    Returns ``(labels (B, P) int32, min squared distance (B, P))``; ties go to
    the lowest centroid id, as ``jnp.argmin`` breaks them.
    """
    x2 = torch.sum(x * x, dim=-1, keepdim=True)                  # (B, P, 1)
    c2 = torch.sum(centroids * centroids, dim=-1)                # (B, K)
    d2 = x2 - 2.0 * (x @ centroids.mT) + c2[:, None, :]          # (B, P, K)
    labels = torch.argmin(d2, dim=-1).to(torch.int32)
    return labels, torch.amin(d2, dim=-1).clamp_min(0.0)


def kmeans_update_ref(x: torch.Tensor, centroids: torch.Tensor,
                      weights: torch.Tensor | None = None):
    """One Lloyd step's statistics: ``(labels, d2, sums (B, K, D), counts (B, K))``.

    ``sums[b, k] = sum_{p: labels[b, p] == k} w[b, p] * x[b, p]`` and
    ``counts[b, k]`` the matching weight sum; ``weights=None`` weighs every
    point 1. Materializes the ``(B, P, K)`` one-hot the kernel avoids.
    """
    labels, d2 = kmeans_assign_ref(x, centroids)
    k = centroids.shape[1]
    ids = torch.arange(k, device=x.device)
    onehot = (labels[..., None] == ids).to(x.dtype)             # (B, P, K)
    if weights is not None:
        onehot = onehot * weights[..., None]
    sums = onehot.mT @ x                                         # (B, K, D)
    counts = torch.sum(onehot, dim=1)                            # (B, K)
    return labels, d2, sums, counts


def _cosine_scores(x: torch.Tensor, signatures: torch.Tensor,
                   k_valid: int | None) -> torch.Tensor:
    """``x @ signatures.T`` in float32, columns at and past ``k_valid`` set
    to -inf (the reference kernels' mask of padded signature rows).

    Each signature's scores are their own ``(1, q) @ (q, P)`` product of a
    batch over signatures, so a score's bits do not depend on how many
    signatures are scored with it (one ``(P, q) @ (q, K)`` product changes
    them with K on the CPU). The kernels keep the same property (one fmaf
    chain per score), which is what lets a cluster-sharded service give the
    unsharded answers bit for bit."""
    s = signatures.to(torch.float32)
    xs = torch.matmul(s[:, None, :], x.to(torch.float32).T[None])[:, 0].T   # (P, K)
    if k_valid is not None and k_valid < xs.shape[1]:
        xs[:, k_valid:] = -torch.inf
    return xs


def cosine_assign_ref(x: torch.Tensor, signatures: torch.Tensor,
                      k_valid: int | None = None):
    """Dot-score assignment of ``x (P, q)`` against unit signatures
    ``(K, q)``: ``(labels (P,) int32, score (P,))``, ``score[i] = max_k
    x[i] . signatures[k]`` over ``k < k_valid`` (all ``K`` by default); ties
    go to the lowest id (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does)."""
    xs = _cosine_scores(x, signatures, k_valid)
    return torch.argmax(xs, dim=-1).to(torch.int32), torch.amax(xs, dim=-1)


def cosine_topk_ref(x: torch.Tensor, signatures: torch.Tensor, k: int,
                    k_valid: int | None = None):
    """Top-``k`` dot-score assignment: ``(labels (P, k) int32, scores (P, k))``,
    descending, ties to the lower id, NaN first, over ``k < k_valid``.
    ``torch.topk`` does not document its tie order, so this takes the first
    ``k`` of a stable descending sort — the order of ``jax.lax.top_k`` on
    finite scores, of the reference kernel's argmax-and-mask and of the CUDA
    kernel. Column 0 equals :func:`cosine_assign_ref`."""
    xs = _cosine_scores(x, signatures, k_valid)
    scores, labels = torch.sort(xs, dim=1, descending=True, stable=True)
    return labels[:, :k].to(torch.int32), scores[:, :k]


def scale_apply_ref(a: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
    """``a (B, M, N) * s1 (B, M)[..., None] * s2 (B, N)[..., None, :]``,
    row scale first, as the reference formula associates it."""
    return a * s1[..., :, None] * s2[..., None, :]


def bipartite_normalize_ref(a: torch.Tensor, d1: torch.Tensor,
                            d2: torch.Tensor, eps: float = 1e-8):
    """``A * rsqrt(max(d1, eps))[:, None] * rsqrt(max(d2, eps))[None, :]``
    per block, from the raw degrees ``d1 (B, M)`` / ``d2 (B, N)``."""
    s1 = torch.rsqrt(torch.clamp_min(d1, eps))
    s2 = torch.rsqrt(torch.clamp_min(d2, eps))
    return scale_apply_ref(a, s1, s2)


def spmm_ref(data: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             n_out: int, b: torch.Tensor) -> torch.Tensor:
    """Element-level SpMM: ``out[rows[e]] += data[e] * b[cols[e]]``.

    ``(data, rows, cols)`` are the COO triplets of a sparse ``A`` whose output
    axis has ``n_out`` entries; ``A.T @ b`` is the same call with ``rows`` and
    ``cols`` swapped.
    """
    contrib = data.to(torch.float32)[:, None] * b.to(torch.float32)[cols]
    out = torch.zeros((n_out, b.shape[1]), dtype=torch.float32, device=b.device)
    return out.index_add_(0, rows, contrib)


def spmm_block_ref(blocks: torch.Tensor, block_rows: torch.Tensor,
                   block_cols: torch.Tensor, n_tile_rows: int, n_tile_cols: int,
                   b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Tile-level SpMM: one batched tile product and a tile segment sum.

    ``b`` must be padded to the tile grid on its contracted axis
    (``n_tile_cols * bk`` rows, or ``n_tile_rows * bm`` when ``transpose``);
    the output covers the whole padded grid of the other axis.
    """
    _g, bm, bk = blocks.shape
    bf = b.to(torch.float32)
    rows, cols = block_rows.long(), block_cols.long()
    if transpose:
        tiles = bf.reshape(n_tile_rows, bm, -1)
        contrib = torch.einsum("gab,gar->gbr", blocks, tiles[rows])
        out = torch.zeros((n_tile_cols, bk, bf.shape[1]), dtype=torch.float32,
                          device=b.device).index_add_(0, cols, contrib)
        return out.reshape(n_tile_cols * bk, -1)
    tiles = bf.reshape(n_tile_cols, bk, -1)
    contrib = torch.einsum("gab,gbr->gar", blocks, tiles[cols])
    out = torch.zeros((n_tile_rows, bm, bf.shape[1]), dtype=torch.float32,
                      device=b.device).index_add_(0, rows, contrib)
    return out.reshape(n_tile_rows * bm, -1)


def sddmm_ref(x: torch.Tensor, y: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """Values of ``x @ y.T`` at ``(rows, cols)``: ``(nnz,)``, never the
    dense product."""
    return torch.sum(x.to(torch.float32)[rows] * y.to(torch.float32)[cols], dim=-1)


def spmm_tiled_ref(a, b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """``A @ b`` (or ``A.T @ b``) for a ``kernels.spmm.BlockSparseMatrix``:
    pending scales materialized, ``b`` zero-padded to the tile grid, the
    padded output sliced off."""
    a = a.materialize_scales()
    m, k = a.shape
    bm, bk = a.tile_shape
    n_tr, n_tc = a.n_tiles
    pad = n_tr * bm - m if transpose else n_tc * bk - k
    bp = torch.nn.functional.pad(b.to(torch.float32), (0, 0, 0, pad))
    out = spmm_block_ref(a.blocks, a.block_rows, a.block_cols, n_tr, n_tc, bp,
                         transpose=transpose)
    return out[: k if transpose else m]


def spmm_ata_ref(a, x: torch.Tensor, with_gram: bool = False):
    """``z = A.T @ (A @ x)`` as two tile-level products; with ``with_gram``
    also ``z.T @ z``. Returns ``z`` or ``(z, gram)``."""
    a = a.materialize_scales()
    z = spmm_tiled_ref(a, spmm_tiled_ref(a, x), transpose=True)
    return (z, z.T @ z) if with_gram else z


_NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, kv_len: int | None = None, window: int = 0,
                        q_offset: int = 0, chunk_size: int = 1024) -> torch.Tensor:
    """Softmax attention of ``q (B, Hq, Sq, Dh)`` over ``k, v (B, Hkv, Skv,
    Dh)``, step by step as the reference's ``chunked_causal_attention``
    (``src/repro/models/attention.py:37``): KV heads repeated to ``Hq``, KV
    chunks of ``chunk_size`` (the last one zero-padded), scores
    ``(q . k) / sqrt(Dh)`` in float32 with masked entries set to ``-1e30``,
    a running max, normalizer and accumulator, then ``acc / max(l, 1e-30)``
    in q's dtype. A key is live if its position is below ``kv_len`` (``Skv``
    by default), with ``causal`` at most the query's position ``q_offset +
    i``, and with ``window > 0`` less than ``window`` behind it."""
    b, hq, sq, dh = q.shape
    skv = k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    if k.shape[1] != hq:
        rep = hq // k.shape[1]
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    scale = 1.0 / (dh ** 0.5)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    qf = q.to(torch.float32)
    m = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, dh), dtype=torch.float32, device=dev)
    for c0 in range(0, skv, chunk_size):
        pad = max(0, c0 + chunk_size - skv)
        k_i = torch.nn.functional.pad(k[:, :, c0:c0 + chunk_size].to(torch.float32),
                                      (0, 0, 0, pad))
        v_i = torch.nn.functional.pad(v[:, :, c0:c0 + chunk_size].to(torch.float32),
                                      (0, 0, 0, pad))
        k_pos = c0 + torch.arange(chunk_size, device=dev)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_i) * scale
        mask = (k_pos < kv_len)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_i)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
