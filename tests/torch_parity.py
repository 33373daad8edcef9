"""The reference package's random draws, as numpy arrays for the port.

JAX's threefry bits cannot be reproduced in torch, so the port's parity
tests run the reference's own key derivations here and hand the results to
``repro_torch.interop.draws_from_numpy``. k-means++ seeds are returned as
point indices (the row of the embedding each seed centroid sits on), which
stay valid when the two packages' singular vectors differ in sign.
"""

from __future__ import annotations

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import kmeans as jkmeans
from repro.core import lamc as jlamc
from repro.core import merging as jmerging
from repro.core import partition as jpartition
from repro.core import probability as jprobability
from repro.core import sparse as jsparse
from repro.core import spectral as jspectral


def seed_indices(points, cents) -> np.ndarray:
    """Index of the point each seed centroid was drawn from."""
    p, c = np.asarray(points, np.float64), np.asarray(cents, np.float64)
    return np.argmin(((p[None, :, :] - c[:, None, :]) ** 2).sum(-1), axis=1)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _block_draws(blocks, keys, k, d, svd_iters, qr_method):
    """Per block: the sketch, the stacked embedding and the k-means++ seed
    centroids of the reference's ``spectral.scc`` under its block key."""
    l = max(k, d).bit_length()
    _b, phi, psi = blocks.shape

    def one(block, key):
        ksvd, kkm1, _ = jax.random.split(key, 3)
        omega = jax.random.normal(ksvd, (psi, min(l + 1, phi, psi)), block.dtype)
        a_n, d1i, d2i = jspectral.normalize_bipartite(block)
        u, _s, vt = jspectral.randomized_svd(ksvd, a_n, rank=l + 1,
                                             n_iter=svd_iters, qr_method=qr_method)
        z = jnp.concatenate([d1i[:, None] * u[:, 1 : l + 1],
                             d2i[:, None] * vt[1 : l + 1, :].T], axis=0)
        return omega, z, jkmeans.kmeanspp_init(kkm1, z, k)

    return jax.vmap(one)(blocks, keys)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _nmtf_block_draws(blocks, keys, k, d):
    """Per block: the shifted block and the row and column k-means++ seed
    centroids of the reference's ``nmtf`` under its block key."""

    def one(block, key):
        a = block - jnp.minimum(jnp.min(block), 0.0)
        kf, kg = jax.random.split(key)
        return a, jkmeans.kmeanspp_init(kf, a, k), jkmeans.kmeanspp_init(kg, a.T, d)

    return jax.vmap(one)(blocks, keys)


def nmtf_seeds(blocks, keys, k, d) -> tuple[np.ndarray, np.ndarray]:
    """The reference ``nmtf``'s k-means++ draws on each block under its key,
    as point indices: rows ``(B, k)`` and columns ``(B, d)`` of the block."""
    a, rows, cols = _nmtf_block_draws(jnp.asarray(blocks), keys, k, d)
    a = np.asarray(a)
    return (np.stack([seed_indices(ab, cb) for ab, cb in zip(a, rows)]),
            np.stack([seed_indices(ab.T, cb) for ab, cb in zip(a, cols)]))


_run_resample = jax.jit(jlamc.run_resample, static_argnums=(1, 2))
_kmeanspp = jax.jit(jkmeans.kmeanspp_init, static_argnums=2)


def merge_seeds(key, sigs, counts, k_global, n_restarts):
    """The reference merge k-means++ draws ``(n_restarts, k_global)`` as
    atom indices, for signatures ``(T_p, B, k, q)`` and counts."""
    flat = jnp.asarray(sigs).reshape(-1, sigs.shape[-1])
    w = jnp.asarray(counts).reshape(-1).astype(flat.dtype)
    keys = jax.random.split(key, n_restarts)
    return np.stack([seed_indices(flat, _kmeanspp(kk, flat, k_global, w))
                     for kk in keys])


def lamc_draws(a, plan, cfg) -> dict:
    """Every random draw of the reference's ``lamc_cocluster(a, cfg, plan)``
    as keyword arguments of ``interop.draws_from_numpy``: the SCC atom's
    sketches and seeds, or with ``cfg.atom == "nmtf"`` the NMTF atom's
    row and column seeds. ``a`` is dense; a ``bcoo`` run has the same draws
    (its blocks are the dense run's bit for bit)."""
    a = jnp.asarray(a)
    kar, kac, kmerge = jax.random.split(jax.random.key(plan.seed + 7), 3)
    anchor_rows = jmerging.anchor_indices(kar, plan.n_rows, cfg.signature_dim)
    anchor_cols = jmerging.anchor_indices(kac, plan.n_cols, cfg.signature_dim)
    row_idx, col_idx, atom, outs = [], [], [], []
    for t in range(plan.t_p):
        blocks, ri, ci = jpartition.extract_blocks(a, plan, t)
        row_idx.append(np.asarray(ri))
        col_idx.append(np.asarray(ci))
        kt = jax.random.fold_in(jax.random.key(plan.seed + 1), t)
        keys = jax.vmap(lambda b: jax.random.fold_in(kt, b))(
            jnp.arange(plan.blocks_per_resample))
        if cfg.atom == "nmtf":
            atom.append(nmtf_seeds(blocks, keys, cfg.atom_k, cfg.atom_d))
        else:
            om, z, cents = _block_draws(blocks, keys, cfg.atom_k, cfg.atom_d,
                                        cfg.svd_iters, cfg.qr_method)
            atom.append((np.asarray(om), np.stack(
                [seed_indices(zb, cb) for zb, cb in zip(z, cents)])))
        outs.append(_run_resample(a, plan, cfg, anchor_rows, anchor_cols, t))
    first, second = (np.stack(v) for v in zip(*atom))
    atom_draws = (dict(nmtf_row_seeds=first, nmtf_col_seeds=second)
                  if cfg.atom == "nmtf" else dict(omega=first, atom_seeds=second))
    kr, kc = jax.random.split(kmerge)
    stack = lambda name: np.stack([np.asarray(o[name]) for o in outs])
    return dict(
        row_idx=np.stack(row_idx), col_idx=np.stack(col_idx),
        anchor_rows=np.asarray(anchor_rows), anchor_cols=np.asarray(anchor_cols),
        **atom_draws,
        row_merge_seeds=merge_seeds(kr, stack("row_sigs"), stack("row_counts"),
                                    cfg.n_row_clusters, cfg.merge_restarts),
        col_merge_seeds=merge_seeds(kc, stack("col_sigs"), stack("col_counts"),
                                    cfg.n_col_clusters, cfg.merge_restarts),
    )


def operator_draws(a, plan, cfg) -> dict:
    """Every random draw of the reference's ``lamc_cocluster(a, cfg, plan)``
    for a BCOO ``a`` on a single-block plan that runs the atom on the sparse
    operator (``lamc.py:164-179``), as keyword arguments of
    ``interop.draws_from_numpy``.

    That path draws from block 0's key ``fold_in(fold_in(key(seed+1), t), 0)``
    and does not permute, so the index maps are ``arange`` reshapes. The
    sketch is the raw normal draw: both packages orthonormalize it before
    the first product. k-means++ seeds are point indices into ``Z``.
    """
    route = jprobability.resolve_spmm_route(
        cfg.spmm_impl, jsparse.density(a), float(plan.phi) * plan.psi,
        single=True, svd_method=cfg.svd_method)
    assert route != "dense", "the plan must run the operator path"
    op = jsparse.prepare_operator(a, route)
    kar, kac, kmerge = jax.random.split(jax.random.key(plan.seed + 7), 3)
    anchor_rows = jmerging.anchor_indices(kar, plan.n_rows, cfg.signature_dim)
    anchor_cols = jmerging.anchor_indices(kac, plan.n_cols, cfg.signature_dim)
    k = cfg.atom_k
    l = max(k, cfg.atom_d).bit_length()
    r = min(l + 1, plan.n_rows, plan.n_cols)
    a_n, d1i, d2i = jspectral.normalize_bipartite(op)
    omega, seeds, outs = [], [], []
    for t in range(plan.t_p):
        key_b = jax.random.fold_in(jax.random.fold_in(jax.random.key(plan.seed + 1), t), 0)
        ksvd, kkm1, _ = jax.random.split(key_b, 3)
        omega.append(np.asarray(jax.random.normal(ksvd, (plan.n_cols, r), jnp.float32))[None])
        u, _s, vt = jspectral.randomized_svd(ksvd, a_n, rank=l + 1, n_iter=cfg.svd_iters,
                                             qr_method=cfg.qr_method)
        z = jnp.concatenate([d1i[:, None] * u[:, 1 : l + 1],
                             d2i[:, None] * vt[1 : l + 1, :].T], axis=0)
        seeds.append(seed_indices(z, _kmeanspp(kkm1, z, k))[None])
        outs.append(_run_resample(a, plan, cfg, anchor_rows, anchor_cols, t,
                                  operator=op))
    kr, kc = jax.random.split(kmerge)
    stack = lambda name: np.stack([np.asarray(o[name]) for o in outs])
    return dict(
        row_idx=np.stack([np.arange(plan.n_rows).reshape(1, -1)] * plan.t_p),
        col_idx=np.stack([np.arange(plan.n_cols).reshape(1, -1)] * plan.t_p),
        anchor_rows=np.asarray(anchor_rows), anchor_cols=np.asarray(anchor_cols),
        omega=np.stack(omega), atom_seeds=np.stack(seeds),
        row_merge_seeds=merge_seeds(kr, stack("row_sigs"), stack("row_counts"),
                                    cfg.n_row_clusters, cfg.merge_restarts),
        col_merge_seeds=merge_seeds(kc, stack("col_sigs"), stack("col_counts"),
                                    cfg.n_col_clusters, cfg.merge_restarts),
    )


def stream_draws(chunks, cfg):
    """Every random draw of the reference's ``repro.streaming.fit`` over the
    dense numpy ``chunks`` under its ``StreamConfig`` ``cfg``, as keyword
    arguments of ``interop.stream_draws_from_numpy``, and the reference's
    fitter after folding them (``finalize()`` gives the reference's model).

    Chunk ``t``'s permutations come from ``fold_in(fold_in(key(seed), t),
    resample)``; its block keys from ``fold_in(fold_in(key(seed + 1), t),
    block)``, whose sketches and k-means++ seeds ``_block_draws`` gives. The
    alignment and column seeds are the merge k-means++ draws under
    ``fold_in(key(seed + 7), 2)`` and ``(..., 3)`` (``merge_seeds``).
    """
    sfit = importlib.import_module("repro.streaming.fit")
    fitter = sfit.StreamingCocluster(cfg)
    b, cb = cfg.blocks_per_chunk, cfg.col_blocks
    perms, omega, seeds = [], [], []
    for t, chunk in enumerate(chunks):
        chunk = np.asarray(chunk, np.float32)
        fitter.partial_fit(jnp.asarray(chunk))
        r, n = chunk.shape
        psi = n // cb
        key_t = jax.random.fold_in(jax.random.key(cfg.seed), t)
        p = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key_t, ri),
                                                        n))[: cb * psi]
                      for ri in range(cfg.chunk_resamples)])
        blocks = chunk[:, p.reshape(-1)].reshape(r, b, psi).transpose(1, 0, 2)
        kt = jax.random.fold_in(jax.random.key(cfg.seed + 1), t)
        keys = jax.vmap(lambda i: jax.random.fold_in(kt, i))(jnp.arange(b))
        om, z, cents = _block_draws(jnp.asarray(blocks), keys, cfg.atom_k, cfg.atom_d,
                                    cfg.svd_iters, cfg.qr_method)
        perms.append(p)
        omega.append(np.asarray(om))
        seeds.append(np.stack([seed_indices(zb, cb_) for zb, cb_ in zip(z, cents)]))
    kroot = jax.random.key(cfg.seed + 7)
    fill = max(fitter._res_fill, 1)
    feats_c = jnp.asarray(fitter._res_vals[:fill]).T
    feats_c = feats_c - jnp.mean(feats_c, axis=0, keepdims=True)
    feats_c = feats_c / jnp.maximum(jnp.linalg.norm(feats_c, axis=1, keepdims=True), 1e-12)
    draws = dict(
        perms=np.stack(perms), omega=np.stack(omega), atom_seeds=np.stack(seeds),
        anchor_cols=np.asarray(fitter._anchor_cols),
        align_seeds=merge_seeds(jax.random.fold_in(kroot, 2),
                                np.concatenate(fitter._atom_sigs),
                                np.concatenate(fitter._atom_cnts),
                                cfg.n_row_clusters, cfg.merge_restarts),
        col_seeds=merge_seeds(jax.random.fold_in(kroot, 3), feats_c,
                              np.ones(feats_c.shape[0], np.float32),
                              cfg.n_col_clusters, cfg.merge_restarts))
    return draws, fitter


@pytest.fixture(scope="module", autouse=True)
def release_compiled_code():
    """Give back the memory mappings of a test module's compiled JAX code at
    its start and end (import it into the module to use it): a worker that
    ran the reference's fuzz cases before crosses ``vm.max_map_count`` in
    the module's next compile, which kills the worker and fails the item it
    was running (ROADMAP.md queue 3)."""
    jax.clear_caches()
    yield
    jax.clear_caches()
