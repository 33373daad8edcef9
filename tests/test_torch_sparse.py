"""The port's sparse path against the reference's, on the same numpy inputs.

COO helpers, sparse block extraction and the operator conversions must equal
the reference exactly (they move stored values, they do not add them) or to
``rtol=1e-6`` where they sum (degrees). Spectral results are compared by
principal angles; labels with every random draw of the reference injected
(``torch_parity``) must be equal. ``lamc_cocluster(input_format="bcoo")``
is held against the reference on a multi-block plan, a single-block tiled
plan and a single-block dual-ELL plan, and its multi-block labels against
the port's own dense run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity

from repro.core import LAMCConfig as JConfig
from repro.core import lamc_cocluster as jlamc_cocluster
from repro.core import partition as jpartition
from repro.core import sparse as jsparse
from repro.core import spectral as jspectral
from repro.core.partition import PartitionPlan as JPlan
from repro.data import planted_cocluster_matrix
from repro.data import to_bcoo as jto_bcoo
from repro_torch import interop
from repro_torch.core import lamc, partition, sparse, spectral
from repro_torch.data import to_bcoo
from repro_torch.kernels import ops

CPU = "cpu"
DENSITIES = [0.01, 0.05, 0.2]


def _rand_sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, n)) < density, rng.normal(size=(m, n)),
                    0.0).astype(np.float32)


def _planted(seed, m=300, n=200, density=0.2, k=4):
    return planted_cocluster_matrix(np.random.default_rng(seed), m, n, k=k,
                                    density=density, diagonal_only=True)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("density", DENSITIES)
def test_coo_helpers_match_reference(density):
    mat = _rand_sparse(int(density * 100), 257, 131, density)
    coo, ja = to_bcoo(mat, CPU), jto_bcoo(mat)
    assert sparse.is_bcoo(coo) and not sparse.is_bcoo(torch.from_numpy(mat))
    np.testing.assert_array_equal(coo.indices().numpy().T, np.asarray(ja.indices))
    np.testing.assert_array_equal(coo.values().numpy(), np.asarray(ja.data))
    assert sparse.density(coo) == jsparse.density(ja)
    for mine, theirs in zip(sparse.abs_degree_sums(coo), jsparse.abs_degree_sums(ja)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6)
    rng = np.random.default_rng(1)
    s1, s2 = rng.uniform(0.5, 2, 257).astype(np.float32), rng.uniform(0.5, 2, 131).astype(np.float32)
    scaled = sparse.scale_rows_cols(coo, torch.from_numpy(s1), torch.from_numpy(s2))
    assert scaled.is_coalesced()
    np.testing.assert_array_equal(scaled.values().numpy(), np.asarray(
        jsparse.scale_rows_cols(ja, jnp.asarray(s1), jnp.asarray(s2)).data))
    cols, rows = rng.permutation(131)[:17], rng.permutation(257)[:9]
    np.testing.assert_array_equal(
        sparse.gather_cols_dense(coo, torch.from_numpy(cols)).numpy(),
        np.asarray(jsparse.gather_cols_dense(ja, jnp.asarray(cols))))
    np.testing.assert_array_equal(
        sparse.gather_rows_dense(coo, torch.from_numpy(rows)).numpy(),
        np.asarray(jsparse.gather_rows_dense(ja, jnp.asarray(rows))))
    np.testing.assert_array_equal(sparse.gather_cols_dense(coo, torch.from_numpy(cols)).numpy(),
                                  mat[:, cols])


def test_validate_bcoo_contract():
    mat = _rand_sparse(2, 40, 30, 0.1)
    coo = to_bcoo(mat, CPU)
    assert sparse.validate_bcoo(coo) is coo
    dup = torch.sparse_coo_tensor(torch.tensor([[0, 0], [1, 1]]), torch.ones(2), (3, 3))
    for bad, match in ((torch.from_numpy(mat), "sparse_coo_tensor"),
                       (dup, "coalesced"),
                       (coo.to_sparse_csr(), "sparse_coo_tensor")):
        with pytest.raises(ValueError, match=match):
            sparse.validate_bcoo(bad)
    assert sparse.validate_spmm_impl("tiled") == "tiled"
    with pytest.raises(ValueError, match="spmm_impl"):
        sparse.validate_spmm_impl("csr")


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("grid", [(2, 2, 2), (3, 1, 1), (1, 4, 2)])
def test_extract_blocks_sparse_is_exact(density, grid):
    m, n, t_p = grid
    mat = _rand_sparse(int(density * 1000) + m, 300, 200, density)
    plan = JPlan(300, 200, m=m, n=n, phi=300 // m - 3, psi=200 // n - 2, t_p=t_p, seed=3)
    port_plan = interop.plan_from_numpy(plan)
    coo = to_bcoo(mat, CPU)
    for t in range(t_p):
        want, ri, ci = jpartition.extract_blocks_sparse(jto_bcoo(mat), plan, t)
        ri, ci = torch.from_numpy(np.array(ri)), torch.from_numpy(np.array(ci))
        got, _, _ = partition.extract_blocks_sparse(coo, port_plan, t, row_idx=ri, col_idx=ci)
        dense, _, _ = partition.extract_blocks(torch.from_numpy(mat), port_plan, t,
                                               row_idx=ri, col_idx=ci)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, dense)


@pytest.mark.parametrize("density", DENSITIES)
def test_dual_ell_matches_reference(density):
    mat = _rand_sparse(int(density * 100) + 9, 257, 131, density)
    coo, ja = to_bcoo(mat, CPU), jto_bcoo(mat)
    mine, theirs = sparse.to_ell(coo), jsparse.to_ell(ja)
    for f in ("row_vals", "row_cols", "col_vals", "col_rows"):
        np.testing.assert_array_equal(_np(getattr(mine, f)), np.asarray(getattr(theirs, f)), f)
    assert mine.shape == (257, 131) and sparse.is_ell(mine)
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(131, 6)).astype(np.float32), rng.normal(size=(257, 6)).astype(np.float32)
    np.testing.assert_allclose(sparse.ell_matvec(mine, torch.from_numpy(x)).numpy(),
                               np.asarray(jsparse.ell_matvec(theirs, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sparse.ell_rmatvec(mine, torch.from_numpy(y)).numpy(),
                               np.asarray(jsparse.ell_rmatvec(theirs, jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    for d, w in zip(sparse.ell_abs_degree_sums(mine), jsparse.ell_abs_degree_sums(theirs)):
        np.testing.assert_allclose(d.numpy(), np.asarray(w), rtol=1e-6)
    s1, s2 = rng.uniform(0.5, 2, 257).astype(np.float32), rng.uniform(0.5, 2, 131).astype(np.float32)
    got = sparse.ell_scale_rows_cols(mine, torch.from_numpy(s1), torch.from_numpy(s2))
    want = jsparse.ell_scale_rows_cols(theirs, jnp.asarray(s1), jnp.asarray(s2))
    np.testing.assert_array_equal(got.row_vals.numpy(), np.asarray(want.row_vals))
    np.testing.assert_array_equal(got.col_vals.numpy(), np.asarray(want.col_vals))


@pytest.mark.parametrize("density", DENSITIES)
def test_tiled_degrees_and_scales_match_reference(density):
    mat = _rand_sparse(int(density * 100) + 4, 300, 260, density)
    mine = sparse.to_tiled(to_bcoo(mat, CPU), 64, 64)
    theirs = jsparse.to_tiled(jto_bcoo(mat), 64, 64)
    for d, w in zip(sparse.tiled_abs_degree_sums(mine), jsparse.tiled_abs_degree_sums(theirs)):
        np.testing.assert_allclose(d.numpy(), np.asarray(w), rtol=1e-6)
        assert d.shape == w.shape
    rng = np.random.default_rng(3)
    s1, s2 = rng.uniform(0.5, 2, 300).astype(np.float32), rng.uniform(0.5, 2, 260).astype(np.float32)
    got = sparse.tiled_scale_rows_cols(mine, torch.from_numpy(s1), torch.from_numpy(s2))
    want = jsparse.tiled_scale_rows_cols(theirs, jnp.asarray(s1), jnp.asarray(s2))
    # on the CPU both fold the scales into the payloads, in the same order
    assert not got.has_scales and want.row_scale is None
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))


def _operators(mat):
    coo, ja = to_bcoo(mat, CPU), jto_bcoo(mat)
    return {"bcoo": (coo, ja), "dual_ell": (sparse.to_ell(coo), jsparse.to_ell(ja)),
            "tiled": (sparse.to_tiled(coo, 64, 64), jsparse.to_tiled(ja, 64, 64))}


@pytest.mark.parametrize("form", ["bcoo", "dual_ell", "tiled"])
def test_sparse_normalize_matches_reference(form):
    mat = _planted(6).matrix
    mine, theirs = _operators(mat)[form]
    a_n, s1, s2 = spectral.normalize_bipartite(mine, device=CPU)
    j_n, j1, j2 = jspectral.normalize_bipartite(theirs)
    assert s1.shape == (1, 300) and s2.shape == (1, 200)
    np.testing.assert_allclose(s1[0].numpy(), np.asarray(j1), rtol=1e-6)
    np.testing.assert_allclose(s2[0].numpy(), np.asarray(j2), rtol=1e-6)
    x = np.random.default_rng(4).normal(size=(200, 3)).astype(np.float32)
    dense = (np.asarray(j1)[:, None] * mat * np.asarray(j2)[None, :]) @ x
    if form == "bcoo":
        prod = a_n.to_dense().numpy() @ x
    elif form == "dual_ell":
        prod = sparse.ell_matvec(a_n, torch.from_numpy(x)).numpy()
    else:
        prod = ops.spmm_tiled(a_n, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(prod, dense, rtol=1e-5, atol=1e-5 * np.abs(dense).max())


def _principal_angles(u, v):
    qu, _ = np.linalg.qr(np.asarray(u, np.float64))
    qv, _ = np.linalg.qr(np.asarray(v, np.float64))
    sv = np.linalg.svd(qu.T @ qv, compute_uv=False)
    return np.arccos(np.clip(sv, -1.0, 1.0))


@pytest.mark.parametrize("form", ["bcoo", "dual_ell", "tiled"])
@pytest.mark.parametrize("qr_method", ["qr", "cholesky"])
def test_sparse_randomized_svd_with_injected_omega(form, qr_method):
    mat = _planted(7).matrix
    mine, theirs = _operators(mat)[form]
    key = jax.random.key(11)
    r = 4
    omega = np.asarray(jax.random.normal(key, (200, r), jnp.float32))
    ju, js, jvt = jspectral.randomized_svd(key, theirs, rank=r, n_iter=4, qr_method=qr_method)
    u, s, vt = spectral.randomized_svd(mine, rank=r, n_iter=4, qr_method=qr_method,
                                       omega=omega, device=CPU)
    assert u.shape == (1, 300, r) and vt.shape == (1, r, 200)
    np.testing.assert_allclose(s[0].numpy(), np.asarray(js), rtol=1e-4)
    assert _principal_angles(u[0].numpy(), ju).max() < 1e-3
    assert _principal_angles(vt[0].numpy().T, np.asarray(jvt).T).max() < 1e-3


@pytest.mark.parametrize("form", ["bcoo", "dual_ell", "tiled"])
def test_sparse_scc_labels_equal_with_injected_draws(form):
    pc = _planted(8)
    mine, theirs = _operators(pc.matrix)[form]
    key = jax.random.key(5)
    k, l = 4, 3
    ksvd, kkm1, _ = jax.random.split(key, 3)
    want = jspectral.scc(key, theirs, k, k, qr_method="cholesky")
    a_n, d1, d2 = jspectral.normalize_bipartite(theirs)
    u, _s, vt = jspectral.randomized_svd(ksvd, a_n, rank=l + 1, n_iter=4, qr_method="cholesky")
    z = jnp.concatenate([d1[:, None] * u[:, 1:], d2[:, None] * vt[1:].T], axis=0)
    seeds = torch_parity.seed_indices(z, torch_parity._kmeanspp(kkm1, z, k))
    got = spectral.scc(mine, k, k, qr_method="cholesky",
                       omega=np.asarray(jax.random.normal(ksvd, (200, l + 1), jnp.float32)),
                       seeds=seeds[None], device=CPU)
    np.testing.assert_array_equal(got.row_labels[0].numpy(), np.asarray(want.row_labels))
    np.testing.assert_array_equal(got.col_labels[0].numpy(), np.asarray(want.col_labels))


@pytest.mark.parametrize("form", ["bcoo", "dual_ell", "tiled"])
def test_sparse_exact_svd_raises(form):
    mine, _ = _operators(_rand_sparse(9, 60, 40, 0.1))[form]
    with pytest.raises(ValueError, match="exact"):
        spectral.scc(mine, 2, svd_method="exact", device=CPU)


@pytest.mark.parametrize("density", [0.05, 0.2])
@pytest.mark.parametrize("qr_method", ["qr", "cholesky"])
def test_lamc_bcoo_multi_block_matches_reference_and_dense(density, qr_method):
    pc = _planted(10, density=density)
    plan = JPlan(300, 200, m=2, n=2, phi=150, psi=100, t_p=2, seed=0)
    cfg = dict(n_row_clusters=4, n_col_clusters=4, qr_method=qr_method)
    want = jlamc_cocluster(jto_bcoo(pc.matrix), JConfig(**cfg, input_format="bcoo"), plan=plan)
    draws = interop.draws_from_numpy(**torch_parity.lamc_draws(pc.matrix, plan, JConfig(**cfg)))
    port_plan = interop.plan_from_numpy(plan)
    got = lamc.lamc_cocluster(to_bcoo(pc.matrix, CPU), lamc.LAMCConfig(**cfg, input_format="bcoo"),
                              plan=port_plan, draws=draws, device=CPU)
    dense = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**cfg), plan=port_plan,
                                draws=draws, device=CPU)
    for side in ("row", "col"):
        mine = getattr(got, f"{side}_labels").numpy()
        np.testing.assert_array_equal(mine, np.asarray(getattr(want, f"{side}_labels")))
        np.testing.assert_array_equal(mine, getattr(dense, f"{side}_labels").numpy())
    assert got.plan.spmm_route == want.plan.spmm_route == "dense"
    np.testing.assert_allclose(got.row_sigs.numpy(), np.asarray(want.row_sigs),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spmm_impl", ["tiled", "dual_ell"])
@pytest.mark.parametrize("density,qr_method", [(0.05, "cholesky"), (0.2, "qr"),
                                               (0.2, "cholesky")])
def test_lamc_bcoo_single_block_operator_matches_reference(spmm_impl, density, qr_method):
    pc = _planted(11, density=density)
    plan = JPlan(300, 200, m=1, n=1, phi=300, psi=200, t_p=2, seed=1)
    cfg = dict(n_row_clusters=4, n_col_clusters=4, input_format="bcoo",
               spmm_impl=spmm_impl, qr_method=qr_method, assign_impl="pallas")
    ja = jto_bcoo(pc.matrix)
    want = jlamc_cocluster(ja, JConfig(**cfg), plan=plan)
    draws = interop.draws_from_numpy(**torch_parity.operator_draws(ja, plan, JConfig(**cfg)))
    got = lamc.lamc_cocluster(to_bcoo(pc.matrix, CPU), lamc.LAMCConfig(**cfg),
                              plan=interop.plan_from_numpy(plan), draws=draws, device=CPU)
    assert got.plan.spmm_route == want.plan.spmm_route == spmm_impl
    for side in ("row", "col"):
        np.testing.assert_array_equal(getattr(got, f"{side}_labels").numpy(),
                                      np.asarray(getattr(want, f"{side}_labels")))


def test_operator_path_rejects_a_permuted_index_map():
    pc = _planted(12)
    plan = lamc.partition.PartitionPlan(300, 200, 1, 1, 300, 200, 1)
    rng = np.random.default_rng(0)
    draws = interop.draws_from_numpy(
        row_idx=rng.permutation(300).reshape(1, 1, 300),
        col_idx=np.arange(200).reshape(1, 1, 200),
        anchor_rows=rng.permutation(300)[:64], anchor_cols=rng.permutation(200)[:64])
    with pytest.raises(ValueError, match="does not permute"):
        lamc.lamc_cocluster(to_bcoo(pc.matrix, CPU),
                            lamc.LAMCConfig(4, 4, input_format="bcoo", spmm_impl="tiled"),
                            plan=plan, draws=draws, device=CPU)


def test_auto_route_and_plan_search_match_reference():
    pc = _planted(13, m=1024, n=512, density=0.05)
    kw = dict(n_row_clusters=4, n_col_clusters=4, min_cocluster_rows=200,
              min_cocluster_cols=100, input_format="bcoo", svd_iters=2, kmeans_iters=4)
    want = jlamc_cocluster(jto_bcoo(pc.matrix), JConfig(**kw))
    got = lamc.lamc_cocluster(to_bcoo(pc.matrix, CPU), lamc.LAMCConfig(**kw), device=CPU)
    assert got.plan == interop.plan_from_numpy(want.plan)
    assert got.row_labels.shape == (1024,) and got.col_labels.shape == (512,)


def test_input_format_mismatch_raises():
    mat = _rand_sparse(14, 60, 40, 0.1)
    plan = lamc.partition.PartitionPlan(60, 40, 1, 1, 60, 40, 1)
    with pytest.raises(ValueError, match="input_format='bcoo'"):
        lamc.lamc_cocluster(to_bcoo(mat, CPU), lamc.LAMCConfig(2, 2), plan=plan, device=CPU)
    with pytest.raises(ValueError, match="sparse_coo_tensor"):
        lamc.lamc_cocluster(mat, lamc.LAMCConfig(2, 2, input_format="bcoo"), plan=plan,
                            device=CPU)
