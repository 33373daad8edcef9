"""Port stages against the reference package, on the reference's draws.

Each stage gets the same numpy inputs and, where it draws random numbers,
the reference's draws (``torch_parity``). Labels must be equal; subspaces
are compared by principal angles (singular-vector signs are free).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity

from repro.core import kmeans as jkmeans
from repro.core import merging as jmerging
from repro.core import metrics as jmetrics
from repro.core import partition as jpartition
from repro.core import spectral as jspectral
from repro.data import synthetic as jsynthetic
from repro_torch import interop
from repro_torch.core import kmeans as tkmeans
from repro_torch.core import merging as tmerging
from repro_torch.core import metrics as tmetrics
from repro_torch.core import partition as tpartition
from repro_torch.core import spectral as tspectral
from repro_torch.data import synthetic as tsynthetic
from torch_parity import release_compiled_code  # noqa: F401 (autouse)

CPU = "cpu"

PLAN_CASES = [
    dict(n_rows=131072, n_cols=16384, min_cocluster_rows=1024,
         min_cocluster_cols=256, workers=132, k=16),       # the chip cell
    dict(n_rows=131072, n_cols=16384, min_cocluster_rows=1024,
         min_cocluster_cols=256, workers=1, k=16),
    dict(n_rows=600, n_cols=500, min_cocluster_rows=120, min_cocluster_cols=100,
         p_thresh=0.9, workers=4, k=5),
    dict(n_rows=4096, n_cols=2048, min_cocluster_rows=64, min_cocluster_cols=64,
         workers=8, seed=3, expected_failed_blocks=2, k=8),
    dict(n_rows=1000, n_cols=1000, min_cocluster_rows=8, min_cocluster_cols=8,
         svd_method="exact", k=4),
]


@pytest.mark.parametrize("kw", PLAN_CASES)
def test_make_plan_is_field_equal(kw):
    mine = tpartition.make_plan(**kw)
    theirs = jpartition.make_plan(**kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert interop.plan_from_numpy(theirs) == mine
    assert tpartition.coverage_probability(mine) == \
        jpartition.coverage_probability(theirs)


def test_chip_cell_plan_resolves_to_the_partitioned_grid():
    plan = tpartition.make_plan(**PLAN_CASES[0])
    assert (plan.m, plan.n, plan.phi, plan.psi, plan.t_p) == (16, 8, 8192, 2048, 1)
    assert plan.rows_used == 131072 and plan.cols_used == 16384


@pytest.mark.parametrize("m,n,t", [(2, 2, 0), (3, 2, 1), (2, 4, 0)])
def test_extract_blocks_with_injected_indices(m, n, t):
    rows, cols = 61, 47
    a = np.random.default_rng(m * 10 + n).normal(size=(rows, cols)).astype(np.float32)
    plan = jpartition.PartitionPlan(rows, cols, m, n, rows // m, cols // n, 2, seed=4)
    jb, jr, jc = jpartition.extract_blocks(jnp.asarray(a), plan, t)
    tb, tr, tc = tpartition.extract_blocks(
        torch.from_numpy(a), interop.plan_from_numpy(plan), t,
        row_idx=torch.from_numpy(np.array(jr)).long(),
        col_idx=torch.from_numpy(np.array(jc)).long())
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    own, _, _ = tpartition.extract_blocks(torch.from_numpy(a),
                                          interop.plan_from_numpy(plan), t)
    assert own.shape == tb.shape


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("assign_impl", ["jnp", "pallas"])
def test_kmeans_with_injected_init(assign_impl, weighted):
    rng = np.random.default_rng(11)
    centers = rng.normal(scale=3.0, size=(6, 5))
    x = (centers[rng.integers(0, 6, 400)] + rng.normal(size=(400, 5))).astype(np.float32)
    w = rng.uniform(0.1, 2.0, 400).astype(np.float32) if weighted else None
    key = jax.random.key(2)
    jw = None if w is None else jnp.asarray(w)
    init = jkmeans.kmeanspp_init(key, jnp.asarray(x), 6, weights=jw)  # kmeans' own seeding
    want = jkmeans.kmeans(key, jnp.asarray(x), 6, n_iter=16,
                          assign_impl=assign_impl, weights=jw)
    got = tkmeans.kmeans(x[None], 6, n_iter=16, assign_impl=assign_impl,
                         weights=None if w is None else w[None],
                         init=np.asarray(init)[None], device=CPU)
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centroids[0].numpy(), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.inertia[0].item(), float(want.inertia), rtol=1e-5)


def test_kmeanspp_seeds_are_data_points_and_weighted():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 50, 4))
                         .astype(np.float32))
    w = torch.ones(3, 50)
    w[:, 25:] = 0.0
    gen = torch.Generator().manual_seed(0)
    cents = tkmeans.kmeanspp_init(x, 5, gen, weights=w)
    d = ((x[:, None, :, :] - cents[:, :, None, :]) ** 2).sum(-1)  # (B, K, P)
    hit = d.argmin(-1)
    assert torch.all(d.amin(-1) == 0) and torch.all(hit < 25)


def _principal_angles(u, v):
    qu, _ = np.linalg.qr(u.astype(np.float64))
    qv, _ = np.linalg.qr(v.astype(np.float64))
    cos = np.clip(np.linalg.svd(qu.T @ qv, compute_uv=False), -1.0, 1.0)
    return np.arccos(cos)


@pytest.mark.parametrize("qr_method", ["qr", "cholesky"])
def test_randomized_svd_with_injected_omega(qr_method):
    rng = np.random.default_rng(3)
    # a clear spectral gap after rank 6, as the normalized atom blocks have
    u = np.linalg.qr(rng.normal(size=(200, 6)))[0]
    v = np.linalg.qr(rng.normal(size=(150, 6)))[0]
    a = (u * np.array([10, 8, 6, 5, 4, 3.0])) @ v.T + 0.01 * rng.normal(size=(200, 150))
    a = a.astype(np.float32)
    key = jax.random.key(9)
    omega = jax.random.normal(key, (150, 6), jnp.float32)
    ju, js, jvt = jspectral.randomized_svd(key, jnp.asarray(a), 6, n_iter=4,
                                           qr_method=qr_method)
    tu, ts, tvt = tspectral.randomized_svd(a[None], 6, n_iter=4, qr_method=qr_method,
                                           omega=np.asarray(omega)[None], device=CPU)
    assert _principal_angles(tu[0].numpy(), np.asarray(ju)).max() < 1e-3
    assert _principal_angles(tvt[0].numpy().T, np.asarray(jvt).T).max() < 1e-3
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js), rtol=1e-4)


def test_normalize_bipartite_matches_reference():
    a = np.random.default_rng(8).uniform(0, 3, size=(2, 40, 30)).astype(np.float32)
    ta, t1, t2 = tspectral.normalize_bipartite(a, device=CPU)
    for i in range(2):
        ja, j1, j2 = jspectral.normalize_bipartite(jnp.asarray(a[i]))
        # rsqrt within 1 ulp in each library, degree sums in another order
        for mine, theirs in ((ta[i], ja), (t1[i], j1), (t2[i], j2)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("assign_impl", ["jnp", "pallas"])
def test_scc_with_injected_draws(assign_impl):
    pc = jsynthetic.planted_cocluster_matrix(np.random.default_rng(4), 120, 90, k=3)
    blocks = np.stack([pc.matrix, pc.matrix[::-1].copy()])
    keys = jax.random.split(jax.random.key(5), 2)
    omega, z, cents = torch_parity._block_draws(jnp.asarray(blocks), keys, 3, 3, 4, "qr")
    seeds = np.stack([torch_parity.seed_indices(zb, cb) for zb, cb in zip(z, cents)])
    got = tspectral.scc(blocks, 3, 3, assign_impl=assign_impl,
                        omega=np.asarray(omega), seeds=seeds, device=CPU)
    for i in range(2):
        want = jspectral.scc(keys[i], jnp.asarray(blocks[i]), 3, 3,
                             assign_impl=assign_impl)
        np.testing.assert_array_equal(got.row_labels[i].numpy(),
                                      np.asarray(want.row_labels))
        np.testing.assert_array_equal(got.col_labels[i].numpy(),
                                      np.asarray(want.col_labels))


def test_atom_signatures_match_reference():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(4, 50, 8)).astype(np.float32)
    labels = rng.integers(0, 5, size=(4, 50))
    labels[0] = labels[0] % 4                          # an empty atom in block 0
    js, jc = jmerging.atom_signatures(jnp.asarray(feats), jnp.asarray(labels), 5)
    ts, tc = tmerging.atom_signatures(torch.from_numpy(feats),
                                      torch.from_numpy(labels), 5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _merge_inputs(seed, t_p=2, m=2, n=2, k=3, q=6, phi=20, psi=15):
    """Atom results of a planted 3-cluster problem: signatures near three
    centers, local labels and index maps as the pipeline produces them."""
    rng = np.random.default_rng(seed)
    b = m * n
    centers = rng.normal(size=(3, q))
    out = {}
    for side, size, width in (("row", m * phi, phi), ("col", n * psi, psi)):
        groups = m if side == "row" else n
        perm = np.stack([rng.permutation(size) for _ in range(t_p)])
        local = np.stack([np.stack([rng.permutation(k) for _ in range(b)])
                          for _ in range(t_p)])               # atom -> center
        sigs = centers[local] + 0.05 * rng.normal(size=(t_p, b, k, q))
        sigs /= np.linalg.norm(sigs, axis=-1, keepdims=True)
        out[f"{side}_sigs"] = sigs.astype(np.float32)
        out[f"{side}_counts"] = rng.integers(0, 9, size=(t_p, b, k)).astype(np.float32)
        out[f"{side}_labels"] = rng.integers(0, k, size=(t_p, b, width))
        out[f"{side}_index"] = perm.reshape(t_p, groups, width)
    out.update(n_rows=m * phi, n_cols=n * psi, k_row=3, k_col=3, m=m, n=n)
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_signature_merge_with_reference_seeding(masked):
    inp = _merge_inputs(1)
    key = jax.random.key(12)
    mask = np.ones((2, 4), bool)
    if masked:
        mask[1, 2] = False
    feats = np.random.default_rng(2).normal(size=(inp["n_rows"], 6)).astype(np.float32)
    want = jmerging.signature_merge(
        key, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in inp.items()},
        kmeans_iters=25, n_restarts=4, row_features=jnp.asarray(feats),
        block_mask=jnp.asarray(mask) if masked else None)
    kr, kc = jax.random.split(key)
    w_mask = mask[:, :, None] if masked else 1.0
    seeds = dict(
        row_seeds=torch_parity.merge_seeds(kr, inp["row_sigs"],
                                           inp["row_counts"] * w_mask, 3, 4),
        col_seeds=torch_parity.merge_seeds(kc, inp["col_sigs"],
                                           inp["col_counts"] * w_mask, 3, 4))
    got = tmerging.signature_merge(
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in inp.items()},
        kmeans_iters=25, n_restarts=4, row_features=torch.from_numpy(feats),
        block_mask=torch.from_numpy(mask) if masked else None, **seeds)
    for name in ("row_labels", "col_labels", "row_votes", "col_votes",
                 "row_membership", "col_membership"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.row_sigs.numpy(), np.asarray(want.row_sigs),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("threshold,min_membership", [(0.25, 0), (0.4, 2), (0.6, 1)])
def test_overlap_assignment_matches_reference(threshold, min_membership):
    votes = np.random.default_rng(7).integers(0, 4, size=(60, 5)).astype(np.float32)
    votes[0] = 0.0                                           # a point with no votes
    jl, jm = jmerging.finalize_assignment(jnp.asarray(votes), "overlap",
                                          threshold, min_membership)
    tl, tm = tmerging.finalize_assignment(torch.from_numpy(votes), "overlap",
                                          threshold, min_membership)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kw", [
    dict(n_rows=512, n_cols=384, k=4),
    dict(n_rows=97, n_cols=61, k=3, d=5, signal=2.0, noise=0.5, density=0.3),
    dict(n_rows=80, n_cols=70, k=4, diagonal_only=True, balanced=False),
])
def test_planted_matrix_is_byte_identical(kw):
    kw = dict(kw)
    rows, cols = kw.pop("n_rows"), kw.pop("n_cols")
    mine = tsynthetic.planted_cocluster_matrix(np.random.default_rng(21), rows, cols, **kw)
    theirs = jsynthetic.planted_cocluster_matrix(np.random.default_rng(21), rows, cols, **kw)
    assert mine.matrix.tobytes() == theirs.matrix.tobytes()
    np.testing.assert_array_equal(mine.row_labels, theirs.row_labels)
    np.testing.assert_array_equal(mine.col_labels, theirs.col_labels)
    assert mine.density == theirs.density


def test_metrics_are_equal():
    rng = np.random.default_rng(13)
    a, b = rng.integers(-1, 5, 300), rng.integers(0, 4, 300)
    assert tmetrics.nmi(a, b) == jmetrics.nmi(a, b)
    assert tmetrics.ari(a, b) == jmetrics.ari(a, b)
    assert tmetrics.cocluster_scores(a, b, b, a) == jmetrics.cocluster_scores(a, b, b, a)
