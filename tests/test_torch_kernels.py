"""Port kernels: plain versions against the reference's kernel wrappers.

On the CPU, ``repro_torch.kernels.ops`` runs each kernel's plain version;
``repro.kernels.ops`` runs the Pallas kernels in interpret mode. Both get
the same numpy inputs. Labels must be equal; float outputs agree within a
tolerance that allows for summation order (k-means, degree sums) and
rsqrt's last-ulp difference between XLA and ATen (normalization).
The CUDA and Triton kernels themselves are held against these plain versions
on the card in ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bipartite_normalize import scale_apply_pallas
from repro_torch.kernels import ops, ref

KM_RTOL, KM_ATOL = 1e-5, 1e-4


def _points(seed, b, p, d, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, p, d)).astype(np.float32)
    c = rng.normal(size=(b, k, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=(b, p)).astype(np.float32)
    return x, c, w


def _tie_points():
    """Points exactly equidistant from two or more centroids, and a
    duplicated centroid: every tie must go to the lowest centroid id."""
    c = np.zeros((1, 5, 5), np.float32)
    c[0, 0, 0], c[0, 1, 0] = 1.0, -1.0          # mirror pair around x0 = 0
    c[0, 2, 1] = c[0, 3, 1] = 2.0                # duplicated centroid
    c[0, 4, 2] = 3.0
    x = np.zeros((1, 6, 5), np.float32)
    x[0, 0, 3] = 0.5                             # ties 0 and 1
    x[0, 1, 1] = 2.0                             # on the duplicated pair
    x[0, 2, 1], x[0, 3, 0] = 1.0, -1.0
    x[0, 4, 4] = 7.0
    return x, c


CASES = [  # (seed, B, P, D, K): D=5 is the atom's width; K not a multiple of 8
    (0, 2, 300, 5, 16),
    (1, 3, 129, 5, 7),
    (2, 1, 64, 13, 13),
]


@pytest.mark.parametrize("seed,b,p,d,k", CASES)
def test_kmeans_assign_matches_reference(seed, b, p, d, k):
    x, c, _ = _points(seed, b, p, d, k)
    labels, d2 = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    for i in range(b):
        jl, jd = jops.kmeans_assign(jnp.asarray(x[i]), jnp.asarray(c[i]))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        np.testing.assert_allclose(d2[i].numpy(), np.asarray(jd),
                                   rtol=KM_RTOL, atol=KM_ATOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed,b,p,d,k", CASES)
def test_kmeans_update_matches_reference(seed, b, p, d, k, weighted):
    x, c, w = _points(seed, b, p, d, k)
    tw = torch.from_numpy(w) if weighted else None
    labels, d2, sums, counts = ops.kmeans_update(
        torch.from_numpy(x), torch.from_numpy(c), tw)
    assert labels.dtype == torch.int32 and sums.shape == (b, k, d)
    for i in range(b):
        jw = jnp.asarray(w[i]) if weighted else None
        jl, jd, js, jc = jops.kmeans_update(jnp.asarray(x[i]), jnp.asarray(c[i]),
                                            weights=jw)
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        for mine, theirs in ((d2[i], jd), (sums[i], js), (counts[i], jc)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=KM_RTOL, atol=KM_ATOL)


def test_kmeans_ties_go_to_lowest_id():
    x, c = _tie_points()
    labels, _ = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    jl, _ = jops.kmeans_assign(jnp.asarray(x[0]), jnp.asarray(c[0]))
    np.testing.assert_array_equal(labels[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(labels[0].numpy(), [0, 2, 2, 1, 0, 0])
    ul, _, _, counts = ops.kmeans_update(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(ul[0].numpy(), labels[0].numpy())
    np.testing.assert_array_equal(counts[0].numpy(), [3, 1, 2, 0, 0])


# Full normalization: the two rsqrt factors are each within 1 ulp of the
# correctly rounded value in both XLA and ATen (so up to 2 ulp apart), and the
# degree sums add |A| in another order; measured up to 8.5e-7 relative on the
# CPU at these shapes.
NORM_RTOL = 1e-6


@pytest.mark.parametrize("b,m,n", [(2, 37, 53), (1, 256, 300)])
def test_bipartite_normalize_matches_reference(b, m, n):
    rng = np.random.default_rng(m * n)
    a = rng.normal(size=(b, m, n)).astype(np.float32)
    a[0, 3] = 0.0                                   # a zero-degree row hits eps
    a_n, s1, s2 = ops.bipartite_normalize(torch.from_numpy(a))
    for i in range(b):
        ja, j1, j2 = jops.bipartite_normalize(jnp.asarray(a[i]))
        for mine, theirs in ((a_n[i], ja), (s1[i], j1), (s2[i], j2)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("b,m,n", [(2, 37, 53), (1, 64, 300)])
def test_scale_apply_is_the_pallas_formula_bit_for_bit(b, m, n):
    """Given the reference's own scales, the plain scale-apply equals the
    Pallas kernel exactly: same products, same association order."""
    rng = np.random.default_rng(m + n)
    a = rng.normal(size=(b, m, n)).astype(np.float32)
    d1 = np.abs(a).sum(2).astype(np.float32)
    d2 = np.abs(a).sum(1).astype(np.float32)
    got = ref.scale_apply_ref(
        torch.from_numpy(a),
        torch.from_numpy(np.asarray(jax.lax.rsqrt(jnp.maximum(d1, 1e-8)))),
        torch.from_numpy(np.asarray(jax.lax.rsqrt(jnp.maximum(d2, 1e-8)))))
    for i in range(b):
        want = scale_apply_pallas(jnp.asarray(a[i]), jnp.asarray(d1[i]),
                                  jnp.asarray(d2[i]), tile_m=m, tile_n=n,
                                  interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_cpu_tensors_never_launch_kernels():
    ops.reset_launch_counts()
    x, c, _ = _points(3, 1, 10, 5, 4)
    ops.kmeans_update(torch.from_numpy(x), torch.from_numpy(c))
    ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    ops.bipartite_normalize(torch.from_numpy(x))
    assert ops.launch_counts() == {"kmeans_update": 0, "kmeans_assign": 0,
                                   "scale_apply": 0, "spmm": 0, "spmm_t": 0,
                                   "spmm_ata": 0, "cosine_assign": 0,
                                   "cosine_topk": 0}
