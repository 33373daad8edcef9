"""The cosine scorers' plain versions against the reference's kernel wrappers.

On the CPU, ``repro_torch.kernels.ops.cosine_assign`` / ``cosine_topk`` run
the plain versions; ``repro.kernels.ops`` runs the Pallas kernels in
interpret mode. Both get the same numpy inputs. Labels must be equal; scores
agree within 1e-5 relative (the two products add in another order). The
CUDA kernel itself is held against these plain versions on the card in
``test_torch_gpu.py``. Shapes stay small: each new reference shape compiles
an interpret-mode kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.kmeans_assign import cosine_assign_pallas, cosine_topk_pallas
from repro_torch.kernels import kmeans_assign, ops, ref
from torch_parity import release_compiled_code  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, p, q, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(p, q)).astype(np.float32)
    s = rng.normal(size=(k, q)).astype(np.float32)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return x, s


def _tie_inputs():
    """Integer-valued points and signatures, so every product is exact: a
    duplicated signature pair (ids 1 and 3) and mirror pairs give exact ties
    in the first and in later top-k rounds."""
    s = np.zeros((5, 3), np.float32)
    s[0, 0] = 1.0
    s[1, 1] = s[3, 1] = 1.0          # duplicated signature
    s[2, 0] = -1.0
    s[4, 2] = 1.0
    x = np.array([[0, 2, 0],         # ties 1 and 3 for first place
                  [0, 0, 0],         # all five tie
                  [1, 1, 1],         # 0, 1, 3, 4 tie
                  [-1, 0, 3],        # 4 wins, then 2, then 1 and 3 tie
                  [2, -2, 0]], np.float32)   # 1, 2 and 3 tie for last
    return x, s


# (seed, P, q, K): q not a multiple of 128, K not a multiple of 8; the
# served model's (q, K) = (64, 16).
CASES = [(0, 133, 70, 5), (1, 40, 64, 16)]


@pytest.mark.parametrize("seed,p,q,k", CASES)
def test_cosine_assign_matches_reference(seed, p, q, k):
    x, s = _inputs(seed, p, q, k)
    labels, score = ops.cosine_assign(torch.from_numpy(x), torch.from_numpy(s))
    assert labels.dtype == torch.int32 and labels.shape == (p,)
    jl, js = jops.cosine_assign(jnp.asarray(x), jnp.asarray(s))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(score.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,p,q,k,k_top", [(0, 133, 70, 5, 1), (0, 133, 70, 5, 5),
                                             (1, 40, 64, 16, 4)])
def test_cosine_topk_matches_reference(seed, p, q, k, k_top):
    x, s = _inputs(seed, p, q, k)
    labels, scores = ops.cosine_topk(torch.from_numpy(x), torch.from_numpy(s), k_top)
    assert labels.dtype == torch.int32 and labels.shape == (p, k_top)
    jl, js = jops.cosine_topk(jnp.asarray(x), jnp.asarray(s), k_top)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())
    first, _ = ops.cosine_assign(torch.from_numpy(x), torch.from_numpy(s))
    assert torch.equal(labels[:, 0], first)


def test_ties_go_to_the_lower_id_in_every_round():
    x, s = _tie_inputs()
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    labels, _ = ops.cosine_assign(tx, ts)
    np.testing.assert_array_equal(labels.numpy(), [1, 0, 0, 4, 0])
    top, _ = ops.cosine_topk(tx, ts, 5)
    np.testing.assert_array_equal(top.numpy(), [[1, 3, 0, 2, 4],
                                                [0, 1, 2, 3, 4],
                                                [0, 1, 3, 4, 2],
                                                [4, 2, 1, 3, 0],
                                                [0, 4, 1, 2, 3]])
    jl, _ = jops.cosine_assign(jnp.asarray(x), jnp.asarray(s))
    jt, _ = jops.cosine_topk(jnp.asarray(x), jnp.asarray(s), 5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jt))


def _padded_reference(x, s, k_valid, k_top):
    """The reference's Pallas kernels called directly, in interpret mode, on
    ``x`` padded to (8, 128) and ``s`` padded to 128 features: the rows of
    ``s`` at and past ``k_valid`` are the caller's padding, masked to -inf."""
    tile = 8
    xp = np.zeros((-(-x.shape[0] // tile) * tile, 128), np.float32)
    xp[:x.shape[0], :x.shape[1]] = x
    sp = np.zeros((s.shape[0], 128), np.float32)
    sp[:, :s.shape[1]] = s
    if k_top is None:
        out = cosine_assign_pallas(jnp.asarray(xp), jnp.asarray(sp), k_valid=k_valid,
                                   tile_p=tile, interpret=True)
    else:
        out = cosine_topk_pallas(jnp.asarray(xp), jnp.asarray(sp), k_valid=k_valid,
                                 k_top=k_top, tile_p=tile, interpret=True)
    return tuple(np.asarray(o)[:x.shape[0]] for o in out)


@pytest.mark.parametrize("k_top", [None, 1, 5])
def test_k_valid_masks_the_padded_signatures_as_the_reference_does(k_top):
    """Signature rows at and past ``k_valid`` would win every point (they are
    the points' own direction, scaled up); masked, they never surface, in the
    port's plain versions as in the reference's kernels."""
    x, s = _inputs(4, 21, 40, 6)
    pad = np.concatenate([s, 10.0 * x[:2]], axis=0)          # (8, 40), k_valid = 6
    tx, ts = torch.from_numpy(x), torch.from_numpy(pad)
    if k_top is None:
        labels, score = ops.cosine_assign(tx, ts, k_valid=6)
        jl, js = _padded_reference(x, pad, 6, None)
        unmasked, _ = ops.cosine_assign(tx, ts)
        np.testing.assert_array_equal(labels.numpy(), ops.cosine_assign(
            tx, torch.from_numpy(s))[0].numpy())
    else:
        labels, score = ops.cosine_topk(tx, ts, k_top, k_valid=6)
        jl, js = _padded_reference(x, pad, 6, k_top)
        unmasked, _ = ops.cosine_topk(tx, ts, k_top)
    assert int(labels.max()) < 6 and int(unmasked.max()) >= 6
    np.testing.assert_array_equal(labels.numpy(), jl)
    np.testing.assert_allclose(score.numpy(), js, rtol=RTOL, atol=ATOL)


def test_k_valid_bounds_k_as_the_signature_count_does():
    x, s = (torch.from_numpy(v) for v in _inputs(5, 4, 8, 6))
    with pytest.raises(ValueError, match=r"top-k width must be in \[1, 3\]"):
        ops.cosine_topk(x, s, 4, k_valid=3)
    for bad in (0, 7):
        with pytest.raises(ValueError, match="k_valid"):
            ops.cosine_assign(x, s, k_valid=bad)
    labels, _ = ops.cosine_topk(x, s, 3, k_valid=3)
    assert int(labels.max()) < 3


def _non_finite_inputs(first):
    """Rows whose scores hold NaN, +inf and -inf: a NaN feature in row 0
    makes every score NaN; rows 1 and 2 carry +inf and -inf in feature 0,
    against signatures whose feature 0 is positive, zero (inf * 0 = NaN) or
    negative (``first="mixed"``) or positive only, which makes row 2's
    scores all -inf."""
    x, s = _inputs(3, 6, 8, 6)
    s[:, 0] = [0.5, 0.0, -0.5, 0.5, 0.0, -0.5] if first == "mixed" else 0.5
    x[0, 3], x[1, 0], x[2, 0] = np.nan, np.inf, -np.inf
    return x, s


@pytest.mark.parametrize("first", ["mixed", "positive"])
def test_non_finite_scores_follow_the_reference_order(first):
    """NaN comes before every number, the first NaN winning, and equal
    infinities go to the lower id: the order of ``jnp.argmax`` and of the
    reference's argmax-and-mask kernel (run in interpret mode). That kernel
    masks a winner to -inf, so once only -inf scores are left it picks the
    first of them again in every round; the port goes on through them in
    ascending id order, as a stable descending sort does. (``jax.lax.top_k``
    on the CPU is no oracle here: it puts NaN first in some rows and last
    in others.)"""
    x, s = _non_finite_inputs(first)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    labels, score = ops.cosine_assign(tx, ts)
    for jl, js in (jref.cosine_assign_ref(jnp.asarray(x), jnp.asarray(s)),
                   jops.cosine_assign(jnp.asarray(x), jnp.asarray(s))):
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_allclose(score.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    assert np.isnan(score[0].item())
    full = tx @ ts.T
    for k_top in (1, 3, 6):
        labels, scores = ops.cosine_topk(tx, ts, k_top)
        jl, js = (np.asarray(v) for v in jops.cosine_topk(jnp.asarray(x), jnp.asarray(s),
                                                          k_top))
        for i in range(x.shape[0]):
            m = min(int((full[i] != -torch.inf).sum()), k_top)  # before the -inf run
            np.testing.assert_array_equal(labels[i, :m].numpy(), jl[i, :m])
            np.testing.assert_allclose(scores[i, :m].numpy(), js[i, :m], rtol=RTOL,
                                       atol=ATOL)
            rest = torch.nonzero(full[i] == -torch.inf)[:k_top - m, 0]
            assert torch.equal(labels[i, m:].long(), rest)
            assert bool((scores[i, m:] == -torch.inf).all())
    assert all(len(set(row.tolist())) == 6 for row in labels)   # no id twice


def test_zero_rows_give_empty_results():
    s = torch.from_numpy(_inputs(0, 1, 64, 16)[1])
    labels, score = ops.cosine_assign(torch.zeros((0, 64)), s)
    assert labels.shape == (0,) and labels.dtype == torch.int32
    assert score.shape == (0,) and score.dtype == torch.float32
    labels, scores = ops.cosine_topk(torch.zeros((0, 64)), s, 3)
    assert labels.shape == (0, 3) and scores.shape == (0, 3)


@pytest.mark.parametrize("k", [0, 6])
def test_bad_k_raises_with_the_reference_wording(k):
    x, s = _inputs(2, 9, 33, 5)
    with pytest.raises(ValueError) as mine:
        ops.cosine_topk(torch.from_numpy(x), torch.from_numpy(s), k)
    with pytest.raises(ValueError) as theirs:
        jops.cosine_topk(jnp.asarray(x), jnp.asarray(s), k)
    assert str(mine.value) == str(theirs.value)


def test_cpu_tensors_never_reach_the_cuda_wrappers():
    """CPU tensors take the plain versions; the CUDA wrappers refuse them
    before loading anything."""
    x, s = (torch.from_numpy(v) for v in _inputs(3, 7, 16, 4))
    ops.reset_launch_counts()
    ops.cosine_assign(x, s)
    ops.cosine_topk(x, s, 2)
    counts = ops.launch_counts()
    assert counts["cosine_assign"] == 0 and counts["cosine_topk"] == 0
    for call in (lambda: kmeans_assign.cosine_assign(x, s),
                 lambda: kmeans_assign.cosine_topk(x, s, 2)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match="signatures"):
        ops.cosine_assign(x, s[:, :5])


def test_topk_breaks_ties_by_a_stable_sort_not_torch_topk():
    """The plain top-k takes the first k of a stable descending sort: equal
    scores keep ascending ids whatever ``torch.topk`` would return."""
    x = torch.ones((3, 4))
    s = torch.ones((40, 4)) * 0.5
    labels, scores = ref.cosine_topk_ref(x, s, 40)
    assert torch.equal(labels, torch.arange(40, dtype=torch.int32).expand(3, 40))
    assert torch.equal(scores, torch.full((3, 40), 2.0))
