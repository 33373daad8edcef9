"""The port's tiled block-sparse format and SpMM family against the reference.

Conversion fields must equal the reference's numpy oracle exactly, including
the zero seed tiles of empty tile bands. The plain SpMM products (what the
port runs on the CPU, and the oracle of its CUDA kernels) are held against
``repro.kernels.ops`` on both of the reference's CPU tiers: the jnp tile
reference and the Pallas kernels in interpret mode. Products sum in another
order than the reference, so floats agree to ``rtol=1e-5`` with an absolute
floor of ``1e-5 * max|ref|``. The CUDA kernels themselves are held against
the plain versions on the card in ``test_torch_gpu.py``.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import to_bcoo as jto_bcoo
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spmm as jspmm
from repro_torch import interop
from repro_torch.core import opcache, sparse
from repro_torch.data import to_bcoo
from repro_torch.kernels import ops, ref, spmm
from torch_parity import release_compiled_code  # noqa: F401 (autouse)

DENSITIES = [0.01, 0.05, 0.2]
FIELDS = ("blocks", "block_rows", "block_cols", "t_order")


def _rand_sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, n)) < density, rng.normal(size=(m, n)),
                    0.0).astype(np.float32)


def _banded(m=300, n=260):
    """Entries only in tile-rows 0 and 2 and tile-cols 1 and 3 (64 x 64
    tiles): empty tile-rows and tile-cols need their zero seed payloads."""
    mat = np.zeros((m, n), np.float32)
    rng = np.random.default_rng(5)
    for r0 in (0, 128):
        for c0 in (64, 192):
            mat[r0 : r0 + 64, c0 : c0 + 64] = rng.normal(size=(64, min(64, n - c0)))
    return mat


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(params=["jnp", "interpret"])
def tier(request, monkeypatch):
    """The reference's jnp tile reference, or its Pallas kernels interpreted."""
    if request.param == "interpret":
        monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    else:
        monkeypatch.delenv("REPRO_FORCE_INTERPRET", raising=False)
    return request.param


def _both(mat, tile=64):
    """The port's and the reference's tiled operators of ``mat``."""
    return (spmm.bcoo_to_block_sparse(to_bcoo(mat, "cpu"), tile, tile),
            jops.bcoo_to_block_sparse(jto_bcoo(mat), bm=tile, bk=tile))


def _assert_fields_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert tuple(got.shape) == tuple(want.shape)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("tile", [(64, 64), (32, 128)])
def test_conversion_equals_the_reference_oracle(density, tile):
    bm, bk = tile
    mat = _rand_sparse(int(density * 100), 300, 389, density)
    want = jspmm.bcoo_to_block_sparse_host(jto_bcoo(mat), bm=bm, bk=bk)
    coo = to_bcoo(mat, "cpu")
    _assert_fields_equal(spmm.bcoo_to_block_sparse(coo, bm, bk), want)
    _assert_fields_equal(spmm.bcoo_to_block_sparse_host(coo, bm, bk), want)


def test_conversion_seeds_empty_tile_bands():
    mat = _banded()
    want = jspmm.bcoo_to_block_sparse_host(jto_bcoo(mat), bm=64, bk=64)
    got = spmm.bcoo_to_block_sparse(to_bcoo(mat, "cpu"), 64, 64)
    _assert_fields_equal(got, want)
    n_tr, n_tc = got.n_tiles
    assert set(got.block_rows.tolist()) == set(range(n_tr))
    assert set(got.block_cols.tolist()) == set(range(n_tc))
    row_ptr, col_ptr = got.segments()
    assert bool((row_ptr[1:] > row_ptr[:-1]).all() and (col_ptr[1:] > col_ptr[:-1]).all())


def test_segments_reject_an_unsorted_operator():
    t, _ = _both(_rand_sparse(6, 300, 260, 0.05))
    shuffled = spmm.BlockSparseMatrix(t.blocks, t.block_rows.flip(0), t.block_cols.flip(0),
                                      t.t_order, t.shape)
    bad_order = spmm.BlockSparseMatrix(t.blocks, t.block_rows, t.block_cols,
                                       t.t_order.flip(0), t.shape)
    for bad in (shuffled, bad_order):
        with pytest.raises(ValueError, match="sorted"):
            bad.segments()


def test_plan_offsets_equal_the_reference_plan():
    mat = _rand_sparse(3, 200, 130, 0.07)
    want = jspmm._plan_host(jto_bcoo(mat), 64, 64)
    plan = spmm.block_sparse_plan(to_bcoo(mat, "cpu"), 64, 64)
    assert plan.flat_idx.dtype == torch.int64 and plan.g == want.g
    np.testing.assert_array_equal(plan.flat_idx.numpy(), want.flat_idx)
    again = spmm.block_sparse_apply(plan, to_bcoo(2 * mat, "cpu").values())
    np.testing.assert_array_equal(again.blocks.numpy(),
                                  2 * spmm.block_sparse_apply(plan, to_bcoo(mat, "cpu")
                                                              .values()).blocks.numpy())


def test_interop_carries_the_reference_operator():
    mat = _rand_sparse(4, 150, 100, 0.1)
    jt = jspmm.bcoo_to_block_sparse_host(jto_bcoo(mat), 64, 64)
    got = interop.block_sparse_from_numpy(jt)
    _assert_fields_equal(got, jt)
    ja = jto_bcoo(mat)
    coo = interop.coo_from_numpy(np.asarray(ja.indices), np.asarray(ja.data), ja.shape)
    assert coo.is_coalesced() and torch.equal(coo.to_dense(), torch.from_numpy(mat))
    with pytest.raises(ValueError, match="sorted"):
        interop.coo_from_numpy(np.asarray(ja.indices)[::-1], np.asarray(ja.data), ja.shape)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_tiled_matches_reference(tier, density, transpose):
    m, k = 300, 260
    mat = _rand_sparse(int(density * 1000) + transpose, m, k, density)
    mine, theirs = _both(mat)
    rhs = np.random.default_rng(1).normal(size=(m if transpose else k, 6)).astype(np.float32)
    want = jops.spmm_tiled(theirs, jnp.asarray(rhs), transpose=transpose)
    _close(ops.spmm_tiled(mine, torch.from_numpy(rhs), transpose=transpose), want)


def _ata_walk(a, x, grid):
    """``A.T (A x)`` walked as the CUDA ``spmm_ata`` kernel walks it: bands of
    :func:`spmm.ata_plan`, each CTA's pieces from :func:`spmm.ata_schedule`
    (every payload once, owned by the CTA of its tile-col), each band's Y
    summed over the CTAs, rows past M zeroed, then its pieces' ``A_b.T Y_b``.
    Plain float32 sums in another order than the kernel's. Returns ``(z,
    plan)``."""
    rn = min(x.shape[1], 8)
    plan = spmm.ata_plan(a, grid, rn)
    sched, bptr = spmm.ata_schedule(a, grid, plan.grp)
    (m, k), (bm, bk), (n_tr, n_tc) = a.shape, a.tile_shape, a.n_tiles
    assert sorted(sched[:, 0].tolist()) == list(range(a.blocks.shape[0]))
    assert plan.nb >= 2 and plan.grp * plan.h <= spmm.ATA_BAND_ROWS
    assert plan.h * bk * 4 * (plan.nb + plan.tb) * plan.cap <= spmm.ATA_RING_BYTES
    blocks = a.materialize_scales().blocks
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_tc * bk - k))
    z = torch.zeros(n_tc * bk, x.shape[1])
    for b in range(plan.n_bands):
        q, s = divmod(b, plan.sub)
        i0, s0 = q * plan.grp, s * plan.h
        hs = min(bm, s0 + plan.h) - s0
        pieces = []
        for c in range(grid):
            j0, j1 = c * n_tc // grid, (c + 1) * n_tc // grid
            for g, i, j, _ in sched[bptr[c * plan.n_q + q]:bptr[c * plan.n_q + q + 1]].tolist():
                assert j0 <= j < j1 and i0 <= i < i0 + plan.grp
                pieces.append((blocks[g, s0:s0 + hs], (i - i0) * hs, j))
        y = torch.zeros(plan.grp * hs, x.shape[1])
        for tile, row0, j in pieces:
            y[row0:row0 + hs] += tile @ xp[j * bk:(j + 1) * bk]
        y[i0 * bm + s0 + torch.arange(plan.grp * hs) >= m] = 0
        for tile, row0, j in pieces:
            z[j * bk:(j + 1) * bk] += tile.T @ y[row0:row0 + hs]
    return z[:k], plan


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("with_gram", [False, True])
def test_spmm_ata_matches_reference(tier, density, with_gram):
    mat = _rand_sparse(int(density * 1000) + 7, 300, 260, density)
    mine, theirs = _both(mat)
    x = np.random.default_rng(2).normal(size=(260, 6)).astype(np.float32)
    want = jops.spmm_ata(theirs, jnp.asarray(x), with_gram=with_gram)
    got = ops.spmm_ata(mine, torch.from_numpy(x), with_gram=with_gram)
    if with_gram:
        (got, gram), (want, wgram) = got, want
        g = np.asarray(wgram)
        np.testing.assert_allclose(gram.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()))
    _close(got, want)
    # the CUDA kernel's bands, ownership and schedule (64 x 64 tiles: bands of
    # two tile-rows; 128 x 128: one tile-row, or half of one where a grid of
    # 120 CTAs and 8 columns overflow R's buffer) give the same z
    big = spmm.bcoo_to_block_sparse(to_bcoo(mat, "cpu"), 128, 128)
    for op, grid in ((mine, 1), (mine, 2), (mine, 5), (big, 3)):
        z, plan = _ata_walk(op, torch.from_numpy(x), grid)
        assert plan.sub == 1
        _close(z, want)
    x8 = np.random.default_rng(3).normal(size=(260, 8)).astype(np.float32)
    z, plan = _ata_walk(big, torch.from_numpy(x8), 120)
    assert (plan.sub, plan.h) == (2, 64)
    _close(z, jops.spmm_ata(theirs, jnp.asarray(x8)))


def _scales(mat, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, mat.shape[0]).astype(np.float32),
            rng.uniform(0.5, 2.0, mat.shape[1]).astype(np.float32))


def test_lazy_scales_equal_materialized_scales_bit_for_bit(tier):
    """The port's pinned multiply order ``(blk * rs) * cs`` gives the
    reference's materialized payloads exactly, and a lazily scaled operator
    the same products as the materialized one."""
    mat = _rand_sparse(11, 300, 260, 0.05)
    mine, theirs = _both(mat)
    s1, s2 = _scales(mat, 0)
    n_tr, n_tc = mine.n_tiles
    rs = np.zeros((n_tr, 64), np.float32)
    cs = np.zeros((n_tc, 64), np.float32)
    rs.reshape(-1)[:300], cs.reshape(-1)[:260] = s1, s2
    lazy = mine.with_scales(torch.from_numpy(rs), torch.from_numpy(cs))
    jlazy = jspmm.BlockSparseMatrix(theirs.blocks, theirs.block_rows, theirs.block_cols,
                                    theirs.t_order, theirs.shape, jnp.asarray(rs),
                                    jnp.asarray(cs))
    eager = lazy.materialize_scales()
    np.testing.assert_array_equal(eager.blocks.numpy(),
                                  np.asarray(jlazy.materialize_scales().blocks))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(260, 6)).astype(np.float32))
    assert torch.equal(ops.spmm_tiled(lazy, x), ops.spmm_tiled(eager, x))
    assert torch.equal(ops.spmm_ata(lazy, x), ops.spmm_ata(eager, x))
    _close(ops.spmm_tiled(lazy, x), jops.spmm_tiled(jlazy, jnp.asarray(x.numpy())))


def test_gram_matches_outer_product():
    """The Gram of ``spmm_ata`` against ``z.T @ z`` in float64, at
    ``rtol=1e-4`` relative to ``max|G|``. The reference's own
    ``TestFusedGram::test_gram_matches_outer_product[jnp]`` holds entries
    near 3e5 to ``atol=5e-4``, tighter than float32 sums allow (it fails on
    its jnp tier at relative error 2.3e-5); this test does not inherit that
    tolerance."""
    mat = _rand_sparse(12, 300, 260, 0.2)
    mine, _ = _both(mat)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(260, 6)).astype(np.float32))
    z, gram = ops.spmm_ata(mine, x, with_gram=True)
    z64 = z.double()
    want = (z64.T @ z64).numpy()
    np.testing.assert_allclose(gram.double().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert torch.equal(gram, gram.T)


def test_element_level_spmm_and_sddmm_match_reference():
    mat = _rand_sparse(13, 200, 130, 0.07)
    coo, ja = to_bcoo(mat, "cpu"), jto_bcoo(mat)
    rng = np.random.default_rng(5)
    b = rng.normal(size=(130, 12)).astype(np.float32)
    c = rng.normal(size=(200, 5)).astype(np.float32)
    _close(ops.spmm(coo, torch.from_numpy(b)), jops.spmm(ja, jnp.asarray(b)))
    _close(ops.spmm(coo, torch.from_numpy(c), transpose=True),
           jops.spmm(ja, jnp.asarray(c), transpose=True))
    x = rng.normal(size=(200, 4)).astype(np.float32)
    y = rng.normal(size=(130, 4)).astype(np.float32)
    _close(ops.sddmm(torch.from_numpy(x), torch.from_numpy(y), coo.indices()),
           jops.sddmm(jnp.asarray(x), jnp.asarray(y), ja.indices))
    idx = coo.indices()
    _close(ref.spmm_ref(coo.values(), idx[0], idx[1], 200, torch.from_numpy(b)),
           jref.spmm_ref(ja.data, ja.indices[:, 0], ja.indices[:, 1], 200, jnp.asarray(b)))
    t, jt = _both(mat)
    n_tr, n_tc = t.n_tiles
    bp = np.zeros((n_tc * 64, 12), np.float32)
    bp[:130] = b
    _close(ref.spmm_block_ref(t.blocks, t.block_rows, t.block_cols, n_tr, n_tc,
                              torch.from_numpy(bp)),
           jref.spmm_block_ref(jt.blocks, jt.block_rows, jt.block_cols, n_tr, n_tc,
                               jnp.asarray(bp)))


def test_cpu_operands_never_reach_the_cuda_wrappers():
    """The plain versions serve CPU tensors; a CUDA wrapper given CPU
    tensors raises before it loads or launches anything."""
    mat = _rand_sparse(14, 150, 100, 0.1)
    t, _ = _both(mat)
    x = torch.ones((100, 3))
    ops.reset_launch_counts()
    ops.spmm_tiled(t, x)
    ops.spmm_tiled(t, torch.ones((150, 3)), transpose=True)
    ops.spmm_ata(t, x, with_gram=True)
    assert ops.launch_counts() == {"kmeans_update": 0, "kmeans_assign": 0,
                                   "scale_apply": 0, "spmm": 0, "spmm_t": 0,
                                   "spmm_ata": 0, "cosine_assign": 0,
                                   "cosine_topk": 0, "flash_attention": 0}
    for call in (lambda: spmm.spmm(t, x), lambda: spmm.spmm_t(t, torch.ones((150, 3))),
                 lambda: spmm.spmm_ata(t, x)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


@pytest.mark.parametrize("kw,match", [
    (dict(bm=256), "tiles"),
    (dict(bk=30), "tiles"),
    (dict(rhs_rows=99), "rhs must be"),
])
def test_cuda_wrappers_reject_unsupported_operands(kw, match):
    mat = _rand_sparse(15, 300, 260, 0.05)
    t = spmm.bcoo_to_block_sparse(to_bcoo(mat, "cpu"), kw.get("bm", 64), kw.get("bk", 64))
    with pytest.raises(ValueError, match=match):
        spmm.spmm(t, torch.ones((kw.get("rhs_rows", 260), 4)))


def test_segment_split_reaches_the_target():
    assert spmm.segment_split(1024, 1) == 1
    assert spmm.segment_split(128, 1) * 128 >= spmm.TARGET_CTAS
    assert spmm.segment_split(3, 2) * 6 >= spmm.TARGET_CTAS


class TestPatternCache:
    def _convert(self, cache, a):
        calls = []

        def plan_fn(x):
            calls.append("plan")
            plan = spmm.block_sparse_plan(x, 64, 64)
            return plan, spmm.block_sparse_apply(plan, x.values())

        def apply_fn(plan, vals):
            calls.append("apply")
            return spmm.block_sparse_apply(plan, vals)

        return cache.convert(a, ("tiled", 64, 64), plan_fn, apply_fn), calls

    def test_hit_refresh_miss(self, monkeypatch):
        monkeypatch.delenv("REPRO_TILED_CACHE", raising=False)
        cache = opcache.PatternCache()
        mat = _rand_sparse(16, 200, 130, 0.1)
        a = to_bcoo(mat, "cpu")
        op1, calls = self._convert(cache, a)
        op2, calls2 = self._convert(cache, a)
        assert calls == ["plan"] and calls2 == [] and op2 is op1
        b = to_bcoo(3 * mat, "cpu")                      # same pattern, new values
        op3, calls3 = self._convert(cache, b)
        assert calls3 == ["apply"]
        np.testing.assert_array_equal(op3.blocks.numpy(), 3 * op1.blocks.numpy())
        a.values().mul_(2)                               # in place: a refresh, not a hit
        op4, calls4 = self._convert(cache, a)
        assert calls4 == ["apply"] and op4 is not op1
        other = to_bcoo(_rand_sparse(17, 200, 130, 0.1), "cpu")
        _, calls5 = self._convert(cache, other)
        assert calls5 == ["plan"]
        assert (cache.hits, cache.refreshes, cache.misses) == (1, 2, 2)
        assert len(cache) == 2

    def test_lru_capacity_and_kill_switch(self, monkeypatch):
        monkeypatch.delenv("REPRO_TILED_CACHE", raising=False)
        cache = opcache.PatternCache(capacity=2)
        mats = [to_bcoo(_rand_sparse(20 + i, 100, 70, 0.1), "cpu") for i in range(3)]
        for a in mats:
            self._convert(cache, a)
        assert len(cache) == 2
        _, calls = self._convert(cache, mats[0])        # evicted: a miss again
        assert calls == ["plan"]
        monkeypatch.setenv("REPRO_TILED_CACHE", "0")
        off = opcache.PatternCache()
        op, calls = self._convert(off, mats[1])
        assert calls == ["plan"] and len(off) == 0
        _assert_fields_equal(op, jspmm.bcoo_to_block_sparse_host(
            jto_bcoo(mats[1].to_dense().numpy()), 64, 64))

    def test_threads_share_one_cache(self, monkeypatch):
        monkeypatch.delenv("REPRO_TILED_CACHE", raising=False)
        cache = opcache.PatternCache()
        mats = [to_bcoo(_rand_sparse(30 + i, 120, 90, 0.1), "cpu") for i in range(3)]
        errors = []

        def work():
            try:
                for _ in range(5):
                    for a in mats:
                        op, _ = self._convert(cache, a)
                        assert op.shape == (120, 90)
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors and len(cache) == 3

    def test_prepare_operator_goes_through_the_default_cache(self, monkeypatch):
        monkeypatch.delenv("REPRO_TILED_CACHE", raising=False)
        opcache.default_cache().clear()
        a = to_bcoo(_rand_sparse(40, 200, 130, 0.1), "cpu")
        one = sparse.prepare_operator(a, "tiled")
        assert sparse.prepare_operator(a, "tiled") is one
        assert sparse.is_ell(sparse.prepare_operator(a, "dual_ell"))
        assert torch.equal(sparse.prepare_operator(a, "dense"), a.to_dense())
        assert len(opcache.default_cache()) == 2
        with pytest.raises(ValueError, match="resolved route"):
            sparse.prepare_operator(a, "auto")
        opcache.default_cache().clear()
