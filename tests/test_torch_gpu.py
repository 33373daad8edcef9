"""The port's CUDA and Triton kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (the decision is
taken inside each test). This file imports no JAX, so it also runs on a
machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, spmm

KM_RTOL, KM_ATOL = 1e-5, 1e-4


def _points(seed, b, p, d, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, p, d)).astype(np.float32)
    c = rng.normal(size=(b, k, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=(b, p)).astype(np.float32)
    return x, c, w


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA C++ / Triton kernels)")
    return torch.device("cuda")


def _label_agreement(x, c, labels, want):
    """Labels must agree, except near-ties within 1e-5 * (|x|^2 + |c|^2)."""
    d2 = ((x[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    mine = torch.gather(d2, 2, labels.long()[..., None])[..., 0]
    theirs = torch.gather(d2, 2, want.long()[..., None])[..., 0]
    scale = (x * x).sum(-1) + (c * c).sum(-1).amax(-1, keepdim=True)
    differ = labels != want
    assert bool(((mine - theirs).abs() <= 1e-5 * scale)[differ].all())
    assert differ.float().mean().item() <= 1e-4


# (b, p, d, k, weighted) shapes, grouped by the tile edge they reach: each
# group is one case of the test, so the collected test count stays small.
KMEANS_SHAPES = {
    "chip_cells": [
        (128, 10240, 5, 16, False),  # the atom k-means at the chip cell's plan
        (1, 147_456, 5, 16, False),  # the sparse cell's shape
    ],
    "merge": [
        (4, 2048, 64, 16, True),     # the merge k-means shape, weighted
    ],
    "narrow_tile_edges": [
        (3, 1000, 7, 13, True),      # ragged tile, odd widths
        (2, 3000, 1, 1, True),       # D = K = 1
        (3, 1, 5, 16, True),         # P = 1 and P = 33 (a tile holds 1,024 points)
        (3, 33, 5, 16, False),
        (2, 10_241, 5, 16, True),    # one point past 10 tiles
    ],
    "centroid_slices": [
        (2, 3000, 5, 65, True),      # K above one centroid slice, no ceiling
        (2, 3000, 5, 128, False),
        (2, 300, 128, 300, True),    # three passes of 128 centroids
    ],
    "feature_slices": [
        (2, 3000, 65, 16, True),     # D above one feature slice
        (2, 3000, 128, 128, False),
    ],
    "wide_tile_edges": [
        (2, 1, 130, 100, True),      # P = 1 and P = 33 (a tile holds 128 points)
        (2, 33, 130, 100, False),
        (2, 3000, 130, 100, True),   # wide, weighted, ragged K and D
    ],
}


def _check_kmeans_shape(dev, b, p, d, k, weighted):
    from repro_torch.kernels import kmeans_assign, kmeans_update

    shape = f"(b, p, d, k, weighted) = {(b, p, d, k, weighted)}"
    x, c, w = (torch.from_numpy(v).to(dev) for v in _points(7, b, p, d, k))
    w = w if weighted else None
    labels, d2 = kmeans_assign.kmeans_assign(x, c)
    rl, rd = ref.kmeans_assign_ref(x, c)
    _label_agreement(x, c, labels, rl)
    torch.testing.assert_close(d2, rd, rtol=KM_RTOL, atol=KM_ATOL, msg=shape)
    ul, ud, us, uc = kmeans_update.kmeans_update(x, c, w)
    assert torch.equal(ul, labels) and torch.equal(ud, d2), shape
    # statistics of the kernel's own labels, so near-tie flips cannot differ
    onehot = (ul.long()[..., None] == torch.arange(k, device=dev)).float()
    if w is not None:
        onehot = onehot * w[..., None]
    torch.testing.assert_close(us, onehot.mT @ x, rtol=KM_RTOL, atol=KM_ATOL, msg=shape)
    torch.testing.assert_close(uc, onehot.sum(1), rtol=KM_RTOL, atol=KM_ATOL, msg=shape)
    again = kmeans_update.kmeans_update(x, c, w)
    assert torch.equal(again[2], us) and torch.equal(again[3], uc), shape  # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("group", list(KMEANS_SHAPES))
def test_cuda_kmeans_kernels_match_plain(group):
    dev = _card()
    for shape in KMEANS_SHAPES[group]:
        _check_kmeans_shape(dev, *shape)


@pytest.mark.gpu
def test_cuda_kmeans_points_off_16_bytes():
    """Points that start 4, 8 or 12 bytes past a 16-byte boundary (a view at
    an offset), in the narrow tile (D = 5, K = 16) and in the wide one (D = 130,
    K = 100): the narrow tile's 16-byte copies start early and skip the skew."""
    dev = _card()
    from repro_torch.kernels import kmeans_assign, kmeans_update

    for (d, k), skew in itertools.product([(5, 16), (130, 100)], (1, 2, 3)):
        x, c, w = (torch.from_numpy(v).to(dev) for v in _points(11, 3, 777, d, k))
        buf = torch.empty(x.numel() + skew, device=dev)
        xs = buf[skew:].view(x.shape)
        xs.copy_(x)
        assert xs.data_ptr() % 16 == 4 * skew
        labels, d2 = kmeans_assign.kmeans_assign(xs, c)
        ul, ud, us, uc = kmeans_update.kmeans_update(xs, c, w)
        want = kmeans_update.kmeans_update(x, c, w)
        where = f"d={d} k={k} skew={skew}"
        assert torch.equal(labels, want[0]) and torch.equal(d2, want[1]), where
        for got, ref_ in zip((ul, ud, us, uc), want):
            assert torch.equal(got, ref_), where


@pytest.mark.gpu
def test_triton_scale_apply_matches_plain():
    dev = _card()
    from repro_torch.kernels import bipartite_normalize

    a = torch.randn((3, 777, 1031), device=dev)
    s1, s2 = torch.rand((3, 777), device=dev), torch.rand((3, 1031), device=dev)
    assert torch.equal(bipartite_normalize.scale_apply(a, s1, s2),
                       ref.scale_apply_ref(a, s1, s2))
    before = ops.launch_counts()["scale_apply"]
    a_n, _, _ = ops.bipartite_normalize(a)
    assert ops.launch_counts()["scale_apply"] == before + 1
    assert torch.equal(a_n, ref.bipartite_normalize_ref(
        a, torch.linalg.vector_norm(a, ord=1, dim=2),
        torch.linalg.vector_norm(a, ord=1, dim=1)))


@pytest.mark.gpu
def test_lamc_on_the_card_matches_the_cpu_path():
    """The whole pipeline on the card, through the kernels, against the CPU
    path (plain versions) on the same injected draws."""
    _card()
    from repro_torch import interop
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.data import planted_cocluster_matrix

    pc = planted_cocluster_matrix(np.random.default_rng(0), 512, 384, k=4)
    plan = PartitionPlan(512, 384, 2, 2, 256, 192, 2, seed=0)
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
    ops.reset_launch_counts()
    card = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws)
    assert ops.launch_counts() == {"kmeans_update": 2 * 16, "kmeans_assign": 2,
                                   "scale_apply": 2, "spmm": 0, "spmm_t": 0,
                                   "spmm_ata": 0, "cosine_assign": 0,
                                   "cosine_topk": 0, "flash_attention": 0}
    host = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws, device="cpu")
    assert card.row_labels.is_cuda
    for side in ("row", "col"):
        assert nmi(getattr(card, f"{side}_labels").cpu().numpy(),
                   getattr(host, f"{side}_labels").numpy()) >= 0.95

    # distributed_lamc on a one-rank NCCL mesh: lamc_cocluster's result exactly
    import tempfile

    import torch.distributed as dist
    from repro_torch.core import distributed
    from repro_torch.launch import mesh as _mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            ops.reset_launch_counts()
            one = distributed.distributed_lamc(_mesh.make_test_mesh(1, 1), pc.matrix, cfg,
                                               plan, draws=draws)
            assert ops.launch_counts()["kmeans_update"] == 2 * 16
            assert ops.launch_counts()["scale_apply"] == 2
        finally:
            dist.destroy_process_group()
    for key in ("row_labels", "col_labels", "row_votes", "col_votes", "row_membership",
                "col_membership"):
        assert torch.equal(getattr(one, key), getattr(card, key)), key


def _tiled(seed, m, n, density, bm, bk, dev):
    from repro_torch.data import to_bcoo

    rng = np.random.default_rng(seed)
    mat = np.where(rng.random((m, n)) < density, rng.normal(size=(m, n)),
                   0.0).astype(np.float32)
    a = spmm.bcoo_to_block_sparse(to_bcoo(mat, dev), bm, bk)
    n_tr, n_tc = a.n_tiles
    rs = torch.from_numpy(rng.uniform(0.5, 2, (n_tr, bm)).astype(np.float32)).to(dev)
    cs = torch.from_numpy(rng.uniform(0.5, 2, (n_tc, bk)).astype(np.float32)).to(dev)
    return a, a.with_scales(rs, cs)


def _spmm_close(got, want):
    """Sums in another order than the plain version: rtol 1e-5 with an
    absolute floor of 1e-5 * max|want|."""
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(want.abs().max().item(), 1e-30))


# (m, n, density, bm, bk, r) grouped by what they reach in the kernels; each
# group is one case of the test, so the collected test count stays small. The
# spmm_ata notes name its branches (csrc/spmm.cu, spmm.ata_plan).
SPMM_SHAPES = {
    "ragged": [
        (1000, 700, 0.05, 128, 128, 6),      # ragged edges, the atom's rank
        (700, 500, 0.1, 100, 40, 6),         # 50-row slices, 10 chunks a row
        (512, 34_000, 0.01, 128, 128, 6),    # more tile-cols than SMs: several a CTA,
                                             # a band's slices overflow the ring
    ],
    "small_tiles": [
        (300, 389, 0.2, 64, 64, 3),          # small tiles, partial lanes; bands of 2 tile-rows
        (1000, 500, 0.05, 16, 32, 5),        # bands of 8 tile-rows
    ],
    "stripes": [
        (257, 1031, 0.01, 32, 128, 11),      # two stripes, empty tiles
        (1000, 700, 0.05, 128, 128, 11),     # two stripes at full tiles
    ],
    "few_tile_cols": [
        (4096, 256, 0.1, 128, 128, 1),       # few tile-cols: split transposed walk,
                                             # a grid of 2 CTAs for spmm_ata
        (2048, 640, 0.1, 128, 128, 6),       # 5 tile-cols, fewer than the SMs
        (256, 15_360, 0.01, 128, 128, 8),    # a grid of 120 at 8 columns: bands of
                                             # half a tile-row (sub = 2)
    ],
}


@pytest.mark.gpu
@pytest.mark.parametrize("group", list(SPMM_SHAPES))
def test_cuda_spmm_kernels_match_plain(group):
    dev = _card()
    for m, n, density, bm, bk, r in SPMM_SHAPES[group]:
        a, lazy = _tiled(3, m, n, density, bm, bk, dev)
        eager = lazy.materialize_scales()
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((n, r), generator=g, device=dev)
        y = torch.randn((m, r), generator=g, device=dev)
        for op in (a, lazy):
            _spmm_close(spmm.spmm(op, x), ref.spmm_tiled_ref(op, x))
            _spmm_close(spmm.spmm_t(op, y), ref.spmm_tiled_ref(op, y, transpose=True))
            z, gram = spmm.spmm_ata(op, x, with_gram=True)
            want_z, _ = ref.spmm_ata_ref(op, x, with_gram=True)
            _spmm_close(z, want_z)
            torch.testing.assert_close(gram, z.T @ z, rtol=1e-4,
                                       atol=1e-4 * (z.T @ z).abs().max().item())
            assert torch.equal(spmm.spmm_ata(op, x), z)    # with_gram leaves z as it is
        # lazy scales give the materialized operator's bits, and runs repeat
        assert torch.equal(spmm.spmm(lazy, x), spmm.spmm(eager, x))
        assert torch.equal(spmm.spmm_t(lazy, y), spmm.spmm_t(eager, y))
        z, gram = spmm.spmm_ata(lazy, x, with_gram=True)
        z_eager, gram_eager = spmm.spmm_ata(eager, x, with_gram=True)
        assert torch.equal(z, z_eager) and torch.equal(gram, gram_eager)
        z_again, gram_again = spmm.spmm_ata(lazy, x, with_gram=True)
        assert torch.equal(z, z_again) and torch.equal(gram, gram_again)
        assert torch.equal(spmm.spmm_t(lazy, y), spmm.spmm_t(lazy, y))


@pytest.mark.gpu
def test_sparse_lamc_on_the_card_matches_the_cpu_path():
    """The operator path (tiled, single block) on the card, through the SpMM
    kernels, against the CPU path on the same injected draws."""
    dev = _card()
    from repro_torch import interop
    from repro_torch.core import lamc
    from repro_torch.core.metrics import nmi
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.data import planted_cocluster_matrix, to_bcoo

    pc = planted_cocluster_matrix(np.random.default_rng(0), 1024, 512, k=4,
                                  density=0.1, diagonal_only=True)
    plan = PartitionPlan(1024, 512, 1, 1, 1024, 512, 2, seed=0)
    rng = np.random.default_rng(1)
    draws = interop.draws_from_numpy(
        row_idx=np.stack([np.arange(1024).reshape(1, -1)] * 2),
        col_idx=np.stack([np.arange(512).reshape(1, -1)] * 2),
        anchor_rows=rng.permutation(1024)[:64], anchor_cols=rng.permutation(512)[:64],
        omega=rng.normal(size=(2, 1, 512, 4)),
        atom_seeds=np.stack([rng.permutation(1536)[:4][None] for _ in range(2)]),
        row_merge_seeds=np.stack([rng.permutation(8)[:4] for _ in range(4)]),
        col_merge_seeds=np.stack([rng.permutation(8)[:4] for _ in range(4)]))
    cfg = lamc.LAMCConfig(4, 4, input_format="bcoo", spmm_impl="tiled",
                          qr_method="cholesky", assign_impl="pallas")
    ops.reset_launch_counts()
    card = lamc.lamc_cocluster(to_bcoo(pc.matrix, dev), cfg, plan=plan, draws=draws)
    counts = ops.launch_counts()
    assert counts["spmm_ata"] == 2 * 4 and counts["spmm"] == 2 and counts["spmm_t"] == 2
    assert counts["scale_apply"] == 0
    host = lamc.lamc_cocluster(to_bcoo(pc.matrix, "cpu"), cfg, plan=plan, draws=draws,
                               device="cpu")
    for side in ("row", "col"):
        assert nmi(getattr(card, f"{side}_labels").cpu().numpy(),
                   getattr(host, f"{side}_labels").numpy()) >= 0.95


def _cosine_inputs(seed, p, q, k, dev):
    """Random points, unit signatures with an exact duplicate pair (ids 0
    and k - 1), and a few points equal to a signature row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((p, q), generator=g, device=dev)
    s = torch.randn((k, q), generator=g, device=dev)
    s = s / torch.linalg.vector_norm(s, dim=1, keepdim=True)
    if k > 1:
        s[k - 1] = s[0]
    x[: min(p, 3)] = s[0]
    return x, s


def _check_scores(x, s, labels, scores, want_labels, want_scores):
    """Scores within 1e-5 of the dot product's scale sum_d |x_d s_kd| (its
    rounding error grows with it); labels equal except near ties whose two
    plain scores lie within 1e-6 of that scale."""
    k_cols = labels.long().reshape(labels.shape[0], -1)
    want_cols = want_labels.long().reshape(labels.shape[0], -1)
    full = x @ s.T
    mag = x.abs() @ s.abs().T
    scale = torch.gather(mag, 1, want_cols)
    got_s, exp_s = scores.reshape(scale.shape), want_scores.reshape(scale.shape)
    assert bool(((got_s - exp_s).abs() <= 1e-5 * scale).all())
    differ = k_cols != want_cols
    gap = (torch.gather(full, 1, k_cols) - torch.gather(full, 1, want_cols)).abs()
    assert bool((gap <= 1e-6 * scale)[differ].all())
    return int(differ.sum().item())


@pytest.mark.gpu
@pytest.mark.parametrize("p,q,k,k_top", [
    (1, 64, 16, 1), (64, 64, 16, 4), (1024, 64, 16, 16),     # the served model
    (1000, 70, 13, 13),                                      # ragged q, K
    (257, 1024, 1024, 8),                                    # the reference's envelope
])
def test_cuda_cosine_kernels_match_plain(p, q, k, k_top):
    dev = _card()
    from repro_torch.kernels import kmeans_assign

    x, s = _cosine_inputs(p + k, p, q, k, dev)
    ops.reset_launch_counts()
    labels, score = kmeans_assign.cosine_assign(x, s)
    top, top_s = kmeans_assign.cosine_topk(x, s, k_top)
    assert ops.launch_counts()["cosine_assign"] == 1
    assert ops.launch_counts()["cosine_topk"] == 1
    rl, rs = ref.cosine_assign_ref(x, s)
    tl, ts = ref.cosine_topk_ref(x, s, k_top)
    _check_scores(x, s, labels, score, rl, rs)
    _check_scores(x, s, top, top_s, tl, ts)
    assert torch.equal(top[:, 0], labels) and torch.equal(top_s[:, 0], score)
    assert torch.equal(labels[:3], torch.zeros(min(p, 3), dtype=torch.int32, device=dev))
    assert bool((top_s[:, :-1] >= top_s[:, 1:]).all())
    again = kmeans_assign.cosine_topk(x, s, k_top)
    assert torch.equal(again[0], top) and torch.equal(again[1], top_s)


@pytest.mark.gpu
def test_cuda_cosine_kernels_read_only_the_valid_signatures():
    """Rows at and past ``k_valid`` would win every point; the kernels never
    read them, so the labels are those of the unpadded signatures."""
    dev = _card()
    from repro_torch.kernels import kmeans_assign

    x, s = _cosine_inputs(7, 300, 64, 16, dev)
    pad = torch.cat([s, 10.0 * x[3:11]]).contiguous()
    labels, score = kmeans_assign.cosine_assign(x, pad, 16)
    top, top_s = kmeans_assign.cosine_topk(x, pad, 5, 16)
    assert int(labels.max()) < 16 and int(top.max()) < 16
    _check_scores(x, s, labels, score, *ref.cosine_assign_ref(x, pad, 16))
    _check_scores(x, s, top, top_s, *ref.cosine_topk_ref(x, pad, 5, 16))
    want, want_s = kmeans_assign.cosine_topk(x, s, 5)
    assert torch.equal(top, want) and torch.equal(top_s, want_s)


@pytest.mark.gpu
def test_cuda_cosine_kernels_order_non_finite_scores_as_plain():
    """Rows whose scores are NaN, +inf or -inf: the kernel takes the plain
    version's order (NaN first, the first NaN winning, equal infinities to
    the lower id) and never returns an id out of range or an id twice."""
    dev = _card()
    from repro_torch.kernels import kmeans_assign

    x, s = _cosine_inputs(5, 40, 64, 16, dev)
    s[:, 0] = torch.tensor([0.5, 0.0, -0.5, 0.25] * 4, device=dev)
    x[0, 3], x[1, 0], x[2, 0] = float("nan"), float("inf"), float("-inf")
    pos = s.clone()
    pos[:, 0] = 0.5                       # row 2 then scores -inf everywhere
    for sigs in (s, pos):
        labels, score = kmeans_assign.cosine_assign(x, sigs)
        rl, rs = ref.cosine_assign_ref(x, sigs)
        assert torch.equal(labels[:3], rl[:3])
        torch.testing.assert_close(score[:3], rs[:3], rtol=0, atol=0, equal_nan=True)
        _check_scores(x[3:], sigs, labels[3:], score[3:], rl[3:], rs[3:])
        for k_top in (1, 4, 16):
            top, top_s = kmeans_assign.cosine_topk(x, sigs, k_top)
            tl, ts = ref.cosine_topk_ref(x, sigs, k_top)
            assert torch.equal(top[:3], tl[:3])
            torch.testing.assert_close(top_s[:3], ts[:3], rtol=0, atol=0, equal_nan=True)
            _check_scores(x[3:], sigs, top[3:], top_s[3:], tl[3:], ts[3:])
            assert int(top.min()) >= 0 and int(top.max()) < 16
        assert torch.equal(top.sort(dim=1).values,
                           torch.arange(16, dtype=torch.int32, device=dev).expand(40, 16))


@pytest.mark.gpu
def test_cuda_cosine_zero_rows_and_limits():
    """A zero-row batch launches nothing. Above the k_top kept as a running
    top-k the kernel scores into a scratch in device memory (its rows staged
    in shared memory at K = 256, read from device memory at K = 1500); at
    K = 2000 and 4000 a cluster's CTAs take several passes of signatures
    each, at a ragged P. Every case gives the plain version's labels,
    descending scores, exact ties to the lower id, cosine_assign as column
    0 and the same bits on a second launch: K and k_top have no ceiling."""
    dev = _card()
    from repro_torch.kernels import _build, kmeans_assign

    s = torch.eye(4, 8, device=dev)
    ops.reset_launch_counts()
    labels, scores = kmeans_assign.cosine_topk(torch.zeros((0, 8), device=dev), s, 2)
    assert labels.shape == (0, 2) and ops.launch_counts()["cosine_topk"] == 0
    max_k = _build.load("cosine").cosine_max_k()
    assert max_k >= 16
    for q, k, k_top in ((64, 256, max_k + 1), (64, 1500, max_k + 1), (64, 4000, 1),
                        (64, 4000, max_k), (1024, 2000, 8)):
        x, sigs = _cosine_inputs(k, 300, q, k, dev)
        top, top_s = kmeans_assign.cosine_topk(x, sigs, k_top)
        _check_scores(x, sigs, top, top_s, *ref.cosine_topk_ref(x, sigs, k_top))
        labels, score = kmeans_assign.cosine_assign(x, sigs)
        assert torch.equal(top[:, 0], labels) and torch.equal(top_s[:, 0], score)
        assert torch.equal(labels[:3], torch.zeros(3, dtype=torch.int32, device=dev))
        assert bool((top_s[:, :-1] >= top_s[:, 1:]).all())
        again = kmeans_assign.cosine_topk(x, sigs, k_top)
        assert torch.equal(again[0], top) and torch.equal(again[1], top_s)


@pytest.mark.gpu
def test_serving_on_the_card_matches_the_cpu_path(tmp_path):
    """A model saved on the card loads on the CPU with equal leaves; the card
    and the CPU give the same labels for the same requests, directly and
    through the service."""
    dev = _card()
    from repro_torch import streaming
    from repro_torch.core import lamc
    from repro_torch.data import planted_cocluster_matrix, to_bcoo

    pc = planted_cocluster_matrix(np.random.default_rng(0), 512, 384, k=4)
    plan = lamc.partition.PartitionPlan(512, 384, 2, 2, 256, 192, 2, seed=0)
    res = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(4, 4), plan=plan, device="cpu")
    streaming.save_model(str(tmp_path), streaming.model_from_result(res).to(dev))
    card, _ = streaming.load_model(str(tmp_path))
    host, _ = streaming.load_model(str(tmp_path), device="cpu")
    assert card.row_sigs.is_cuda
    assert streaming.model_fingerprint(card) == streaming.model_fingerprint(host)
    ops.reset_launch_counts()
    for fn, x in ((streaming.assign_rows, pc.matrix), (streaming.assign_cols, pc.matrix.T),
                  (lambda m, v: streaming.assign_rows_topk(m, v, k=3), pc.matrix)):
        assert torch.equal(fn(card, x).labels.cpu(), fn(host, x).labels)
    coo = streaming.assign_rows(card, to_bcoo(pc.matrix[:64], dev))
    assert torch.equal(coo.labels.cpu(), streaming.assign_rows(host, pc.matrix[:64]).labels)
    assert ops.launch_counts()["cosine_assign"] == 3
    assert ops.launch_counts()["cosine_topk"] == 1
    with streaming.AssignService(card, config=streaming.ServeConfig(batch=16, replicas=2)) as svc:
        tickets = [svc.submit(pc.matrix[i:i + 5]) for i in range(0, 40, 5)]
        got = np.concatenate([t.result(timeout=60.0).labels for t in tickets])
    np.testing.assert_array_equal(got, streaming.assign_rows(host, pc.matrix[:40]).labels)

    # the tables cluster-sharded over four slices of the card (K = 4: one
    # cluster each): the unsharded service's labels and score bits
    cfg = streaming.ServeConfig(batch=16, replicas=1)
    with streaming.AssignService(card, config=cfg) as one, \
            streaming.AssignService(card, config=cfg, devices=[dev] * 4) as four:
        assert len(four._engine.slices["rows"]) == 4
        for x, axis, k in ((pc.matrix[:16], "rows", 1), (pc.matrix[:16], "rows", 3),
                           (pc.matrix.T[:16].copy(), "cols", 2)):
            want = one.submit(x, axis=axis, k=k).result(timeout=60.0)
            got = four.submit(x, axis=axis, k=k).result(timeout=60.0)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got.scores.view(np.int32), want.scores.view(np.int32))


# ---------------------------------------------------------------------------
# flash attention (kernel 9) and the LM serving path
# ---------------------------------------------------------------------------

FLASH_F32_ATOL = 1e-5    # float32: the same sums in another order
FLASH_BF16_TOL = 2e-2    # bf16: the reference's own (atol and rtol) for its bf16 test


def _flash_inputs(seed, b, hq, hkv, sq, skv, dh, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, sq, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, skv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, skv, dh), generator=gen, device=dev).to(dtype)
    return q, k, v


# (B, Hq, Hkv, Sq, Skv, Dh, options) of the flash checks, grouped by what
# they exercise. The bf16 kernel's tiles are 128 query rows and 128 keys (64
# at Dh = 256); ``misaligned`` hands the kernel views 2 bytes (bf16) or 4
# bytes (float32) off a 16-byte boundary, which TMA cannot read.
FLASH_CASES = {
    "head_widths": [(1, 4, 2, 64, 64, 16, {}), (1, 4, 2, 100, 100, 64, {}),
                    (1, 4, 2, 100, 100, 128, {}), (1, 4, 2, 100, 100, 256, {}),
                    (1, 4, 2, 129, 191, 128, dict(causal=False)),   # Sq, Skv off the tiles
                    (1, 4, 2, 129, 191, 256, {}),
                    (1, 4, 2, 100, 100, 64, dict(misaligned=True))],   # the float32 pipe
    "heads_and_lengths": [
        (1, 32, 8, 2048, 2048, 128, {}),                    # the served prefill's heads
        (1, 15, 5, 100, 100, 64, {}),                       # smollm's heads
        (1, 15, 5, 160, 160, 64, dict(causal=False)),
        (2, 3, 1, 1, 77, 128, dict(q_offset=76)),           # one query row
        (1, 10, 1, 300, 300, 256, dict(window=128))],       # recurrentgemma-2b's MQA heads
    "masks": [(1, 4, 2, 37, 300, 128, dict(q_offset=263)),  # prefill continuation
              (1, 4, 4, 200, 200, 64, dict(window=48)),
              (1, 4, 2, 64, 100, 64, dict(kv_len=70, causal=False)),
              (1, 2, 2, 50, 130, 32, dict(window=8, q_offset=200)),   # rows with no live key
              (1, 4, 2, 384, 384, 128, dict(window=100)),   # a window crossing KV tiles
              (1, 4, 2, 384, 384, 256, dict(window=100)),
              (1, 4, 2, 200, 300, 64, dict(kv_len=150, causal=False)),   # kv_len inside a tile
              (1, 4, 2, 100, 400, 128, dict(q_offset=300)),   # continuation past a tile edge
              (1, 2, 2, 50, 130, 256, dict(window=8, q_offset=200))],   # no live key, Dh 256
}


def _misaligned(t):
    """A contiguous copy of ``t`` one element past its buffer's start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("group", sorted(FLASH_CASES))
def test_cuda_flash_attention_matches_plain(group):
    """Each case in float32 (the float32-pipe kernel) and bf16 (the wgmma
    kernel where Dh % 8 == 0 and the tensors are 16-byte aligned, else the
    float32 pipe), each launch through the route the library names."""
    dev = _card()
    from repro_torch.kernels import flash_attention

    for (b, hq, hkv, sq, skv, dh, kw), dtype in itertools.product(
            FLASH_CASES[group], (torch.float32, torch.bfloat16)):
        kw = dict(kw)
        misaligned = kw.pop("misaligned", False)
        tol = ((0, FLASH_F32_ATOL) if dtype == torch.float32
               else (FLASH_BF16_TOL, FLASH_BF16_TOL))
        q, k, v = _flash_inputs(sq + skv + dh, b, hq, hkv, sq, skv, dh, dtype, dev)
        if misaligned:
            q, k, v = (_misaligned(t) for t in (q, k, v))
        route = ("wgmma" if dtype == torch.bfloat16 and dh % 8 == 0 and not misaligned
                 else "f32_pipe")
        case = (b, hq, hkv, sq, skv, dh, kw, dtype, misaligned)
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, **kw)
        assert ops.launch_counts()["flash_attention"] == 1 and flash_attention.launches == 1
        assert flash_attention.last_route == route, case
        want = ref.flash_attention_ref(q, k, v, **kw)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1],
                                   msg=lambda m: f"{case}: {m}")
        assert torch.equal(ops.flash_attention(q, k, v, **kw), got)   # deterministic


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_what_it_cannot_take():
    dev = _card()
    q, k, v = _flash_inputs(0, 1, 2, 2, 8, 8, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="Dh <="):
        ops.flash_attention(*_flash_inputs(0, 1, 2, 2, 8, 8, 320, torch.float32, dev))
    with pytest.raises(ValueError, match="like q"):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    ops.reset_launch_counts()
    empty = ops.flash_attention(q[:, :, :0], k, v)
    assert empty.shape == (1, 2, 0, 16) and ops.launch_counts()["flash_attention"] == 0


@pytest.mark.gpu
def test_lm_on_the_card_matches_the_cpu_path():
    """A reduced qwen3 served on the card (prefill through the flash kernel)
    and on the CPU with the same weights, in float32 compute: the same
    greedy tokens, and one flash launch per layer per prefill."""
    dev = _card()
    from repro_torch.configs import reduced
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = reduced("qwen3-4b")
    host_model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = host_model.init(0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70)))
    host = serve._generate(host_model, params, prompts, 6)
    ops.reset_launch_counts()
    card = serve._generate(build_model(cfg, dtype=torch.float32, device=dev),
                           params.to(dev), prompts.to(dev), 6)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    np.testing.assert_array_equal(card["tokens"], host["tokens"])
    assert card["logits_finite"]


@pytest.mark.gpu
def test_kernels_launch_on_the_tensors_device():
    """Every wrapper makes its tensors' device current: with cuda:0 current,
    tensors on cuda:1 give the plain version's results. Needs two cards."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (launch on cuda:1 while cuda:0 is current)")
    from repro_torch.kernels import bipartite_normalize, kmeans_assign, kmeans_update

    dev = torch.device("cuda:1")
    torch.cuda.set_device(0)
    x, c, w = (torch.from_numpy(a).to(dev) for a in _points(3, 2, 700, 70, 70))
    labels, d2 = kmeans_assign.kmeans_assign(x, c)
    _label_agreement(x, c, labels, ref.kmeans_assign_ref(x, c)[0])
    ul, _, us, _ = kmeans_update.kmeans_update(x, c, w)
    assert torch.equal(ul, labels) and us.device == dev
    xs, sigs = _cosine_inputs(3, 300, 64, 2000, dev)
    _check_scores(xs, sigs, *kmeans_assign.cosine_topk(xs, sigs, 2),
                  *ref.cosine_topk_ref(xs, sigs, 2))
    a = torch.randn((2, 65, 130), device=dev)
    s1, s2 = torch.rand((2, 65), device=dev), torch.rand((2, 130), device=dev)
    assert torch.equal(bipartite_normalize.scale_apply(a, s1, s2), ref.scale_apply_ref(a, s1, s2))
    ta, _ = _tiled(5, 300, 200, 0.2, 64, 64, dev)
    rhs = torch.randn((200, 3), device=dev)
    _spmm_close(spmm.spmm(ta, rhs), ref.spmm_tiled_ref(ta, rhs))
    q, k, v = _flash_inputs(1, 1, 4, 2, 100, 100, 64, torch.bfloat16, dev)
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               ref.flash_attention_ref(q, k, v).float(), rtol=FLASH_BF16_TOL,
                               atol=FLASH_BF16_TOL)
    assert torch.cuda.current_device() == 0


# Slice 9: the NMTF atom, the baselines and the examples run plain batched
# products and the "jnp" k-means (no kernel of their own), plus kernel 3 in
# scc_full and kernels 3 and 5 in the examples. On the card they must give
# the CPU path's labels on the same injected draws. One test item: the
# collected count sets the CPU suite's xdist schedule (ROADMAP.md queue 3).
NMTF_FACTOR_RTOL = 1e-4      # of max|factor|: 64 updates of float32 products, cuBLAS vs CPU

# (blocks, rows, cols, k, d, seed); each block a planted matrix of its own.
NMTF_CASES = [(1, 300, 250, 5, 5, 0), (4, 128, 96, 4, 4, 1), (2, 200, 150, 3, 6, 2),
              (3, 64, 256, 6, 3, 3), (1, 1000, 40, 2, 2, 4), (2, 257, 129, 7, 5, 5),
              (8, 96, 64, 4, 4, 6), (1, 40, 900, 3, 3, 7)]


def _planted_stack(b, m, n, k, d, seed):
    from repro_torch.data import planted_cocluster_matrix

    rng = np.random.default_rng(seed)
    return np.stack([planted_cocluster_matrix(rng, m, n, k, d, signal=4.0, noise=0.6).matrix
                     for _ in range(b)])


def _nmtf_on_the_card_matches_the_cpu_path(b, m, n, k, d, seed):
    from repro_torch.core.nmtf import nmtf

    a = _planted_stack(b, m, n, k, d, seed)
    rng = np.random.default_rng(seed + 100)
    init = (np.stack([rng.permutation(m)[:k] for _ in range(b)]),
            np.stack([rng.permutation(n)[:d] for _ in range(b)]))
    ops.reset_launch_counts()
    card = nmtf(a, k, d, init=init)
    assert not any(ops.launch_counts().values())
    host = nmtf(a, k, d, init=init, device="cpu")
    case = (b, m, n, k, d, seed)
    assert torch.equal(card.row_labels.cpu(), host.row_labels), case
    assert torch.equal(card.col_labels.cpu(), host.col_labels), case
    for name in ("f", "s", "g"):
        mine, theirs = getattr(card, name).cpu(), getattr(host, name)
        assert float((mine - theirs).abs().max()) <= NMTF_FACTOR_RTOL * float(
            theirs.abs().max()), (case, name)


def _baselines_on_the_card_match_the_cpu_path(name, seed):
    from repro_torch.core import baselines

    a = _planted_stack(1, 400, 300, 5, 5, seed)[0]
    rng = np.random.default_rng(seed + 200)
    if name == "scc_full":       # l + 1 = 4 sketch columns, seeds into Z (700 points)
        kw = dict(omega=rng.normal(size=(300, 4)).astype(np.float32),
                  seeds=rng.permutation(700)[:5])
    else:
        kw = dict(init=(rng.permutation(400)[:5], rng.permutation(300)[:5]))
    fn = getattr(baselines, name)
    ops.reset_launch_counts()
    card = fn(a, 5, **kw)
    assert ops.launch_counts()["scale_apply"] == (name == "scc_full"), name
    host = fn(a, 5, device="cpu", **kw)
    assert torch.equal(card.row_labels.cpu(), host.row_labels), (name, seed)
    assert torch.equal(card.col_labels.cpu(), host.col_labels), (name, seed)


def _lamc_nmtf_on_the_card_matches_the_cpu_path(kind, nmtf_iters):
    from repro_torch import interop
    from repro_torch.core import lamc
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.data import planted_cocluster_matrix, to_bcoo

    pc = planted_cocluster_matrix(np.random.default_rng(0), 512, 384, k=4)
    plan = PartitionPlan(512, 384, 2, 2, 256, 192, 2, seed=0)
    rng = np.random.default_rng(1)
    draws = interop.draws_from_numpy(
        row_idx=np.stack([rng.permutation(512).reshape(2, 256) for _ in range(2)]),
        col_idx=np.stack([rng.permutation(384).reshape(2, 192) for _ in range(2)]),
        anchor_rows=rng.permutation(512)[:64], anchor_cols=rng.permutation(384)[:64],
        nmtf_row_seeds=np.stack([[rng.permutation(256)[:4] for _ in range(4)]
                                 for _ in range(2)]),
        nmtf_col_seeds=np.stack([[rng.permutation(192)[:4] for _ in range(4)]
                                 for _ in range(2)]),
        row_merge_seeds=np.stack([rng.permutation(32)[:4] for _ in range(4)]),
        col_merge_seeds=np.stack([rng.permutation(32)[:4] for _ in range(4)]))
    cfg = lamc.LAMCConfig(4, 4, atom="nmtf", nmtf_iters=nmtf_iters, input_format=kind)
    a = {dev: pc.matrix if kind == "dense" else to_bcoo(pc.matrix, dev)
         for dev in ("cuda", "cpu")}
    ops.reset_launch_counts()
    card = lamc.lamc_cocluster(a["cuda"], cfg, plan=plan, draws=draws)
    assert not any(ops.launch_counts().values())
    host = lamc.lamc_cocluster(a["cpu"], cfg, plan=plan, draws=draws, device="cpu")
    assert torch.equal(card.row_labels.cpu(), host.row_labels), (kind, nmtf_iters)
    assert torch.equal(card.col_labels.cpu(), host.col_labels), (kind, nmtf_iters)


def _example_runs_on_the_card(name):
    """An example at its default size, on the card: the fit normalizes
    through kernel 3 and ``assign_rows`` scores through kernel 5."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_launch_counts()
    out = mod.main([])
    counts = ops.launch_counts()
    assert counts["scale_apply"] >= 1 and counts["cosine_assign"] == 1, counts
    if name == "torch_quickstart":
        assert out["lamc_nmi"] >= 0.8 and out["heldout_nmi"] >= 0.8, out
    else:
        assert 0.0 <= out["fit_nmi"] <= 1.0, out


def _strict_audit_on_the_card():
    """``python -m repro_torch.analysis --strict`` on the card: the lint, the
    entry points' audit and the shared-memory audit report no finding."""
    from repro_torch.analysis import cli

    assert cli.main(["--strict"]) == 0


@pytest.mark.gpu
def test_slice9_on_the_card_matches_the_cpu_path():
    _card()
    for case in NMTF_CASES:
        _nmtf_on_the_card_matches_the_cpu_path(*case)
    for name in ("scc_full", "nmtf_full"):
        for seed in range(4):
            _baselines_on_the_card_match_the_cpu_path(name, seed)
    for kind in ("dense", "bcoo"):
        for nmtf_iters in (16, 64):
            _lamc_nmtf_on_the_card_matches_the_cpu_path(kind, nmtf_iters)
    for name in ("torch_quickstart", "torch_text_coclustering"):
        _example_runs_on_the_card(name)
    _strict_audit_on_the_card()
