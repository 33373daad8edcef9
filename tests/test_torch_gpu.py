"""The port's CUDA and Triton kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (the decision is
taken inside each test). This file imports no JAX, so it also runs on a
machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

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


@pytest.mark.gpu
@pytest.mark.parametrize("b,p,d,k,weighted", [
    (128, 10240, 5, 16, False),      # the atom k-means at the chip cell's plan
    (4, 2048, 64, 16, True),         # the merge k-means shape, weighted
    (3, 1000, 7, 13, True),          # ragged tile, odd widths
])
def test_cuda_kmeans_kernels_match_plain(b, p, d, k, weighted):
    dev = _card()
    x, c, w = (torch.from_numpy(v).to(dev) for v in _points(7, b, p, d, k))
    w = w if weighted else None
    from repro_torch.kernels import kmeans_assign, kmeans_update

    labels, d2 = kmeans_assign.kmeans_assign(x, c)
    rl, rd = ref.kmeans_assign_ref(x, c)
    _label_agreement(x, c, labels, rl)
    torch.testing.assert_close(d2, rd, rtol=KM_RTOL, atol=KM_ATOL)
    ul, ud, us, uc = kmeans_update.kmeans_update(x, c, w)
    assert torch.equal(ul, labels) and torch.equal(ud, d2)
    # statistics of the kernel's own labels, so near-tie flips cannot differ
    onehot = (ul.long()[..., None] == torch.arange(k, device=dev)).float()
    if w is not None:
        onehot = onehot * w[..., None]
    torch.testing.assert_close(us, onehot.mT @ x, rtol=KM_RTOL, atol=KM_ATOL)
    torch.testing.assert_close(uc, onehot.sum(1), rtol=KM_RTOL, atol=KM_ATOL)
    again = kmeans_update.kmeans_update(x, c, w)
    assert torch.equal(again[2], us) and torch.equal(again[3], uc)  # deterministic


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
                                   "cosine_topk": 0}
    host = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, draws=draws, device="cpu")
    assert card.row_labels.is_cuda
    for side in ("row", "col"):
        assert nmi(getattr(card, f"{side}_labels").cpu().numpy(),
                   getattr(host, f"{side}_labels").numpy()) >= 0.95


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


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,density,bm,bk,r", [
    (1000, 700, 0.05, 128, 128, 6),      # ragged edges, the atom's rank
    (300, 389, 0.2, 64, 64, 3),          # small tiles, partial lanes
    (257, 1031, 0.01, 32, 128, 11),      # two stripes, empty tiles
    (4096, 256, 0.1, 128, 128, 1),       # few tile-cols: split transposed walk
])
def test_cuda_spmm_kernels_match_plain(m, n, density, bm, bk, r):
    dev = _card()
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
        assert torch.equal(spmm.spmm_ata(op, x), z)
    # lazy scales give the materialized operator's bits, and runs repeat
    assert torch.equal(spmm.spmm(lazy, x), spmm.spmm(eager, x))
    assert torch.equal(spmm.spmm_t(lazy, y), spmm.spmm_t(eager, y))
    assert torch.equal(spmm.spmm_ata(lazy, x, with_gram=True)[1],
                       spmm.spmm_ata(eager, x, with_gram=True)[1])
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
    dev = _card()
    from repro_torch.kernels import _build, kmeans_assign

    s = torch.eye(4, 8, device=dev)
    ops.reset_launch_counts()
    labels, scores = kmeans_assign.cosine_topk(torch.zeros((0, 8), device=dev), s, 2)
    assert labels.shape == (0, 2) and ops.launch_counts()["cosine_topk"] == 0
    max_k = _build.load("cosine").cosine_max_k()
    assert max_k >= 1024
    with pytest.raises(ValueError, match=f"at most K = {max_k}"):
        kmeans_assign.cosine_assign(torch.ones((2, 8), device=dev),
                                    torch.ones((max_k + 1, 8), device=dev))


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
