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
                                   "spmm_ata": 0}
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
