"""The NMTF atom, LAMC with ``atom="nmtf"`` and the unpartitioned baselines,
against the reference package on its own random draws.

With the reference's k-means++ draws injected (``torch_parity``), labels must
equal the reference's exactly. Factors, which pass through 64 multiplicative
updates of float32 products summed in another order, must agree within
``FACTOR_RTOL`` of the factor's largest entry, and the loss within
``LOSS_RTOL``. The LAMC cases use the reference's own end-to-end plan and
matrix (``tests/test_lamc_e2e.py``: 600 x 500, k = d = 5, a 2 x 2 plan).

The checks run as one test item: the suite's collected count sets
pytest-xdist's schedule, and with it whether the reference's fuzz cases
share a worker (ROADMAP.md queue 3, "The count rule"). Each check names its
case in its assertion message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity

from repro.core import LAMCConfig as JConfig
from repro.core import lamc_cocluster as jlamc_cocluster
from repro.core.baselines import nmtf_full as jnmtf_full
from repro.core.baselines import scc_full as jscc_full
from repro.core.nmtf import nmtf as jnmtf
from repro.core.partition import PartitionPlan as JPlan
from repro.data import planted_cocluster_matrix
from repro.data import to_bcoo as jto_bcoo
from repro_torch import interop
from repro_torch.core import baselines, lamc
from repro_torch.core.nmtf import nmtf as tnmtf
from repro_torch.core.metrics import cocluster_scores
from repro_torch.data import to_bcoo

CPU = "cpu"
FACTOR_RTOL = 1e-5     # of max |factor|; the seen gap is ~1.5e-6
LOSS_RTOL = 1e-5       # the seen gap is ~1e-7
E2E_PLAN = JPlan(600, 500, m=2, n=2, phi=300, psi=250, t_p=2, seed=0)
E2E_CFG = dict(n_row_clusters=5, n_col_clusters=5, atom="nmtf",
               min_cocluster_rows=120, min_cocluster_cols=100)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_code():
    """Give back the memory mappings of this module's compiled JAX code, so
    an xdist worker that also runs the reference's fuzz cases stays under
    ``vm.max_map_count``."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def planted():
    return planted_cocluster_matrix(np.random.default_rng(0), 600, 500, k=5, d=5,
                                    signal=4.0, noise=0.6)


def _close(mine, theirs, rtol, what):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=rtol * np.abs(theirs).max(),
                               err_msg=what)


def _labels_equal(got, want, case):
    for side in ("row", "col"):
        np.testing.assert_array_equal(getattr(got, f"{side}_labels").cpu().numpy(),
                                      np.asarray(getattr(want, f"{side}_labels")),
                                      err_msg=f"{case} {side}")


def _nmtf_with_injected_seeds(planted, k, d):
    """Every block of a stack against the reference's vmapped call, with its
    own key; a 2-D input is a stack of one and leaves it unchanged."""
    blocks = np.stack([planted.matrix[:300, :250], planted.matrix[300:, 250:][::-1]])
    keys = jax.random.split(jax.random.key(3), 2)
    rows, cols = torch_parity.nmtf_seeds(blocks, keys, k, d)
    got = tnmtf(blocks, k, d, init=(rows, cols), device=CPU)
    assert got.f.shape == (2, 300, k) and got.s.shape == (2, k, d)
    for i in range(2):
        want = jnmtf(keys[i], jnp.asarray(blocks[i]), k, d)
        case = f"k={k} d={d} block {i}"
        for side in ("row", "col"):
            np.testing.assert_array_equal(getattr(got, f"{side}_labels")[i].numpy(),
                                          np.asarray(getattr(want, f"{side}_labels")),
                                          err_msg=f"{case} {side}")
        for name in ("f", "s", "g"):
            _close(getattr(got, name)[i].numpy(), getattr(want, name), FACTOR_RTOL,
                   f"{case} {name}")
        np.testing.assert_allclose(float(got.loss[i]), float(want.loss), rtol=LOSS_RTOL,
                                   err_msg=f"{case} loss")
    one = torch.from_numpy(blocks[1].copy())
    single = tnmtf(one, k, d, init=(rows[1:], cols[1:]), device=CPU)
    assert torch.equal(single.row_labels[0], got.row_labels[1]), (k, d)
    assert torch.equal(one, torch.from_numpy(blocks[1])), (k, d)


def _nmtf_shifts_each_block_by_its_own_minimum():
    """Shifting by the stack's minimum instead of each block's would change the
    second block's factors; ``overwrite_a`` shifts the caller's stack in place."""
    rng = np.random.default_rng(1)
    low = rng.normal(size=(2, 40, 30)).astype(np.float32)
    low[0] -= 5.0
    a = torch.from_numpy(low.copy())
    got = tnmtf(a, 3, init=(np.tile([0, 1, 2], (2, 1)),) * 2, overwrite_a=True,
                device=CPU)
    alone = tnmtf(low[1], 3, init=([0, 1, 2], [0, 1, 2]), device=CPU)
    torch.testing.assert_close(got.f[1], alone.f[0])
    want = low - np.minimum(low.min(axis=(1, 2), keepdims=True), 0)
    np.testing.assert_array_equal(a.numpy(), want)
    for shape in ((5,), (1, 2, 3, 4)):
        with pytest.raises(ValueError, match="expected"):
            tnmtf(np.ones(shape, np.float32), 2, device=CPU)


def _lamc_nmtf_atom_matches_reference(planted, kind, nmtf_iters):
    """LAMC-PNMTF on the reference's end-to-end plan: a COO input densifies
    its blocks, so both give the dense reference run's labels exactly; the
    config's iteration count reaches the atom."""
    cfg = dict(E2E_CFG, nmtf_iters=nmtf_iters)
    case = f"{kind}, nmtf_iters={nmtf_iters}"
    a = planted.matrix if kind == "dense" else jto_bcoo(planted.matrix)
    want = jlamc_cocluster(a, JConfig(**cfg, input_format=kind), plan=E2E_PLAN)
    draws = interop.draws_from_numpy(
        **torch_parity.lamc_draws(planted.matrix, E2E_PLAN, JConfig(**cfg)))
    assert draws.omega is None and draws.nmtf_row_seeds.shape == (2, 4, 5)
    mine = planted.matrix if kind == "dense" else to_bcoo(planted.matrix, CPU)
    got = lamc.lamc_cocluster(mine, lamc.LAMCConfig(**cfg, input_format=kind),
                              plan=interop.plan_from_numpy(E2E_PLAN), draws=draws,
                              device=CPU)
    _labels_equal(got, want, case)
    np.testing.assert_allclose(got.row_sigs.numpy(), np.asarray(want.row_sigs),
                               rtol=1e-4, atol=1e-5, err_msg=case)
    scores = cocluster_scores(got.row_labels.numpy(), got.col_labels.numpy(),
                              planted.row_labels, planted.col_labels)
    assert scores["nmi"] > 0.4, (case, scores)      # the reference's own bar


def _lamc_nmtf_own_draws_and_phases(planted):
    """Without injected draws the port draws its own; the NMTF phase is timed
    under its own name, and the quality bar is the reference's."""
    names = []

    def timer(name):
        names.append(name)
        return lamc.spectral.no_timer(name)

    got = lamc.lamc_cocluster(planted.matrix, lamc.LAMCConfig(**E2E_CFG),
                              plan=interop.plan_from_numpy(E2E_PLAN), device=CPU,
                              timer=timer)
    assert names == ["extract", "nmtf", "nmtf_init", "nmtf_updates", "signatures"] * 2 + [
        "merge"]
    scores = cocluster_scores(got.row_labels.numpy(), got.col_labels.numpy(),
                              planted.row_labels, planted.col_labels)
    assert scores["nmi"] > 0.4, scores


def _baselines_match_reference(planted):
    """``scc_full`` and ``nmtf_full`` on the reference's draws give its labels;
    on their own draws (two generator streams each) they meet its bars."""
    key = jax.random.key(0)
    omega, z, cents = torch_parity._block_draws(jnp.asarray(planted.matrix)[None],
                                                key[None], 5, 5, 4, "qr")
    seeds = torch_parity.seed_indices(z[0], cents[0])
    got = baselines.scc_full(planted.matrix, 5, omega=np.array(omega[0]), seeds=seeds,
                             device=CPU)
    assert got.row_labels.shape == (600,) and got.col_labels.shape == (500,)
    _labels_equal(got, jscc_full(key, jnp.asarray(planted.matrix), 5), "scc_full")
    rows, cols = torch_parity.nmtf_seeds(planted.matrix[None], key[None], 5, 5)
    got = baselines.nmtf_full(planted.matrix, 5, n_iter=64, init=(rows[0], cols[0]),
                              device=CPU)
    _labels_equal(got, jnmtf_full(key, jnp.asarray(planted.matrix), 5, n_iter=64),
                  "nmtf_full")
    for fn, bar in ((baselines.scc_full, 0.6), (baselines.nmtf_full, 0.5)):
        for seed in (0, 1):
            got = fn(planted.matrix, 5, generator=torch.Generator().manual_seed(seed),
                     device=CPU)
            scores = cocluster_scores(got.row_labels.numpy(), got.col_labels.numpy(),
                                      planted.row_labels, planted.col_labels)
            assert scores["nmi"] > bar, (fn.__name__, seed, scores)


def test_nmtf_atom_lamc_and_baselines_match_reference(planted):
    for k, d in ((5, 5), (4, 6), (3, 3), (6, 4), (2, 7)):
        _nmtf_with_injected_seeds(planted, k, d)
    _nmtf_shifts_each_block_by_its_own_minimum()
    for kind in ("dense", "bcoo"):
        for nmtf_iters in (64, 16):
            _lamc_nmtf_atom_matches_reference(planted, kind, nmtf_iters)
    _lamc_nmtf_own_draws_and_phases(planted)
    _baselines_match_reference(planted)
