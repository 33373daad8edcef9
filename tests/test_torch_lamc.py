"""The port's LAMC pipeline end to end, against the reference package.

Both packages get the same planted numpy matrix and the same plan; the port
also gets every random draw of the reference run (``torch_parity``). The
port's labels must then agree with the reference's (NMI >= 0.95), and its
quality against the planted truth must sit within 0.05 NMI of the
reference's. The reference's own golden-hash tests of this path
(``test_overlap.py::TestHardModeGolden``) fail on this JAX version, so the
comparison is against the reference's live output, never its pinned hashes.
The serving model ``model_from_result`` packs is held to the reference's
live model too, not to the expectation of
``test_streaming.py::TestModelArtifact::test_batch_result_carries_serving_fields``
(unit-norm signatures), which fails on this JAX version: an empty cluster
gets a zero signature.
"""

import numpy as np
import pytest
import torch
import torch_parity

from repro import streaming as jstreaming
from repro.core import LAMCConfig as JConfig
from repro.core import lamc_cocluster as jlamc_cocluster
from repro.core.partition import PartitionPlan as JPlan
from repro.core.partition import make_plan as jmake_plan
from repro.data import planted_cocluster_matrix
from repro_torch import interop, streaming
from repro_torch.core import lamc
from repro_torch.core.metrics import nmi
from repro_torch.data import to_bcoo

CPU = "cpu"
CFG = dict(n_row_clusters=4, n_col_clusters=4)
PLAN = JPlan(512, 384, m=2, n=2, phi=256, psi=192, t_p=2, seed=0)


def _planted(seed):
    return planted_cocluster_matrix(np.random.default_rng(seed), 512, 384, k=4)


@pytest.mark.parametrize("assign_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_labels_match_reference_on_its_draws(seed, assign_impl):
    pc = _planted(seed)
    cfg = dict(CFG, assign_impl=assign_impl)
    want = jlamc_cocluster(pc.matrix, JConfig(**cfg), plan=PLAN)
    draws = interop.draws_from_numpy(**torch_parity.lamc_draws(pc.matrix, PLAN,
                                                               JConfig(**cfg)))
    got = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**cfg),
                              plan=interop.plan_from_numpy(PLAN), draws=draws,
                              device=CPU)
    for side, truth in (("row", pc.row_labels), ("col", pc.col_labels)):
        mine = getattr(got, f"{side}_labels").numpy()
        theirs = np.asarray(getattr(want, f"{side}_labels"))
        assert nmi(mine, theirs) >= 0.95, side
        assert abs(nmi(mine, truth) - nmi(theirs, truth)) <= 0.05, side
    np.testing.assert_array_equal(got.anchor_rows.numpy(), np.asarray(want.anchor_rows))
    np.testing.assert_allclose(got.row_sigs.numpy(), np.asarray(want.row_sigs),
                               rtol=1e-4, atol=1e-5)
    # the serving artifact packs the same model: labels, votes and anchors
    # exactly, in the reference's dtypes; signatures and means within 1e-5
    model, jmodel = streaming.model_from_result(got), jstreaming.model_from_result(want)
    for field in model._fields:
        mine, theirs = getattr(model, field).numpy(), np.asarray(getattr(jmodel, field))
        assert mine.dtype == theirs.dtype, field
        if field.endswith(("sigs", "mean")):
            np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5, err_msg=field)
        else:
            np.testing.assert_array_equal(mine, theirs, err_msg=field)


def test_own_draws_recover_the_planted_structure():
    """Without injected draws the port draws its own; its quality against the
    truth must still sit within a band of the reference's."""
    pc = _planted(0)
    got = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**CFG),
                              plan=interop.plan_from_numpy(PLAN), device=CPU)
    want = jlamc_cocluster(pc.matrix, JConfig(**CFG), plan=PLAN)
    for side, truth in (("row", pc.row_labels), ("col", pc.col_labels)):
        mine = nmi(getattr(got, f"{side}_labels").numpy(), truth)
        theirs = nmi(np.asarray(getattr(want, f"{side}_labels")), truth)
        assert mine >= theirs - 0.15, (side, mine, theirs)


def test_plan_search_run():
    pc = _planted(2)
    kw = dict(CFG, min_cocluster_rows=64, min_cocluster_cols=48, workers=4)
    res = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**kw), device=CPU)
    want = jmake_plan(512, 384, min_cocluster_rows=64, min_cocluster_cols=48,
                      workers=4, k=4)
    assert res.plan == interop.plan_from_numpy(want)
    assert res.row_labels.shape == (512,) and res.col_labels.shape == (384,)
    assert int(res.row_labels.min()) >= 0 and int(res.row_labels.max()) < 4
    assert torch.equal(res.row_membership.sum(1), torch.ones(512, dtype=torch.int64))
    out = interop.result_to_numpy(res)
    assert out["plan"]["m"] == want.m and out["row_votes"].shape == (512, 4)


def test_majority_overlap_reduces_to_hard_mode():
    pc = _planted(3)
    plan = interop.plan_from_numpy(PLAN)
    hard = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**CFG), plan=plan,
                               device=CPU)
    soft = lamc.lamc_cocluster(
        pc.matrix, lamc.LAMCConfig(**CFG, assignment="overlap",
                                   overlap_threshold=0.51, min_membership=1),
        plan=plan, device=CPU)
    assert torch.equal(hard.row_labels, soft.row_labels)
    assert torch.equal(hard.col_labels, soft.col_labels)
    assert torch.equal(hard.row_membership, soft.row_membership)


def test_deterministic_and_full_mask_is_no_mask():
    pc = _planted(4)
    plan = interop.plan_from_numpy(PLAN)
    cfg = lamc.LAMCConfig(**CFG, qr_method="cholesky")
    one = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, device=CPU)
    two = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, device=CPU,
                              block_mask=np.ones((2, 4), bool))
    assert torch.equal(one.row_labels, two.row_labels)
    assert torch.equal(one.col_votes, two.col_votes)
    with pytest.raises(ValueError, match="block_mask"):
        lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, device=CPU,
                            block_mask=np.ones((1, 4), bool))


def test_exact_svd_atom_runs():
    pc = _planted(5)
    res = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**CFG, svd_method="exact"),
                              plan=interop.plan_from_numpy(PLAN), device=CPU)
    assert nmi(res.row_labels.numpy(), pc.row_labels) > 0.5


@pytest.mark.parametrize("kw", [dict(input_format="bcoo"), dict(spmm_impl="tiled")])
def test_sparse_options_run(kw):
    """``input_format="bcoo"`` (a COO input) and the ``spmm_impl`` knob run
    (they raised ``NotImplementedError`` before the sparse path was ported);
    on a multi-block plan both give the dense path's labels."""
    pc = _planted(0)
    plan = interop.plan_from_numpy(PLAN)
    a = to_bcoo(pc.matrix, CPU) if kw.get("input_format") == "bcoo" else pc.matrix
    got = lamc.lamc_cocluster(a, lamc.LAMCConfig(**CFG, **kw), plan=plan, device=CPU)
    dense = lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**CFG), plan=plan, device=CPU)
    assert torch.equal(got.row_labels, dense.row_labels)
    assert torch.equal(got.col_labels, dense.col_labels)


@pytest.mark.parametrize("kw,exc", [
    (dict(atom="pnmtf"), ValueError),
    (dict(assignment="soft"), ValueError),
    (dict(assign_impl="triton"), ValueError),
])
def test_unported_and_bad_options_raise(kw, exc):
    pc = _planted(0)
    with pytest.raises(exc):
        lamc.lamc_cocluster(pc.matrix, lamc.LAMCConfig(**CFG, **kw),
                            plan=interop.plan_from_numpy(PLAN), device=CPU)
