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

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch_dist
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
from torch_parity import release_compiled_code  # noqa: F401 (autouse)

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


# The reference's distributed case (tests/test_overlap.py,
# test_distributed_overlap_parity_8dev), its m = n = 4 variant, and the
# meshes the port's ranks run it on: (shape, axis names, call options).
DIST_DATA = dict(n_rows=320, n_cols=240, k=4, d=4, signal=4.0, noise=0.6)
DIST_PLANS = {"4x2": dict(n_rows=320, n_cols=240, m=4, n=2, phi=80, psi=120, t_p=2, seed=0),
              "4x4": dict(n_rows=320, n_cols=240, m=4, n=4, phi=80, psi=60, t_p=2, seed=0)}
DIST_MODES = {"hard": dict(CFG),
              "overlap": dict(CFG, assignment="overlap", overlap_threshold=0.3),
              "forced": dict(CFG, assignment="overlap", overlap_threshold=1.0,
                             min_membership=1)}
DIST_MESHES = {"W1": ((1, 1), ("data", "model"), {}),
               "W2": ((2, 1), ("data", "model"), {}),
               "W4": ((2, 2), ("data", "model"), {}),
               "pod2_data2": ((2, 2), ("pod", "data"),
                              dict(block_axes=("data",), resample_axis="pod"))}
EXACT = ("row_labels", "col_labels", "row_votes", "col_votes", "row_membership",
         "col_membership")

# The reference's distributed_lamc on 8 forced CPU devices, on a mesh built
# with jax.sharding.Mesh (Auto axes: jax.make_mesh's Explicit axes make its
# with_sharding_constraint raise on this JAX version).
_REFERENCE_DISTRIBUTED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.core import LAMCConfig
    from repro.core.distributed import distributed_lamc
    from repro.core.partition import PartitionPlan
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    a = np.load(sys.argv[1])
    for name, plan in eval(sys.argv[2]).items():
        out = distributed_lamc(mesh, a, LAMCConfig(**eval(sys.argv[3])), PartitionPlan(**plan))
        np.save(sys.argv[1] + "." + name + ".row.npy", np.asarray(out.row_labels))
        np.save(sys.argv[1] + "." + name + ".col.npy", np.asarray(out.col_labels))
    print("REFERENCE_DISTRIBUTED_OK")
""")


def _reference_distributed(matrix, tmp_path):
    path = str(tmp_path / "a.npy")
    np.save(path, matrix)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE_DISTRIBUTED, path,
                          repr(DIST_PLANS), repr(CFG)], capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0 and "REFERENCE_DISTRIBUTED_OK" in res.stdout, res.stderr[-3000:]
    return {name: (np.load(f"{path}.{name}.row.npy"), np.load(f"{path}.{name}.col.npy"))
            for name in DIST_PLANS}


def test_majority_overlap_reduces_to_hard_mode(tmp_path):
    """Hard mode is overlap mode at a majority threshold, in one process and
    in ``distributed_lamc`` (the counterpart of the reference's
    ``test_distributed_overlap_parity_8dev``): on gloo worlds of 1, 2 and 4
    ranks and a (pod = 2, data = 2) mesh with the resamples split over
    ``pod``, every mode gives ``lamc_cocluster``'s labels, votes and
    memberships exactly and its signatures within 1e-6 of their largest
    entry; the forced overlap gives hard mode. On the reference's draws, the
    port's ranks give the labels of the reference's own ``distributed_lamc``
    on 8 devices."""
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

    data = planted_cocluster_matrix(np.random.default_rng(0), 320, 240, k=4, d=4, signal=4.0, noise=0.6)
    a = data.matrix
    want = {(p, mode): lamc.lamc_cocluster(a, lamc.LAMCConfig(**cfg),
                                           plan=lamc.partition.PartitionPlan(**plan),
                                           device=CPU)
            for p, plan in DIST_PLANS.items() for mode, cfg in DIST_MODES.items()}
    ref_draws = {p: torch_parity.lamc_draws(a, JPlan(**plan), JConfig(**CFG))
                 for p, plan in DIST_PLANS.items()}
    for mesh, (shape, axes, opts) in DIST_MESHES.items():
        cases = [(f"{p}/{mode}", a, cfg, DIST_PLANS[p], opts)
                 for p in DIST_PLANS for mode, cfg in DIST_MODES.items()]
        if mesh == "W4":
            cases += [(f"{p}/reference_draws", a, CFG, plan, dict(draws=ref_draws[p]))
                      for p, plan in DIST_PLANS.items()]
        ranks = torch_dist.run_world(torch_dist.lamc_cases, shape[0] * shape[1], tmp_path,
                                     shape, axes, cases)
        for rank, outs in enumerate(ranks):
            for (p, mode), one in want.items():
                got, what = outs[f"{p}/{mode}"], f"{mesh} rank {rank} {p} {mode}"
                assert isinstance(got, dict), f"{what}: {got}"
                for key in EXACT:
                    np.testing.assert_array_equal(got[key], getattr(one, key).numpy(),
                                                  err_msg=f"{what}: {key}")
                for key in ("row_sigs", "col_sigs"):
                    np.testing.assert_allclose(
                        got[key], getattr(one, key).numpy(), rtol=0,
                        atol=1e-6 * np.abs(getattr(one, key).numpy()).max(),
                        err_msg=f"{what}: {key}")
                if mode == "forced":
                    for key in EXACT:
                        np.testing.assert_array_equal(
                            got[key], outs[f"{p}/hard"][key], err_msg=f"{what}: forced {key}")
        if mesh == "W4":
            theirs = _reference_distributed(a, tmp_path)
            for p, (rows, cols) in theirs.items():
                got = ranks[0][f"{p}/reference_draws"]
                np.testing.assert_array_equal(got["row_labels"], rows, err_msg=f"{p}: rows")
                np.testing.assert_array_equal(got["col_labels"], cols, err_msg=f"{p}: cols")


def test_deterministic_and_full_mask_is_no_mask(tmp_path):
    """One process: a full mask is no mask and a wrong mask raises. Four
    gloo ranks (the reference's ``test_distributed_small_matrix_and_bcoo_8dev``
    cases): ``distributed_lamc`` is deterministic, a COO matrix gives the
    dense labels, a 48-row matrix (fewer rows than signature_dim: q clamped
    per axis) runs, and the divisibility and format errors are raised."""
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

    rng = np.random.default_rng(0)
    small = planted_cocluster_matrix(rng, 48, 400, k=3, d=3, signal=4.0, noise=0.4).matrix
    sparse = planted_cocluster_matrix(rng, 480, 400, k=4, d=4, signal=4.0, noise=0.5, density=0.2).matrix
    plan_small = dict(n_rows=48, n_cols=400, m=4, n=2, phi=12, psi=200, t_p=2, seed=0)
    plan_sparse = dict(n_rows=480, n_cols=400, m=4, n=2, phi=120, psi=200, t_p=2, seed=0)
    chol = dict(CFG, qr_method="cholesky")
    cases = [
        ("det/1", pc.matrix, chol, DIST_PLANS["4x2"] | dict(n_rows=512, n_cols=384, phi=128,
                                                            psi=192), {}),
        ("det/2", pc.matrix, chol, DIST_PLANS["4x2"] | dict(n_rows=512, n_cols=384, phi=128,
                                                            psi=192), {}),
        ("small", small, dict(n_row_clusters=3, n_col_clusters=3), plan_small, {}),
        ("dense", sparse, CFG, plan_sparse, {}),
        ("coo", ("coo", sparse), dict(CFG, input_format="bcoo"), plan_sparse, {}),
        ("indivisible", sparse, CFG, plan_sparse | dict(m=3, n=1, phi=160, psi=400), {}),
        ("t_p", sparse, CFG, plan_sparse | dict(t_p=3),
         dict(block_axes=("model",), resample_axis="data")),
        ("format", ("coo", sparse), CFG, plan_sparse, {}),
    ]
    ranks = torch_dist.run_world(torch_dist.lamc_cases, 4, tmp_path, (2, 2),
                                 ("data", "model"), cases)
    single = lamc.lamc_cocluster(pc.matrix, cfg, plan=lamc.partition.PartitionPlan(
        **cases[0][3]), device=CPU)
    for rank, outs in enumerate(ranks):
        for key in EXACT:
            np.testing.assert_array_equal(outs["det/1"][key], outs["det/2"][key],
                                          err_msg=f"rank {rank}: two runs, {key}")
            np.testing.assert_array_equal(outs["det/1"][key], getattr(single, key).numpy(),
                                          err_msg=f"rank {rank}: against one process, {key}")
            np.testing.assert_array_equal(outs["coo"][key], outs["dense"][key],
                                          err_msg=f"rank {rank}: COO against dense, {key}")
        assert outs["small"]["row_labels"].shape == (48,)
        assert outs["small"]["col_sigs"].shape == (3, 48), "q_col clamped to the 48 rows"
        assert "multiple of the device count 4" in outs["indivisible"]
        assert "T_p=3 must be a multiple of the resample axis size 2" in outs["t_p"]
        assert "input_format='dense'" in outs["format"]


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
