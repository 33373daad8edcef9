"""The rest of the reference's public API in the port, against the reference.

The metrics, generators, failure simulations and the host-side Jaccard
merge are numpy in both packages: on the same inputs and seeds they must
give exactly the same outputs. Trace files cross between the packages (each
reads and validates the other's) and render to the same text. The two
example scripts run end to end on the CPU at a small size. Nothing here
compiles JAX code.

The checks run as one test item: the suite's collected count sets
pytest-xdist's schedule, and with it whether the reference's fuzz cases
share a worker (ROADMAP.md queue 3, "The count rule"). Each check names its
case in its assertion message.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import merging as jmerging
from repro.core import metrics as jmetrics
from repro.core import probability as jprobability
from repro.data import synthetic as jsynthetic
from repro_torch import obs as tobs
from repro_torch.core import merging as tmerging
from repro_torch.core import metrics as tmetrics
from repro_torch.core import probability as tprobability
from repro_torch.data import synthetic as tsynthetic
from torch_parity import release_compiled_code  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _labels(seed, n=120, k=4, outliers=0.1):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    lab[rng.random(n) < outliers] = -1
    return lab


def _membership(seed, n=120, k=4):
    return np.random.default_rng(seed).random((n, k)) < 0.3


METRIC_CASES = {
    "labels": lambda: (_labels(0), _labels(1)),
    "same_labels": lambda: (_labels(2), _labels(2)),
    "memberships": lambda: (_membership(3), _membership(4)),
    "labels_vs_membership": lambda: (_labels(5, outliers=0.0), _membership(6)),
    "no_pairs": lambda: (np.array([1]), np.array([0])),
}


def _metrics_are_equal():
    for case, make in METRIC_CASES.items():
        a, b = make()
        for name in ("omega_index", "overlap_f1"):
            assert getattr(tmetrics, name)(a, b) == getattr(jmetrics, name)(a, b), (case, name)
            assert getattr(tmetrics, name)(b, a) == getattr(jmetrics, name)(b, a), (case, name)
    for labels in (_labels(7), _labels(8, k=1), np.full(5, -1), np.array([3, 0, -1, 3])):
        for k in (None, 7):
            np.testing.assert_array_equal(tmetrics.membership_from_labels(labels, k=k),
                                          jmetrics.membership_from_labels(labels, k=k),
                                          err_msg=f"{labels} k={k}")


GENERATORS = {
    "overlap_default": lambda m: m.planted_overlapping_cocluster_matrix(
        np.random.default_rng(0), 200, 150, 4),
    "overlap_both_axes_sparse": lambda m: m.planted_overlapping_cocluster_matrix(
        np.random.default_rng(1), 180, 160, 3, 5, row_overlap=0.3, row_outliers=0.1,
        col_overlap=0.2, col_outliers=0.05, density=0.3),
    "overlap_outliers_only": lambda m: m.planted_overlapping_cocluster_matrix(
        np.random.default_rng(5), 150, 120, 5, row_overlap=0.0, row_outliers=0.2,
        signal=2.0, noise=0.5),
    "overlap_k_wider_than_d": lambda m: m.planted_overlapping_cocluster_matrix(
        np.random.default_rng(6), 130, 90, 6, 2, row_overlap=0.5, col_overlap=0.5),
    "amazon1000": lambda m: m.amazon1000_proxy(seed=2),
    "amazon1000_default": lambda m: m.amazon1000_proxy(),
    "classic4": lambda m: m.classic4_proxy(seed=3, n_docs=700),
    "classic4_default": lambda m: m.classic4_proxy(),
    "rcv1": lambda m: m.rcv1_proxy(seed=4, n_docs=900, n_terms=400),
    "rcv1_seed0": lambda m: m.rcv1_proxy(n_docs=2000, n_terms=700),
}


def _generators_are_byte_identical():
    for name, make in GENERATORS.items():
        mine, theirs = make(tsynthetic), make(jsynthetic)
        assert type(mine).__name__ == type(theirs).__name__, name
        assert mine.matrix.dtype == theirs.matrix.dtype, name
        assert mine.matrix.tobytes() == theirs.matrix.tobytes(), name
        assert (mine.k, mine.d, mine.density, mine.shape) == (
            theirs.k, theirs.d, theirs.density, theirs.shape), name
        for field in ("row_labels", "col_labels", "row_membership", "col_membership"):
            if hasattr(theirs, field):
                np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field),
                                              err_msg=f"{name} {field}")
        coo = mine.bcoo("cpu")
        np.testing.assert_array_equal(coo.to_dense().numpy(), mine.matrix, err_msg=name)


def _failure_simulations_are_equal():
    for seed, t_p, n_blocks, n_failed in ((0, 3, 8, 2), (5, 4, 4, 0), (9, 2, 6, 6),
                                          (1, 1, 1, 1), (3, 5, 10, 5), (7, 2, 3, 1)):
        mine = tprobability.sample_block_failures(seed, t_p, n_blocks, n_failed)
        np.testing.assert_array_equal(mine, jprobability.sample_block_failures(
            seed, t_p, n_blocks, n_failed), err_msg=f"{seed, t_p, n_blocks, n_failed}")
        assert (mine.sum(1) == n_blocks - n_failed).all()
        with pytest.raises(ValueError):
            tprobability.sample_block_failures(seed, t_p, n_blocks, n_blocks + 1)
    for args in ((40, 30, 400, 300, 4, 3, 3, 3), (12, 10, 256, 128, 8, 4, 2, 2),
                 (100, 100, 1000, 1000, 4, 4, 20, 20), (5, 5, 600, 600, 16, 16, 1, 1)):
        mine = tprobability.mc_failure_estimate(np.random.default_rng(7), *args, trials=300)
        theirs = jprobability.mc_failure_estimate(np.random.default_rng(7), *args,
                                                  trials=300)
        assert mine == theirs, args
    assert tprobability.PartitionSpec1D(4, 100) == tprobability.PartitionSpec1D(
        count=4, size=100)
    assert [f.name for f in tprobability.dataclasses.fields(tprobability.PartitionSpec1D)] \
        == [f.name for f in jprobability.dataclasses.fields(jprobability.PartitionSpec1D)]


def _atoms(seed, n_rows=60, n_cols=40, t_p=2, m=2, n=2, per_block=3):
    rng = np.random.default_rng(seed)
    atoms = []
    for t in range(t_p):
        for i in range(m):
            for j in range(n):
                for _ in range(per_block):
                    atoms.append(dict(
                        rows={int(r) for r in rng.choice(n_rows, rng.integers(3, 20), False)},
                        cols={int(c) for c in rng.choice(n_cols, rng.integers(3, 15), False)},
                        resample=t, block=(i, j)))
    return atoms


def _jaccard_merge_host_is_equal():
    for tau, min_support in ((0.3, 1), (0.1, 2), (0.6, 1), (0.0, 1), (1.0, 1), (0.2, 4)):
        atoms = _atoms(int(tau * 10) + min_support)
        mine = tmerging.jaccard_merge_host(atoms, 60, 40, tau=tau, min_support=min_support)
        theirs = jmerging.jaccard_merge_host(atoms, 60, 40, tau=tau,
                                             min_support=min_support)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b, err_msg=f"tau={tau} min={min_support}")


def _record(pkg, shape):
    """A small trace in ``pkg``'s obs: nested spans with attrs and events, two
    root spans, or events alone."""
    was = pkg.enabled()
    pkg.configure(enabled=True)
    try:
        pkg.reset_trace()
        if shape == "nested":
            with pkg.span("fit", rows=12, cols=8):
                with pkg.span("plan", m=2):
                    pkg.event("picked", t_p=3)
                with pkg.span("pipeline"):
                    pass
        elif shape == "two_roots":
            with pkg.span("fit"):
                pass
            with pkg.span("serve", batch=4):
                pkg.event("swap", version=2)
        pkg.event("done", ok=True)
        return pkg.current_trace()
    finally:
        pkg.configure(enabled=was)


TRACE_TYPES = {"nested": ["trace", "span", "span", "event", "span", "event"],
               "two_roots": ["trace", "span", "span", "event", "event"],
               "events_only": ["trace", "event"]}


def _trace_files_cross_between_packages(tmp_path):
    for writer, reader in ((tobs, jobs), (jobs, tobs)):
        for shape, types in TRACE_TYPES.items():
            case = f"{writer.__name__} writes, {shape}"
            path = str(tmp_path / "trace.jsonl")
            writer.write_trace_jsonl(path, _record(writer, shape))
            rows = reader.read_trace_jsonl(path)
            assert rows == writer.read_trace_jsonl(path), case
            assert [r["type"] for r in rows] == types, case
            assert reader.validate_trace_jsonl(path) == [], case
            assert reader.validate_rows(rows) == writer.validate_rows(rows) == [], case
            assert tobs.render_rows(rows) == jobs.render_rows(rows), case


BAD_ROWS = {
    "empty": [],
    "no_header": [{"type": "span"}],
    "bad_span": [{"type": "trace", "version": 1},
                 {"type": "span", "name": "", "path": "x", "depth": -1,
                  "t_start_s": "0", "dur_s": -1.0, "attrs": []}],
    "bad_event_and_kind": [{"type": "trace", "version": 2},
                           {"type": "event", "name": "e", "path": "", "t_s": True,
                            "attrs": {}},
                           {"type": "trace"}, {"type": "other"}],
    "missing_keys": [{"type": "trace", "version": 1}, {"type": "span", "name": "a"},
                     {"type": "event", "name": "e"}],
    "path_not_ending_in_name": [{"type": "trace", "version": 1},
                                {"type": "span", "name": "a", "path": "a/b", "depth": 0,
                                 "t_start_s": 0.0, "dur_s": 1.0, "attrs": {}}],
}


def _validators_and_renderer_agree_on_bad_rows(tmp_path):
    for case, rows in BAD_ROWS.items():
        assert tobs.validate_rows(rows) == jobs.validate_rows(rows) != [], case
        good = [r for r in rows
                if r.get("type") == "event" and isinstance(r.get("attrs"), dict)]
        assert tobs.render_rows(good) == jobs.render_rows(good), case
    path = tmp_path / "bad.jsonl"
    path.write_text('{"type": "trace", "version": 1}\nnot json\n')
    assert tobs.validate_trace_jsonl(str(path)) == jobs.validate_trace_jsonl(str(path))


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart_example_runs_on_the_cpu(capsys):
    was = tobs.enabled()
    out = _example("torch_quickstart").main(["--device", "cpu", "--rows", "700",
                                             "--cols", "450"])
    assert tobs.enabled() == was
    printed = capsys.readouterr().out
    assert "held-out assign_rows" in printed and "lamc " in printed and "scc_full" in printed
    assert out["lamc_nmi"] > 0.6 and out["scc_full_nmi"] > 0.6, out
    assert out["heldout_nmi"] > 0.6, out


def _text_example_fits_serves_and_reloads(tmp_path, capsys):
    mod = _example("torch_text_coclustering")
    for args in ([], ["--overlap"]):
        out = mod.main(["--device", "cpu", "--n-docs", "1500"] + args)
        assert 0.0 <= out["fit_nmi"] <= 1.0 and 0.0 <= out["assign_nmi_vs_fit"] <= 1.0
    docs = out["memberships"]["docs"]
    assert docs["single"] + docs["multi"] + docs["outliers"] == 1500
    capsys.readouterr()
    # serve a saved checkpoint; an empty directory fails loudly
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    data = mod.classic4_proxy(seed=0, n_docs=1500)
    with pytest.raises(SystemExit, match="cannot serve"):
        mod.main(["--device", "cpu", "--n-docs", "1500", "--ckpt", str(ckpt)])
    res = mod.lamc_cocluster(data.matrix, mod.LAMCConfig(4, 4, min_cocluster_rows=700,
                                                         min_cocluster_cols=120),
                             device="cpu")
    mod.streaming.save_model(str(ckpt), mod.streaming.model_from_result(res))
    served = mod.main(["--device", "cpu", "--n-docs", "1500", "--ckpt", str(ckpt)])
    assert set(served) == {"consensus_confidence", "assign_nmi_vs_fit"}
    assert "restored cocluster_model (1500x1000)" in capsys.readouterr().out


def test_api_ports_match_reference_and_examples_run(tmp_path, capsys):
    _metrics_are_equal()
    _generators_are_byte_identical()
    _failure_simulations_are_equal()
    _jaccard_merge_host_is_equal()
    _trace_files_cross_between_packages(tmp_path)
    _validators_and_renderer_agree_on_bad_rows(tmp_path)
    _quickstart_example_runs_on_the_cpu(capsys)
    _text_example_fits_serves_and_reloads(tmp_path, capsys)
