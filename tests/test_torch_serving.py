"""The port's serving path against the reference package, on the CPU.

One small port fit (512 x 384, k = 4, a fixed plan) gives the model; the
reference gets the same arrays as its own ``CoclusterModel``, so no test
here pays for a reference fit. Checked:

* checkpoints cross between the packages in both directions, arrays bit-equal,
  leaf hashes and ``model_fingerprint`` equal;
* ``load_model`` fails loudly on empty, foreign and tampered checkpoints;
* ``assign_rows`` / ``assign_cols`` / ``_topk`` give the reference's labels on
  the same model and requests, dense and COO, and empty results for zero
  rows;
* ``validate_request`` gives the reference's reason codes;
* ``AssignService``: coalesced results equal direct ones, top-k and column
  traffic, zero rows, reject codes, ``queue_full`` (ordered by an ``Event``,
  never by sleeping), close, ``swap`` and ``swap_async``, the registry;
* ``serve_lamc.serve`` returns the reference's keys.

``model_from_result`` on a fit with every reference draw injected is held to
the reference model (labels exact, signatures within 1e-5) in
``test_torch_lamc.py::test_labels_match_reference_on_its_draws``, which
already pays for that reference fit.

Every service runs as a context manager, so its workers are joined; every
``result()`` waits at most 60 s and nothing asserts elapsed time.
"""

import dataclasses
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import obs as jobs
from repro import streaming as jstreaming
from repro.core import LAMCConfig as JConfig
from repro.core.partition import PartitionPlan as JPlan
from repro.data import to_bcoo as jto_bcoo
from repro.launch import serve_lamc as jserve_lamc
from repro_torch import checkpoint, interop, obs, streaming
from repro_torch.core import lamc
from repro_torch.data import planted_cocluster_matrix, to_bcoo
from repro_torch.launch import serve_lamc

CPU = "cpu"
WAIT = 60.0
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def fitted():
    pc = planted_cocluster_matrix(np.random.default_rng(0), 512, 384, k=4)
    cfg = lamc.LAMCConfig(4, 4)
    plan = lamc.partition.PartitionPlan(512, 384, 2, 2, 256, 192, 2, seed=0)
    res = lamc.lamc_cocluster(pc.matrix, cfg, plan=plan, device=CPU)
    return streaming.model_from_result(res), cfg, res.plan, pc


def _numpy(model) -> dict:
    return {f: np.asarray(getattr(model, f)) for f in model._fields}


def _reference_model(model):
    return jstreaming.CoclusterModel(**{f: jnp.asarray(v)
                                        for f, v in _numpy(model).items()})


def _assert_same_model(port_model, ref_model):
    for f in port_model._fields:
        mine, theirs = getattr(port_model, f).numpy(), np.asarray(getattr(ref_model, f))
        assert mine.dtype == theirs.dtype, f
        np.testing.assert_array_equal(mine, theirs, err_msg=f)


def _service(model, **over):
    kw = dict(batch=16, replicas=2)
    kw.update(over)
    return streaming.AssignService(model, version="v1", config=streaming.ServeConfig(**kw),
                                   metrics=obs.Registry(), device=CPU)


# --- checkpoints across the packages -------------------------------------------


def test_reference_checkpoint_loads_in_the_port(fitted, tmp_path):
    model, _, _, _ = fitted
    jmodel = _reference_model(model)
    jstreaming.save_model(str(tmp_path), jmodel, cfg=JConfig(4, 4),
                          plan=JPlan(512, 384, m=2, n=2, phi=256, psi=192, t_p=2),
                          extra={"note": "ref"})
    got, meta = streaming.load_model(str(tmp_path), device=CPU)
    _assert_same_model(got, jmodel)
    assert streaming.model_fingerprint(got) == jstreaming.model_fingerprint(jmodel)
    assert meta["kind"] == streaming.MODEL_KIND and meta["note"] == "ref"
    assert meta["config"]["n_row_clusters"] == 4 and meta["plan"]["phi"] == 256


def test_port_checkpoint_loads_in_the_reference(fitted, tmp_path):
    model, cfg, plan, _ = fitted
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    streaming.save_model(mine, model, cfg=cfg, plan=plan)
    jmodel, meta = jstreaming.load_model(mine)
    _assert_same_model(model, jmodel)
    assert jstreaming.model_fingerprint(jmodel) == streaming.model_fingerprint(model)
    # the manifest is the reference's, leaf for leaf, and so is the metadata
    jstreaming.save_model(theirs, jmodel, cfg=JConfig(4, 4),
                          plan=JPlan(**dataclasses.asdict(plan)))
    assert checkpoint.read_manifest(mine, 0) == jckpt.read_manifest(theirs, 0)
    assert meta == jckpt.read_manifest(theirs, 0)["extra"]


def test_checkpoint_names_follow_the_reference_flattener(tmp_path):
    tree = {"b": [np.arange(3, dtype=np.int32), 2.5], "a": {"x": torch.ones(2, 2)},
            "c": None}
    checkpoint.save(str(tmp_path), 3, tree, extra_meta={"k": 1})
    names = list(checkpoint.read_manifest(str(tmp_path), 3)["leaves"])
    assert names == ["a/x", "b/0", "b/1"]
    got, extra = jckpt.restore_tree(str(tmp_path), 3)
    np.testing.assert_array_equal(got["b"]["0"], [0, 1, 2])
    back, extra2 = checkpoint.restore(str(tmp_path), 3, tree, device=CPU)
    assert back["b"][1] == 2.5 and back["c"] is None and extra == extra2 == {"k": 1}
    assert torch.equal(back["a"]["x"], torch.ones(2, 2))


def test_checkpoint_survives_a_crash_at_each_commit_stage(tmp_path):
    """A half-written ``.tmp`` is invisible, an overwrite keeps the step
    readable, and a crash between displacing the old copy and renaming the
    new one in leaves the ``.old`` copy readable — by both packages."""
    root = str(tmp_path)
    checkpoint.save(root, 1, {"w": np.arange(4, dtype=np.float32)})
    os.makedirs(os.path.join(root, "step_00000002.tmp"))      # crashed save
    assert checkpoint.available_steps(root) == [1] and checkpoint.latest_step(root) == 1
    checkpoint.save(root, 1, {"w": np.arange(4, dtype=np.float32) + 1})   # overwrite
    assert sorted(os.listdir(root)) == ["step_00000001", "step_00000002.tmp"]
    os.rename(os.path.join(root, "step_00000001"), os.path.join(root, "step_00000001.old"))
    assert checkpoint.available_steps(root) == jckpt.available_steps(root) == [1]
    back, _ = checkpoint.restore(root, 1, {"w": np.zeros(4, np.float32)}, device=CPU)
    np.testing.assert_array_equal(back["w"].numpy(), [1, 2, 3, 4])
    theirs, _ = jckpt.restore_tree(root, 1)
    np.testing.assert_array_equal(theirs["w"], [1, 2, 3, 4])
    with pytest.raises(FileNotFoundError):
        checkpoint.read_manifest(root, 2)


def test_bfloat16_leaves_round_trip(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    checkpoint.save(str(tmp_path), 0, {"w": x})
    back, _ = checkpoint.restore(str(tmp_path), 0, {"w": x}, device=CPU)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    leaf = checkpoint.read_manifest(str(tmp_path), 0)["leaves"]["w"]
    assert leaf["dtype"] == "bfloat16"


def test_load_model_is_loud_on_bad_checkpoints(fitted, tmp_path):
    model, _, _, _ = fitted
    with pytest.raises(streaming.ModelLoadError, match="no committed checkpoint"):
        streaming.load_model(str(tmp_path / "empty"), device=CPU)
    foreign = str(tmp_path / "foreign")
    checkpoint.save(foreign, 0, {"w": np.zeros(3, np.float32)})
    with pytest.raises(streaming.ModelLoadError, match="not a CoclusterModel"):
        streaming.load_model(foreign, device=CPU)
    tampered = str(tmp_path / "tampered")
    streaming.save_model(tampered, model)
    path = os.path.join(tampered, "step_00000000", "arrays.npz")
    arrays = dict(np.load(path))
    arrays[".row_sigs"] = arrays[".row_sigs"] + 1.0
    np.savez(path, **arrays)
    with pytest.raises(checkpoint.CheckpointCorruptError, match=r"\.row_sigs"):
        streaming.load_model(tampered, device=CPU)


# --- assignment ---------------------------------------------------------------


@pytest.mark.parametrize("axis,k,fmt", [
    ("rows", 1, "dense"), ("cols", 1, "dense"), ("rows", 3, "dense"),
    ("cols", 4, "dense"), ("rows", 1, "coo"), ("cols", 2, "coo"),
])
def test_assign_matches_the_reference(fitted, axis, k, fmt):
    """One model in both packages: the reference's arrays carried into the
    port by ``interop.model_from_numpy``."""
    _, _, _, pc = fitted
    jmodel = _reference_model(fitted[0])
    model = interop.model_from_numpy(jmodel, CPU)
    _assert_same_model(model, jmodel)
    rng = np.random.default_rng(5)
    base = pc.matrix if axis == "rows" else pc.matrix.T
    x = base[rng.permutation(base.shape[0])[:40]].copy()
    x[rng.random(x.shape) < 0.7] = 0.0           # sparse enough for a COO batch
    mine_x = to_bcoo(x, CPU) if fmt == "coo" else x
    theirs_x = jto_bcoo(x) if fmt == "coo" else jnp.asarray(x)
    if k == 1:
        fn = streaming.assign_rows if axis == "rows" else streaming.assign_cols
        jfn = jstreaming.assign_rows if axis == "rows" else jstreaming.assign_cols
        got, want = fn(model, mine_x), jfn(jmodel, theirs_x)
        got_s, want_s = got.score, want.score
    else:
        fn = streaming.assign_rows_topk if axis == "rows" else streaming.assign_cols_topk
        jfn = (jstreaming.assign_rows_topk if axis == "rows"
               else jstreaming.assign_cols_topk)
        got, want = fn(model, mine_x, k=k), jfn(jmodel, theirs_x, k=k)
        got_s, want_s = got.scores, want.scores
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL, atol=ATOL)


def test_zero_row_batches_and_bad_requests(fitted):
    model, _, _, _ = fitted
    res = streaming.assign_rows(model, np.zeros((0, model.n_cols), np.float32))
    assert res.labels.shape == (0,) and res.labels.dtype == torch.int32
    assert res.score.shape == (0,) and res.score.dtype == torch.float32
    assert streaming.assign_cols(model, torch.zeros((0, model.n_rows))).labels.shape == (0,)
    top = streaming.assign_cols_topk(model, torch.zeros((0, model.n_rows)), k=3)
    assert top.labels.shape == (0, 3) and top.scores.shape == (0, 3)
    with pytest.raises(ValueError, match="k"):
        streaming.assign_rows_topk(model, torch.zeros((0, model.n_cols)), k=99)
    with pytest.raises(ValueError, match="row vectors"):
        streaming.assign_rows(model, torch.ones((4, 123)))
    with pytest.raises(ValueError, match="column vectors"):
        streaming.assign_cols(model, torch.ones((4, 123)))
    with pytest.raises(ValueError, match="row vectors"):
        streaming.assign_rows(model, to_bcoo(np.ones((4, 123), np.float32), CPU))


def test_memberships_are_a_view_of_the_votes(fitted):
    model, _, _, _ = fitted
    rows, cols = streaming.model_memberships(model, overlap_threshold=0.6,
                                             min_membership=1)
    assert rows.shape == (model.n_rows, 4) and cols.dtype == torch.bool
    assert bool((rows.sum(1) >= 1).all())


_BAD = {
    "good": np.zeros((3, 384), np.float32),
    "empty": np.zeros((0, 384), np.float32),
    "rank": np.zeros((384,), np.float32),
    "width": np.zeros((3, 385), np.float32),
    "dtype": np.zeros((3, 384), np.int32),
    "nan": np.full((3, 384), np.nan, np.float32),
}


@pytest.mark.parametrize("name", list(_BAD))
def test_validate_request_codes_match_the_reference(name):
    x = _BAD[name]
    mine, theirs = streaming.validate_request(x, 384), jstreaming.validate_request(x, 384)
    assert mine == theirs
    assert serve_lamc.validate_request(x, 384) == jserve_lamc.validate_request(x, 384)


# --- the service ----------------------------------------------------------------


def test_service_coalesces_to_the_direct_answers(fitted):
    model, _, _, pc = fitted
    sizes = [1, 3, 16, 0, 7, 5]
    reqs, off = [], 0
    for s in sizes:
        reqs.append(pc.matrix[off:off + s])
        off += s
    direct = [streaming.assign_rows(model, x) for x in reqs]
    with _service(model) as svc:
        tickets = [svc.submit(x) for x in reqs]
        for x, t, want in zip(reqs, tickets, direct):
            res = t.result(timeout=WAIT)
            assert res.ok and res.version == "v1", (res.reason, res.detail)
            assert res.labels.shape == (x.shape[0],)
            np.testing.assert_array_equal(res.labels, want.labels.numpy())
            np.testing.assert_allclose(res.scores, want.score.numpy(), rtol=RTOL, atol=ATOL)
        workers = list(svc._workers)
    assert not any(w.is_alive() for w in workers)


def test_service_topk_and_column_traffic(fitted):
    model, _, _, pc = fitted
    xr, xc = pc.matrix[:6], pc.matrix.T[:6].copy()
    with _service(model) as svc:
        rk = svc.submit(xr, axis="rows", k=3).result(timeout=WAIT)
        rc = svc.submit(xc, axis="cols").result(timeout=WAIT)
        empty = svc.submit(np.zeros((0, model.n_rows), np.float32), axis="cols",
                           k=2).result(timeout=WAIT)
    assert rk.ok and rk.labels.shape == (6, 3)
    np.testing.assert_array_equal(rk.labels,
                                  streaming.assign_rows_topk(model, xr, k=3).labels.numpy())
    np.testing.assert_array_equal(rc.labels, streaming.assign_cols(model, xc).labels.numpy())
    assert empty.ok and empty.labels.shape == (0, 2) and empty.version == "v1"


def test_service_rejects_with_the_reference_codes(fitted):
    model, _, _, _ = fitted
    dim = model.n_cols
    cases = [
        (np.zeros((3,), np.float32), {}, "bad_rank"),
        (np.zeros((3, dim + 1), np.float32), {}, "bad_width"),
        (np.zeros((3, dim), np.int64), {}, "bad_dtype"),
        (np.full((3, dim), np.inf, np.float32), {}, "non_finite"),
        (np.zeros((3, dim), np.float32), {"k": 9}, "bad_k"),
        (np.zeros((17, dim), np.float32), {}, "oversize"),
    ]
    with _service(model) as svc:
        for x, kw, code in cases:
            res = svc.submit(x, **kw).result(timeout=WAIT)
            assert not res.ok and res.reason == code and res.labels is None
        with pytest.raises(ValueError, match="axis"):
            svc.submit(np.zeros((2, dim), np.float32), axis="diag")
        rejected = svc.stats()["rejected"]
    assert {key.split("=")[1] for key in rejected} == {c for _, _, c in cases}
    assert set(streaming.REJECT_REASONS) == set(jstreaming.REJECT_REASONS)


def test_queue_full_sheds_load(fitted):
    model, _, _, _ = fitted
    taken, gate = threading.Event(), threading.Event()
    with _service(model, batch=4, replicas=1, max_queue_rows=8) as svc:
        score = svc._score_batch

        def stalled(key, reqs):
            taken.set()
            gate.wait(WAIT)
            score(key, reqs)

        svc._score_batch = stalled
        x4 = np.zeros((4, model.n_cols), np.float32)
        first = svc.submit(x4)
        assert taken.wait(WAIT)             # the worker holds the first batch
        held = [svc.submit(x4), svc.submit(x4)]
        shed = svc.submit(x4).result(timeout=WAIT)
        assert not shed.ok and shed.reason == "queue_full"
        gate.set()
        assert all(t.result(timeout=WAIT).ok for t in [first] + held)


def test_swap_to_another_width_fails_queued_requests_not_the_worker(fitted):
    """Requests admitted at the old width and scored after a swap to a
    model of another width are each answered ``internal_error``; the
    worker goes on serving."""
    model, _, _, pc = fitted
    narrow = model._replace(col_labels=model.col_labels[:300],
                            col_votes=model.col_votes[:300])
    taken, gate = threading.Event(), threading.Event()
    x = pc.matrix[:4]
    with _service(model, batch=4, replicas=1) as svc:
        score = svc._score_batch

        def stalled(key, reqs):
            taken.set()
            gate.wait(WAIT)
            score(key, reqs)

        svc._score_batch = stalled
        first = svc.submit(x)
        assert taken.wait(WAIT)             # the worker holds the first batch
        queued = svc.submit(x)
        svc.swap(narrow, "v2")
        gate.set()
        for ticket in (first, queued):
            res = ticket.result(timeout=WAIT)
            assert not res.ok and res.reason == "internal_error"
            assert "does not match the model's 300" in res.detail
        svc._score_batch = score
        svc.swap(model, "v3")
        res = svc.submit(x).result(timeout=WAIT)
    assert res.ok and res.version == "v3"


def test_close_drains_then_rejects(fitted):
    model, _, _, _ = fitted
    x = np.zeros((2, model.n_cols), np.float32)
    with _service(model) as svc:
        admitted = svc.submit(x)
    assert admitted.result(timeout=WAIT).ok
    res = svc.submit(x).result(timeout=WAIT)
    assert not res.ok and res.reason == "shutdown"


def test_swap_serves_the_new_version(fitted):
    """The successor's signature table is a roll of the original's, so its
    labels are a known permutation of the first model's."""
    model, _, _, pc = fitted
    model2 = model._replace(row_sigs=torch.roll(model.row_sigs, 1, dims=0))
    x = pc.matrix[:8]
    want1 = streaming.assign_rows(model, x).labels.numpy()
    with _service(model) as svc:
        svc.submit(x, k=2).result(timeout=WAIT)
        assert svc.swap(model2, "v2") == "v1"
        assert set(svc._engine.warmed_keys()) == {("rows", 1), ("rows", 2)}
        res = svc.submit(x).result(timeout=WAIT)
        failed = svc.swap_async(lambda: 1 / 0, "v3").result(timeout=WAIT)
        assert svc.version == "v2"
    assert res.ok and res.version == "v2"
    np.testing.assert_array_equal(res.labels, (want1 + 1) % 4)
    assert not failed.ok and failed.reason == "internal_error"
    assert "ZeroDivisionError" in failed.detail


def test_hot_swap_under_load_drops_nothing(fitted):
    """More client threads than cores keep submitting (every other request
    malformed) while the model is swapped back and forth four times, with
    the interpreter switching threads as often as it can: every request is
    answered, each by one version with that version's direct labels, and no
    count in ``stats()`` loses an update."""
    model, _, _, pc = fitted
    models = {"v1": model, "v2": model._replace(row_sigs=torch.roll(model.row_sigs, 1, 0))}
    want = {v: streaming.assign_rows(m, pc.matrix[:64]).labels.numpy()
            for v, m in models.items()}
    n_clients, per_client = (os.cpu_count() or 4) + 2, 100
    tickets = [[] for _ in range(n_clients)]
    started = threading.Barrier(n_clients + 1, timeout=WAIT)

    def client(i):
        started.wait()
        for j in range(per_client):
            lo = (7 * j + 3 * i) % 60
            x = pc.matrix[lo] if j % 2 == 1 else pc.matrix[lo:lo + 4]   # bad rank
            tickets[i].append((lo, svc.submit(x)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _service(model, batch=8, replicas=4, max_queue_rows=10**6) as svc:
            threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
            for t in threads:
                t.start()
            started.wait()
            for n in range(4):
                svc.swap(*((models["v2"], "v2") if n % 2 == 0 else (models["v1"], "v1")))
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
            results = [(lo, t.result(timeout=WAIT)) for ts in tickets for lo, t in ts]
            stats = svc.stats()
    finally:
        sys.setswitchinterval(interval)
    good = [(lo, r) for lo, r in results if r.reason != "bad_rank"]
    assert len(results) == n_clients * per_client
    assert len(good) == n_clients * (per_client - per_client // 2)
    for lo, res in good:
        assert res.ok, (res.reason, res.detail)
        np.testing.assert_array_equal(res.labels, want[res.version][lo:lo + 4])
    assert stats["swaps"] == 4 and stats["submitted"] == len(good)
    assert stats["rows_served"] == 4 * len(good)
    assert stats["rejected"] == {"reason=bad_rank": len(results) - len(good)}


def test_registry_round_trip_feeds_swap_async(fitted, tmp_path):
    model, cfg, _, pc = fitted
    reg = streaming.ModelRegistry(str(tmp_path))
    e1 = reg.publish("lamc", model, cfg=cfg, metrics={"nmi": 0.9},
                     data_fingerprint=streaming.model_fingerprint(model))
    e2 = reg.publish("lamc", model, cfg=cfg)
    assert (e1.version, e2.version) == ("v_000001", "v_000002")
    assert reg.versions("lamc") == ["v_000001", "v_000002"] and reg.names() == ["lamc"]
    assert e1.config_hash == streaming.config_hash(cfg) == jstreaming.config_hash(
        dataclasses.asdict(cfg))
    back, ent = reg.load("lamc", "v_000001", device=CPU)
    assert ent.metrics == {"nmi": 0.9} and ent.data_fingerprint == e1.data_fingerprint
    assert streaming.model_fingerprint(back) == e1.data_fingerprint
    # the reference reads the port's registry
    jback, jent = jstreaming.ModelRegistry(str(tmp_path)).load("lamc")
    assert jent.version == "v_000002" and jent.config_hash == e2.config_hash
    with _service(model) as svc:
        done = svc.swap_async(lambda: reg.load("lamc", device=CPU)[0], e2.version)
        assert done.result(timeout=WAIT).ok
        res = svc.submit(pc.matrix[:3]).result(timeout=WAIT)
    assert res.version == "v_000002"
    with pytest.raises(ValueError, match="bad model name"):
        reg.publish("../x", model)


# --- telemetry --------------------------------------------------------------------


def test_histogram_percentiles_match_the_reference():
    """The same observations in both packages' fixed-bucket histograms give
    the same p50/p99, count and sum."""
    obs_values = np.random.default_rng(3).lognormal(5.0, 1.5, size=2000)
    mine, theirs = obs.Histogram("lat_us"), jobs.Histogram("lat_us")
    for v in obs_values:
        mine.observe(float(v))
        theirs.observe(float(v))
    for p in (50, 90, 99):
        assert mine.percentile(p) == theirs.percentile(p)
    assert (mine.count, mine.sum) == (theirs.count, theirs.sum)
    assert mine.snapshot() == theirs.snapshot()


def test_service_metric_names_are_the_references(fitted):
    model, _, _, _ = fitted
    reg = obs.Registry()
    with streaming.AssignService(model, config=streaming.ServeConfig(batch=8),
                                 metrics=reg, device=CPU) as svc:
        svc.submit(np.zeros((3,), np.float32)).result(timeout=WAIT)
        assert svc.submit(np.zeros((2, model.n_cols), np.float32)).result(timeout=WAIT).ok
    names = set(reg.snapshot())
    assert {"serve_svc_rejected", "serve_svc_submitted", "serve_svc_rows",
            "serve_svc_batches", "serve_svc_swaps", "serve_svc_queue_rows",
            "serve_svc_batch_latency_us", "serve_svc_request_latency_us",
            "serve_svc_batch_fill_pct"} <= names
    assert reg.snapshot()["serve_svc_rejected"]["series"] == {"reason=bad_rank": 1.0}


def test_serve_trace_has_the_reference_spans_and_schema(fitted, tmp_path):
    """With spans on, ``serve`` writes the reference's span tree, and the
    JSONL trace passes the reference's schema validator."""
    model, _, _, _ = fitted
    streaming.save_model(str(tmp_path / "m"), model)
    obs.configure(enabled=True)
    try:
        obs.reset_trace()
        serve_lamc.serve(str(tmp_path / "m"), batch=4, requests=2, warmup=1,
                         adversarial=1, device=CPU)
        path = obs.write_trace_jsonl(str(tmp_path / "trace.jsonl"))
        roots = obs.current_trace().roots
    finally:
        obs.configure(enabled=False)
        obs.reset_trace()
    assert [r.name for r in roots] == ["serve"]
    assert [c.name for c in roots[0].children] == ["warmup", "request_loop"]
    assert roots[0].attrs["served"] == 2 and roots[0].attrs["errors"] == 1
    assert jobs.validate_trace_jsonl(path) == []


# --- the launcher -----------------------------------------------------------------


def test_serve_launcher_reports_the_reference_keys(fitted, tmp_path):
    model, _, _, _ = fitted
    streaming.save_model(str(tmp_path), model)
    mine = serve_lamc.serve(str(tmp_path), batch=16, requests=2, warmup=1,
                            adversarial=2, device=CPU)
    theirs = jserve_lamc.serve(str(tmp_path), batch=16, requests=2, warmup=1,
                               adversarial=2, registry=jobs.Registry())
    assert set(mine) == set(theirs)
    assert mine["serve_assign_rows_rows"] == theirs["serve_assign_rows_rows"] == 32
    assert mine["serve_assign_rows_errors"] == 2
    assert mine["_labels_sample"] == theirs["_labels_sample"]
    cols = serve_lamc.serve(str(tmp_path), axis="cols", batch=8, rows=20, warmup=1,
                            device=CPU)
    assert cols["serve_assign_cols_rows"] == 20 and cols["serve_assign_cols_qps"] > 0
    svc = serve_lamc.serve_service(str(tmp_path), batch=8, requests=4, warmup=1,
                                   device=CPU)
    assert svc["serve_svc_rows_rows"] == 8 and svc["_batches"] >= 1


def test_fit_demo_waits_for_the_streaming_fit(tmp_path):
    """``--fit-demo`` needs ``streaming.fit``, which is not ported: it raises
    and names the roadmap item instead of fitting something else."""
    with pytest.raises(NotImplementedError, match="item 11"):
        serve_lamc.fit_demo_model(str(tmp_path))
    with pytest.raises(NotImplementedError, match="streaming.fit"):
        serve_lamc.main(["--ckpt", str(tmp_path), "--fit-demo", "--device", "cpu"])
