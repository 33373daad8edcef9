"""The out-of-core streaming fit and its recovery loop, against the reference.

Checked, on the CPU:

* with the reference's draws injected (``torch_parity.stream_draws``), the
  port's fit gives ``repro.streaming.fit``'s row and column labels and vote
  tables exactly, for dense and COO chunks; its signatures and means agree
  within ``SIG_RTOL`` of their largest entry. The data is the reference's
  ``TestOutOfSampleAssignment`` case (``tests/test_streaming.py:170``), whose
  train and held-out NMI the port must reproduce: the reference reaches
  about 0.868 and 0.855 there, below that test's own 0.9 bar;
* ``run_with_recovery`` keeps the reference's contract
  (``tests/test_fault_tolerance.py``, ``TestRunWithRecovery``);
* injected failures, empty chunks, a failure before the first checkpoint,
  a failure in a ragged last chunk, a resume in the manner of a new process, and a real SIGKILL of a
  subprocess followed by a resume all give a model equal, leaf for leaf, to
  the uninterrupted run;
* FitState checkpoints load in either package and save again with equal
  leaf hashes;
* ``elastic_restore``: a FitState restored onto four gloo ranks
  (``tests/torch_dist.py``), each holding its shards, continues to the
  uninterrupted model leaf for leaf;
* the loud errors of the reference's tests.

The checks run as one test item: the suite's collected count sets
pytest-xdist's schedule, and with it whether the reference's fuzz cases
share a worker (ROADMAP.md queue 3, "The count rule"). Each check names its
case in its assertion message.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist
import torch_parity

from repro import checkpoint as jckpt
from repro import streaming as jstreaming
from repro.core.metrics import nmi
from repro.data import planted_cocluster_matrix
from repro.runtime import shardings as jshardings
from repro_torch import checkpoint, interop, obs, streaming
from repro_torch.data import to_bcoo
from repro_torch.runtime.fault_tolerance import (
    FailureInjector,
    SimulatedFailure,
    run_with_recovery,
)

jfit = importlib.import_module("repro.streaming.fit")
sfit = importlib.import_module("repro_torch.streaming.fit")

CPU = "cpu"
SIG_RTOL = 1e-5        # of max |value|; the seen gap is ~5e-7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_models_equal(a, b, what):
    for name in streaming.CoclusterModel._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {name} differs"


def assert_matches_reference(mine, ref, what):
    """Labels, votes, anchors and row means exactly; signatures and column
    means within SIG_RTOL of their largest entry."""
    for name in streaming.CoclusterModel._fields:
        want, got = np.asarray(getattr(ref, name)), getattr(mine, name).numpy()
        assert want.dtype == got.dtype, f"{what}: {name} dtype {got.dtype} vs {want.dtype}"
        if name in ("row_sigs", "col_sigs", "col_mean"):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=SIG_RTOL * np.abs(want).max(),
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {name}")


def leaves(ckpt_dir, step):
    return checkpoint.read_manifest(ckpt_dir, step)["leaves"]


# --- the recovery loop ---------------------------------------------------------


def _drive_loop(tmp, *, total, save_every, fail_at=(), max_retries=8):
    """An integer counter through the real checkpoint machinery: (final
    value, loop stats, save steps, restore steps)."""
    inj = FailureInjector(fail_at_steps=tuple(fail_at))
    saves, restores = [], []

    def step_fn(t, s):
        out = {"v": np.asarray(s["v"] + 1, np.int64)}
        inj.maybe_fail(t)
        return out

    def save_fn(s, st):
        saves.append(s)
        checkpoint.save(tmp, s, st, extra_meta={"step": s})

    def restore_state(step):
        restores.append(step)
        if step < 0:
            return {"v": np.asarray(0, np.int64)}
        return {"v": checkpoint.restore_tree(tmp, step)[0]["v"]}

    state, stats = run_with_recovery(
        total_steps=total, step_fn=step_fn, state={"v": np.asarray(0, np.int64)},
        ckpt_dir=tmp, save_every=save_every, restore_state=restore_state,
        max_retries=max_retries, save_fn=save_fn)
    return int(state["v"]), stats, saves, restores


def check_recovery_loop(tmp_path):
    inj = FailureInjector(fail_at_steps=(2,))
    inj.maybe_fail(0)
    with pytest.raises(SimulatedFailure, match="step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)                                  # a retried step passes
    a, b = FailureInjector((1,)), FailureInjector((1,))
    for one in (a, b):                                 # fired sets are per instance
        with pytest.raises(SimulatedFailure):
            one.maybe_fail(1)

    reg = obs.get_registry()
    before = {name: reg.counter(name).value for name in
              ("recovery_failures", "recovery_restores", "recovery_checkpoints",
               "recovery_stale_checkpoints")}
    obs.configure(enabled=True)
    try:
        obs.reset_trace()
        v, stats, saves, restores = _drive_loop(str(tmp_path / "a"), total=7,
                                                save_every=2, fail_at=(0, 3, 5))
        events = [e["name"] for e in obs.current_trace().events]
    finally:
        obs.configure(enabled=False)
        obs.reset_trace()
    assert (v, stats) == (7, {"failures": 3, "final_step": 7}), "progress"
    assert restores == [-1, 2, 4], f"restore steps {restores}"
    assert saves == [2, 4, 6, 7], f"save steps {saves}"
    assert events.count("recovery.restore") == 3 and "recovery.checkpoint_saved" in events
    delta = {name: reg.counter(name).value - before[name] for name in before}
    assert delta == {"recovery_failures": 3, "recovery_restores": 3,
                     "recovery_checkpoints": 4, "recovery_stale_checkpoints": 0}, delta

    v, _, saves, _ = _drive_loop(str(tmp_path / "b"), total=6, save_every=3)
    assert v == 6 and saves == [3, 6], "one save for a final save_every step"
    assert checkpoint.available_steps(str(tmp_path / "b")) == [3, 6]

    def always(t, s):
        raise SimulatedFailure("always")

    with pytest.raises(RuntimeError, match="exceeded 3 retries"):
        run_with_recovery(total_steps=5, step_fn=always, state={"v": np.asarray(0)},
                          ckpt_dir=str(tmp_path / "c"), save_every=2,
                          restore_state=lambda s: {"v": np.asarray(max(s, 0))},
                          max_retries=3)

    items, saves = iter(range(5)), []

    def from_stream(t, s):
        next(items)
        return {"v": np.asarray(s["v"] + 1, np.int64)}

    state, stats = run_with_recovery(
        total_steps=None, step_fn=from_stream, state={"v": np.asarray(0, np.int64)},
        ckpt_dir=str(tmp_path / "d"), save_every=2,
        save_fn=lambda s, st: saves.append(s))
    assert int(state["v"]) == 5 and stats["final_step"] == 5 and saves == [2, 4, 5], \
        "stream-driven termination saves the tail"

    def ends(t, s):
        raise StopIteration

    with pytest.raises(StopIteration):
        run_with_recovery(total_steps=3, step_fn=ends, state=None,
                          ckpt_dir=str(tmp_path / "e"), save_every=2,
                          save_fn=lambda s, st: None)

    for name, fail_at, want in (("f", (1,), [-1]), ("g", (3,), [2])):
        d = str(tmp_path / name)
        checkpoint.save(d, 50, {"v": np.asarray(999, np.int64)})   # a stale step
        v, stats, _, restores = _drive_loop(d, total=5, save_every=2, fail_at=fail_at)
        assert v == 5 and restores == want, f"stale checkpoint: restores {restores}"
    assert reg.counter("recovery_stale_checkpoints").value - before[
        "recovery_stale_checkpoints"] == 2


# --- kill and resume within the port ---------------------------------------------


_KILL = textwrap.dedent("""
    import importlib, os, signal, sys
    import numpy as np
    from repro_torch.data import planted_cocluster_matrix
    sfit = importlib.import_module("repro_torch.streaming.fit")

    class KillAt:
        def maybe_fail(self, t):
            if t == 2:
                os.kill(os.getpid(), signal.SIGKILL)   # no cleanup at all

    data = planted_cocluster_matrix(np.random.default_rng(0), 400, 360, k=4, d=3,
                                    signal=3.5, noise=0.4)
    cfg = sfit.StreamConfig(**eval(sys.argv[2]))
    sfit.fit(sfit.iter_row_chunks(data.matrix, 100, device="cpu"), cfg,
             ckpt_dir=sys.argv[1], save_every=2, failure_injector=KillAt(),
             device="cpu")
    print("UNREACHABLE")
""")


def check_kill_and_resume(tmp_path):
    data = planted_cocluster_matrix(np.random.default_rng(0), 400, 360, k=4, d=3,
                                    signal=3.5, noise=0.4)
    cfg = streaming.StreamConfig(n_row_clusters=4, n_col_clusters=3, col_blocks=2,
                                 chunk_resamples=1, signature_dim=32, anchor_rows=32,
                                 seed=11, merge_restarts=2)
    chunks = lambda rows=100: streaming.iter_row_chunks(data.matrix, rows, device=CPU)
    m0, stats = streaming.fit(chunks(), cfg, device=CPU)
    assert stats.chunks == 4 and stats.rows_seen == 400

    inj = FailureInjector(fail_at_steps=(1, 3))
    m1, _ = streaming.fit(chunks(), cfg, ckpt_dir=str(tmp_path / "inj"), save_every=2,
                          failure_injector=inj, device=CPU)
    assert inj._fired == {1, 3}
    assert_models_equal(m0, m1, "injected failures")

    def with_empties():
        for i, chunk in enumerate(chunks()):
            if i % 2 == 0:
                yield np.zeros((0, 360), np.float32)
            yield chunk
        yield np.zeros((0, 360), np.float32)

    m2, stats = streaming.fit(with_empties(), cfg, ckpt_dir=str(tmp_path / "empty"),
                              save_every=2, failure_injector=FailureInjector((1,)),
                              device=CPU)
    assert stats.chunks == 4
    assert_models_equal(m0, m2, "empty chunks in a recovery stream")

    m3, _ = streaming.fit(chunks(), cfg, ckpt_dir=str(tmp_path / "first"), save_every=2,
                          failure_injector=FailureInjector((0,)), device=CPU)
    assert_models_equal(m0, m3, "failure before the first checkpoint")

    r0, stats = streaming.fit(chunks(96), cfg, device=CPU)
    assert stats.chunks == 5 and tuple(r0.row_labels.shape) == (400,)
    r1, _ = streaming.fit(chunks(96), cfg, ckpt_dir=str(tmp_path / "ragged"), save_every=2,
                          failure_injector=FailureInjector((4,)), device=CPU)
    assert_models_equal(r0, r1, "a failure in the ragged last chunk")

    d = str(tmp_path / "proc")
    with pytest.raises(SimulatedFailure):
        f = streaming.StreamingCocluster(cfg, device=CPU)
        for t, chunk in enumerate(chunks()):
            f.partial_fit(chunk)
            if (t + 1) % 2 == 0:
                streaming.save_fit_state(d, f)
            if t == 2:
                raise SimulatedFailure("poof")
    m4, stats = streaming.fit(chunks(), cfg, resume_from=d, ckpt_dir=d, save_every=2,
                              device=CPU)
    assert stats.chunks == 4
    assert_models_equal(m0, m4, "resume in the manner of a new process")

    killed_dir = str(tmp_path / "killed")
    env = dict(os.environ, PYTHONPATH="src")
    killed = subprocess.run(
        [sys.executable, "-c", _KILL, killed_dir, repr(dataclasses.asdict(cfg))],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert killed.returncode == -9, (killed.returncode, killed.stderr)
    assert "UNREACHABLE" not in killed.stdout
    assert checkpoint.latest_step(killed_dir) == 2, checkpoint.available_steps(killed_dir)
    m5, _ = streaming.fit(chunks(), cfg, resume_from=killed_dir, ckpt_dir=killed_dir,
                          save_every=2, device=CPU)
    assert_models_equal(m0, m5, "SIGKILL and resume")

    # the loud errors of the reference's tests
    f = streaming.StreamingCocluster(cfg, device=CPU)
    f.partial_fit(data.matrix[:100])
    f.partial_fit(data.matrix[100:200])
    for bad, match in ((data.matrix[:100, :250], "chunk 2: chunk has 250 columns"),
                       (data.matrix[:100].astype(np.float16), "dtype"),
                       (to_bcoo(data.matrix[:100], CPU), "BCOO"),
                       (data.matrix[0], "2-D")):
        with pytest.raises(ValueError, match=match):
            f.partial_fit(bad)
    with pytest.raises(ValueError, match="empty"):
        streaming.fit([], cfg, device=CPU)
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        streaming.fit(chunks(), cfg, resume_from=str(tmp_path / "none"), device=CPU)
    with pytest.raises(ValueError, match="seed"):
        streaming.load_fit_state(d, dataclasses.replace(cfg, seed=12), device=CPU)
    with pytest.raises(ValueError, match="same stream"):
        streaming.fit(chunks(80), cfg, resume_from=d, device=CPU)
    with pytest.raises(ValueError, match="no checkpoint"):
        streaming.fit(chunks(), cfg, failure_injector=FailureInjector((1,)), device=CPU)
    with pytest.raises(ValueError, match="both knobs"):
        streaming.fit(chunks(), cfg, ckpt_dir=d, device=CPU)
    with pytest.raises(ValueError, match="format"):
        streaming.iter_row_chunks(data.matrix, 100, format="csr", device=CPU)
    streaming.save_model(str(tmp_path / "model"), m0)
    with pytest.raises(ValueError, match="kind="):
        streaming.load_fit_state(str(tmp_path / "model"), cfg, device=CPU)
    path = streaming.save_fit_state(str(tmp_path / "corrupt"), f)
    npz = os.path.join(path, "arrays.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(npz, "wb") as fh:
        fh.write(blob)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        streaming.load_fit_state(str(tmp_path / "corrupt"), cfg, device=CPU)


def check_elastic_restore(tmp_path):
    """The reference's elastic test (``tests/test_fault_tolerance.py``,
    ``_ELASTIC_SCRIPT``) on four gloo ranks: a FitState written by one
    process, restored with ``stream_state_specs`` onto a 4-rank mesh (each
    rank holding a quarter of ``res_vals``), continued to the uninterrupted
    model leaf for leaf on every rank; the placements are the reference's
    ``PartitionSpec``s on the same shapes."""
    data = planted_cocluster_matrix(np.random.default_rng(0), 400, 360, k=4, d=3,
                                    signal=3.5, noise=0.4)
    cfg = streaming.StreamConfig(n_row_clusters=4, n_col_clusters=3, col_blocks=2,
                                 chunk_resamples=1, signature_dim=32, anchor_rows=32,
                                 seed=11, merge_restarts=2)
    chunks = [data.matrix[i:i + 100] for i in range(0, 400, 100)]
    m0, _ = streaming.fit([torch.from_numpy(c) for c in chunks], cfg, device=CPU)
    d = str(tmp_path / "ckpt")
    f = streaming.StreamingCocluster(cfg, device=CPU)
    for chunk in chunks[:2]:
        f.partial_fit(chunk)
    streaming.save_fit_state(d, f)
    outs = torch_dist.run_world(torch_dist.elastic_continue, 4, tmp_path, d,
                                dataclasses.asdict(cfg), chunks[2:], 4)
    template, _ = checkpoint.restore_tree(d, 2)
    want = jshardings.stream_state_specs(template, types.SimpleNamespace(shape={"data": 4}))
    for rank, out in enumerate(outs):
        assert out["kind"] == "stream_fit_state"
        assert out["local_res_vals"] == (32, 90), f"rank {rank}: {out['local_res_vals']}"
        for name, spec in out["specs"].items():
            assert spec == tuple(want[name]), f"elastic: {name} spec {spec}"
        for name in streaming.CoclusterModel._fields:
            x, y = getattr(m0, name).numpy(), out["model"][name]
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                f"elastic restore, rank {rank}: {name} differs"


# --- against the reference -------------------------------------------------------


def check_reference_parity(tmp_path):
    """The reference's TestOutOfSampleAssignment data on its own draws."""
    data = planted_cocluster_matrix(np.random.default_rng(7), 760, 500, k=5, d=5,
                                    signal=4.0, noise=0.6)
    train, test = data.matrix[:600], data.matrix[600:]
    jcfg = jstreaming.StreamConfig(n_row_clusters=5, n_col_clusters=5,
                                   chunk_resamples=2, seed=0)
    cfg = streaming.StreamConfig(**dataclasses.asdict(jcfg))
    raw, jfitter = torch_parity.stream_draws([train[i:i + 150] for i in (0, 150, 300, 450)],
                                             jcfg)
    draws = interop.stream_draws_from_numpy(**raw)
    ref, _ = jfitter.finalize()
    ref_bcoo, _ = jstreaming.fit(jstreaming.iter_row_chunks(train, 150, format="bcoo"),
                                 jcfg)
    ref_held = np.asarray(jstreaming.assign_rows(ref, jnp.asarray(test)).labels)
    truth, held_truth = data.row_labels[:600], data.row_labels[600:]
    for fmt, want in (("dense", ref), ("bcoo", ref_bcoo)):
        model, stats = streaming.fit(streaming.iter_row_chunks(train, 150, format=fmt,
                                                               device=CPU),
                                     cfg, draws=draws, device=CPU)
        assert_matches_reference(model, want, f"{fmt} chunks")
        held = streaming.assign_rows(model, torch.from_numpy(test)).labels.numpy()
        np.testing.assert_array_equal(held, ref_held, err_msg=f"{fmt}: held-out labels")
        assert nmi(model.row_labels.numpy(), truth) == nmi(np.asarray(want.row_labels),
                                                           truth)
        assert nmi(held, held_truth) == nmi(ref_held, held_truth)
        assert nmi(model.col_labels.numpy(), data.col_labels) == 1.0, f"{fmt}: columns"
        assert (stats.rows_seen, stats.chunks) == (600, 4)
        assert stats.state_bytes < train.nbytes / 2, f"{fmt}: state bytes"
        if fmt == "dense":
            assert stats.peak_chunk_bytes == 150 * 500 * 4, "one chunk, not M x N"

    # FitState checkpoints in both directions: load, save again, same leaves
    ours = streaming.StreamingCocluster(cfg, draws=draws, device=CPU)
    for chunk in (train[:150], train[150:300]):
        ours.partial_fit(chunk)
    streaming.save_fit_state(str(tmp_path / "port"), ours)
    theirs, folded = jfit.load_fit_state(str(tmp_path / "port"), jcfg)
    assert folded == 2
    jfit.save_fit_state(str(tmp_path / "port_again"), theirs)
    assert leaves(str(tmp_path / "port"), 2) == leaves(str(tmp_path / "port_again"), 2), \
        "a port FitState saved again by the reference"
    jsaved = jfit.StreamingCocluster(jcfg)
    for chunk in (train[:150], train[150:300]):
        jsaved.partial_fit(jnp.asarray(chunk))
    jfit.save_fit_state(str(tmp_path / "ref"), jsaved)
    back, _ = streaming.load_fit_state(str(tmp_path / "ref"), cfg, draws=draws, device=CPU)
    streaming.save_fit_state(str(tmp_path / "ref_again"), back)
    assert leaves(str(tmp_path / "ref"), 2) == leaves(str(tmp_path / "ref_again"), 2), \
        "a reference FitState saved again by the port"
    assert jckpt.read_manifest(str(tmp_path / "ref"), 2)["extra"]["stream_config"] == \
        checkpoint.read_manifest(str(tmp_path / "port"), 2)["extra"]["stream_config"]
    # the reference's state carries the reference's draws: the port, given
    # the same draws, finishes it to the reference's labels
    for chunk in (train[300:450], train[450:]):
        back.partial_fit(chunk)
    resumed, _ = back.finalize()
    np.testing.assert_array_equal(resumed.row_labels.numpy(), np.asarray(ref.row_labels))
    np.testing.assert_array_equal(resumed.col_labels.numpy(), np.asarray(ref.col_labels))


def test_streaming_fit_and_recovery(tmp_path):
    jax.clear_caches()
    try:
        check_recovery_loop(tmp_path / "loop")
        check_kill_and_resume(tmp_path / "kill")
        (tmp_path / "elastic").mkdir()
        check_elastic_restore(tmp_path / "elastic")
        check_reference_parity(tmp_path / "ref")
    finally:
        jax.clear_caches()
