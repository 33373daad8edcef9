"""Multi-rank worlds on the CPU for the port's distributed tests (not a test file).

``run_world(fn, world, tmp_path, *args)`` starts ``world`` processes with the
``spawn`` method, joins them into one gloo process group through a
``FileStore`` under ``tmp_path`` (never a fixed port), runs
``fn(rank, *args)`` in each and returns their results in rank order. Each
world is waited for at most ``TIMEOUT`` seconds, so a hang fails the test
item that started it rather than the suite. The rank functions live here and
import no JAX: a spawned rank imports this module, never the test file.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from datetime import timedelta

import numpy as np
import torch

TIMEOUT = 120.0


def _rank_main(fn, rank, world, store_path, args, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=TIMEOUT))
        try:
            out.put((rank, "ok", fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the parent reports it
        out.put((rank, "error", traceback.format_exc()))


def run_world(fn, world: int, tmp_path, *args):
    """``[fn(rank, *args) for each rank]`` from a gloo world of ``world`` ranks."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{fn.__name__}-{world}-{os.getpid()}"
                         f"-{len(os.listdir(tmp_path))}")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, status, value = out.get(timeout=TIMEOUT)
            except queue.Empty:
                raise AssertionError(f"{fn.__name__}: a rank of {world} gave no result "
                                     f"within {TIMEOUT} s") from None
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
    assert not errors, "\n".join(errors)
    return [results[r] for r in range(world)]


def _numpy_result(res) -> dict:
    keys = ("row_labels", "col_labels", "row_votes", "col_votes", "row_sigs", "col_sigs",
            "row_membership", "col_membership")
    return {k: getattr(res, k).cpu().numpy() for k in keys}


# ------------------------------------------------------------- rank functions


def lamc_cases(rank, mesh_shape, axes, cases):
    """``distributed_lamc`` on a CPU mesh for each case ``(name, matrix,
    config fields, plan fields, call options)``; returns ``{name: result or
    error text}``. ``matrix`` is dense numpy, or ``("coo", dense)``."""
    from repro_torch.core import distributed, lamc
    from repro_torch.data import to_bcoo
    from repro_torch.launch import mesh as _mesh

    mesh = _mesh.make_test_mesh(*mesh_shape, device="cpu", axes=axes)
    out = {}
    for name, matrix, cfg, plan, opts in cases:
        cfg = lamc.LAMCConfig(**cfg)
        plan = lamc.partition.PartitionPlan(**plan)
        opts = dict(opts)
        draws = opts.pop("draws", None)
        if draws is not None:
            from repro_torch import interop
            draws = interop.draws_from_numpy(**draws)
        a = to_bcoo(matrix[1], "cpu") if isinstance(matrix, tuple) else matrix
        try:
            res = distributed.distributed_lamc(mesh, a, cfg, plan, draws=draws,
                                               device="cpu", **opts)
            out[name] = _numpy_result(res)
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def elastic_continue(rank, ckpt_dir, cfg_fields, chunks, mesh_size):
    """Restore a FitState onto a ``(mesh_size,)`` ``data`` mesh with
    ``stream_state_specs``, continue the fit over ``chunks`` and return the
    model, with the local shape of ``res_vals`` and the placements."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import checkpoint, streaming
    from repro_torch.runtime import fault_tolerance, shardings

    mesh = init_device_mesh("cpu", (mesh_size,), mesh_dim_names=("data",))
    step = checkpoint.latest_step(ckpt_dir)
    template, _ = checkpoint.restore_tree(ckpt_dir, step)
    specs = shardings.stream_state_specs(template, mesh)
    tree, extra = fault_tolerance.elastic_restore(ckpt_dir, step, template, mesh, specs,
                                                  device="cpu")
    local = tuple(tree["res_vals"].to_local().shape)
    cfg = streaming.StreamConfig(**cfg_fields)
    fitter = streaming.StreamingCocluster.from_state_tree(
        cfg, tree, chunk_format=extra["chunk_format"], chunk_dtype=extra["chunk_dtype"],
        device="cpu")
    for c in chunks:
        fitter.partial_fit(c)
    model, _ = fitter.finalize()
    spec = {k: shardings.partition_spec(v, mesh, np.ndim(template[k]))
            for k, v in specs.items() if not isinstance(v, dict)}
    return dict(model={f: getattr(model, f).cpu().numpy() for f in model._fields},
                local_res_vals=local, kind=extra["kind"], specs=spec)
