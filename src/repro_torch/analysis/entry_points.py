"""The port's entry points, registered under the reference's sixteen names.

Each entry's factory takes a ``device`` and returns ``(fn, example_args)`` at the
reference's representative small shapes (``src/repro/analysis/
entry_points.py``), its arrays made by the same numpy recipe (``_rng``,
``_dense``, ``_coo``), so a kernel entry's arguments equal the reference's
bit for bit. The audit (``dispatch_audit``) calls them for real, on the card
unless asked for the CPU: eager PyTorch has no trace to stage.

The LAMC and streaming entries run ``assign_impl="pallas"``, the
configuration the card's cells run, so that on the card they launch the
k-means kernels (on the CPU both values take the plain version).
``lamc_sparse`` runs the tiled route, the sparse cell's on the card, where
the reference's entry stages ``dual_ell``: the port's ``dual_ell`` products
are plain PyTorch, its tiled ones the SpMM kernels (both directions and the
fused ``A.T (A X)``).

``_obs`` twins run their entry with spans on, inside a span that fences the
output, as the port's spans do: a twin must dispatch its plain entry's ops
and make its syncs plus the span's fence, nothing else.
"""

from __future__ import annotations

import importlib
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ENTRY_POINTS", "KERNEL_ENTRIES", "OBS_TWINS", "recompile_targets",
           "close"]

_GROUP = {"started": False, "dir": None}


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _dense_np(seed: int, *shape: int) -> np.ndarray:
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _dense(seed: int, *shape: int, device) -> torch.Tensor:
    return torch.from_numpy(_dense_np(seed, *shape)).to(device)


def _coo_np(seed: int, m: int, n: int, density: float = 0.1) -> np.ndarray:
    g = _rng(seed)
    mask = g.random((m, n)) < density
    mask[0, 0] = True  # never empty
    return np.where(mask, g.standard_normal((m, n)), 0.0).astype(np.float32)


def _coo(seed: int, m: int, n: int, density: float = 0.1, *, device) -> torch.Tensor:
    return torch.from_numpy(_coo_np(seed, m, n, density)).to(device).to_sparse().coalesce()


def _small_cfg(**overrides):
    from ..core.lamc import LAMCConfig
    base = dict(n_row_clusters=2, n_col_clusters=2, svd_iters=2,
                kmeans_iters=2, merge_kmeans_iters=2, merge_restarts=1,
                signature_dim=8, seed=0, assign_impl="pallas")
    base.update(overrides)
    return LAMCConfig(**base)


def _small_plan(**overrides):
    from ..core.partition import PartitionPlan
    base = dict(n_rows=32, n_cols=32, m=2, n=2, phi=16, psi=16, t_p=2, seed=0)
    base.update(overrides)
    return PartitionPlan(**base)


# -- entry factories --------------------------------------------------------

def _lamc_dense(device):
    from ..core import lamc
    cfg, plan = _small_cfg(), _small_plan()
    return (lambda a: lamc.lamc_cocluster(a, cfg, plan, device=device),
            (_dense(0, 32, 32, device=device),))


def _lamc_sparse(device):
    from ..core import lamc
    cfg = _small_cfg(input_format="bcoo", spmm_impl="tiled")
    plan = _small_plan(m=1, n=1, phi=32, psi=32, spmm_route="tiled")
    return (lambda a: lamc.lamc_cocluster(a, cfg, plan, device=device),
            (_coo(1, 32, 32, density=0.2, device=device),))


def _one_rank_group(device) -> None:
    """A one-rank process group, started here unless one is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("distributed_step runs on a one-rank mesh; the process "
                               f"group has {dist.get_world_size()} ranks")
        return
    _GROUP["dir"] = tempfile.TemporaryDirectory()
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(_GROUP["dir"].name, "store"), 1), rank=0, world_size=1)
    _GROUP["started"] = True


def close() -> None:
    """Stop the process group :func:`_one_rank_group` started, if any."""
    import torch.distributed as dist

    if _GROUP["started"]:
        dist.destroy_process_group()
        _GROUP["dir"].cleanup()
        _GROUP.update(started=False, dir=None)


def _distributed_step(device):
    from ..core import distributed
    from ..launch import mesh as _mesh
    _one_rank_group(device)
    cfg, plan = _small_cfg(), _small_plan()
    mesh = _mesh.make_test_mesh(1, 1, device=device)
    return (lambda a: distributed.distributed_lamc(mesh, a, cfg, plan, device=device),
            (_dense(2, 32, 32, device=device),))


def _streaming_chunk(device):
    # the package re-exports a `fit` *function*, shadowing the module
    fit = importlib.import_module("repro_torch.streaming.fit")
    cfg = fit.StreamConfig(n_row_clusters=2, n_col_clusters=2, col_blocks=2,
                           signature_dim=8, anchor_rows=8, svd_iters=2,
                           kmeans_iters=2, assign_impl="pallas")
    fitter = fit.StreamingCocluster(cfg, device=device)
    blocks = _dense(3, cfg.blocks_per_chunk, 16, 16, device=device)
    feats = _dense(4, 16, 8, device=device)
    return fitter._chunk_atoms, (blocks, feats, 0)


def _cosine_assign(device):
    from ..kernels import ops
    return ops.cosine_assign, (_dense(5, 256, 64, device=device),
                               _dense(6, 4, 64, device=device))


def _cosine_topk(device):
    from ..kernels import ops
    return (lambda x, s: ops.cosine_topk(x, s, 2),
            (_dense(7, 256, 64, device=device), _dense(8, 4, 64, device=device)))


def _spmm(device):
    from ..kernels import ops
    return (lambda mat, b: ops.spmm(mat, b),
            (_coo(9, 64, 64, device=device), _dense(10, 64, 16, device=device)))


def _tiled_operand(device):
    from ..kernels import spmm as kspmm
    return kspmm.bcoo_to_block_sparse(_coo(11, 256, 256, device=device), bm=128, bk=128)


def _spmm_tiled(device):
    from ..kernels import ops
    return (lambda mat, b: ops.spmm_tiled(mat, b),
            (_tiled_operand(device), _dense(12, 256, 128, device=device)))


def _spmm_ata(device):
    from ..kernels import ops
    return (lambda mat, x: ops.spmm_ata(mat, x),
            (_tiled_operand(device), _dense(13, 256, 128, device=device)))


def _scaled_operand(device):
    a = _tiled_operand(device)
    n_tr, n_tc = a.n_tiles
    bm, bk = a.tile_shape
    rs = torch.abs(_dense(14, n_tr, bm, device=device)) + 0.5
    cs = torch.abs(_dense(15, n_tc, bk, device=device)) + 0.5
    return a.with_scales(rs, cs)


def _spmm_tiled_scaled(device):
    from ..kernels import ops
    return (lambda mat, b: ops.spmm_tiled(mat, b),
            (_scaled_operand(device), _dense(16, 256, 128, device=device)))


def _spmm_ata_gram(device):
    from ..kernels import ops
    return (lambda mat, x: ops.spmm_ata(mat, x, with_gram=True),
            (_scaled_operand(device), _dense(17, 256, 16, device=device)))


def _tiled_convert(device):
    # the whole conversion (pattern, its one host sync, values, and on the
    # card spmm_ata's schedule): the reference stages its second half
    from ..kernels import spmm as kspmm
    return (lambda a: kspmm.bcoo_to_block_sparse(a, 128, 128),
            (_coo(18, 256, 256, device=device),))


def _with_obs(make: Callable) -> Callable:
    """Obs-enabled twin of an entry's factory: spans on for the call, inside a
    span that fences the output (a ``torch.cuda.synchronize`` at its exit
    when the output lies on the card)."""
    def build(device):
        from .. import obs

        fn, example_args = make(device)

        def wrapped(*args):
            was = obs.enabled()
            obs.configure(enabled=True)
            try:
                with obs.span("audit_entry") as sp:
                    return sp.fence(fn(*args))
            finally:
                obs.configure(enabled=was)
        return wrapped, example_args
    return build


#: name -> (device) -> (fn, example_args), under the reference's names.
ENTRY_POINTS: dict[str, Callable] = {
    "lamc_dense": _lamc_dense,
    "lamc_sparse": _lamc_sparse,
    "distributed_step": _distributed_step,
    "streaming_chunk": _streaming_chunk,
    "cosine_assign": _cosine_assign,
    "cosine_topk": _cosine_topk,
    "spmm": _spmm,
    "spmm_tiled": _spmm_tiled,
    "spmm_ata": _spmm_ata,
    "spmm_tiled_scaled": _spmm_tiled_scaled,
    "spmm_ata_gram": _spmm_ata_gram,
    "tiled_convert": _tiled_convert,
    "lamc_dense_obs": _with_obs(_lamc_dense),
    "streaming_chunk_obs": _with_obs(_streaming_chunk),
    "cosine_assign_obs": _with_obs(_cosine_assign),
    "spmm_ata_obs": _with_obs(_spmm_ata),
}

#: The entries that are one ``kernels.ops`` call: on the card they must make
#: no host sync but an ``_obs`` twin's span fence. The others run whole
#: pipelines; their syncs are recorded.
KERNEL_ENTRIES = frozenset({"cosine_assign", "cosine_topk", "spmm", "spmm_tiled",
                            "spmm_ata", "spmm_tiled_scaled", "spmm_ata_gram",
                            "cosine_assign_obs", "spmm_ata_obs"})

#: twin -> its plain entry
OBS_TWINS = {name: name[:-len("_obs")] for name in ENTRY_POINTS if name.endswith("_obs")}


def recompile_targets(device) -> dict[str, tuple[Callable, Callable[[], tuple]]]:
    """The reference's A3 targets (``lamc_cocluster``, ``assign_rows``):
    ``name -> (fn, make_args)``, where ``make_args`` builds fresh tensors of
    the same shapes on every call."""
    from ..core import lamc
    from ..streaming import assign, model as smodel

    dev = resolve_device(device)
    cfg, plan = _small_cfg(), _small_plan()
    counter = {"n": 0}

    def lamc_args():
        counter["n"] += 1
        return (_dense(100 + counter["n"], 32, 32, device=dev), cfg, plan)

    k, q, n_cols = 2, 8, 32
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    model = smodel.CoclusterModel(
        row_labels=z(32, dtype=torch.int32), col_labels=z(32, dtype=torch.int32),
        row_votes=z(32, k), col_votes=z(32, k),
        row_sigs=_dense(200, k, q, device=dev), col_sigs=_dense(201, k, q, device=dev),
        row_mean=z(q), col_mean=z(q),
        anchor_rows=torch.arange(q, dtype=torch.int32, device=dev),
        anchor_cols=torch.arange(q, dtype=torch.int32, device=dev))

    def assign_args():
        counter["n"] += 1
        return (model, _dense(300 + counter["n"], 16, n_cols, device=dev))

    return {
        "lamc_cocluster": (lambda a, c, p: lamc.lamc_cocluster(a, c, p, device=dev),
                           lamc_args),
        "assign_rows": (assign.assign_rows, assign_args),
    }
