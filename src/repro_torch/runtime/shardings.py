"""Sharding policy for the LAMC state: shard-or-replicate placements over a
device mesh.

The reference's policy for a streaming ``FitState`` restored elastically
(``stream_state_specs``) and for the serving tables
(``serve_model_specs``), with its semantics: a dimension that does not
divide the mesh axis relaxes to replication, never fails. Placements are
DTensor placements, one per mesh dimension (``Shard(d)`` on the named axis,
``Replicate()`` on the others), for
``torch.distributed.tensor.DTensor.from_local`` / ``distribute_tensor``;
:func:`partition_spec` turns one back into the reference's ``PartitionSpec``
entries (for each tensor dimension, the mesh axis it is split over or
None).

``mesh`` is a ``DeviceMesh`` or a mapping of axis names to sizes (the
serving engine's slices on one card have no process group).

The reference's LM policy (``param_specs``, ``param_shardings``,
``unit_gather_shardings``, ``batch_specs``, ``cache_specs``) serves
multi-device LM training and the dry run, which the port does not have yet
(ROADMAP item 16.7).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["MeshAxes", "pad_vocab", "path_name", "axis_sizes", "placements",
           "partition_spec", "stream_state_specs", "serve_model_specs",
           "serve_model_shardings", "local_shard", "distribute", "full_tensor"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis names present in the mesh."""
    data: tuple[str, ...] = ("data",)      # ("pod", "data") for multi-pod
    model: str = "model"

    @property
    def fsdp(self) -> tuple[str, ...]:
        return self.data


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def path_name(path) -> str:
    """``a/b/0`` from a path of keys, attribute names or indices."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, axis: str, dim: int | None) -> tuple:
    """One placement per mesh dimension: ``Shard(dim)`` on ``axis`` (or
    ``Replicate()`` when ``dim`` is None), ``Replicate()`` on the others."""
    return tuple(Shard(dim) if name == axis and dim is not None else Replicate()
                 for name in axis_sizes(mesh))


def partition_spec(places, mesh, ndim: int) -> tuple:
    """The reference's ``PartitionSpec`` entries of ``places``: for each of
    the ``ndim`` tensor dimensions the mesh axis it is sharded over, or
    None."""
    dims: list = [None] * ndim
    for name, p in zip(axis_sizes(mesh), places):
        if isinstance(p, Shard):
            dims[p.dim] = name
    return tuple(dims)


def _map(tree, fn):
    """``fn`` over the leaves of nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def stream_state_specs(tree, mesh, axis: str = "data"):
    """Shard-or-replicate placements for an accumulated-state tree.

    The elastic-restore policy for checkpoints whose structure is known only
    at load time (a streaming ``FitState``): each array leaf shards its
    *largest* ``axis``-divisible dimension over ``axis`` and replicates
    everything else; small leaves (counters, per-chunk label rows) replicate
    whole. Pairs with ``fault_tolerance.elastic_restore``.
    """
    size = axis_sizes(mesh)[axis]

    def one(leaf):
        shape = _shape(leaf)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % size == 0 and shape[i] >= size:
                return placements(mesh, axis, i)
        return placements(mesh, axis, None)

    return _map(tree, one)


def serve_model_specs(model, mesh, axis: str = "data"):
    """Placements for a ``CoclusterModel``'s serving tables.

    The per-cluster signature tables (``(K, q)``) and the vote tables
    (``(M, K)``) shard their *leading* dimension over ``axis`` when it
    divides: scoring contracts over ``q``, so a cluster-sharded table scores
    a slice of the clusters and the argmax / top-k is merged across slices.
    Everything 1-D (anchors, means, labels) replicates. A leading dimension
    that does not divide relaxes to replication.
    """
    size = axis_sizes(mesh)[axis]

    def one(leaf):
        shape = _shape(leaf)
        if len(shape) >= 2 and shape[0] % size == 0 and shape[0] >= size:
            return placements(mesh, axis, 0)
        return placements(mesh, axis, None)

    return _map(model, one)


def serve_model_shardings(model, mesh, axis: str = "data"):
    """``{field: (placements, spec)}`` of :func:`serve_model_specs`: each
    table's placements beside its reference ``PartitionSpec`` entries."""
    specs = serve_model_specs(model, mesh, axis)
    return {name: (p, partition_spec(p, mesh, len(_shape(getattr(model, name)))))
            for name, p in zip(model._fields, specs)}


def _cut(n: int, parts: int, i: int) -> tuple[int, int]:
    """Shard ``i`` of ``parts`` of a dimension of ``n``: ``torch.chunk``'s
    cut, which DTensor's ``Shard`` uses."""
    size = -(-n // parts)
    return min(i * size, n), min((i + 1) * size, n)


def local_shard(tensor: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of the whole ``tensor`` under ``places`` on the
    ``DeviceMesh`` ``mesh`` (a view; mesh dimensions split in order)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            lo, hi = _cut(tensor.shape[p.dim], mesh.size(i), coord[i])
            tensor = tensor.narrow(p.dim, lo, hi - lo)
    return tensor


def distribute(tensor: torch.Tensor, mesh, places, device=None) -> DTensor:
    """A DTensor of the whole ``tensor`` (which every rank holds) keeping
    only this rank's shard, moved to ``device``: no communication."""
    local = local_shard(tensor, mesh, places).contiguous()
    return DTensor.from_local(local if device is None else local.to(device), mesh,
                              tuple(places), run_check=False, shape=tensor.shape,
                              stride=torch.empty(tensor.shape, device="meta").stride())


def full_tensor(x):
    """The whole tensor of a DTensor, gathered over its mesh (a gloo group
    takes CUDA tensors through host memory); anything else unchanged."""
    if not isinstance(x, DTensor):
        return x
    import torch.distributed as dist

    mesh, local = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):               # the innermost split first
        p = x.placements[i]
        if not isinstance(p, Shard) or mesh.size(i) == 1:
            continue
        group = mesh.get_group(i)
        stage = local.is_cuda and dist.get_backend(group) == "gloo"
        src = local.cpu() if stage else local
        n = dist.get_world_size(group)
        lengths = [torch.zeros(1, dtype=torch.int64, device=src.device) for _ in range(n)]
        dist.all_gather(lengths, torch.tensor([src.shape[p.dim]], device=src.device),
                        group=group)
        width = max(int(v) for v in lengths)
        pad = list(src.shape)
        pad[p.dim] = width
        padded = torch.zeros(pad, dtype=src.dtype, device=src.device)
        padded.narrow(p.dim, 0, src.shape[p.dim]).copy_(src)
        parts = [torch.empty_like(padded) for _ in range(n)]
        dist.all_gather(parts, padded, group=group)
        coord = {int(mesh.mesh[pos]): pos[i] for pos in np.ndindex(*mesh.mesh.shape)}
        ranks = dist.get_process_group_ranks(group)
        order = sorted(range(n), key=lambda g: coord[ranks[g]])
        local = torch.cat([parts[g].narrow(p.dim, 0, int(lengths[g])) for g in order],
                          dim=p.dim)
        local = local.to(x.device) if stage else local
    return local

