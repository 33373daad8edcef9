"""Device meshes over a ``torch.distributed`` process group.

Functions, not module constants: importing this module never starts a
process group or touches a device, so tests and single-process runs see
none.

Axis names are the reference's: ``("data", "model")`` for one pod and
``("pod", "data", "model")`` across pods. The shape comes from the world
size (one rank per card), not from a fixed topology: ``model`` takes the
largest power of two that divides a pod's ranks and whose square does not
exceed them (16 x 16 for 256, 4 x 2 for 8), ``data`` the rest. The ``pod`` axis carries only small payloads (the LAMC signature
gathers and vote sums).

A process group is started when none is up: NCCL for ranks on cards, gloo
when the caller asks for the CPU or for ranks that share one card (NCCL
refuses two ranks on one device). Rank, world size and rendezvous come from
the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); a caller that rendezvous
otherwise (a ``FileStore``) starts the group itself first.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device
from ..runtime.shardings import MeshAxes

__all__ = ["make_production_mesh", "mesh_axes", "make_test_mesh", "ensure_process_group"]


def ensure_process_group(device: str | torch.device = "cuda", *,
                         shared_card: bool = False) -> str:
    """Start the default process group if none is up; return its backend.

    ``device="cuda"`` (the default) binds this rank to card ``LOCAL_RANK``
    (card 0 when ``shared_card``) and asks for NCCL; ``"cpu"`` or
    ``shared_card=True`` asks for gloo. A group that is already up must have
    the backend asked for: NCCL is never replaced by gloo.
    """
    dev = resolve_device(device)
    want = "gloo" if dev.type == "cpu" or shared_card else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(0 if shared_card else int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group(want)
    got = dist.get_backend()
    if got != want:
        raise RuntimeError(f"the process group runs {got!r}, but {want!r} was asked for "
                           f"(device={dev.type}, shared_card={shared_card})")
    return got


def _mesh_shape(world: int, *, multi_pod: bool = False) -> tuple[int, ...]:
    """``(data, model)``, or ``(pod=2, data, model)``, for ``world`` ranks."""
    pods = 2 if multi_pod else 1
    if world % pods:
        raise ValueError(f"a two-pod mesh needs an even world size, got {world}")
    per_pod = world // pods
    model = 1
    while per_pod % (model * 2) == 0 and (model * 2) ** 2 <= per_pod:
        model *= 2
    shape = (per_pod // model, model)
    return (pods, *shape) if multi_pod else shape


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """The mesh over every rank of the process group (started if needed)."""
    ensure_process_group(device)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type,
                            _mesh_shape(dist.get_world_size(), multi_pod=multi_pod),
                            mesh_dim_names=axes)


def mesh_axes(mesh: DeviceMesh) -> MeshAxes:
    """MeshAxes view of a mesh made by :func:`make_production_mesh`."""
    if "pod" in mesh.mesh_dim_names:
        return MeshAxes(data=("pod", "data"), model="model")
    return MeshAxes(data=("data",), model="model")


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   device: str | torch.device = "cuda", shared_card: bool = False,
                   axes: tuple[str, ...] = ("data", "model")) -> DeviceMesh:
    """A small ``(n_data, n_model)`` mesh; its size must be the world size.
    ``axes`` renames the two axes (``("pod", "data")`` for a pod mesh)."""
    ensure_process_group(device, shared_card=shared_card)
    if n_data * n_model != dist.get_world_size():
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} "
                         f"ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, (n_data, n_model),
                            mesh_dim_names=axes)
