"""Crash-consistent checkpoints of nested tensor trees, in the reference format.

Format: one directory per step, byte for byte what the reference package
writes, so checkpoints cross between the two packages in both directions::

    ckpt_dir/step_000123/
        manifest.json        (leaf names, shapes, dtypes, per-leaf sha256
                              content hashes, extra metadata)
        arrays.npz           (flat leaf name -> host array)
        _COMMITTED           (sentinel written last: atomicity marker)

Leaf names follow the reference's ``jax.tree_util.tree_flatten_with_path``
naming, joined with ``/``: a dict key by its string (keys in sorted order),
a list or tuple entry by its index, a NamedTuple field as ``.field`` (so a
model's leaves are ``.row_labels``, ``.col_labels``, ...). ``None`` holds no
leaf. Tensors are saved from the host; bfloat16 is stored as uint16 and
recorded as ``"bfloat16"``.

Crash consistency: writes go to ``step_X.tmp``; every file is fsync'd, then
the temporary directory, then it is renamed into place and the parent
directory fsync'd, so a crash leaves the old committed checkpoint or a
``.tmp`` directory that ``latest_step`` ignores. Overwriting a committed step
first displaces it to ``step_X.old`` (removed only after the new directory
is renamed in); the restore and listing paths fall back to the ``.old``
copy. Restore checks each leaf against its recorded sha256 and raises
:class:`CheckpointCorruptError` naming the bad leaf on any mismatch,
truncation or missing payload.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save", "restore", "restore_tree", "read_manifest",
           "latest_step", "available_steps", "CheckpointCorruptError"]

_SENTINEL = "_COMMITTED"


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed integrity verification.

    Raised when the manifest or array payload is missing, truncated, or
    fails its recorded content hash; the message names the offending
    leaf or file. Distinct from :class:`FileNotFoundError` (no committed
    checkpoint at all) and ``ValueError`` (template mismatch).
    """


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def _rebuild(tree, fn, path: str = ""):
    """``tree`` with every leaf replaced by ``fn(name, leaf)``, walked in the
    reference's flatten order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, _join(path, str(k))) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, _join(path, "." + f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, _join(path, str(i)))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _flatten_with_names(tree) -> tuple[list[str], list]:
    names, leaves = [], []

    def collect(name, leaf):
        names.append(name)
        leaves.append(leaf)
        return leaf

    _rebuild(tree, collect)
    return names, leaves


def _leaf_hash(arr: np.ndarray) -> str:
    """sha256 over the raw bytes + shape/dtype (shape collisions matter)."""
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _to_host(leaf) -> tuple[np.ndarray, bool]:
    """``(host array, is_bfloat16)``; bfloat16 comes back viewed as uint16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree, extra_meta: dict | None = None) -> str:
    """Atomically write ``tree`` as checkpoint ``step`` (fsync'd commit)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    names, leaves = _flatten_with_names(tree)
    meta = {"step": step, "leaves": {}}
    packed = {}
    for name, leaf in zip(names, leaves):
        arr, bf16 = _to_host(leaf)
        packed[name] = arr
        meta["leaves"][name] = {"dtype": "bfloat16" if bf16 else str(arr.dtype),
                                "shape": list(arr.shape), "sha256": _leaf_hash(arr)}
    if extra_meta:
        meta["extra"] = extra_meta
    arrays_path = os.path.join(tmp, "arrays.npz")
    manifest_path = os.path.join(tmp, "manifest.json")
    sentinel_path = os.path.join(tmp, _SENTINEL)
    np.savez(arrays_path, **packed)
    with open(manifest_path, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(arrays_path)
    # sentinel last: its presence asserts the payload + manifest are durable
    with open(sentinel_path, "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    # Overwriting a committed step never passes through a state with no
    # durable copy: displace the old directory to ``.old``, rename the new
    # one in, and only then drop the old.
    old = final + ".old"
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)  # stale leftover from a crashed overwrite
        os.rename(final, old)
    os.rename(tmp, final)
    _fsync_path(ckpt_dir)
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def _step_dir(ckpt_dir: str, step: int) -> str:
    """Committed directory for ``step``: the canonical path, or the ``.old``
    copy displaced mid-overwrite if a crash left only that."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(os.path.join(final, _SENTINEL)):
        return final
    old = final + ".old"
    if os.path.exists(os.path.join(old, _SENTINEL)):
        return old
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    """Committed step numbers under ``ckpt_dir``, each listed once.

    ``step_X`` and ``step_X.old`` both map to step X. The sentinel is looked
    for under both names whichever one the listing returned, so an overwrite
    that renames ``step_X`` between the listing and the check cannot hide a
    committed step.
    """
    if not os.path.isdir(ckpt_dir):
        return []
    steps = set()
    for name in os.listdir(ckpt_dir):
        stem = name[:-len(".old")] if name.endswith(".old") else name
        if not (stem.startswith("step_") and stem[len("step_"):].isdigit()):
            continue
        final = os.path.join(ckpt_dir, stem)
        if (os.path.exists(os.path.join(final, _SENTINEL))
                or os.path.exists(os.path.join(final + ".old", _SENTINEL))):
            steps.add(int(stem[len("step_"):]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """Load + parse a committed checkpoint's manifest; loud on corruption."""
    path = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(path, _SENTINEL)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise CheckpointCorruptError(
            f"checkpoint {path} is committed but manifest.json is missing — "
            "the directory was partially deleted or tampered with")
    try:
        with open(manifest_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: manifest.json is unparseable ({e}) — "
            "truncated or corrupted after commit") from e
    if "leaves" not in meta:
        raise CheckpointCorruptError(
            f"checkpoint {path}: manifest.json has no 'leaves' table")
    return meta


def _open_arrays(path: str):
    arrays_path = os.path.join(path, "arrays.npz")
    if not os.path.exists(arrays_path):
        raise CheckpointCorruptError(
            f"checkpoint {path} is committed but arrays.npz is missing")
    try:
        return np.load(arrays_path)
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: arrays.npz failed to open ({e}) — "
            "truncated or corrupted after commit") from e


def _load_leaf(data, meta: dict, name: str, path: str) -> np.ndarray:
    """One verified leaf off the npz (bfloat16 still viewed as uint16)."""
    if name not in meta["leaves"]:
        raise KeyError(f"checkpoint missing leaf {name!r}")
    info = meta["leaves"][name]
    if name not in getattr(data, "files", ()):
        raise CheckpointCorruptError(
            f"checkpoint {path}: leaf {name!r} is in the manifest but "
            "missing from arrays.npz — partial write or truncation")
    try:
        arr = data[name]
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: leaf {name!r} failed to decompress ({e}) — "
            "truncated or corrupted after commit") from e
    want = info.get("sha256")
    if want is not None:
        got = _leaf_hash(arr)
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint {path}: leaf {name!r} failed its content hash "
                f"(manifest {want[:12]}…, on disk {got[:12]}…) — the payload "
                "changed after commit; refusing to restore silent garbage")
    return arr


def _to_tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like, device: str | torch.device = "cuda", *,
            mesh=None, placements=None):
    """Restore checkpoint ``step`` into the structure of ``like``.

    ``like`` supplies the tree structure and expected shapes; its tensor
    and array leaves come back as tensors on ``device``, its Python
    ``bool``/``int``/``float`` leaves as Python scalars of the same type.
    ``placements`` (one DTensor placement tuple for every leaf, as a list in
    leaf order, or one tuple for all) with a ``DeviceMesh`` ``mesh`` places
    each array leaf on the mesh: it comes back as a DTensor holding only
    this rank's shard (the reference's ``shardings``, for a restore onto a
    mesh of another size than the writer's). Every leaf is verified against
    the manifest's content hash. Returns ``(tree, extra_meta)``.
    """
    dev = resolve_device(device)
    path = _step_dir(ckpt_dir, step)
    meta = read_manifest(ckpt_dir, step)
    data = _open_arrays(path)
    if placements is not None:
        from ..runtime.shardings import distribute

        n_leaves = len(_flatten_with_names(like)[0])
        if not isinstance(placements, list):
            placements = [placements] * n_leaves
        if len(placements) != n_leaves:
            raise ValueError(f"{len(placements)} placements for {n_leaves} leaves")
    position = itertools.count()

    def load(name, leaf):
        i = next(position)
        arr = _load_leaf(data, meta, name, path)
        want_shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs model {want_shape}")
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(arr[()])
        t = _to_tensor(arr, meta["leaves"][name]["dtype"] == "bfloat16")
        if placements is not None:
            return distribute(t, mesh, placements[i], device=dev)
        return t.to(dev)

    return _rebuild(like, load), meta.get("extra")


def restore_tree(ckpt_dir: str, step: int):
    """Template-free restore: rebuild a nested dict from the manifest.

    Leaf names are split on ``/`` into nested dict keys. Leaves come back as
    hash-verified host numpy arrays, bfloat16 leaves as CPU
    ``torch.bfloat16`` tensors (numpy has no bfloat16). Returns
    ``(tree, extra_meta)``.
    """
    path = _step_dir(ckpt_dir, step)
    meta = read_manifest(ckpt_dir, step)
    data = _open_arrays(path)
    tree: dict = {}
    for name in sorted(meta["leaves"]):
        arr = _load_leaf(data, meta, name, path)
        if meta["leaves"][name]["dtype"] == "bfloat16":
            arr = _to_tensor(arr, True)
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree, meta.get("extra")
