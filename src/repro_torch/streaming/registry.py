"""Versioned model registry: the store that makes hot swaps safe.

A :class:`ModelRegistry` is a directory of named model lines, each a
sequence of immutable versions, laid out as the reference package lays
them out (so either package reads the other's registry)::

    root/
      <name>/
        v_000001/   one checkpoint dir (save_model format)
        v_000002/
        ...

Every version records *provenance* next to the arrays: the config hash
(so "did the knobs change?" is one string compare), a data fingerprint
(what the model was fitted on — caller-supplied, e.g. a stream id or
:func:`model_fingerprint` of the artifact itself), and free-form metrics
(fit NMI, rows/s). Publishing is crash-consistent for free: the version
directory is claimed atomically (``mkdir``), the payload commits through
``checkpoint``'s fsync'd rename, and a version without a committed
checkpoint (a crash mid-publish) is invisible to ``versions``/``load``.
Versions are immutable — a republish allocates the next id, it never
rewrites history — which is exactly what lets the serving path swap
between them without coordination: any version a reader resolved stays
readable forever.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import checkpoint as _ckpt
from ..device import resolve_device
from .model import CoclusterModel, ModelLoadError, load_model, save_model

__all__ = ["ModelRegistry", "RegistryEntry", "config_hash",
           "model_fingerprint"]

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")
_VERSION_RE = re.compile(r"^v_(\d{6})$")


def config_hash(cfg) -> str:
    """Stable hash of a fit config (dataclass, dict, or None).

    Key order is canonicalized, so two configs with equal fields hash
    equal regardless of construction order; ``None`` hashes to a fixed
    sentinel so "no config recorded" is still a comparable value.
    """
    if cfg is None:
        payload = "null"
    else:
        d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else cfg
        payload = json.dumps(d, sort_keys=True, default=str)
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def model_fingerprint(model: CoclusterModel) -> str:
    """Content hash over every array leaf (name, dtype, shape, bytes).

    Two bit-identical models fingerprint equal; any retrain that moves a
    single vote count does not. The hash covers the host numpy view of each
    leaf in the reference's field order and dtype strings, so one model
    fingerprints equal in both packages. Usable as the registry's
    ``data_fingerprint`` when no upstream dataset id exists.
    """
    h = hashlib.blake2b(digest_size=8)
    for field in model._fields:
        leaf = getattr(model, field)
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        h.update(field.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class RegistryEntry(NamedTuple):
    """One committed version's identity + provenance (no arrays)."""

    name: str
    version: str
    path: str                     # the version's checkpoint directory
    config_hash: str
    data_fingerprint: str | None
    metrics: dict
    created: float | None         # unix seconds at publish


class ModelRegistry:
    """Named, versioned ``CoclusterModel`` store over ``checkpoint``.

    Single registry object per process is the expected shape (the
    service and the background fitter share one); publishing is guarded
    by a lock in-process and by atomic ``mkdir`` claims across
    processes, so concurrent publishers can never allocate the same
    version id.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    # -- naming ----------------------------------------------------------
    def _line_dir(self, name: str) -> str:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad model name {name!r}: must match {_NAME_RE.pattern} "
                "(a path-safe identifier)")
        return os.path.join(self.root, name)

    def names(self) -> list[str]:
        """Model lines with at least one committed version."""
        if not os.path.isdir(self.root):
            return []
        return sorted(n for n in os.listdir(self.root)
                      if _NAME_RE.match(n) and self.versions(n))

    def versions(self, name: str) -> list[str]:
        """Committed version ids for ``name``, oldest first."""
        line = self._line_dir(name)
        if not os.path.isdir(line):
            return []
        out = []
        for entry in os.listdir(line):
            if not _VERSION_RE.match(entry):
                continue
            # a claimed-but-never-committed version dir (crash mid-
            # publish) has no committed checkpoint step and is invisible
            if _ckpt.latest_step(os.path.join(line, entry)) is not None:
                out.append(entry)
        return sorted(out)

    def latest(self, name: str) -> str | None:
        vs = self.versions(name)
        return vs[-1] if vs else None

    # -- write path ------------------------------------------------------
    def publish(self, name: str, model: CoclusterModel, *, cfg=None,
                metrics: dict | None = None,
                data_fingerprint: str | None = None,
                extra: dict | None = None) -> RegistryEntry:
        """Commit ``model`` as the next version of line ``name``.

        Returns the committed :class:`RegistryEntry`. The version id is
        claimed with an atomic ``mkdir`` (retried past ids claimed by
        racing publishers), then the payload lands via ``save_model``'s
        fsync'd rename — so a crash at any point leaves either a fully
        committed version or an empty claim that listing ignores.
        """
        line = self._line_dir(name)
        os.makedirs(line, exist_ok=True)
        with self._lock:
            n = 0
            for entry in os.listdir(line):
                m = _VERSION_RE.match(entry)
                if m:
                    n = max(n, int(m.group(1)))
            while True:
                n += 1
                version = f"v_{n:06d}"
                vdir = os.path.join(line, version)
                try:
                    os.mkdir(vdir)  # atomic claim, also across processes
                    break
                except FileExistsError:
                    continue
        reg_meta = {
            "name": name,
            "version": version,
            "config_hash": config_hash(cfg),
            "data_fingerprint": data_fingerprint,
            "metrics": dict(metrics or {}),
            "created": time.time(),
        }
        payload = {"registry": reg_meta}
        if extra:
            payload.update(extra)
        cfg_arg = cfg if (dataclasses.is_dataclass(cfg)
                          and not isinstance(cfg, type)) else None
        save_model(vdir, model, cfg=cfg_arg, extra=payload)
        return self._entry(name, version, vdir, reg_meta)

    # -- read path -------------------------------------------------------
    @staticmethod
    def _entry(name: str, version: str, vdir: str,
               reg_meta: dict) -> RegistryEntry:
        return RegistryEntry(
            name=name, version=version, path=vdir,
            config_hash=reg_meta.get("config_hash", ""),
            data_fingerprint=reg_meta.get("data_fingerprint"),
            metrics=dict(reg_meta.get("metrics") or {}),
            created=reg_meta.get("created"))

    def entry(self, name: str, version: str | None = None) -> RegistryEntry:
        """Provenance of one version (latest by default) — manifest only,
        no array payload is read."""
        version = version or self.latest(name)
        if version is None:
            raise ModelLoadError(
                f"registry has no committed versions of {name!r} under "
                f"{self.root!r} — publish one first")
        vdir = os.path.join(self._line_dir(name), version)
        step = _ckpt.latest_step(vdir)
        if step is None:
            raise ModelLoadError(
                f"registry version {name}/{version} has no committed "
                "checkpoint (crashed publish?) — pick another version")
        meta = _ckpt.read_manifest(vdir, step)
        reg_meta = (meta.get("extra") or {}).get("registry") or {}
        return self._entry(name, version, vdir, reg_meta)

    def entries(self, name: str) -> list[RegistryEntry]:
        return [self.entry(name, v) for v in self.versions(name)]

    def load(self, name: str, version: str | None = None,
             device: str | torch.device = "cuda"
             ) -> tuple[CoclusterModel, RegistryEntry]:
        """Restore ``(model, entry)`` for ``name`` at ``version`` (latest
        when omitted) onto ``device``; hash-verified via ``load_model``."""
        dev = resolve_device(device)
        ent = self.entry(name, version)
        model, _ = load_model(ent.path, device=dev)
        return model, ent
