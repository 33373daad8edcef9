"""Pattern-keyed sparse-operator conversion cache (DESIGN.md §9).

The resample loop prepares the operator of a matrix whose sparsity pattern
is stable. Conversion splits the same way as its cost: the pattern half
(tile discovery, visit order, scatter offsets: ``kernels.spmm.block_sparse_plan``
/ ``sparse.ell_plan``) and the values half (one flat scatter). The cache
keeps the converted operators of up to ``capacity`` patterns, so:

  * the same COO tensor object, unmodified    -> **hit**: the cached
    operator as it is (no work);
  * the same pattern with other values        -> **refresh**: the cached
    plan re-applied in one scatter;
  * anything else                             -> **miss**: full conversion,
    result cached.

A hit is decided by object identity and the tensor's version counter (an
in-place change of the values bumps it), so the hit path never reads the
indices. A candidate for a refresh must match shape, nnz, device, dtype and
tile config, and is then confirmed by ``torch.equal`` of the indices on the
device: nothing is hashed or copied to the host.

Counters: ``hits``, ``misses``, ``refreshes`` (plain integers).
``REPRO_TILED_CACHE=0`` disables the cache: every lookup converts and stores
nothing; the result is the same either way.

Thread safety: one re-entrant lock guards the entry table; the conversion
work itself runs outside it, so two threads may both convert on a cold miss
(the last install wins, which is correct because conversion is
deterministic).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["PatternCache", "cache_enabled", "default_cache"]


def cache_enabled() -> bool:
    return os.environ.get("REPRO_TILED_CACHE", "1") != "0"


class _Entry(NamedTuple):
    plan: Any          # reusable pattern half (BlockSparsePlan / EllPlan)
    operator: Any      # the operator built from (plan, source's values)
    source: Any        # strong ref: the COO tensor it was built from
    version: int       # source._version when it was built


def _signature(a: torch.Tensor, config: tuple) -> tuple:
    """Everything but the indices' contents that a match must share."""
    return (tuple(a.shape), a._nnz(), str(a.device), str(a.dtype), *config)


class PatternCache:
    """Bounded LRU of converted sparse operators, keyed by pattern.

    One process-wide instance (:func:`default_cache`) backs
    ``core.sparse.prepare_operator``; tests construct their own. Entries
    hold the whole converted operator (the block stack dominates), so the
    capacity stays small.
    """

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._entries: OrderedDict[int, tuple[tuple, _Entry]] = OrderedDict()
        self._next_id = 0
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.refreshes = 0

    def _find(self, a: torch.Tensor, sig: tuple):
        """``(slot, entry, is_hit)`` of a cached entry for ``a``'s pattern, or
        ``(None, None, False)``. Caller holds the lock."""
        for slot, (esig, entry) in self._entries.items():
            if esig == sig and entry.source is a and entry.version == a._version:
                return slot, entry, True
        for slot, (esig, entry) in self._entries.items():
            if esig == sig and torch.equal(entry.source.indices(), a.indices()):
                return slot, entry, False
        return None, None, False

    def convert(self, a: torch.Tensor, config: tuple,
                plan_fn: Callable[[Any], Any], apply_fn: Callable[[Any, Any], Any]):
        """Convert coalesced COO ``a`` under ``config``, reusing cached work.

        ``plan_fn(a)`` returns ``(plan, operator)`` on a miss;
        ``apply_fn(plan, values)`` rebuilds an operator from a cached plan
        and fresh values. ``config`` is the static part of the key (tile
        shape or format tag).
        """
        if not cache_enabled():
            return plan_fn(a)[1]
        sig = _signature(a, config)
        with self._lock:
            slot, entry, hit = self._find(a, sig)
            if slot is not None:
                self._entries.move_to_end(slot)
            if hit:
                self.hits += 1
                return entry.operator
        if entry is not None:
            op = apply_fn(entry.plan, a.values())
            with self._lock:
                self._install(sig, _Entry(entry.plan, op, a, a._version), slot)
                self.refreshes += 1
            return op
        plan, op = plan_fn(a)
        with self._lock:
            # a racing thread may have installed the same pattern meanwhile
            slot, _, _ = self._find(a, sig)
            self._install(sig, _Entry(plan, op, a, a._version), slot)
            self.misses += 1
        return op

    def _install(self, sig: tuple, entry: _Entry, slot: int | None) -> None:
        if slot is None or slot not in self._entries:
            slot = self._next_id
            self._next_id += 1
        self._entries[slot] = (sig, entry)
        self._entries.move_to_end(slot)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_DEFAULT: PatternCache | None = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> PatternCache:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = PatternCache()
    return _DEFAULT
