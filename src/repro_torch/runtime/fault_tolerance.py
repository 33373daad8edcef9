"""Fault-tolerance runtime: failure simulation and retry-from-checkpoint.

The recovery loop has one shape wherever a process can fail mid-run::

    while step < total:
        try:
            state = step_fn(step, state)
        except failure:
            restore the latest checkpoint this run committed
            continue

This module provides that loop's pieces in a testable form, with the
reference's semantics, event names and counter names:

  * ``FailureInjector`` — a deterministic step-indexed fault schedule (raises
    ``SimulatedFailure`` inside the step callable), so tests and drivers
    exercise the real recovery path;
  * ``run_with_recovery`` — the retry loop: restore from this run's latest
    save, bounded retries, monotonic progress;
  * ``elastic_restore`` — a checkpoint placed onto a device mesh of another
    size than the one that wrote it, each rank holding only its shards
    (placements from ``runtime.shardings``).

LAMC's own resilience is statistical: ``probability.resamples_for_failures``
turns an expected number of failed blocks into extra resamples, a fault
budget no retry loop needs to see.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import torch

from .. import obs
from ..checkpoint import checkpoint as ckpt

logger = logging.getLogger("repro_torch.fault_tolerance")

__all__ = ["SimulatedFailure", "FailureInjector", "run_with_recovery", "elastic_restore"]


class SimulatedFailure(RuntimeError):
    """Stands in for a device or process failure in tests and examples."""


@dataclasses.dataclass
class FailureInjector:
    """Raises at the configured steps — exactly once each."""
    fail_at_steps: tuple[int, ...] = ()
    _fired: set[int] = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


def run_with_recovery(
    *,
    total_steps: int | None,
    step_fn: Callable[[int, Any], Any],       # (step, state) -> state
    state: Any,
    ckpt_dir: str,
    save_every: int,
    state_for_save: Callable[[Any], Any] = lambda s: s,
    restore_state: Callable[[int], Any] | None = None,
    max_retries: int = 8,
    start_step: int = 0,
    save_fn: Callable[[int, Any], None] | None = None,
) -> tuple[Any, dict]:
    """Drive ``step_fn`` with checkpoint/restart fault tolerance.

    ``restore_state(step)`` rebuilds the state from checkpoint ``step``
    (``restore_state(-1)``: from scratch); without it the state is kept as
    the failed step left it. ``total_steps=None`` runs stream-driven: the
    loop ends when ``step_fn`` raises ``StopIteration``, with a final
    checkpoint of whatever followed the last periodic save; a sized run that
    meets ``StopIteration`` re-raises it. ``save_fn(step, state)`` replaces
    the default ``checkpoint.save`` call (for callers that attach their own
    metadata). A step that is both a ``save_every`` multiple and the final
    step is saved once. Only checkpoints this run wrote are restored: a
    higher step left in ``ckpt_dir`` by an earlier run is ignored. Returns
    ``(final_state, {"failures": n, "final_step": step})``.
    """
    step = step0 = start_step
    retries = 0
    failures = 0
    last_saved: int | None = None

    _metrics = obs.get_registry()

    def _save(s: int, st: Any) -> None:
        nonlocal last_saved
        if s == last_saved:
            return  # already durable at this step
        if save_fn is not None:
            save_fn(s, st)
        else:
            ckpt.save(ckpt_dir, s, state_for_save(st), extra_meta={"step": s})
        last_saved = s
        obs.event("recovery.checkpoint_saved", step=s)
        _metrics.counter(
            "recovery_checkpoints",
            help="checkpoints committed by run_with_recovery").inc()

    while total_steps is None or step < total_steps:
        try:
            state = step_fn(step, state)
        except StopIteration:
            if total_steps is not None:
                raise  # a sized run must not end early
            break  # stream exhausted: normal termination
        except SimulatedFailure as e:
            failures += 1
            retries += 1
            _metrics.counter(
                "recovery_failures",
                help="step failures seen by run_with_recovery").inc()
            if retries > max_retries:
                obs.event("recovery.retries_exhausted", failed_step=step,
                          retries=retries - 1, max_retries=max_retries)
                raise RuntimeError(f"exceeded {max_retries} retries") from e
            latest = ckpt.latest_step(ckpt_dir)
            if latest is not None and (last_saved is None or latest > last_saved):
                # a step this run did not write (a dirty directory): restore
                # this run's own latest save, or start over
                logger.warning(
                    "ignoring checkpoint step %s in %s: not written by this "
                    "run (last saved here: %s)", latest, ckpt_dir, last_saved)
                obs.event("recovery.stale_checkpoint", ignored_step=latest,
                          last_saved=last_saved)
                _metrics.counter(
                    "recovery_stale_checkpoints",
                    help="foreign checkpoint steps ignored on restore").inc()
                latest = last_saved
            logger.warning("step %d failed (%s); restoring from %s",
                           step, e, latest)
            obs.event("recovery.restore", failed_step=step,
                      target=-1 if latest is None else latest,
                      retries=retries, chunks_replayed=(
                          step - (step0 if latest is None else latest)))
            _metrics.counter(
                "recovery_restores",
                help="restore-from-checkpoint recoveries").inc()
            if latest is None:
                step = step0
                if restore_state is not None:
                    state = restore_state(-1)
            else:
                assert latest >= step0, (
                    f"checkpoint {latest} predates start step {step0}")
                step = latest
                if restore_state is not None:
                    state = restore_state(latest)
            continue
        step += 1
        retries = 0
        if step % save_every == 0 or (total_steps is not None
                                      and step == total_steps):
            _save(step, state)
    if step > step0:
        _save(step, state)  # a no-op unless progress followed the last save
    return state, {"failures": failures, "final_step": step}


def _flat_placements(like, specs) -> list:
    """``specs`` (placement tuples in ``like``'s structure) as a list in the
    checkpoint's leaf order."""
    out: list = []

    def walk(leaf, spec):
        if leaf is None:
            return
        if isinstance(leaf, dict):
            for key in sorted(leaf):
                walk(leaf[key], spec[key])
        elif isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            for field in leaf._fields:
                walk(getattr(leaf, field), getattr(spec, field))
        elif isinstance(leaf, (list, tuple)):
            for a, b in zip(leaf, spec):
                walk(a, b)
        else:
            out.append(spec)

    walk(like, specs)
    return out


def elastic_restore(ckpt_dir: str, step: int, like, mesh, specs,
                    device: str | torch.device = "cuda"):
    """Restore a checkpoint onto the ``DeviceMesh`` ``mesh`` with ``specs``
    (placements in ``like``'s structure, e.g.
    ``shardings.stream_state_specs``): array leaves come back as DTensors,
    each rank holding only its shards on ``device``. The mesh may differ in
    size from the one that wrote the checkpoint (elastic scaling). Returns
    ``(tree, extra_meta)``."""
    return ckpt.restore(ckpt_dir, step, like, device, mesh=mesh,
                        placements=_flat_placements(like, specs))
