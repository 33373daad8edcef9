"""Static and run-time analysis of the port (the reference's ``repro.analysis``).

Two layers guard the invariants the port's results depend on:

* **AST lint** (:mod:`.ast_lint`) — rules R1-R4 over source: draws that
  are not replayable, host syncs in hot scopes, Python state captured
  across calls, and wall-clock or global RNG where seeded generator streams
  are the contract.
* **Entry-point and kernel audit** (:mod:`.dispatch_audit`,
  :mod:`.entry_points`, :mod:`.smem`) — the ops each entry point
  dispatches (A2 dtype promotion), rebuilds on a repeat call (A3), host
  syncs on the card (R2 at run time), and each CUDA kernel's shared memory
  and registers against Hopper's budget (A4).

CLI: ``python -m repro_torch.analysis [--strict] [--json] [--device cpu]``.
Suppress a finding in source with ``# repro: allow[RULE] reason``, the
reference's pragma (one pragma serves both analyzers).
"""

from .findings import RULES, Finding, parse_pragmas  # noqa: F401

__all__ = ["Finding", "RULES", "parse_pragmas"]
