"""``python -m repro_torch.analysis`` — run the analyzer and report findings.

Layers are selectable so a lane can split them into fast and slow steps:

* ``--ast-only``   — Layer 1 AST lint over the source tree (imports nothing
  of the port, runs anywhere)
* ``--audit-only`` — Layer 2: the entry-point audit (A2, A3, R2 at run
  time) and the shared-memory audit (A4)
* default          — both layers

The audit runs the entry points on the card unless ``--device cpu`` asks for
the CPU, and raises where there is no card. On the card A4 also builds the
kernels and holds each estimate against what ptxas and the launchers
report; on the CPU it checks the estimates against the budgets, and the
sync count is reported as not run.

``--strict`` exits 1 on any active (non-suppressed) finding; ``--json``
emits the machine-readable report (the reference's schema).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import ast_lint
from .findings import Finding, render_json, render_text

#: relative to the repository root
_DEFAULT_PATHS = (os.path.join("src", "repro_torch"), "chip_smoke.py")


def _repo_root() -> str:
    # src/repro_torch/analysis/cli.py -> the repository root is above src/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run_audits(entries: list[str] | None, device: str) -> tuple[list[Finding], dict]:
    """Both Layer 2 audits on ``device``: ``(findings, details)``, where
    ``details`` holds each entry's report, the recompile counts and the A4
    rows (with what the card reports, on the card)."""
    from ..device import resolve_device
    from . import dispatch_audit, smem

    dev = resolve_device(device)
    findings, reports, recompiles = dispatch_audit.audit_entry_points(entries, dev)
    measured = smem.measure() if dev.type == "cuda" else None
    a4, rows = smem.audit_smem(measured)
    return findings + a4, {"entries": reports, "recompiles": recompiles, "smem": rows}


def _details_text(details: dict) -> str:
    out = ["entry points (ops, syncs, span fences, rebuilds on the repeat call):"]
    for rep in details["entries"]:
        s = rep.summary()
        out.append(f"  {s['entry']:<22} ops {s['ops']:>5}  syncs {s['syncs']!s:>13}  "
                   f"fences {s['fences']}  rebuilds {s['rebuilds']}")
    for name, n in sorted(details["recompiles"].items()):
        out.append(f"  {name:<22} rebuilds on repeat calls: {n}")
    out.append("A4 (static + dynamic shared memory a block; card's report when measured):")
    for row in details["smem"]:
        got = ""
        if "measured_static_bytes" in row:
            got = (f"  card {row['measured_static_bytes']} + "
                   f"{row['measured_dynamic_bytes']} B, {row['registers']} regs, "
                   f"spills {row['spill_bytes']} B")
        out.append(f"  {row['kernel']:<42} {row['static_bytes']} + {row['dynamic_bytes']} B "
                   f"x {row['threads']} threads{got}")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST lint + entry-point and shared-memory audit for the port")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to lint (default: src/repro_torch and "
                             "chip_smoke.py at the repository root)")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 if any active finding remains")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable findings report")
    layer = parser.add_mutually_exclusive_group()
    layer.add_argument("--ast-only", action="store_true",
                       help="run only the Layer 1 AST lint")
    layer.add_argument("--audit-only", action="store_true",
                       help="run only the Layer 2 entry-point and shared-memory audits")
    parser.add_argument("--entry", action="append", dest="entries",
                        help="audit only this entry point (repeatable)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the audit runs the entry points (default: the card)")
    args = parser.parse_args(argv)

    findings: list[Finding] = []
    suppressed: list[Finding] = []
    details = None

    if not args.audit_only:
        paths = args.paths or [os.path.join(_repo_root(), p) for p in _DEFAULT_PATHS]
        active, supp = ast_lint.run_ast_lint(paths)
        findings += active
        suppressed += supp

    if not args.ast_only:
        active, details = run_audits(args.entries, args.device)
        findings += active

    if args.as_json:
        print(render_json(findings, suppressed))
    else:
        if details is not None:
            print(_details_text(details))
        print(render_text(findings, suppressed, args.strict))
    return 1 if (args.strict and findings) else 0


if __name__ == "__main__":
    sys.exit(main())
