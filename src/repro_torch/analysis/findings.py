"""Finding records, ``# repro: allow[RULE]`` pragmas, and report rendering.

Every analyzer layer (AST lint, dispatch audit, shared-memory estimator)
emits :class:`Finding` records. A finding names its rule, where it anchors
(``path:line`` for lint findings, ``entry:<name>`` or ``kernel:<name>`` for
audit findings), and the evidence that makes it actionable.

Suppression is source-anchored and spelled as in the reference package, so
one pragma is read by both analyzers: a ``# repro: allow[R2]`` comment on
the offending line (or on a comment-only line directly above it) silences
that rule there. A pragma carries a free-text reason after the bracket; the
lint does not parse it, but review should: an allow pragma without a
reason is a smell.

The JSON report has the reference's schema (``findings``, ``suppressed``,
``rules``). ``RULES`` has no A1: eager PyTorch fuses no generator into a
gather, so the rule has nothing to check (``dispatch_audit``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Iterable

__all__ = ["Finding", "parse_pragmas", "filter_suppressed",
           "render_text", "render_json", "RULES"]

#: rule id -> one-line description
RULES = {
    "R1": "draw that is not replayable: a sampling call without generator=, or "
          "two generators seeded from the same words, both sampled",
    "R2": "host sync in a hot scope (.item()/.tolist()/.cpu()/.numpy(), "
          "float()/int()/bool() or a Python if/while on a tensor, "
          "torch.cuda.synchronize)",
    "R3": "Python state captured across calls (mutable defaults, mutated "
          "module globals) in hot-reachable code",
    "R4": "wall clock or global RNG (legacy np.random, unseeded default_rng, "
          "torch.manual_seed/seed) where seeded generator streams are the "
          "contract",
    "A2": "unintended dtype promotion (a float64/complex128 result from "
          "float32 or integer inputs in an entry point)",
    "A3": "rebuild on a same-shape repeat call (nvcc build, library load, "
          "Triton compile or a new cudaFuncSetAttribute)",
    "A4": "CUDA kernel over Hopper's per-block budget: shared memory (static "
          "+ dynamic), registers x threads, registers a thread, spills; or "
          "an estimate that differs from what the card reports",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # "R1".."R4" (lint) / "A2".."A4" (audit)
    path: str       # repo-relative file path, or "entry:<name>" / "kernel:<name>"
    line: int       # 1-based source line; 0 when not source-anchored
    message: str    # what is wrong, in one sentence
    evidence: str = ""  # the snippet / op / byte math backing it

    def key(self) -> tuple:
        return (self.rule, self.path, self.line, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "evidence": self.evidence}


_PRAGMA_RE = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9*,\s]+)\]")


def parse_pragmas(source: str) -> dict[int, set[str]]:
    """Map line number -> set of allowed rule ids (``{"*"}`` allows all).

    A pragma on a code line covers that line. A pragma on a line whose
    code content is only the comment covers the *next* line as well, so
    long statements can carry the pragma above them.
    """
    allowed: dict[int, set[str]] = {}
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        allowed.setdefault(i, set()).update(rules)
        if text[: m.start()].strip() == "":  # comment-only line
            allowed.setdefault(i + 1, set()).update(rules)
    return allowed


def _covers(rules: set[str], rule: str) -> bool:
    return "*" in rules or rule in rules


def filter_suppressed(findings: Iterable[Finding],
                      pragmas_by_path: dict[str, dict[int, set[str]]],
                      ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (active, suppressed) using per-file pragmas.

    Multi-line statements anchor their finding at the statement's first
    line, which is where the pragma must sit (or the comment line above).
    """
    active, suppressed = [], []
    for f in findings:
        rules = pragmas_by_path.get(f.path, {}).get(f.line, set())
        (suppressed if _covers(rules, f.rule) else active).append(f)
    return active, suppressed


def render_text(findings: list[Finding], suppressed: list[Finding],
                strict: bool) -> str:
    out = []
    for f in sorted(findings, key=Finding.key):
        loc = f.path if f.line == 0 else f"{f.path}:{f.line}"
        out.append(f"{loc}: [{f.rule}] {f.message}")
        if f.evidence:
            for ln in f.evidence.splitlines():
                out.append(f"    {ln}")
    n, s = len(findings), len(suppressed)
    tail = f"{n} finding{'s' if n != 1 else ''}"
    if s:
        tail += f" ({s} suppressed by pragma)"
    if strict and n:
        tail += " — failing (--strict)"
    out.append(tail)
    return "\n".join(out)


def render_json(findings: list[Finding], suppressed: list[Finding]) -> str:
    return json.dumps(
        {"findings": [f.to_dict() for f in sorted(findings, key=Finding.key)],
         "suppressed": [f.to_dict() for f in sorted(suppressed,
                                                    key=Finding.key)],
         "rules": RULES},
        indent=2)
