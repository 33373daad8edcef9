"""Layer 2 — what PyTorch dispatches when the entry points run (A2, A3, R2).

The reference stages each entry point to a jaxpr and audits the trace
(``src/repro/analysis/jaxpr_audit.py``). Eager PyTorch has no trace to
stage, so the port runs each entry for real, twice, on fresh tensors of the
same shapes, and audits the second call:

* **A2 — unintended dtype promotion.** Every op the call dispatches is
  recorded under a ``TorchDispatchMode`` with the dtypes of its outputs;
  the entries' inputs are float32 and integer, so a float64 or complex128
  output is a promotion the float32 kernels would never see.
* **A3 — rebuild on a repeat call.** After the warm call, the call at the
  same shapes must make no ``nvcc`` build, no library load and no Triton
  compile (``kernels._build.rebuilds``), and no new
  ``cudaFuncSetAttribute`` (each library's own count).
* **R2 at run time, on the card only.** The call runs under
  ``torch.cuda.set_sync_debug_mode("warn")`` and its synchronizing calls
  are counted from the warnings (PyTorch 2.11's debug mode does not warn on
  ``torch.cuda.synchronize``, so a span's fence is added to the count by
  hand). A kernel entry must make none but its span fences; a pipeline
  entry's count is recorded, with the Python line of each sync. An ``_obs`` twin
  must dispatch its plain entry's ops and make its plain entry's syncs
  plus its spans' fences (the port's spans synchronize the card at exit by
  design). On the CPU the check is reported as not run, never as passed.

**A1 is not ported.** The reference's A1 catches a generator fused into a
gather by XLA. Eager PyTorch fuses nothing: every draw is materialized
before the op that reads it, and the port's kernels read materialized
operands (as the reference treats ``pallas_call`` as opaque).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import warnings
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .findings import Finding

__all__ = ["OpRecorder", "audit_dtypes", "rebuild_events", "count_rebuilds",
           "count_syncs", "EntryReport", "audit_entry", "audit_entry_points"]

_BAD_DTYPES = (torch.float64, torch.complex128)
# the debug mode's warning for each synchronizing call (setting the mode also
# warns once, about the mode itself)
_SYNC_WARNING = "called a synchronizing CUDA operation"
_FENCE_SITE = "repro_torch/obs/trace.py (span fence)"


class OpRecorder(TorchDispatchMode):
    """Records ``(op, output dtypes)`` of every op dispatched while active."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, tuple[str, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = tuple(str(t.dtype) for t in tree_flatten(out)[0]
                     if isinstance(t, torch.Tensor))
        self.ops.append((str(func), outs))
        return out


def audit_dtypes(entry: str, rec: OpRecorder) -> list[Finding]:
    """A2: every op (once) whose output is float64 or complex128; the
    entries' inputs are float32 and integer, so each is a promotion."""
    bad = {str(d) for d in _BAD_DTYPES}
    findings, seen = [], set()
    for op, outs in rec.ops:
        hit = bad & set(outs)
        if hit and op not in seen:
            seen.add(op)
            findings.append(Finding(
                rule="A2", path=f"entry:{entry}", line=0,
                message=f"{'/'.join(sorted(hit))} produced by {op} from float32 or "
                        "integer inputs — a promotion the float32 kernels never see",
                evidence="pass an explicit dtype=torch.float32"))
    return findings


def _attribute_sets() -> int:
    from ..kernels import _build
    total = 0
    for name, lib in _build.loaded().items():
        prefix = "flash" if name == "flash_attention" else name
        total += getattr(lib, f"{prefix}_attribute_sets")()
    return total


def rebuild_events() -> dict[str, int]:
    """nvcc builds, library loads, Triton compiles and ``cudaFuncSetAttribute``
    calls made so far in this process."""
    from ..kernels import _build
    return {**_build.rebuilds, "attribute_sets": _attribute_sets()}


def _rebuilds(entry: str, before: dict, after: dict) -> tuple[int, list[Finding]]:
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    n = sum(delta.values())
    findings = [] if not n else [Finding(
        rule="A3", path=f"entry:{entry}", line=0,
        message=f"{n} rebuild event(s) on a same-shape repeat call",
        evidence=", ".join(f"{k}: {v}" for k, v in sorted(delta.items())))]
    return n, findings


def count_rebuilds(entry: str, fn: Callable, make_args: Callable[[], tuple],
                   ) -> tuple[int, list[Finding]]:
    """Call ``fn`` on fresh same-shape arguments three times, as the
    reference does; any rebuild event after the warm call is an A3 finding.
    Returns ``(events, findings)``."""
    fn(*make_args())
    before = rebuild_events()
    for _ in range(2):
        fn(*make_args())
    return _rebuilds(entry, before, rebuild_events())


def _site(filename: str, lineno: int) -> str:
    norm = filename.replace("\\", "/")
    i = norm.rfind("repro_torch/")
    return f"{norm[i:] if i >= 0 else os.path.basename(norm)}:{lineno}"


def count_syncs(fn: Callable, *args):
    """``(out, sites)``: ``fn(*args)`` under the sync debug mode ``warn``;
    ``sites`` lists the Python line of each synchronizing call (CUDA only)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, [_site(w.filename, w.lineno) for w in caught
                 if str(w.message).startswith(_SYNC_WARNING)]


@dataclasses.dataclass
class EntryReport:
    """What one entry's audited call did."""

    name: str
    ops: list = dataclasses.field(default_factory=list)
    sync_sites: list | None = None   # None: not run (the CPU)
    fences: int = 0               # span fences (torch.cuda.synchronize) in the call
    rebuilds: int = 0
    findings: list = dataclasses.field(default_factory=list)

    @property
    def syncs(self) -> int | None:
        return None if self.sync_sites is None else len(self.sync_sites)

    def summary(self) -> dict:
        out = {"entry": self.name, "ops": len(self.ops),
               "syncs": "not run (cpu)" if self.syncs is None else self.syncs,
               "fences": self.fences, "rebuilds": self.rebuilds,
               "findings": len(self.findings)}
        if self.sync_sites:
            out["sync_sites"] = dict(sorted(collections.Counter(self.sync_sites).items()))
        return out


def audit_entry(name: str, device) -> EntryReport:
    """Warm call, then the audited call on fresh tensors of the same shapes:
    its ops, A2, A3 and (on the card) its syncs, each span fence added to
    them by hand (one site per fence)."""
    from ..obs import trace
    from . import entry_points

    dev = torch.device(device)
    make = entry_points.ENTRY_POINTS[name]
    fn, args = make(dev)
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fn, args = make(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report = EntryReport(name)
    before, fences = rebuild_events(), trace.fence_count()
    rec = OpRecorder()
    with rec:
        if dev.type == "cuda":
            _, report.sync_sites = count_syncs(fn, *args)
        else:
            fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report.rebuilds, found = _rebuilds(name, before, rebuild_events())
    report.fences = trace.fence_count() - fences
    if report.sync_sites is not None:
        report.sync_sites += [_FENCE_SITE] * report.fences
    report.ops = rec.ops
    report.findings += audit_dtypes(name, rec) + found
    if report.syncs and report.syncs > report.fences and name in entry_points.KERNEL_ENTRIES:
        report.findings.append(Finding(
            rule="R2", path=f"entry:{name}", line=0,
            message=f"kernel entry made {report.syncs - report.fences} host sync(s) "
                    "besides its span fences",
            evidence="a kernel entry launches and returns; nothing waits for the card"))
    return report


def _twin_findings(twin: EntryReport, plain: EntryReport) -> list[Finding]:
    out = []
    if twin.ops != plain.ops:
        extra = len(twin.ops) - len(plain.ops)
        first = next((i for i, (a, b) in enumerate(zip(twin.ops, plain.ops)) if a != b),
                     min(len(twin.ops), len(plain.ops)))
        out.append(Finding(
            rule="R2", path=f"entry:{twin.name}", line=0,
            message=f"obs twin dispatches other ops than {plain.name} "
                    f"({len(twin.ops)} against {len(plain.ops)})",
            evidence=f"first difference at op {first}; {extra:+d} ops"))
    if twin.syncs is not None and twin.syncs != plain.syncs + twin.fences:
        extra = collections.Counter(twin.sync_sites)
        extra.subtract(plain.sync_sites)
        out.append(Finding(
            rule="R2", path=f"entry:{twin.name}", line=0,
            message=f"obs twin made {twin.syncs} syncs; {plain.name} made {plain.syncs} "
                    f"and its spans fenced {twin.fences} time(s)",
            evidence="sites (twin - plain): " + ", ".join(
                f"{k} {v:+d}" for k, v in sorted(extra.items()) if v)))
    return out


def audit_entry_points(names: list[str] | None = None, device="cuda",
                       ) -> tuple[list[Finding], list[EntryReport], dict]:
    """A2/A3/R2 over the registry and A3 over the reference's recompile
    targets: ``(findings, reports, recompiles)``. An entry that fails to run
    is itself a finding."""
    from ..device import resolve_device
    from . import entry_points

    device = resolve_device(device)
    names = list(names or entry_points.ENTRY_POINTS)
    for twin, plain in entry_points.OBS_TWINS.items():
        if twin in names and plain not in names:
            names.append(plain)
    findings: list[Finding] = []
    reports: dict[str, EntryReport] = {}
    try:
        for name in names:
            try:
                reports[name] = audit_entry(name, device)
            except Exception as exc:  # noqa: BLE001 — report, don't crash the lane
                findings.append(Finding(
                    rule="A3", path=f"entry:{name}", line=0,
                    message="entry point failed to run",
                    evidence=f"{type(exc).__name__}: {exc}"))
                continue
            findings += reports[name].findings
        for twin, plain in entry_points.OBS_TWINS.items():
            if twin in reports and plain in reports:
                findings += _twin_findings(reports[twin], reports[plain])
        recompiles = {}
        for name, (fn, make_args) in entry_points.recompile_targets(device).items():
            recompiles[name], found = count_rebuilds(name, fn, make_args)
            findings += found
    finally:
        entry_points.close()
    return findings, [reports[n] for n in names if n in reports], recompiles
