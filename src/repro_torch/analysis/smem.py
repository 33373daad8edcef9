"""A4 — Hopper shared-memory and register estimator for the port's kernels.

The reference prices each Pallas kernel's VMEM working set from its
BlockSpecs (``src/repro/analysis/vmem.py``). A CUDA kernel's per-CTA budget
on an H100 is shared memory and registers, so this module prices each
kernel instance of ``kernels/csrc`` from the same constants the ``.cu``
files use (``narrow_smem`` and ``Wide::kSmem`` in ``kmeans.cu``, ``Tile::kSmem``
in ``cosine.cu``, the static arrays and ``AtaSmem`` in ``spmm.cu``,
``smem_floats<kDh>`` and ``Cfg<kDh>::kSmem`` in ``flash_attention.cu``): static
plus dynamic bytes at the configuration each launcher uses, with the threads
of a block and the blocks an SM its ``__launch_bounds__`` promise. An
instance is priced at its largest launch (the k-means narrow tile at
``D = DM, K = 32``, what its launcher opts in to), and the atom's own
launch (``D = 5, K = 16``) is priced beside it.

The budgets of an H100 (sm_90): 232,448 bytes of
shared memory a block (227 KB), of which at most 48 KB static (more only as
dynamic memory after ``cudaFuncSetAttribute``); 233,472 bytes an SM with
1 KB kept by the system for each resident block; 65,536 registers a block
(and an SM), at most 255 a thread; no spills.

:func:`measure` reads what the card's toolchain reports: static shared
memory, registers and spill bytes from each library's ``-Xptxas -v``
report (``kernels._build``), and the dynamic bytes from the launcher itself
(``<lib>_smem_bytes``); the Triton ``scale_apply`` is priced from its
compiled metadata. :func:`audit_smem` checks the estimates against the
budgets and, given a measurement, against what was measured: an estimate
must equal the measured use, and an instance the report names but the
registry does not (or the other way round) is a finding.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

from .findings import Finding

__all__ = ["KernelVariant", "VARIANTS", "parse_ptxas", "kernel_key",
           "measure", "audit_smem", "ALLOWED_SPILLS", "SMEM_PER_BLOCK",
           "STATIC_SMEM_MAX", "SMEM_PER_SM", "RESERVED_PER_BLOCK",
           "REGS_PER_BLOCK", "REGS_PER_THREAD"]

SMEM_PER_BLOCK = 232_448
STATIC_SMEM_MAX = 48 * 1024
SMEM_PER_SM = 233_472
RESERVED_PER_BLOCK = 1024
REGS_PER_BLOCK = 65_536
REGS_PER_THREAD = 255

#: Spills the port ships with, by kernel instance: (spill store bytes,
#: spill load bytes) at most, measured on the H100 with the CUDA 12 ptxas
#: (PERF.md, section 6). A measurement above them is a finding.
ALLOWED_SPILLS: dict[str, tuple[int, int]] = {
    "spmm_fwd_kernel<7>": (8, 8),
    "spmm_fwd_kernel<8>": (180, 136),
    "spmm_ata_kernel<6>": (16, 24),
    "spmm_ata_kernel<7>": (16, 28),
    "spmm_ata_kernel<8>": (48, 76),
}

F32 = 4


def _round4(v: int) -> int:
    return (v + 3) & ~3


# ---------------------------------------------------------------- kmeans.cu
KM_THREADS = 256
KM_NARROW_TILE = KM_THREADS * 4
KM_NARROW_MAX_D, KM_NARROW_MAX_K = 16, 32
KM_GROUPS = KM_THREADS // 32


def kmeans_narrow_bytes(dm: int, d: int, k: int, update: bool) -> int:
    """``narrow_smem(round4(DM), D, K, update).total`` floats, in bytes."""
    cs = _round4(dm)
    c2 = k * cs
    x = c2 + _round4(k)
    lab = x + _round4(KM_NARROW_TILE * d + 3)
    slab = lab + 2 * KM_NARROW_TILE
    total = slab + (KM_THREADS // (d + 1)) * k * (d + 1) if update else lab
    return F32 * total


def kmeans_wide_bytes() -> int:
    """``Wide::kSmem``: a three-deep ring of 32 feature rows of 128 points
    and 128 centroids (kLd = 260), the rows' norms, labels and weights."""
    rows = 128 + 128
    ring = 3 * 32 * (rows + 4)
    return F32 * (ring + rows) + (4 + 4) * 128


# ---------------------------------------------------------------- cosine.cu

def cosine_tile_bytes(mp: int, mk: int, warps_p: int, warps_k: int, chunk_q: int,
                      stages: int) -> tuple[int, int]:
    """``(Tile::kThreads, Tile::kSmem)``: the ring of feature slices and the
    running top-16 lists (8 bytes an entry)."""
    threads = 32 * warps_p * warps_k
    tile_p = warps_p * 2 * mp
    tile_k = warps_k * 16 * mk
    ld = tile_p + tile_k + 4
    lists = warps_k * tile_p
    return threads, F32 * stages * chunk_q * ld + 8 * lists * 16


COSINE_NARROW = (4, 1, 4, 1, 16, 4, 1)   # Tile<MP, MK, WarpsP, WarpsK, ChunkQ, Stages, MinBlocks>
COSINE_WIDE = (16, 8, 2, 4, 32, 2, 1)


# ------------------------------------------------------------------ spmm.cu
SPMM_THREADS, SPMM_MAX_TILE, SPMM_REDUCE_THREADS, GRAM_THREADS = 512, 128, 256, 64
ATA_THREADS = 32 * 8 + 128


def spmm_ata_bytes() -> int:
    """``AtaSmem::total``: the 192 KiB ring, F's band partial, T's two Y
    bands, the x tile, col and row scales, R's two partial buffers, the
    piece descriptors, the slot and band metadata and the mbarriers."""
    band = 128 * 8                       # kBandRows x kMaxRN floats
    ring = 192 * 1024
    rbuf = 4 * 320
    size = (ring + F32 * band + F32 * 2 * band + F32 * SPMM_MAX_TILE * 8
            + F32 * SPMM_MAX_TILE + F32 * 5 * 128 + F32 * 2 * rbuf
            + 16 * 32 + 16 * 8 * 8 + 4 * 8 + 4 * 8 + 8 * 8 + 8)
    return size + 8 * (2 * 8 + 2 * 2 + 2)


# ------------------------------------------------------- flash_attention.cu
FLASH_THREADS, FLASH_WG_THREADS = 256, 3 * 128


def flash_f32_bytes(dh: int) -> int:
    """``smem_floats<kDh>()`` in bytes: Q and O tiles (64 x (Dh + 4)), a K/V
    tile, the 64 x 68 probabilities and the dead-row value sums."""
    return F32 * (2 * 64 * (dh + 4) + 64 * dh + 64 * 68 + dh)


def flash_wgmma_bytes(dh: int) -> int:
    """``Cfg<kDh>::kSmem``: Q (128 rows), the K and V stages, O's staging
    buffer where the kernel is persistent (Dh <= 128), the barriers, the
    value sums and 1 KiB of alignment slack for the 128-byte swizzle."""
    block_n = 64 if dh == 256 else 128
    stages = 4 if dh == 64 else 2
    boxes = dh // 64
    q_bytes = boxes * 128 * 128
    kv_bytes = boxes * block_n * 128
    off_v = q_bytes + stages * kv_bytes
    end_v = off_v + stages * kv_bytes
    off_bar = end_v + q_bytes if dh <= 128 else end_v
    bars = 2 + 4 * stages
    off_vsum = off_bar + -(-bars * 8 // 16) * 16
    return off_vsum + 2 * dh * 4 + 1024


# ---------------------------------------------------------------- registry

@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One kernel instance at one launch configuration."""

    label: str            # what the launch is, for the report
    kernel: str           # the instance, as :func:`kernel_key` names it
    library: str          # csrc/<library>.cu
    threads: int          # a block's
    min_blocks: int       # __launch_bounds__'s blocks an SM (1 when not given)
    static_bytes: int
    dynamic_bytes: int
    query: tuple          # (<lib>_smem_bytes, its arguments but the last)

    @property
    def smem_bytes(self) -> int:
        return self.static_bytes + self.dynamic_bytes


def _variants() -> list[KernelVariant]:
    out = []
    for update in (False, True):
        what = "update" if update else "assign"
        for dm in (1, 2, 3, 4, 5, 6, 7, 8, 16):
            out.append(KernelVariant(
                f"kmeans_{what} narrow tile, D = {dm}, K = 32 (its largest)",
                f"kmeans_narrow_kernel<{dm},{str(update).lower()}>", "kmeans",
                KM_THREADS, 1, 0, kmeans_narrow_bytes(dm, dm, KM_NARROW_MAX_K, update),
                ("kmeans_smem_bytes", dm, KM_NARROW_MAX_K, int(update))))
        out.append(KernelVariant(
            f"kmeans_{what} narrow tile at the atom, D = 5, K = 16",
            f"kmeans_narrow_kernel<5,{str(update).lower()}>", "kmeans", KM_THREADS, 1, 0,
            kmeans_narrow_bytes(5, 5, 16, update), ("kmeans_smem_bytes", 5, 16, int(update))))
        out.append(KernelVariant(
            f"kmeans_{what} wide tile, D = K = 128", f"kmeans_wide_kernel<{str(update).lower()}>",
            "kmeans", KM_THREADS, 2, 0, kmeans_wide_bytes(),
            ("kmeans_smem_bytes", 128, 128, int(update))))
    out.append(KernelVariant(
        "kmeans_update cross-tile sum", "kmeans_reduce_kernel", "kmeans", KM_THREADS, 1,
        F32 * KM_GROUPS * 32, 0, ()))
    for name, tile, k in (("narrow, K <= 16", COSINE_NARROW, 16),
                          ("wide, K > 16", COSINE_WIDE, 1024)):
        threads, smem = cosine_tile_bytes(*tile[:6])
        key = "cosine_topk_kernel<Tile<" + ",".join(map(str, tile)) + ">>"
        out.append(KernelVariant(f"cosine (k = 1 and top-k) {name}", key, "cosine",
                                 threads, tile[6], 0, smem, ("cosine_smem_bytes", k)))
    for rn in range(1, 9):
        out.append(KernelVariant(
            f"spmm, a stripe of {rn} columns", f"spmm_fwd_kernel<{rn}>", "spmm",
            SPMM_THREADS, 1, F32 * (rn * SPMM_MAX_TILE + SPMM_MAX_TILE), 0,
            ("spmm_smem_bytes", 0)))
        out.append(KernelVariant(
            f"spmm_t, a stripe of {rn} columns", f"spmm_t_kernel<{rn}>", "spmm",
            SPMM_THREADS, 1, F32 * (2 * rn * SPMM_MAX_TILE + SPMM_MAX_TILE), 0,
            ("spmm_smem_bytes", 1)))
        out.append(KernelVariant(
            f"spmm_ata, a stripe of {rn} columns", f"spmm_ata_kernel<{rn}>", "spmm",
            ATA_THREADS, 1, 0, spmm_ata_bytes(), ("spmm_smem_bytes", 2)))
    out.append(KernelVariant("spmm / spmm_t split sums", "sum_parts_kernel", "spmm",
                             SPMM_REDUCE_THREADS, 1, 0, 0, ("spmm_smem_bytes", 3)))
    out.append(KernelVariant("spmm_ata Gram sum", "gram_reduce_kernel", "spmm",
                             GRAM_THREADS, 1, 0, 0, ("spmm_smem_bytes", 4)))
    for dh in (64, 128, 256):
        for dtype in ("float", "__nv_bfloat16"):
            out.append(KernelVariant(
                f"flash float32 pipe, {dtype}, Dh <= {dh}", f"flash_fwd_kernel<{dtype},{dh}>",
                "flash_attention", FLASH_THREADS, 1, 0, flash_f32_bytes(dh),
                ("flash_smem_bytes", 0, dh)))
        out.append(KernelVariant(
            f"flash wgmma, bf16, Dh <= {dh}", f"flash_fwd_wgmma_kernel<{dh}>",
            "flash_attention", FLASH_WG_THREADS, 1, 0, flash_wgmma_bytes(dh),
            ("flash_smem_bytes", 1, dh)))
    return out


#: Every CUDA kernel instance of ``kernels/csrc`` at the launches priced.
VARIANTS: tuple[KernelVariant, ...] = tuple(_variants())


# ------------------------------------------------------------ ptxas report

class _Demangler:
    """Enough of the Itanium C++ ABI for the port's kernel names: a nested
    name in an anonymous namespace with integer, bool, type and nested
    class template arguments."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def _source(self) -> str:
        j = self.i
        while self.s[j].isdigit():
            j += 1
        n = int(self.s[self.i:j])
        self.i = j + n
        return self.s[j:j + n]

    def name(self) -> tuple[str, list[str]]:
        if self._peek() == "N":
            self.i += 1
            base, args = "", []
            while self._peek() != "E":
                c = self._peek()
                if c == "I":
                    args = self._template_args()
                elif c == "S":       # a substitution: an earlier prefix
                    self.i = self.s.index("_", self.i) + 1
                else:
                    base, args = self._source(), []
            self.i += 1
            return base, args
        base = self._source()
        return base, self._template_args() if self._peek() == "I" else []

    def _template_args(self) -> list[str]:
        self.i += 1
        args = []
        while self._peek() != "E":
            args.append(self._arg())
        self.i += 1
        return args

    def _arg(self) -> str:
        c = self._peek()
        if c == "L":
            kind = self.s[self.i + 1]
            j = self.s.index("E", self.i)
            value = self.s[self.i + 2:j].replace("n", "-")
            self.i = j + 1
            return {"1": "true", "0": "false"}[value] if kind == "b" else value
        if c == "f":
            self.i += 1
            return "float"
        if c.isdigit():
            return self._source()
        if c == "N":
            base, args = self.name()
            return f"{base}<{','.join(args)}>" if args else base
        raise ValueError(f"cannot read template argument at {self.s[self.i:]!r}")


def kernel_key(mangled: str) -> str:
    """``base<args>`` of a mangled kernel name (``base`` when not a template)."""
    if not mangled.startswith("_Z"):
        return mangled
    d = _Demangler(mangled[2:])
    base, args = d.name()
    return f"{base}<{','.join(args)}>" if args else base


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(report: str) -> dict[str, dict]:
    """``{kernel_key: {registers, static_bytes, spill_stores, spill_loads,
    stack_bytes}}`` for every entry function of a ``-Xptxas -v`` report."""
    out: dict[str, dict] = {}
    entry = props = None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = props = m.group(1)
            out[kernel_key(entry)] = {"registers": 0, "static_bytes": 0, "spill_stores": 0,
                                      "spill_loads": 0, "stack_bytes": 0}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        if entry is None:
            continue
        rec = out[kernel_key(entry)]
        m = _STACK.search(line)
        if m and props == entry:
            rec["stack_bytes"], rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = _USED.search(line)
        if m:
            rec["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            rec["static_bytes"] = int(s.group(1)) if s else 0
    return out


def measure() -> dict:
    """What the card's toolchain reports: ``{"kernels": {kernel_key: ptxas
    record}, "dynamic": {variant label: the launcher's dynamic bytes},
    "threads": {variant label: the launcher's threads}, "triton": [compiled
    scale_apply metadata]}``. Builds and loads the libraries (on a machine
    with ``nvcc`` and a card)."""
    import ctypes

    from ..kernels import _build

    kernels: dict[str, dict] = {}
    for lib in _build.LIBRARIES:
        kernels.update(parse_ptxas(_build.build(lib)[1]))
    dynamic, threads = {}, {}
    for v in VARIANTS:
        if not v.query:
            continue
        n = ctypes.c_int(0)
        dynamic[v.label] = getattr(_build.load(v.library), v.query[0])(*v.query[1:],
                                                                       ctypes.byref(n))
        threads[v.label] = n.value
    triton = []
    for binary in _build.triton_binaries():
        meta = getattr(binary, "metadata", None)
        triton.append({"name": getattr(meta, "name", "scale_apply_kernel"),
                       "shared": getattr(meta, "shared", None),
                       "num_warps": getattr(meta, "num_warps", None),
                       "registers": getattr(binary, "n_regs", None),
                       "spills": getattr(binary, "n_spills", None)})
    return {"kernels": kernels, "dynamic": dynamic, "threads": threads, "triton": triton}


# ------------------------------------------------------------------- audit

def _budget(v: KernelVariant, finding: Callable[[str, str], None]) -> None:
    if v.static_bytes > STATIC_SMEM_MAX:
        finding(f"static shared memory {v.static_bytes} B exceeds {STATIC_SMEM_MAX} B",
                "more than 48 KB must be dynamic and opted in")
    if v.smem_bytes > SMEM_PER_BLOCK:
        finding(f"shared memory {v.smem_bytes} B a block exceeds {SMEM_PER_BLOCK} B",
                f"static {v.static_bytes} + dynamic {v.dynamic_bytes}")
    if (v.smem_bytes + RESERVED_PER_BLOCK) * v.min_blocks > SMEM_PER_SM:
        finding(f"{v.min_blocks} blocks an SM need {(v.smem_bytes + RESERVED_PER_BLOCK) * v.min_blocks}"
                f" B of shared memory, the SM has {SMEM_PER_SM} B",
                "__launch_bounds__ promises more blocks than fit")


def audit_smem(measured: dict | None = None,
               variants: tuple[KernelVariant, ...] = VARIANTS) -> tuple[list[Finding], list[dict]]:
    """A4 over ``variants``: ``(findings, rows)``, a row for each variant
    with its estimate and, given ``measured`` (:func:`measure`), what the
    card reports. Spills within :data:`ALLOWED_SPILLS` are not findings."""
    findings: list[Finding] = []
    rows = []
    for v in variants:
        def finding(message: str, evidence: str = "", v=v) -> None:
            findings.append(Finding(rule="A4", path=f"kernel:{v.kernel}", line=0,
                                    message=f"{v.label}: {message}", evidence=evidence))

        _budget(v, finding)
        row = {"label": v.label, "kernel": v.kernel, "threads": v.threads,
               "min_blocks": v.min_blocks, "static_bytes": v.static_bytes,
               "dynamic_bytes": v.dynamic_bytes}
        rows.append(row)
        if measured is None:
            continue
        rec = measured["kernels"].get(v.kernel)
        if rec is None:
            finding("the ptxas report names no such kernel", "the registry prices "
                    "an instance the build does not make")
            continue
        dyn = measured["dynamic"].get(v.label, 0)
        threads = measured["threads"].get(v.label, v.threads)
        regs = rec["registers"]
        row.update(measured_static_bytes=rec["static_bytes"], measured_dynamic_bytes=dyn,
                   measured_threads=threads, registers=regs,
                   spill_bytes=rec["spill_stores"] + rec["spill_loads"])
        if (rec["static_bytes"], dyn, threads) != (v.static_bytes, v.dynamic_bytes, v.threads):
            finding("estimate differs from what the card reports",
                    f"estimate static {v.static_bytes} + dynamic {v.dynamic_bytes} B, "
                    f"{v.threads} threads; reported static {rec['static_bytes']} + dynamic "
                    f"{dyn} B, {threads} threads")
        if regs > REGS_PER_THREAD:
            finding(f"{regs} registers a thread exceed {REGS_PER_THREAD}")
        if regs * threads * v.min_blocks > REGS_PER_BLOCK:
            finding(f"{regs} registers x {threads} threads x {v.min_blocks} blocks exceed "
                    f"{REGS_PER_BLOCK} registers an SM")
        spills = (rec["spill_stores"], rec["spill_loads"])
        allowed = ALLOWED_SPILLS.get(v.kernel, (0, 0))
        if spills[0] > allowed[0] or spills[1] > allowed[1]:
            finding(f"spills {spills[0]} B stored and {spills[1]} B loaded",
                    f"allowed {allowed[0]} / {allowed[1]} B (ALLOWED_SPILLS)")
    if measured is not None:
        priced = {v.kernel for v in variants}
        for name in sorted(set(measured["kernels"]) - priced):
            findings.append(Finding(rule="A4", path=f"kernel:{name}", line=0,
                                    message="kernel instance has no price in the registry",
                                    evidence="add it to analysis.smem.VARIANTS"))
        for meta in measured["triton"]:
            row = {"label": "scale_apply (Triton, compiled metadata)", "kernel": meta["name"],
                   "threads": 32 * (meta["num_warps"] or 0), "min_blocks": 1,
                   "static_bytes": meta["shared"], "dynamic_bytes": 0,
                   "measured_static_bytes": meta["shared"], "measured_dynamic_bytes": 0,
                   "registers": meta["registers"], "spill_bytes": meta["spills"]}
            rows.append(row)
            tv = KernelVariant(row["label"], row["kernel"], "triton", row["threads"], 1,
                               0, meta["shared"] or 0, ())
            _budget(tv, lambda m, e="": findings.append(Finding(
                rule="A4", path=f"kernel:{tv.kernel}", line=0, message=f"{tv.label}: {m}",
                evidence=e)))
            if (meta["registers"] or 0) * row["threads"] > REGS_PER_BLOCK or meta["spills"]:
                findings.append(Finding(
                    rule="A4", path=f"kernel:{tv.kernel}", line=0,
                    message=f"{tv.label}: {meta['registers']} registers x {row['threads']} "
                            f"threads, {meta['spills']} spills", evidence="compiled metadata"))
    return findings, rows
