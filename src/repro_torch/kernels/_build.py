"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout (a
directory git ignores), at first use. The hash covers the source and the
flags, so an edited kernel is rebuilt and a stale library is never loaded.
The ``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
the library as ``.ptxas.txt``; ``analysis.smem`` reads it.

``rebuilds`` counts what a warm call must not do again: ``nvcc`` builds and
library loads here, Triton compiles in ``bipartite_normalize``; each
library also counts its own ``cudaFuncSetAttribute`` calls
(``<name>_attribute_sets``). ``analysis.dispatch_audit`` reads them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "LIBRARIES", "nvcc_path", "build", "load",
           "loaded", "rebuilds", "note_triton_launch", "triton_binaries"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)

#: nvcc builds, library loads and Triton compiles since the process started.
rebuilds = {"nvcc": 0, "load": 0, "triton": 0}
_loaded: dict[str, ctypes.CDLL] = {}
_triton_binaries: dict[int, object] = {}

# C signatures of each library's entry points: name -> (restype, argtypes).
_SIGNATURES = {
    "kmeans": {
        "kmeans_tile": (_I, [_I, _I]),
        "kmeans_smem_bytes": (_I, [_I, _I, _I, _IP]),
        "kmeans_attribute_sets": (_I, []),
        "kmeans_error_string": (ctypes.c_char_p, [_I]),
        "kmeans_assign_f32": (_I, [_P, _P, _I, _I, _I, _I, _P, _P, _P]),
        "kmeans_update_f32": (_I, [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _P]),
    },
    "cosine": {
        "cosine_error_string": (ctypes.c_char_p, [_I]),
        "cosine_max_k": (_I, []),
        "cosine_smem_bytes": (_I, [_I, _IP]),
        "cosine_attribute_sets": (_I, []),
        "cosine_topk_f32": (_I, [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    },
    "flash_attention": {
        "flash_error_string": (ctypes.c_char_p, [_I]),
        "flash_max_head_dim": (_I, []),
        "flash_smem_bytes": (_I, [_I, _I, _IP]),
        "flash_attribute_sets": (_I, []),
        "flash_route": (_I, [_I, _I, _P, _P, _P, _P]),
        "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, ctypes.c_float, _P]),
    },
    "spmm": {
        "spmm_error_string": (ctypes.c_char_p, [_I]),
        "spmm_smem_bytes": (_I, [_I, _IP]),
        "spmm_attribute_sets": (_I, []),
        "spmm_f32": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I,
                          _I, _P, _P]),
        "spmm_t_f32": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P,
                            _I, _I, _P, _P]),
        "spmm_ata_grid": (_I, [_I]),
        "spmm_ata_f32": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P,
                              _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P]),
    },
}

#: The libraries, one for each ``csrc/<name>.cu``.
LIBRARIES = tuple(_SIGNATURES)


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library path and the ptxas report."""
    lib = _library_path(name)
    log = lib.with_suffix(".ptxas.txt")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build under a temporary name and rename, so concurrent builders
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            rebuilds["nvcc"] += 1
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
            log.write_text(proc.stderr)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib, log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its C signatures declared."""
    rebuilds["load"] += 1
    lib = ctypes.CDLL(str(build(name)[0]))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _loaded[name] = lib
    return lib



def loaded() -> dict[str, ctypes.CDLL]:
    """The libraries this process has loaded, by name (loading none)."""
    return dict(_loaded)


def note_triton_launch(binary) -> None:
    """Record the compiled kernel a Triton launch returned: a binary not seen
    before is a specialization Triton compiled (or loaded) for this launch."""
    if id(binary) not in _triton_binaries:
        _triton_binaries[id(binary)] = binary
        rebuilds["triton"] += 1


def triton_binaries() -> list:
    """The compiled Triton kernels launched so far (their ``metadata`` gives
    shared memory; ``n_regs`` and ``n_spills`` registers and spills)."""
    return list(_triton_binaries.values())
