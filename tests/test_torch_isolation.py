"""The port stands alone: no JAX, no reference package, the card by default."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, interop, streaming
from repro_torch.core import kmeans, lamc, spectral
from repro_torch.data import to_bcoo
from repro_torch.launch import serve_lamc

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_port_file_list_is_complete():
    names = {p.name for p in PORT_FILES}
    assert {"lamc.py", "ops.py", "interop.py", "chip_smoke.py", "checkpoint.py",
            "model.py", "assign.py", "registry.py", "serve.py", "serve_lamc.py",
            "metrics.py", "trace.py", "export.py"} <= names


def _model(a):
    """A tiny well-formed model on the CPU (for the entry points that take one)."""
    n, q = a.shape[1], 4
    return streaming.CoclusterModel(
        torch.zeros(a.shape[0], dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        torch.ones(a.shape[0], 2), torch.ones(n, 2), torch.eye(2, q), torch.eye(2, q),
        torch.zeros(q), torch.zeros(q), torch.arange(q, dtype=torch.int32),
        torch.arange(q, dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda a: lamc.lamc_cocluster(a, lamc.LAMCConfig(2, 2)),
    lambda a: spectral.scc(a[None], 2),
    lambda a: kmeans.kmeans(a[None], 2),
    lambda a: spectral.normalize_bipartite(a[None]),
    lambda a: to_bcoo(a),
    lambda a: lamc.lamc_cocluster(to_bcoo(a, "cpu"),
                                  lamc.LAMCConfig(2, 2, input_format="bcoo")),
    lambda a: spectral.scc(to_bcoo(a, "cpu"), 2),
    lambda a: streaming.load_model("no-such-dir"),
    lambda a: streaming.AssignService(_model(a)),
    lambda a: serve_lamc.serve("no-such-dir"),
    lambda a: serve_lamc.serve_service("no-such-dir"),
    lambda a: checkpoint.restore("no-such-dir", 0, {}),
    lambda a: interop.model_from_numpy(_model(a)._asdict()),
])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """Without ``device=`` an entry point asks for CUDA; on a machine without
    it, it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.random.default_rng(0).normal(size=(40, 30)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(a)


def test_registry_load_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming.ModelRegistry(str(tmp_path)).load("m")
