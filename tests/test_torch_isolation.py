"""The port stands alone: no JAX, no reference package, the card by default."""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, interop, streaming
from repro_torch.analysis import dispatch_audit
from repro_torch.configs import reduced
from repro_torch.core import baselines, distributed, kmeans, lamc, spectral
from repro_torch.core.nmtf import nmtf
from repro_torch.data import to_bcoo
from repro_torch.launch import mesh, profile_serve, serve, serve_lamc
from repro_torch.models import build_model
from repro_torch.runtime import fault_tolerance

ROOT = Path(__file__).resolve().parents[1]
# The files of the later slices (and, to make room for later test items,
# two of the kernels' files, the LM configs, the LM path's models and
# launchers, obs and checkpoint) are checked inside one item, not as cases
# of their own: each case moves pytest-xdist's schedule (ROADMAP.md queue 3,
# "The count rule").
GROUPED_FILES = [ROOT / "src" / "repro_torch" / name for name in
                 ("runtime/__init__.py", "runtime/fault_tolerance.py", "streaming/fit.py",
                  "runtime/shardings.py", "launch/mesh.py", "core/distributed.py",
                  "analysis/__init__.py", "analysis/__main__.py", "analysis/findings.py",
                  "analysis/ast_lint.py", "analysis/smem.py", "analysis/dispatch_audit.py",
                  "analysis/entry_points.py", "analysis/cli.py", "obs/__main__.py",
                  "kernels/_build.py", "obs/trace.py", "models/rglru.py",
                  "configs/recurrentgemma_2b.py", "configs/__init__.py", "configs/base.py",
                  "configs/chatglm3_6b.py", "configs/minicpm_2b.py", "configs/qwen3_4b.py",
                  "configs/smollm_360m.py", "models/__init__.py", "models/moe.py",
                  "configs/deepseek_moe_16b.py", "configs/llama4_scout_17b_a16e.py",
                  "models/attention.py", "models/layers.py", "models/model.py",
                  "models/transformer.py", "launch/__init__.py", "launch/profile_serve.py",
                  "launch/serve.py", "obs/__init__.py", "obs/export.py", "obs/metrics.py",
                  "checkpoint/__init__.py", "checkpoint/checkpoint.py")]
# Spawned ranks import this helper, so it must stand alone too.
RANK_HELPERS = [ROOT / "tests" / "torch_dist.py"]
PORT_FILES = sorted(set((ROOT / "src" / "repro_torch").rglob("*.py")) - set(GROUPED_FILES)) + [
    ROOT / "chip_smoke.py"]
EXAMPLES = ("torch_quickstart", "torch_text_coclustering")
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
    names = {p.name for p in PORT_FILES + GROUPED_FILES}
    assert {"lamc.py", "ops.py", "interop.py", "chip_smoke.py", "checkpoint.py",
            "model.py", "assign.py", "registry.py", "serve.py", "serve_lamc.py",
            "metrics.py", "trace.py", "export.py", "transformer.py", "attention.py",
            "flash_attention.py", "layers.py", "base.py", "qwen3_4b.py", "nmtf.py",
            "baselines.py", "fit.py", "fault_tolerance.py", "distributed.py",
            "shardings.py", "mesh.py", "findings.py", "ast_lint.py", "smem.py",
            "dispatch_audit.py", "entry_points.py", "cli.py", "__main__.py",
            "_build.py", "rglru.py", "recurrentgemma_2b.py", "moe.py",
            "deepseek_moe_16b.py", "llama4_scout_17b_a16e.py"} <= names


def _example_main(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


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
    lambda a: build_model(reduced("qwen3-4b")),
    lambda a: serve.generate(arch="qwen3-4b", batch=1, prompt_len=4, gen_len=2),
    lambda a: interop.lm_params_from_numpy(reduced("qwen3-4b"), {}),
    lambda a: profile_serve.profile_serve(prompt_len=4),
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


def test_examples_and_slice9_entry_points_stand_alone(monkeypatch, tmp_path):
    """The two example scripts, the out-of-core fit's, the distributed
    fit's and the analyzer's modules (and the other grouped files) and the
    spawned ranks' helper import neither JAX nor the reference, and the NMTF
    atom, the baselines, both examples' ``main``, the out-of-core fit, the
    launcher's demo fit, the meshes, the distributed driver, the elastic
    restore, the analyzer's audit, the hybrid LM and the MoE LM ask for the
    card by default (one item: the collected count is kept, ROADMAP.md
    queue 3)."""
    assert all(path.is_file() for path in GROUPED_FILES + RANK_HELPERS)
    for path in ([ROOT / "examples" / f"{name}.py" for name in EXAMPLES] + GROUPED_FILES
                 + RANK_HELPERS):
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{path.name} imports {bad}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.random.default_rng(0).normal(size=(40, 30)).astype(np.float32)
    for call in (lambda: nmtf(a, 2),
                 lambda: lamc.lamc_cocluster(a, lamc.LAMCConfig(2, 2, atom="nmtf")),
                 lambda: baselines.scc_full(a, 2),
                 lambda: baselines.nmtf_full(a, 2),
                 lambda: _example_main("torch_quickstart")([]),
                 lambda: _example_main("torch_text_coclustering")(["--n-docs", "40"]),
                 lambda: streaming.fit([a], streaming.StreamConfig(2, 2)),
                 lambda: streaming.StreamingCocluster(streaming.StreamConfig(2, 2)),
                 lambda: streaming.iter_row_chunks(a, 10),
                 lambda: serve_lamc.fit_demo_model(str(tmp_path)),
                 lambda: mesh.make_test_mesh(1, 1),
                 lambda: mesh.make_production_mesh(),
                 lambda: distributed.distributed_lamc(
                     {"data": 1, "model": 1}, a, lamc.LAMCConfig(2, 2),
                     lamc.partition.PartitionPlan(40, 30, 2, 1, 20, 30, 1)),
                 lambda: fault_tolerance.elastic_restore(str(tmp_path), 0, {}, None, {}),
                 lambda: dispatch_audit.audit_entry_points(["cosine_assign"]),
                 lambda: build_model(reduced("recurrentgemma-2b")),
                 lambda: serve.generate(arch="recurrentgemma-2b", batch=1, prompt_len=4,
                                        gen_len=2),
                 lambda: build_model(reduced("deepseek-moe-16b"), param_dtype=torch.bfloat16),
                 lambda: serve.generate(arch="deepseek-moe-16b", batch=1, prompt_len=4,
                                        gen_len=2, param_dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
