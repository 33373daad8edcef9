"""The port's analyzer (``repro_torch.analysis``) against the reference's.

Two items (the collected count is kept, ROADMAP.md queue 3, "The count
rule"): the lint layer (R1-R4, pragmas, the JSON report, the CLI, the hot
roots, ``obs``'s trace CLI) and the audit layer on the CPU (the entry
points' arguments and outputs against the reference's, A2, A3, A4 and the
strict run over the port's tree). The reference's ``audit_entry_points``
is not called: it fails under JAX 0.9 on ``jax.core.Literal``.
"""

import ast
import dataclasses
import json
import os
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import ast_lint as ref_lint
from repro.analysis import cli as ref_cli
from repro.analysis import entry_points as ref_entries
from repro.analysis import findings as ref_findings
from repro_torch import obs
from repro_torch.analysis import ast_lint, cli, dispatch_audit, entry_points, findings, smem
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
REF_PATH, PORT_PATH = "src/repro/_fixture.py", "src/repro_torch/_fixture.py"


def _src(text: str) -> str:
    return textwrap.dedent(text)


def _rule_lines(fs) -> list[tuple[str, int]]:
    return sorted((f.rule, f.line) for f in fs)


# The reference's R3 and R4 fixtures (tests/test_analysis.py, TestR3 and
# TestR4), linted by both analyzers as they are.
R3_R4_SOURCES = {
    "mutable_default": """
        def f(x, acc=[]):
            acc.append(x)
            return acc
    """,
    "global_mutation_in_jit": """
        import jax

        _COUNT = 0

        @jax.jit
        def f(x):
            global _COUNT
            _COUNT += 1
            return x
    """,
    "none_default": """
        def f(x, acc=None):
            acc = [] if acc is None else acc
            acc.append(x)
            return acc
    """,
    "legacy_sampler": """
        import numpy as np

        def f():
            return np.random.rand(3)
    """,
    "unseeded_default_rng": """
        import numpy as np

        def f():
            return np.random.default_rng().normal(size=3)
    """,
    "seeded_default_rng": """
        import numpy as np

        def f(seed, step):
            return np.random.default_rng([seed, step]).normal(size=3)
    """,
    "clock_into_seed": """
        import time

        import jax

        def f():
            seed = int(time.time())
            return jax.random.key(seed)
    """,
}

# TestR1/TestR2's fixtures (reference source, PyTorch translation), line for
# line: each translation must fire where the reference's fires.
R1_R2_PAIRS = {
    "double_sample": ("""
        import jax

        def f(seed):
            k = jax.random.key(seed)
            a = jax.random.normal(k, (4,))
            b = jax.random.normal(k, (4,))
            return a + b
    """, """
        import torch

        def f(seed):
            g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
            a = torch.randn(4, generator=g1)
            b = torch.randn(4, generator=g2)
            return a + b
    """),
    "sample_after_split": ("""
        import jax

        def f(seed):
            k = jax.random.key(seed)
            k1, k2 = jax.random.split(k)
            return jax.random.normal(k, (4,))
    """, """
        import torch

        def f(seed):
            g = torch.Generator().manual_seed(seed)
            x = torch.randn(4, generator=torch.Generator().manual_seed(seed))
            return torch.randn(4, generator=g) + x
    """),
    "fold_in_after_sample": ("""
        import jax

        def f(seed):
            k = jax.random.key(seed)
            a = jax.random.normal(k, (4,))
            k2 = jax.random.fold_in(k, 1)
            return a + jax.random.normal(k2, (4,))
    """, """
        import torch
        from repro_torch.device import seeded_generator

        def f(seed):
            g = seeded_generator("cpu", seed)
            a = torch.randn(4, generator=g)
            g2 = seeded_generator("cpu", seed, 1)
            return a + torch.randn(4, generator=g2)
    """),
    "split_fanout": ("""
        import jax

        def g(k):
            return jax.random.normal(k, (4,))

        def f(seed):
            keys = jax.random.split(jax.random.key(seed), 4)
            return g(keys[0]) + g(keys[1])
    """, """
        import torch

        def g(gen):
            return torch.randn(4, generator=gen)

        def f(seed):
            gens = [torch.Generator().manual_seed(seed + i) for i in range(4)]
            return g(gens[0]) + g(gens[1])
    """),
    "whole_key_escapes_twice": ("""
        import jax

        def g(k):
            return jax.random.normal(k, (4,))

        def f(seed):
            k = jax.random.key(seed)
            return g(k) + g(k)
    """, """
        import torch

        def g(gen):
            return torch.randn(4, generator=gen)

        def f(seed):
            a, b = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
            return g(a) + g(b)
    """),
    "loop_reconsume": ("""
        import jax

        def f(k, xs):
            out = 0.0
            for x in xs:
                out = out + x * jax.random.normal(k, ())
            return out
    """, """
        import torch

        def f(seed, xs):
            out = 0.0
            for x in xs:
                out = out + x * torch.randn((), generator=torch.Generator().manual_seed(seed))
            return out
    """),
    "loop_rebind": ("""
        import jax

        def f(seed, n):
            out = 0.0
            for k in jax.random.split(jax.random.key(seed), n):
                out = out + jax.random.normal(k, ())
            return out
    """, """
        import torch

        def f(seed, n):
            out = 0.0
            for i in range(n):
                out = out + torch.randn((), generator=torch.Generator().manual_seed(seed + i))
            return out
    """),
    "float_on_traced_value": ("""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x):
            return float(jnp.sum(x))
    """, """
        import torch
        import torch.nn.functional as F

        @torch.compile
        def f(x):
            return float(torch.sum(x))
    """),
    "item_in_reachable_callee": ("""
        import jax
        import jax.numpy as jnp

        def helper(x):
            return x.item()

        @jax.jit
        def f(x):
            return helper(jnp.sum(x))
    """, """
        import torch
        import torch.nn.functional as F

        def helper(x):
            return x.item()

        @torch.compile
        def f(x):
            return helper(torch.sum(x))
    """),
    "host_sync_outside_jit": ("""
        import jax.numpy as jnp

        def report(x):
            return float(jnp.sum(x))
    """, """
        import torch

        def report(x):
            return float(torch.sum(x))
    """),
    "array_only_jit_body": ("""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x):
            return jnp.sum(x) * 2.0
    """, """
        import torch
        import torch.nn.functional as F

        @torch.compile
        def f(x):
            return torch.sum(x) * 2.0
    """),
}

# PyTorch-only hazards the port's rules add, with the lines they fire on.
PORT_ONLY = {
    """
    import torch

    def f(n):
        a = torch.randn(n)
        torch.manual_seed(0)
        return a + torch.rand(n, generator=torch.Generator().manual_seed(1))
    """: [("R1", 5), ("R4", 6)],
    """
    import torch

    def f(x):
        x.uniform_()
        return x
    """: [("R1", 5)],
    """
    import torch
    from repro_torch.device import seeded_generator

    def f(seed, n):
        out = []
        for t in range(n):
            g = seeded_generator("cpu", seed, 3)
            out.append(torch.randperm(8, generator=g))
        return out
    """: [("R1", 9)],
    """
    import torch

    @torch.compile
    def f(x: torch.Tensor):
        if x.sum() > 0:
            torch.cuda.synchronize()
        return x.cpu()
    """: [("R2", 6), ("R2", 7), ("R2", 8)],
}

PRAGMA_SOURCES = [
    """
    import numpy as np

    def f():
        return np.random.rand(3)  # repro: allow[R4] fixture noise only
    """,
    """
    import numpy as np

    def f():
        # repro: allow[R4] exercised below
        return np.random.rand(3)
    """,
    """
    import numpy as np

    def f():
        return np.random.rand(3)  # repro: allow[R1] fixture noise only
    """,
    """
    import numpy as np

    def f():
        return np.random.rand(3)  # repro: allow[*] fixture noise only
    """,
]


def _cli(main, argv, capsys):
    code = main(argv)
    return code, capsys.readouterr().out


def _trace_file(path):
    obs.configure(enabled=True)
    try:
        obs.reset_trace()
        with obs.span("fit", rows=8) as sp:
            with obs.span("atoms", resample=0):
                obs.event("kernel_dispatch", op="kmeans_update", tier="ref")
            sp.set(chunks=2)
        return obs.write_trace_jsonl(str(path))
    finally:
        obs.configure(enabled=False)
        obs.reset_trace()


def test_lint_layer_matches_the_reference(tmp_path, capsys):
    """R1-R4, pragmas, the JSON report and the CLI agree with the reference's
    on its own fixtures (R1/R2 translated line for line); the hot-root
    table matches the reference's jit roots; the port's tree lints clean;
    ``python -m repro_torch.obs`` validates and renders as the reference's."""
    # R3 and R4 on the reference's fixtures: the same (rule, line) findings
    for name, text in R3_R4_SOURCES.items():
        src = _src(text)
        ref = ref_lint.lint_source(REF_PATH, src)
        mine = ast_lint.lint_source(PORT_PATH, src)
        assert _rule_lines(mine) == _rule_lines(ref), name
    legacy = _src(R3_R4_SOURCES["legacy_sampler"])
    assert ast_lint.lint_source("tests/helpers.py", legacy) == []
    assert ref_lint.lint_source("tests/helpers.py", legacy) == []

    # R1 and R2: each translation fires exactly where the reference's fires
    for name, (ref_text, port_text) in R1_R2_PAIRS.items():
        ref = _rule_lines(ref_lint.lint_source(REF_PATH, _src(ref_text)))
        mine = _rule_lines(ast_lint.lint_source(PORT_PATH, _src(port_text)))
        assert mine == ref, (name, mine, ref)
    for text, want in PORT_ONLY.items():
        assert _rule_lines(ast_lint.lint_source(PORT_PATH, _src(text))) == want, text

    # pragmas, suppression and the JSON report
    for text in PRAGMA_SOURCES:
        src = _src(text)
        assert findings.parse_pragmas(src) == ref_findings.parse_pragmas(src)
        ref_raw = ref_lint.lint_source(REF_PATH, src)
        mine_raw = ast_lint.lint_source(PORT_PATH, src)
        ref_split = ref_findings.filter_suppressed(
            ref_raw, {REF_PATH: ref_findings.parse_pragmas(src)})
        mine_split = findings.filter_suppressed(
            mine_raw, {PORT_PATH: findings.parse_pragmas(src)})
        ref_doc = json.loads(ref_findings.render_json(*ref_split))
        mine_doc = json.loads(findings.render_json(*mine_split))
        assert set(mine_doc) == set(ref_doc) == {"findings", "suppressed", "rules"}
        for key in ("findings", "suppressed"):
            assert ([(f["rule"], f["line"]) for f in mine_doc[key]]
                    == [(f["rule"], f["line"]) for f in ref_doc[key]])
            assert all(set(f) == {"rule", "path", "line", "message", "evidence"}
                       for f in mine_doc[key])
        assert set(mine_doc["rules"]) == set(ref_doc["rules"]) - {"A1"}

    # the CLI on the reference's TestCli fixture
    bad = tmp_path / "bad.py"
    bad.write_text(_src(R3_R4_SOURCES["mutable_default"]))
    ok = tmp_path / "ok.py"
    ok.write_text("def f(x):\n    return x + 1\n")
    for main in (ref_cli.main, cli.main):
        code, out = _cli(main, [str(bad), "--ast-only"], capsys)
        assert code == 0 and "[R3]" in out and "1 finding" in out
        assert _cli(main, [str(bad), "--ast-only", "--strict"], capsys)[0] == 1
        code, out = _cli(main, [str(bad), "--ast-only", "--json"], capsys)
        doc = json.loads(out)
        assert [f["rule"] for f in doc["findings"]] == ["R3"] and doc["suppressed"] == []
        assert _cli(main, [str(ok), "--ast-only", "--strict"], capsys)[0] == 0
    assert set(findings.RULES) == set(ref_findings.RULES) - {"A1"}

    # the hot roots, module by module, against the reference's jit roots
    ref_roots = {}
    for path in ref_lint.iter_python_files([str(ROOT / "src" / "repro")]):
        tree = ast.parse(Path(path).read_text())
        functions = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions.setdefault(node.name, node)
        roots = ref_lint._jit_roots(tree, ref_lint._Aliases(tree), functions)
        if roots:
            ref_roots[os.path.relpath(path, ROOT / "src" / "repro")] = roots
    assert set(ast_lint.HOT_ROOTS) == set(ref_roots)
    for module, table in ast_lint.HOT_ROOTS.items():
        assert set(table) == ref_roots[module], module
        port_path = ROOT / "src" / "repro_torch" / module
        names = {n.name for n in ast.walk(ast.parse(port_path.read_text()))
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for ported in table.values():
            assert set(ported) <= names, (module, ported)

    # the port's own tree: clean under --strict, with its pragmas read by
    # both analyzers (the reference's lint finds nothing in the port either)
    assert _cli(cli.main, ["--ast-only", "--strict"], capsys)[0] == 0
    ref_active, _ = ref_lint.run_ast_lint([str(ROOT / "src" / "repro_torch")])
    assert ref_active == []

    # python -m repro_torch.obs against python -m repro.obs on one trace file
    from repro.obs.__main__ import main as ref_obs_main
    from repro_torch.obs.__main__ import main as obs_main

    good = _trace_file(tmp_path / "trace.jsonl")
    broken = tmp_path / "broken.jsonl"
    broken.write_text(Path(good).read_text().replace('"span"', '"spam"', 1))
    for argv in ([good], [good, "--validate"], [str(broken)], [str(broken), "--validate"]):
        mine = _cli(obs_main, argv, capsys)
        theirs = _cli(ref_obs_main, argv, capsys)
        assert mine == theirs, argv
    assert _cli(obs_main, [good], capsys)[0] == 0
    assert _cli(obs_main, [str(broken)], capsys)[0] == 1


def _arrays(x):
    """Every array of an entry's arguments or outputs, as numpy."""
    if isinstance(x, torch.Tensor):
        return [(x.to_dense() if x.is_sparse else x).numpy()]
    if hasattr(x, "todense") and hasattr(x, "indices"):          # a BCOO
        return [np.asarray(x.todense())]
    if hasattr(x, "blocks") and hasattr(x, "block_rows"):        # tiled operand
        return [a for f in ("blocks", "block_rows", "block_cols", "t_order",
                            "row_scale", "col_scale")
                for a in _arrays(getattr(x, f)) if getattr(x, f) is not None]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _arrays(v)]
    if x is None:
        return []
    return [np.asarray(x)]


def _match(mine, ref, what):
    mine, ref = _arrays(mine), _arrays(ref)
    assert len(mine) == len(ref), what
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
        if np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), what
        else:
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= 1e-5 * scale, what


def test_audit_layer_matches_the_reference_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The sixteen entry points; each kernel entry's arguments equal the
    reference's bit for bit and its CPU outputs the reference entry's; A2,
    A3 and A4 fire on translated fixtures and are clean on the port's
    entries; ``--device cpu --strict`` exits 0 on the port's tree and the
    default device asks for the card."""
    jax.clear_caches()
    assert list(entry_points.ENTRY_POINTS) == list(ref_entries.ENTRY_POINTS)
    for name in sorted(entry_points.KERNEL_ENTRIES):
        ref_fn, ref_args = ref_entries.ENTRY_POINTS[name]()
        fn, args = entry_points.ENTRY_POINTS[name]("cpu")
        ref_arrays, arrays = _arrays(ref_args), _arrays(args)
        assert len(arrays) == len(ref_arrays), name
        for a, b in zip(arrays, ref_arrays):      # the same bits
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        _match(fn(*args), jax.device_get(ref_fn(*ref_args)), name)

    # kernel_dispatch, held to the reference's TestKernelDispatch on the same
    # inputs: two CPU spmm calls count tier ref twice in both registries; a
    # reset empties the cached counter child, which counts again from zero
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    from repro import obs as ref_obs
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm import bcoo_to_block_sparse
    dense = np.zeros((16, 16), np.float32)
    dense[0, 0] = 1.0

    def dispatch_series(reg):
        return reg.counter("kernel_dispatch").snapshot()["series"]

    ref_obs.reset_metrics()
    for _ in range(2):
        ref_ops.spmm(jsparse.BCOO.fromdense(jnp.asarray(dense)), jnp.ones((16, 4)))
    ref_series = dispatch_series(ref_obs.get_registry())
    for calls in (2, 2, 1):
        obs.reset_metrics()
        for _ in range(calls):
            ops.spmm(torch.from_numpy(dense).to_sparse_coo(), torch.ones(16, 4))
        assert dispatch_series(obs.get_registry()) == {"op=spmm,tier=ref": float(calls)}
    assert ref_series["op=spmm,tier=ref"] == 2.0
    # spmm_ata inside a span with obs on attaches its event, as the
    # reference's does; bipartite_normalize's tier on the CPU is ref
    rng = np.random.default_rng(11)
    sparse = np.where(rng.random((256, 256)) < 0.1,
                      rng.standard_normal((256, 256)), 0.0).astype(np.float32)
    tiled = bcoo_to_block_sparse(torch.from_numpy(sparse).to_sparse_coo(), bm=128, bk=128)
    obs.configure(enabled=True)
    try:
        tr = obs.reset_trace()
        obs.reset_metrics()
        with obs.span("host"):
            ops.spmm_ata(tiled, torch.ones(256, 8))
            ops.bipartite_normalize(torch.ones(2, 4, 4))
        evs = [e for e in tr.roots[0].events if e["name"] == "kernel_dispatch"]
        assert [e["attrs"]["op"] for e in evs] == ["spmm_ata", "bipartite_normalize"]
        assert [e["attrs"]["tier"] for e in evs] == ["ref", "ref"]
        assert dispatch_series(obs.get_registry()) == {
            "op=spmm_ata,tier=ref": 1.0, "op=bipartite_normalize,tier=ref": 1.0}
    finally:
        obs.configure(enabled=False)
        obs.reset_trace()
        obs.reset_metrics()

    # A2 on the reference's fixture pair, translated: a numpy float64
    # constant promotes; a float32 one does not
    v = torch.ones(4)
    for fn, fires in ((lambda x: x * torch.from_numpy(np.array([2.0])), True),
                      (lambda x: x * torch.tensor(2.0), False)):
        rec = dispatch_audit.OpRecorder()
        with rec:
            fn(v)
        found = dispatch_audit.audit_dtypes("fixture", rec)
        assert bool(found) == fires and all(f.rule == "A2" for f in found)

    # A3: a library loaded again on every call (the per-call jit of the
    # reference's fixture) fires; a cached load does not
    class _Lib:
        pass

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Lib())
    monkeypatch.setattr(_build, "build", lambda name: (tmp_path / f"lib{name}.so", ""))
    monkeypatch.setattr(_build, "_SIGNATURES", {"fixture": {}})
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(dispatch_audit, "_attribute_sets", lambda: 0)
    _build.load.cache_clear()
    try:
        def leaky(x):
            _build.load.cache_clear()
            _build.load("fixture")
            return x * 2

        def stable(x):
            _build.load("fixture")
            return x * 2

        make_args = lambda: (torch.ones(8),)
        n, found = dispatch_audit.count_rebuilds("fixture_leaky", leaky, make_args)
        assert n > 0 and [f.rule for f in found] == ["A3"]
        assert dispatch_audit.count_rebuilds("fixture_stable", stable, make_args) == (0, [])
    finally:
        _build.load.cache_clear()

    # A4: the shipped registry fits; over-budget and mismatched variants fire
    assert smem.audit_smem()[0] == []
    base = smem.VARIANTS[0]
    for bad in (dict(dynamic_bytes=300_000), dict(static_bytes=50_000),
                dict(dynamic_bytes=120_000, min_blocks=2)):
        found, _ = smem.audit_smem(variants=(dataclasses.replace(base, **bad),))
        assert found and all(f.rule == "A4" for f in found), bad
    report = ("ptxas info    : Compiling entry function "
              "'_ZN12_GLOBAL__N_120kmeans_narrow_kernelILi1ELb0EEEvPKfS2_S2_iiiPiPfS4_' "
              "for 'sm_90a'\n"
              "ptxas info    : Function properties for "
              "_ZN12_GLOBAL__N_120kmeans_narrow_kernelILi1ELb0EEEvPKfS2_S2_iiiPiPfS4_\n"
              "    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes "
              "spill loads\n"
              "ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem\n")
    kernel = "kmeans_narrow_kernel<1,false>"
    assert base.kernel == kernel
    for spill, regs, smem_bytes, dyn in ((0, 40, 0, base.dynamic_bytes),     # clean
                                         (4, 40, 0, base.dynamic_bytes),     # spills
                                         (0, 300, 0, base.dynamic_bytes),    # registers
                                         (0, 40, 16, base.dynamic_bytes),    # static differs
                                         (0, 40, 0, base.dynamic_bytes + 4)):
        parsed = smem.parse_ptxas(report.format(spill=spill, regs=regs, smem=smem_bytes))
        assert parsed[kernel]["spill_stores"] == spill and parsed[kernel]["registers"] == regs
        measured = {"kernels": parsed, "dynamic": {base.label: dyn},
                    "threads": {base.label: base.threads}, "triton": []}
        found, rows = smem.audit_smem(measured, variants=(base,))
        fires = (spill, regs, smem_bytes, dyn) != (0, 40, 0, base.dynamic_bytes)
        assert bool(found) == fires and rows[0]["registers"] == regs
    # an instance the report names but the registry does not price
    found, _ = smem.audit_smem({"kernels": parsed, "dynamic": {}, "threads": {}, "triton": []},
                               variants=())
    assert [f.path for f in found] == [f"kernel:{kernel}"]
    assert smem.kernel_key(
        "_ZN41_GLOBAL__N__397b6904_9_cosine_cu_2af606b918cosine_topk_kernelINS_4TileILi4ELi1E"
        "Li4ELi1ELi16ELi4ELi1EEEEEvPKfS4_iiiiiPiPfS6_") == \
        "cosine_topk_kernel<Tile<4,1,4,1,16,4,1>>"
    assert smem.kernel_key(
        "_ZN51_GLOBAL__N__db73d750_18_flash_attention_cu_0a6aac1c16flash_fwd_kernelI13__nv_"
        "bfloat16Li64EEEvPKT_S4_S4_PS2_iiiiiiiiiff") == "flash_fwd_kernel<__nv_bfloat16,64>"

    # R2 at run time (the card's counts, here on made-up reports): a kernel
    # entry's sync beyond its span fences, and a twin that differs from its
    # plain entry by more than its fences, are findings
    plain = dispatch_audit.EntryReport("cosine_assign", ops=[("aten.mm", ("float32",))],
                                       sync_sites=[])
    twin = dispatch_audit.EntryReport("cosine_assign_obs", ops=list(plain.ops),
                                      sync_sites=["repro_torch/obs/trace.py (span fence)"],
                                      fences=1)
    assert dispatch_audit._twin_findings(twin, plain) == []
    for bad in (dataclasses.replace(twin, sync_sites=twin.sync_sites + ["x.py:1"]),
                dataclasses.replace(twin, ops=twin.ops + [("aten.add", ("float32",))])):
        assert [f.rule for f in dispatch_audit._twin_findings(bad, plain)] == ["R2"]
    assert plain.summary()["syncs"] == 0
    assert dispatch_audit.EntryReport("x").summary()["syncs"] == "not run (cpu)"

    # the strict run over the port's tree: lint plus the audit on the CPU
    code, out = _cli(cli.main, ["--device", "cpu", "--strict"], capsys)
    assert code == 0, out
    assert "not run (cpu)" in out and "0 findings" in out
    for name in entry_points.ENTRY_POINTS:
        assert name in out
    # the audit asks for the card unless told otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--audit-only"])
    jax.clear_caches()
