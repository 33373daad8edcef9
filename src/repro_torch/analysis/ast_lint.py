"""Layer 1 — AST lint over the port's source (rules R1-R4).

The rules keep the reference analyzer's IDs and intent
(``src/repro/analysis/ast_lint.py``), with PyTorch meanings:

* **R1 — draws that are not replayable.** The port's contract is that every
  draw comes from a named generator stream (``device.seeded_generator``), so
  a fit replays bit for bit after a recovery. Two things break it: a
  sampling call with no ``generator=`` (``torch.rand``/``randn``/
  ``randint``/``randperm``/``multinomial``/``normal``/``bernoulli``, the
  in-place ``Tensor.uniform_``/``normal_``/``exponential_``/``random_``/
  ``bernoulli_``) draws from the hidden global stream; and two generators
  seeded from the same words in one function body (``seeded_generator(dev,
  *words)`` or ``Generator.manual_seed(s)`` with the same argument
  expression), both sampled, give identical draws — the counterpart of a
  JAX key sampled twice. The walk is linear over one function body with
  branches merged and loop bodies walked twice, as the reference's; a
  generator seeded in a loop from words that do not change in the loop
  collides with itself on the second pass.

* **R2 — host sync in a hot scope.** ``.item()``/``.tolist()``/``.cpu()``/
  ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor, ``np.*`` on a
  tensor, a Python ``if``/``while`` (or conditional expression) on a
  tensor, and ``torch.cuda.synchronize`` each stall the host on the card.
  The rule flags them in every function reachable, in the same module, from
  a hot root. The hot roots are :data:`HOT_ROOTS` — for each module, the
  port's counterparts of the functions the reference jits (its
  ``_jit_roots``) — plus functions compiled in place
  (``@torch.compile``, ``@torch.jit.script``, ``@jax.jit``). A host
  conversion a function needs by design stays, with a pragma and a reason.

* **R3 — Python state captured across calls.** Mutable default arguments,
  ``global`` mutation inside hot-reachable functions, and writes to
  module-level mutable containers from hot-reachable code: a CUDA graph
  captures the call once, so such state no longer follows the replays. The
  reference's logic, unchanged.

* **R4 — wall clock or global RNG in ``src/repro_torch``.** Legacy
  ``np.random.*`` samplers (the hidden global stream), an unseeded
  ``default_rng()``, ``time.*`` flowing into a seed, and
  ``torch.manual_seed``/``torch.cuda.manual_seed(_all)``/``torch.seed()``
  (the global generators) break bit-replayability.

False positives are suppressed in place with ``# repro: allow[RULE]
reason`` (``findings.parse_pragmas``).
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from .findings import Finding, filter_suppressed, parse_pragmas

__all__ = ["lint_source", "run_ast_lint", "iter_python_files", "HOT_ROOTS",
           "hot_roots"]

#: The port's hot roots: module (relative to ``src/repro_torch``) -> the
#: reference's jit root in the same module -> its counterparts in the port.
#: An empty tuple: the reference's root is a Pallas kernel body, whose
#: counterpart is CUDA code (``kernels/csrc``), not Python.
HOT_ROOTS: dict[str, dict[str, tuple[str, ...]]] = {
    # the scatter, atoms and merge of one rank run inline in distributed_lamc
    "core/distributed.py": {"step": ("distributed_lamc",),
                            "local_atom_phase": ("distributed_lamc",),
                            "local_atom_phase_tp": ("distributed_lamc",),
                            "merge_phase": ("_merge",)},
    "core/kmeans.py": {"kmeans": ("kmeans",)},
    # the reference jits the resamples and the merge; lamc_cocluster
    # around them keeps its host work (plan search, validation)
    "core/lamc.py": {"_lamc_jit": ("run_resample",)},
    "core/nmtf.py": {"nmtf": ("nmtf",)},
    "core/spectral.py": {"scc": ("scc",)},
    "kernels/bipartite_normalize.py": {"scale_apply_pallas": ("scale_apply",)},
    "kernels/flash_attention.py": {"flash_attention_pallas": ("flash_attention",)},
    "kernels/kmeans_assign.py": {"_kernel": (),
                                 "cosine_assign_pallas": ("cosine_assign",),
                                 "cosine_topk_pallas": ("cosine_topk",),
                                 "kmeans_assign_pallas": ("kmeans_assign",)},
    "kernels/kmeans_update.py": {"_kernel": (),
                                 "kmeans_update_pallas": ("kmeans_update",)},
    "kernels/spmm.py": {"_apply_device": ("block_sparse_apply",),
                        "block_sparse_build_device": ("block_sparse_apply",),
                        "block_sparse_pattern_device": ("block_sparse_plan",),
                        "spmm_ata_pallas": ("spmm_ata",),
                        "spmm_pallas": ("spmm",),
                        "spmm_t_pallas": ("spmm_t",)},
    "streaming/fit.py": {"_chunk_atoms": ("_chunk_atoms",)},
}

# torch samplers that take ``generator=``: module functions, and the Tensor
# methods (and ``torch.nn.init`` functions) that draw in place.
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
                   "normal", "bernoulli", "poisson", "rand_like", "randn_like",
                   "randint_like"}
_METHOD_SAMPLERS = {"uniform_", "normal_", "exponential_", "random_",
                    "bernoulli_", "cauchy_", "geometric_", "log_normal_"}
# module-level legacy numpy samplers (the hidden global MT19937 stream);
# everything else under np.random (default_rng, Generator, SeedSequence,
# bit generators) is the counter-friendly API and allowed.
_NP_LEGACY_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "Philox", "SFC64", "MT19937"}
_TIME_FNS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
             "monotonic", "monotonic_ns"}
# torch's global generators
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                       "torch.cuda.manual_seed_all", "torch.cuda.seed",
                       "torch.cuda.seed_all", "torch.random.manual_seed",
                       "torch.random.seed"}
_COMPILED = {"torch.compile", "torch.jit.script", "jax.jit", "jit"}


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Aliases:
    """Resolve import aliases to canonical dotted module paths."""

    def __init__(self, tree: ast.Module):
        self.map: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name != "*":
                        self.map[a.asname or a.name] = (
                            f"{node.module}.{a.name}")

    def resolve(self, name: str | None) -> str | None:
        if name is None:
            return None
        head, _, rest = name.partition(".")
        base = self.map.get(head, head)
        return f"{base}.{rest}" if rest else base


def _call_target(call: ast.Call, aliases: _Aliases) -> str:
    return aliases.resolve(_dotted(call.func)) or ""


def _names_in(node: ast.AST) -> Iterable[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# --------------------------------------------------------------------------
# R1 — draws that are not replayable
# --------------------------------------------------------------------------


def _unseeded_draws(tree: ast.Module, aliases: _Aliases,
                    findings: list[Finding]) -> None:
    """A sampling call without ``generator=`` draws from the global stream."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _kw(node, "generator") is not None:
            continue
        tgt = _call_target(node, aliases)
        leaf = tgt.rsplit(".", 1)[-1]
        fn = None
        if tgt.startswith("torch.") and tgt.count(".") == 1 and leaf in _TORCH_SAMPLERS:
            fn = tgt
        elif tgt.startswith("torch.nn.init.") and leaf.endswith("_"):
            fn = tgt
        elif (isinstance(node.func, ast.Attribute) and node.func.attr in _METHOD_SAMPLERS
              and not tgt.startswith(("torch.", "np.", "numpy."))):
            fn = f"Tensor.{node.func.attr}"
        if fn is not None:
            findings.append(Finding(
                rule="R1", path="", line=node.lineno,
                message=f"{fn} without generator= draws from the global "
                        "stream — not replayable",
                evidence="pass generator=seeded_generator(device, *words)"))


class _R1Scope:
    """Linear walk of one function body tracking seeded generators.

    ``bind[name] = (seed key, binding id)``; ``sampled[seed key]`` is the set
    of binding ids of that key sampled so far on this path."""

    def __init__(self, aliases: _Aliases, findings: list[Finding]):
        self.aliases = aliases
        self.findings = findings
        self.bind: dict[str, tuple[str, tuple]] = {}
        self.sampled: dict[str, set[tuple]] = {}
        self.first: dict[str, int] = {}
        self.variant: set[str] = set()   # names rebound by the loops being walked
        self.pass_no = 0

    # -- helpers -----------------------------------------------------------
    def _seed_key(self, node: ast.AST) -> str | None:
        """The seed words of a generator-making expression, else None."""
        if not isinstance(node, ast.Call):
            return None
        tgt = _call_target(node, self.aliases)
        words = None
        if tgt.endswith("seeded_generator"):
            words = node.args[1:]
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed":
            inner = node.func.value
            if (isinstance(inner, ast.Call)
                    and _call_target(inner, self.aliases).endswith("Generator")):
                words = node.args
        if words is None:
            return None
        key = "|".join(ast.dump(w) for w in words)
        if self.variant & {n for w in words for n in _names_in(w)}:
            # words that change in the loop: a new stream every iteration
            key += f"#pass{self.pass_no}"
        return key

    def _binding(self, node: ast.AST) -> tuple:
        # the loop pass is part of the identity: a loop-invariant seed bound
        # again on the second pass is a second generator of the same key
        return (node.lineno, node.col_offset, self.pass_no)

    def _sample(self, key: str, ident: tuple, node: ast.AST) -> None:
        others = self.sampled.setdefault(key, set()) - {ident}
        if others:
            self.findings.append(Finding(
                rule="R1", path="", line=node.lineno,
                message="generator seeded from the same words as one already "
                        "sampled — both give identical draws",
                evidence=f"the other is seeded at line "
                         f"{self.first.get(key, node.lineno)}; add a word "
                         "that names this stream"))
        self.sampled[key].add(ident)
        self.first.setdefault(key, node.lineno)

    def _use(self, arg: ast.AST, node: ast.AST) -> None:
        """``arg`` handed to a call: a generator is sampled (or escapes to a
        callee that samples it)."""
        if isinstance(arg, ast.Name) and arg.id in self.bind:
            key, ident = self.bind[arg.id]
            self._sample(key, ident, node)
            return
        key = self._seed_key(arg)
        if key is not None:          # an anonymous generator, sampled at once
            self._sample(key, self._binding(arg), node)

    def _assign(self, target: ast.AST, value: ast.AST | None) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            vals = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)
                    else [None] * len(target.elts))
            for t, v in zip(target.elts, vals):
                self._assign(t, v)
            return
        if not isinstance(target, ast.Name):
            return
        key = None if value is None else self._seed_key(value)
        if key is None:
            self.bind.pop(target.id, None)
        else:
            self.bind[target.id] = (key, self._binding(value))

    # -- statement walk ----------------------------------------------------
    def run(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _copy(self):
        return dict(self.bind), {k: set(v) for k, v in self.sampled.items()}

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is not None:
                self._expr(value)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if isinstance(stmt, ast.AugAssign):
                    self._assign(t, None)
                else:
                    self._assign(t, value)
        elif isinstance(stmt, ast.If):
            self._expr(stmt.test)
            before = self._copy()
            self.run(stmt.body)
            bind_if, sampled_if = self._copy()
            self.bind, self.sampled = before[0], before[1]
            self.run(stmt.orelse)
            # a name bound to the same key on both paths is one generator
            for name, (key, ident) in bind_if.items():
                mine = self.bind.get(name)
                if mine is not None and mine[0] == key and mine[1] != ident:
                    for ids in self.sampled.values():
                        if mine[1] in ids:
                            ids.discard(mine[1])
                            ids.add(ident)
                    self.bind[name] = (key, ident)
            for key, ids in sampled_if.items():
                self.sampled.setdefault(key, set()).update(ids)
            for name, val in bind_if.items():
                self.bind.setdefault(name, val)
        elif isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._expr(stmt.iter)
                self._assign(stmt.target, None)
            else:
                self._expr(stmt.test)
            rebound = set(_names_in(stmt.target)) if isinstance(
                stmt, (ast.For, ast.AsyncFor)) else set()
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    for t in (sub.targets if isinstance(sub, ast.Assign)
                              else [sub.target]):
                        rebound.update(_names_in(t))
                elif isinstance(sub, (ast.For, ast.AsyncFor, ast.comprehension)):
                    rebound.update(_names_in(sub.target))
            saved_variant, saved_pass = self.variant, self.pass_no
            self.variant = self.variant | rebound
            for p in range(2):
                self.pass_no = saved_pass * 2 + p + 1
                self.run(stmt.body)
            self.variant, self.pass_no = saved_variant, saved_pass
            self.run(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
            self.run(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.run(stmt.body)
            for h in stmt.handlers:
                self.run(h.body)
            self.run(stmt.orelse)
            self.run(stmt.finalbody)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._expr(stmt.value)
        # nested defs get their own scope via the module walk

    def _expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            if (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "manual_seed"
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id in self.bind and sub.args):
                # g.manual_seed(s): g is re-seeded (a new binding of g)
                key = "|".join(ast.dump(w) for w in sub.args)
                if self.variant & {n for w in sub.args for n in _names_in(w)}:
                    key += f"#pass{self.pass_no}"
                self.bind[sub.func.value.id] = (key, self._binding(sub))
                continue
            if self._seed_key(sub) is not None:
                continue             # making a generator is not sampling it
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                self._use(arg, sub)


def _r1_function(fn: ast.AST, aliases: _Aliases,
                 findings: list[Finding]) -> None:
    scope = _R1Scope(aliases, findings)
    scope.run(fn.body)


# --------------------------------------------------------------------------
# R2/R3 — hot reachability + host sync + captured state
# --------------------------------------------------------------------------

def _module_key(path: str) -> str | None:
    """``core/kmeans.py`` for ``.../repro_torch/core/kmeans.py``."""
    norm = path.replace(os.sep, "/")
    marker = "repro_torch/"
    i = norm.rfind(marker)
    return norm[i + len(marker):] if i >= 0 else None


def _decorator_is_compiled(dec: ast.AST, aliases: _Aliases) -> bool:
    tgt = aliases.resolve(_dotted(dec))
    if tgt in _COMPILED:
        return True
    if isinstance(dec, ast.Call):
        head = aliases.resolve(_dotted(dec.func))
        if head in _COMPILED:
            return True
        if head in ("functools.partial", "partial") and dec.args:
            return aliases.resolve(_dotted(dec.args[0])) in _COMPILED
    return False


def hot_roots(path: str, tree: ast.Module, aliases: _Aliases,
              functions: dict[str, ast.AST]) -> set[str]:
    """The table's roots for ``path`` and the functions compiled in place."""
    roots: set[str] = set()
    key = _module_key(path)
    for names in HOT_ROOTS.get(key, {}).values() if key else ():
        roots.update(n for n in names if n in functions)
    for name, fn in functions.items():
        for dec in getattr(fn, "decorator_list", []):
            if _decorator_is_compiled(dec, aliases):
                roots.add(name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_target(node, aliases) in _COMPILED:
            if node.args and _dotted(node.args[0]) in functions:
                roots.add(_dotted(node.args[0]))
    return roots


def _reachable(functions: dict[str, ast.AST], roots: set[str]) -> set[str]:
    calls: dict[str, set[str]] = {}
    for name, fn in functions.items():
        calls[name] = {n for n in _names_in(fn) if n in functions and n != name}
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        cur = frontier.pop()
        for nxt in calls.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


_STATIC_PARAM_NAMES = {"self", "cls", "cfg", "config", "plan", "mesh", "device",
                       "dev", "timer", "generator", "gen", "layout"}
# host metadata of a tensor: reading it does not wait for the card
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_sparse"}
_META_METHODS = {"numel", "size", "dim", "data_ptr", "stride", "is_contiguous",
                 "element_size", "get_device", "nelement", "storage_offset",
                 "is_coalesced", "is_floating_point", "item", "tolist"}
# torch calls whose value is no tensor
_TORCH_NON_TENSOR = ("torch.device", "torch.Generator", "torch.is_tensor",
                     "torch.is_floating_point", "torch.finfo", "torch.iinfo",
                     "torch.get_default_dtype", "torch.Size", "torch.promote_types",
                     "torch.result_type", "torch.no_grad", "torch.inference_mode",
                     "torch.cuda.", "torch.distributed.", "torch.backends.")
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


def _is_tensor_annotation(ann: ast.AST | None, aliases: _Aliases) -> bool:
    if ann is None:
        return False
    for sub in ast.walk(ann):
        if isinstance(sub, (ast.Attribute, ast.Name)):
            if aliases.resolve(_dotted(sub)) in ("torch.Tensor", "Tensor"):
                return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if "Tensor" in sub.value:
                return True
    return False


class _Taint:
    """Which expressions of one function hold tensors (``narrow``: from
    torch calls, tensor methods and ``torch.Tensor`` parameters) or may
    (``broad``: any non-static parameter, as the reference taints)."""

    def __init__(self, fn: ast.AST, aliases: _Aliases):
        self.aliases = aliases
        args = fn.args
        params = args.posonlyargs + args.args + args.kwonlyargs
        self.tensors = {a.arg for a in params
                        if _is_tensor_annotation(a.annotation, aliases)}
        self.broad = {a.arg for a in params if a.arg not in _STATIC_PARAM_NAMES}
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign)) and n.value is not None]
        for _ in range(4):           # a few rounds reach a fixpoint in practice
            for node in assigns:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = [n for t in targets for n in _names_in(t)]
                if self.tensor(node.value):
                    self.tensors.update(names)
                if self.maybe(node.value):
                    self.broad.update(names)

    def _torch_call(self, call: ast.Call) -> bool:
        tgt = _call_target(call, self.aliases)
        return tgt.startswith("torch.") and not tgt.startswith(_TORCH_NON_TENSOR)

    def tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            return node.attr not in _META_ATTRS and self.tensor(node.value)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _META_METHODS:
                    return False
                if self._torch_call(node):
                    return True
                return self.tensor(node.func.value)
            return self._torch_call(node)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(self.tensor(v) for v in [node.left] + node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        return False

    def maybe(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.broad:
                return True
            if isinstance(sub, ast.Call) and self._torch_call(sub):
                return True
        return False


def _r2_r3_function(fn: ast.AST, aliases: _Aliases,
                    module_mutables: set[str],
                    findings: list[Finding]) -> None:
    taint = _Taint(fn, aliases)

    def r2(node: ast.AST, message: str, evidence: str) -> None:
        findings.append(Finding(rule="R2", path="", line=node.lineno,
                                message=message, evidence=evidence))

    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            findings.append(Finding(
                rule="R3", path="", line=node.lineno,
                message=f"'global {', '.join(node.names)}' inside "
                        "hot-reachable code — module state a captured call "
                        "does not update",
                evidence="thread state through function arguments instead"))
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if (isinstance(base, ast.Name) and base.id in module_mutables
                        and not isinstance(t, ast.Name)):
                    findings.append(Finding(
                        rule="R3", path="", line=node.lineno,
                        message=f"write into module-level mutable "
                                f"{base.id!r} from hot-reachable code",
                        evidence="state shared by every call; a captured "
                                 "call does not write it again"))
        if isinstance(node, (ast.If, ast.While, ast.IfExp)) and taint.tensor(node.test):
            kind = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional"}[type(node)]
            r2(node, f"Python {kind} on a tensor inside hot-reachable code "
                     "waits for the card", "branch on device values with "
                     "torch.where, or decide from host values")
        if not isinstance(node, ast.Call):
            continue
        tgt = _call_target(node, aliases)
        if tgt == "torch.cuda.synchronize":
            r2(node, "torch.cuda.synchronize inside hot-reachable code "
                     "stalls the host", "let the caller (or a span) fence")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _HOST_METHODS and not node.args
              and (taint.maybe(node.func.value) or taint.tensor(node.func.value))):
            r2(node, f".{node.func.attr}() inside hot-reachable code copies "
                     "to the host and waits for the card",
               "keep the value on the device, or hoist the readback out of "
               "the hot scope")
        elif tgt in ("float", "int", "bool") and node.args and taint.tensor(
                node.args[0]):
            r2(node, f"{tgt}() of a tensor inside hot-reachable code forces "
                     "a host sync", "keep the value on the device")
        elif (tgt.startswith(("np.", "numpy."))
              and not tgt.startswith(("np.random.", "numpy.random."))
              and any(taint.tensor(a) for a in node.args)):
            r2(node, f"{tgt}(...) on a tensor inside hot-reachable code "
                     "copies it to the host", "use the torch equivalent")


def _mutable_defaults(tree: ast.Module, findings: list[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set))
            if isinstance(d, ast.Call):
                bad = _dotted(d.func) in ("list", "dict", "set")
            if bad:
                findings.append(Finding(
                    rule="R3", path="", line=d.lineno,
                    message="mutable default argument is shared across "
                            "calls",
                    evidence="default to None and construct inside the body"))


def _module_mutables(tree: ast.Module) -> set[str]:
    out = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, (ast.List, ast.Dict, ast.Set)):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


# --------------------------------------------------------------------------
# R4 — wall clock / global RNG
# --------------------------------------------------------------------------

def _strip_annotations(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a tree skipping annotation subtrees (np.random.Generator type
    hints are not calls into the legacy stream)."""
    skip: set[int] = set()
    for node in ast.walk(fn):
        ann = getattr(node, "annotation", None)
        if ann is not None:
            for sub in ast.walk(ann):
                skip.add(id(sub))
    for node in ast.walk(fn):
        if id(node) not in skip:
            yield node


def _is_time(call: ast.AST, aliases: _Aliases) -> bool:
    if not isinstance(call, ast.Call):
        return False
    t2 = _call_target(call, aliases)
    return t2.startswith("time.") and t2.split(".")[1] in _TIME_FNS


def _r4_module(tree: ast.Module, aliases: _Aliases,
               findings: list[Finding]) -> None:
    for node in _strip_annotations(tree):
        if not isinstance(node, ast.Call):
            continue
        tgt = _call_target(node, aliases)
        norm = tgt.replace("numpy.", "np.", 1)
        if norm.startswith("np.random."):
            fn = norm.split(".", 2)[2] if norm.count(".") >= 2 else ""
            leaf = fn.split(".")[0]
            if leaf == "default_rng" and not node.args and not node.keywords:
                findings.append(Finding(
                    rule="R4", path="", line=node.lineno,
                    message="np.random.default_rng() without a seed draws "
                            "from OS entropy — not replayable",
                    evidence="derive the seed from the (seed, step) "
                             "counters the repo keys everything on"))
            elif leaf and leaf not in _NP_LEGACY_OK:
                findings.append(Finding(
                    rule="R4", path="", line=node.lineno,
                    message=f"legacy np.random.{leaf} uses the hidden "
                            "global stream — not counter-derived",
                    evidence="use np.random.default_rng([seed, step]) or a "
                             "seeded_generator stream"))
        elif tgt in _TORCH_GLOBAL_SEEDS:
            findings.append(Finding(
                rule="R4", path="", line=node.lineno,
                message=f"{tgt} sets a global generator — every unseeded "
                        "draw anywhere shares it",
                evidence="draw from seeded_generator(device, *words) streams"))
    # clock-into-seed contexts
    for node in _strip_annotations(tree):
        time_call = ctx = None
        if isinstance(node, ast.Call):
            tgt = _call_target(node, aliases)
            norm = tgt.replace("numpy.", "np.", 1)
            if (norm.startswith("np.random.") or tgt in _TORCH_GLOBAL_SEEDS
                    or norm.endswith((".default_rng", "seeded_generator",
                                      ".manual_seed"))
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "manual_seed")):
                for a in list(node.args) + [k.value for k in node.keywords]:
                    for sub in ast.walk(a):
                        if _is_time(sub, aliases):
                            time_call, ctx = sub, norm or "manual_seed"
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if any("seed" in n.lower() for n in names):
                for sub in ast.walk(node.value):
                    if _is_time(sub, aliases):
                        time_call, ctx = sub, f"seed name {names!r}"
        if time_call is not None:
            findings.append(Finding(
                rule="R4", path="", line=time_call.lineno,
                message="wall clock flows into a seed/RNG — every run "
                        "draws a different stream",
                evidence=f"context: {ctx}; pass an explicit counter-derived "
                         "seed instead"))


# --------------------------------------------------------------------------
# lint entry points
# --------------------------------------------------------------------------

def lint_source(path: str, source: str) -> list[Finding]:
    """All R-rule findings for one file (pragmas NOT yet applied)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:  # surfaced as its own finding, not a crash
        return [Finding(rule="R0", path=path, line=e.lineno or 0,
                        message=f"syntax error: {e.msg}")]
    aliases = _Aliases(tree)
    raw: list[Finding] = []

    functions: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions.setdefault(node.name, node)

    # R1 over every function and the module body
    _unseeded_draws(tree, aliases, raw)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _r1_function(node, aliases, raw)
    _r1_function(tree, aliases, raw)

    # R2/R3 over hot-reachable functions
    reach = _reachable(functions, hot_roots(path, tree, aliases, functions))
    mutables = _module_mutables(tree)
    for name in reach:
        _r2_r3_function(functions[name], aliases, mutables, raw)
    _mutable_defaults(tree, raw)

    # R4 only in the port's package
    if "src/repro_torch" in path.replace(os.sep, "/") or path.startswith("repro_torch/"):
        _r4_module(tree, aliases, raw)

    seen = set()
    out = []
    for f in raw:
        f = Finding(rule=f.rule, path=path, line=f.line, message=f.message,
                    evidence=f.evidence)
        if f.key() not in seen:
            seen.add(f.key())
            out.append(f)
    return out


def iter_python_files(paths: list[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def run_ast_lint(paths: list[str]) -> tuple[list[Finding], list[Finding]]:
    """Lint every .py under ``paths``; returns (active, suppressed)."""
    findings: list[Finding] = []
    pragmas: dict[str, dict[int, set[str]]] = {}
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        pragmas[path] = parse_pragmas(source)
        findings.extend(lint_source(path, source))
    return filter_suppressed(findings, pragmas)
