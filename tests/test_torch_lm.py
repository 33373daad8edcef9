"""The LM serving path against the reference, on the CPU, with the reference's
weights injected.

Reduced configs of the seven archs the port runs (qwen3-4b: GQA with
qk_norm; smollm-360m: 3/1 heads of width 20; minicpm-2b: MHA, odd vocab;
chatglm3-6b: half-dim RoPE; recurrentgemma-2b: one (rglru, rglru, local)
unit and two tail RG-LRU blocks, window 16, gelu; deepseek-moe-16b: a
leading dense layer and two MoE layers of 8 experts, top-2, 2 shared,
capacity factor 8 (nothing dropped); llama4-scout: two MoE layers of 4
experts, top-1, 1 shared, GQA 4/2, capacity factor 1.25, so the prefill
drops pairs). The reference's ``model.init`` tree goes through
``interop.lm_params_from_numpy``; the same numpy tokens go through both
packages' ``forward_full``, ``prefill`` (23 tokens: the local cache is cut
to the last 16), ``grow_cache`` (the local cache rolled by 7) and
``decode_step``; every leaf of the cache trees (``head_<i>`` too) is
compared.

Tolerances, each relative to the largest |value| of the reference's tensor:

* float32 compute: 1e-4. The two sides add the same products in another
  order (ATen's and XLA's CPU matmuls, the flash plain version's chunks,
  the RG-LRU's scan tree), which moves the logits by at most 1.8e-6 of
  their scale and recurrentgemma-2b's caches by at most 1.2e-5 (measured).
* bf16 compute: ``BF16_TOL`` = 3e-2. bf16 keeps 8 bits, and the reference
  rounds where XLA puts it: its units are compiled, and there the ``ln2``
  norm reads the residual sum before its rounding and ``jax.nn.silu``
  rounds after each of its four ops, which the port follows
  (``transformer._ffn``, ``layers.silu``); its tail blocks and the leading
  dense layers run op by op. So qwen3-4b, smollm-360m, minicpm-2b and
  llama4-scout give the reference's bits (0 measured), chatglm3-6b differs
  by 9.3e-3 at most, deepseek-moe-16b by 7.9e-3 (its combine sums two
  experts in another order; its dense first layer runs op by op) and
  recurrentgemma-2b by 2.0e-2 (the decoded logits; its conv state 1.9e-2,
  hidden states 1.3e-2). llama4-scout needs the bits: a one-step
  difference before a router moves a top-1 route, and with capacity drops
  that moves others.
* int8 caches: one quantization step (the scale) per element, since a
  value within float32 noise of a rounding midpoint may round either way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, layers, moe, rglru, transformer

ARCHS = ["qwen3-4b", "smollm-360m", "minicpm-2b", "chatglm3-6b", "recurrentgemma-2b",
         "deepseek-moe-16b", "llama4-scout-17b-a16e"]
# llama4-scout's reduced config drops pairs at capacity 1.25, so a prefill
# and a decode route differently (the reference's own smoke test leaves it
# out of this check too)
CONSISTENT = [arch for arch in ARCHS if arch != "llama4-scout-17b-a16e"]
F32_TOL = 1e-4
BF16_TOL = 3e-2
SEQ, MAX_LEN = 24, 40
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_code():
    """Give back the memory mappings of this module's compiled JAX code, so
    an xdist worker that also runs the reference's fuzz cases stays under
    ``vm.max_map_count``."""
    jax.clear_caches()
    yield
    _RUNS.clear()
    jax.clear_caches()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"


def _leaves(tree, path=""):
    """``{path: leaf}`` of a cache tree (dicts and lists, either package)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {path: tree}
    return {k: v for key, sub in items for k, v in _leaves(sub, f"{path}/{key}").items()}


def _close_trees(got, want, tol, what):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want), f"{what}: leaves {sorted(got)} != {sorted(want)}"
    for path in want:
        _close(got[path], want[path], tol, f"{what} {path}")


def _weights(arch, dtype=torch.float32):
    """The reference's model, its weights, and the same weights in the port."""
    cfg = jreduced(arch)
    params = jbuild_model(cfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, interop.lm_params_from_numpy(reduced(arch), tree, "cpu", dtype)


_RUNS = {}


def _runs(arch, dt):
    """Both packages through forward_full, prefill (s - 1 tokens), grow_cache
    and one decode step, in compute dtype ``dt`` (computed once per case)."""
    if (arch, dt) in _RUNS:
        return _RUNS[arch, dt]
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tparams = _weights(arch)
    cfg = reduced(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, SEQ))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    ref, port = {}, {}
    ref["hidden"] = jtransformer.forward_full(jcfg, jparams, jt, dtype=jdt, remat=False)[0]
    ref["logits"], ref["caches"] = jtransformer.prefill(jcfg, jparams, jt[:, :-1], dtype=jdt)
    ref["grown"] = jtransformer.grow_cache(jcfg, ref["caches"], SEQ - 1, MAX_LEN, dtype=jdt)
    ref["decode"], ref["after"] = jtransformer.decode_step(
        jcfg, jparams, jt[:, -1], ref["grown"], jnp.int32(SEQ - 1), dtype=jdt)
    with torch.inference_mode():
        port["hidden"] = transformer.forward_full(cfg, tparams, tt, dtype=tdt)[0]
        port["logits"], port["caches"] = transformer.prefill(cfg, tparams, tt[:, :-1],
                                                             dtype=tdt)
        port["grown"] = transformer.grow_cache(cfg, port["caches"], SEQ - 1, MAX_LEN,
                                               dtype=tdt)
        grown = {key: ([{k: v.clone() for k, v in e.items()} for e in val] if key == "units"
                       else {k: v.clone() for k, v in val.items()})
                 for key, val in port["grown"].items()}
        port["decode"], port["after"] = transformer.decode_step(
            cfg, tparams, tt[:, -1], grown, SEQ - 1, dtype=tdt)
    _RUNS[arch, dt] = ref, port
    return ref, port


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind, dt):
    jdt, tdt = DTYPES[dt]
    x, scale, bias = _arrays(0, (3, 5, 48), (48,), (48,))
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    p = layers.Norm(kind, 48)
    p.scale.copy_(torch.from_numpy(scale))
    if kind == "layernorm":
        p.bias.copy_(torch.from_numpy(bias))
    fn = jlayers.rmsnorm if kind == "rmsnorm" else jlayers.layernorm
    want = fn(jp, jnp.asarray(x).astype(jdt))
    got = layers.norm_apply(p, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    # one float32 op order apart: 1e-6; bf16: one rounding step of the output
    _close(got, want, 1e-6 if dt == "f32" else 2 ** -7, f"{kind} {dt}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("half", [False, True], ids=["rope", "rope_half"])
def test_rope_matches_reference(half, dt):
    jdt, tdt = DTYPES[dt]
    q, k = _arrays(1, (2, 3, 17, 16), (2, 1, 17, 16))
    pos = np.arange(5, 22)
    jfn, tfn = ((jlayers.apply_rope_half, layers.apply_rope_half) if half
                else (jlayers.apply_rope, layers.apply_rope))
    jq, jk = jfn(jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt), jnp.asarray(pos))
    tq, tk = tfn(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                 torch.from_numpy(pos))
    # f32: cos/sin of angles up to 21 rad differ by an ulp or two between
    # libms; bf16: the products and sums round to bf16 on both sides
    tol = 1e-5 if dt == "f32" else 2 ** -6
    _close(tq, jq, tol, "q")
    _close(tk, jk, tol, "k")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    x, w_in, w_gate, w_out = _arrays(2, (2, 7, 32), (32, 48), (32, 48), (48, 32))
    jp = {"w_in": {"w": jnp.asarray(w_in)}, "w_gate": {"w": jnp.asarray(w_gate)},
          "w_out": {"w": jnp.asarray(w_out)}}
    p = layers.MLP(32, 48)
    for name, w in (("w_in", w_in), ("w_gate", w_gate), ("w_out", w_out)):
        getattr(p, name).copy_(torch.from_numpy(w))
    _close(layers.mlp(p, torch.from_numpy(x), act), jlayers.mlp(jp, jnp.asarray(x), act),
           1e-5, f"mlp {act}")


def test_rglru_block_matches_reference():
    """The RG-LRU block on the reference's weights: ``rglru_block_apply``
    (S = 1, 2, 24, with and without ``h0``) and a ``rglru_block_step``
    chained from its state. float32 against the reference at ``F32_TOL``
    (measured at 8.2e-7 at most); the bf16 apply against the compiled
    reference (``jax.jit``, whose rounding the conv follows) at one bf16
    step of the scale, 2^-8 (measured at 1.5e-3)."""
    d = 48
    jp = jrglru.rglru_block_init(jax.random.key(2), d, d)
    tree = jax.tree.map(np.asarray, jp)
    leaves = {"w_x": tree["w_x"]["w"], "w_gate": tree["w_gate"]["w"],
              "w_out": tree["w_out"]["w"], "conv": tree["conv"], "lambda": tree["lambda"],
              **{f"gates.{n}": tree["gates"][n] for n in ("w_a", "b_a", "w_i", "b_i")}}
    rng = np.random.default_rng(7)
    for dt in ("f32", "bf16"):
        jdt, tdt = DTYPES[dt]
        blk = rglru.RecurrentBlock(d, d, device="meta")
        blk.load_state_dict({n: torch.tensor(np.array(v)).to(
            torch.float32 if transformer.keeps_float32(n) else tdt) for n, v in leaves.items()},
            strict=True, assign=True)
        apply = jrglru.rglru_block_apply if dt == "f32" else jax.jit(jrglru.rglru_block_apply)
        for s in (1, 2, 24):
            x = rng.normal(size=(2, s + 1, d)).astype(np.float32)
            h0 = rng.normal(size=(2, d)).astype(np.float32)
            for with_h0 in (False, True):
                what = f"{dt} S={s} h0={with_h0}"
                jo, js = apply(jp, jnp.asarray(x[:, :s]).astype(jdt),
                               jnp.asarray(h0) if with_h0 else None)
                to, ts = rglru.rglru_block_apply(blk, torch.from_numpy(x[:, :s]).to(tdt),
                                                 torch.from_numpy(h0) if with_h0 else None)
                tol = F32_TOL if dt == "f32" else 2 ** -8
                _close(to, jo, tol, f"apply out {what}")
                _close_trees(ts, js, tol, f"apply state {what}")
                if dt == "f32":
                    jo, js = jrglru.rglru_block_step(jp, jnp.asarray(x[:, s:]), js)
                    to, ts = rglru.rglru_block_step(blk, torch.from_numpy(x[:, s:]), ts)
                    _close(to, jo, tol, f"step out {what}")
                    _close_trees(ts, js, tol, f"step state {what}")


def _ref_dropped(jp, x, top_k, capacity_factor):
    """The (token, k) pairs the reference's ``moe_apply`` drops: its routing
    and slot lines, replayed."""
    b, s, _ = x.shape
    e = jp["w_in"].shape[0]
    c = jmoe.row_capacity(s, top_k, e, capacity_factor)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(b, s * top_k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1)
    return int(jnp.sum(pos >= c))


def test_moe_matches_reference():
    """``moe.moe_apply`` against ``jax.jit`` of the reference's on its
    weights: top-6 of 8 experts with 2 shared (deepseek's shape) and top-1 of
    4 with 1 shared (llama4-scout's), at capacity factor 1.0 (pairs dropped)
    and 8.0 (none), float32 and bf16: ``out`` and ``aux`` within ``F32_TOL``
    and ``BF16_TOL`` and the same count of dropped pairs."""
    d, d_ff = 32, 48
    rng = np.random.default_rng(11)
    for top_k, n_experts, n_shared in ((6, 8, 2), (1, 4, 1)):
        jp = jmoe.moe_init(jax.random.key(top_k), d, d_ff, n_experts, n_shared)
        tree = jax.tree.map(np.asarray, jp)
        leaves = {"router": tree["router"]["w"], "w_in": tree["w_in"],
                  "w_gate": tree["w_gate"], "w_out": tree["w_out"],
                  **{f"shared.{n}": tree["shared"][n]["w"] for n in ("w_in", "w_gate", "w_out")}}
        p = moe.MoE(d, d_ff, n_experts, n_shared, device="meta")
        p.load_state_dict({n: torch.tensor(np.array(v)) for n, v in leaves.items()},
                          strict=True, assign=True)
        x = rng.normal(size=(2, 23, d)).astype(np.float32)
        for cf in (1.0, 8.0):
            apply = jax.jit(lambda q, y, cf=cf, k=top_k: jmoe.moe_apply(
                q, y, top_k=k, act="silu", capacity_factor=cf))
            for dt in ("f32", "bf16"):
                jdt, tdt = DTYPES[dt]
                jx = jnp.asarray(x).astype(jdt)
                jo, ja = apply(jp, jx)
                with moe.count_dropped() as dropped:
                    to, ta = moe.moe_apply(p, torch.from_numpy(x).to(tdt), top_k=top_k,
                                           act="silu", capacity_factor=cf)
                what = f"top-{top_k} cf={cf} {dt}"
                assert to.dtype == tdt, what
                tol = F32_TOL if dt == "f32" else BF16_TOL
                _close(to, jo, tol, f"moe out {what}")
                _close(ta, ja, F32_TOL, f"moe aux {what}")
                want = _ref_dropped(jp, jx, top_k, cf)
                assert [int(n) for n in dropped] == [want], what
                assert (want > 0) == (cf == 1.0), what       # drops forced, or none


# ---------------------------------------------------------------------------
# the model, with the reference's weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, dt):
    ref, port = _runs(arch, dt)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    _close(port["hidden"], ref["hidden"], tol, "forward_full hidden")
    _close(port["logits"], ref["logits"], tol, "prefill logits")
    _close_trees(port["caches"], ref["caches"], tol, "prefill cache")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grow_cache_and_decode_match_reference(arch, dt):
    ref, port = _runs(arch, dt)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    cfg = reduced(arch)
    for kind, entry in zip(cfg.block_pattern, port["grown"]["units"]):
        if kind != "rglru":      # a local entry is a rolling buffer of the window
            want = min(cfg.window, MAX_LEN) if kind == "local" else MAX_LEN
            assert entry["k"].shape[-2] == entry["v"].shape[-2] == want
    _close_trees(port["grown"], ref["grown"], tol, "grown cache")
    _close_trees(port["after"], ref["after"], tol, "cache after decode")
    _close(port["decode"], ref["decode"], tol, "decode logits")


@pytest.mark.parametrize("arch", ["qwen3-4b", "chatglm3-6b"])
def test_int8_cache_decode_matches_reference(arch):
    """Four decode steps from position 0 over an int8 cache, float32 compute."""
    jcfg, jparams, tparams = _weights(arch)
    cfg = reduced(arch)
    jm, tm = jbuild_model(jcfg, dtype=jnp.float32), build_model(cfg, dtype=torch.float32,
                                                                device="cpu")
    jcache = jm.init_decode_cache(2, 16, quantized=True)
    tcache = tm.init_decode_cache(2, 16, quantized=True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 4))
    for pos in range(4):
        jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, pos], jnp.int32), jcache,
                                    jnp.int32(pos))
        tl, tcache = tm.decode_step(tparams, torch.as_tensor(toks[:, pos]), tcache, pos)
        _close(tl, jl, 1e-3, f"int8 decode logits at {pos}")
    want, got = jcache["units"][0], tcache["units"][0]
    for leaf, sleaf in (("k", "ks"), ("v", "vs")):
        _close(got[sleaf], want[sleaf], F32_TOL, f"int8 scales {sleaf}")
        deq_got = _np(got[leaf]) * _np(got[sleaf])[..., None]
        deq_want = _np(want[leaf]) * _np(want[sleaf])[..., None]
        step = _np(want[sleaf])[..., None]
        assert bool((np.abs(deq_got - deq_want) <= step * (1 + 1e-5)).all()), leaf
        assert got[leaf].dtype == torch.int8


@pytest.mark.parametrize("arch", CONSISTENT)
def test_prefill_decode_consistency(arch):
    """decode(prefill(t[:s-1]), t[s-1]) gives forward_full's last logits (the
    reference's ``test_prefill_decode_consistency``, its tolerance)."""
    cfg = reduced(arch)
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    params = m.init(0)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, SEQ)))
    with torch.inference_mode():
        hidden, _ = transformer.forward_full(cfg, params, toks, dtype=torch.float32)
        want = transformer.logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]
    _, caches = m.prefill(params, toks[:, :-1])
    cache = transformer.grow_cache(cfg, caches, SEQ - 1, 64, dtype=torch.float32)
    got, _ = m.decode_step(params, toks[:, -1], cache, SEQ - 1)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_gives_the_reference_tokens(arch):
    """``serve._generate`` on the reference's weights and prompts, float32
    compute, 8 tokens: the reference's ``generate`` loop gives the same ones."""
    jcfg, jparams, tparams = _weights(arch)
    cfg = reduced(arch)
    batch, prompt_len, gen_len = 2, 12, 8
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt_len))
    jm = jbuild_model(jcfg, dtype=jnp.float32)
    last, caches = jm.prefill(jparams, jnp.asarray(prompts, jnp.int32))
    cache = jtransformer.grow_cache(jcfg, caches, prompt_len, prompt_len + gen_len)
    tok = jnp.argmax(last, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen_len - 1):
        logits, cache = jm.decode_step(jparams, tok, cache, jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], 1)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    out = serve._generate(model, tparams, torch.as_tensor(prompts), gen_len)
    np.testing.assert_array_equal(out["tokens"], want)
    assert out["logits_finite"]


def test_generate_runs_on_the_cpu():
    ops.reset_launch_counts()
    for arch, param_dtype in (("qwen3-4b", torch.float32), ("recurrentgemma-2b", torch.float32),
                              ("deepseek-moe-16b", torch.bfloat16)):
        out = serve.generate(arch=arch, batch=2, prompt_len=10, gen_len=4, device="cpu",
                             param_dtype=param_dtype)
        assert out["tokens"].shape == (2, 4) and out["tokens"].dtype == np.int32
        assert out["logits_finite"] and out["tokens_per_s"] > 0
    assert ops.launch_counts()["flash_attention"] == 0
    sampled = serve.generate(arch="qwen3-4b", batch=2, prompt_len=10, gen_len=4,
                             device="cpu", greedy=False)
    assert sampled["tokens"].shape == (2, 4)


def test_weights_carry_over_exactly():
    """Every leaf of the reference's tree lands in the port's module: the
    compute copy in bf16 equals the reference's per-use cast bit for bit."""
    _, jparams, tparams = _weights("qwen3-4b")
    unit = jparams["units"]["0"]
    blk = tparams.blocks[1]
    np.testing.assert_array_equal(blk.attn.wq.numpy(), np.asarray(unit["attn"]["wq"][1]))
    np.testing.assert_array_equal(blk.attn.q_norm.scale.numpy(),
                                  np.asarray(unit["attn"]["q_norm"]["scale"][1]))
    np.testing.assert_array_equal(blk.mlp.w_out.numpy(),
                                  np.asarray(unit["mlp"]["w_out"]["w"][1]))
    half = tparams.compute(torch.bfloat16)
    assert half is tparams.compute(torch.bfloat16)           # made once
    assert half.blocks[1].ln1.scale.dtype == torch.float32    # norms stay float32
    np.testing.assert_array_equal(
        half.embed.to(torch.float32).numpy(),
        np.asarray(jparams["embed"]["table"].astype(jnp.bfloat16), np.float32))
    # the RG-LRU's gates are read in float32, so the compute copy shares them
    _, jparams, tparams = _weights("recurrentgemma-2b")
    rec = tparams.blocks[4].rec                                # the second tail block
    np.testing.assert_array_equal(rec.gates.w_a.numpy(),
                                  np.asarray(jparams["tail"][1]["rec"]["gates"]["w_a"]))
    np.testing.assert_array_equal(tparams.blocks[1].rec.conv.numpy(),   # unit 0, position 1
                                  np.asarray(jparams["units"]["1"]["rec"]["conv"][0]))
    half = tparams.compute(torch.bfloat16).blocks[4].rec
    assert half.gates.w_a.dtype == getattr(half, "lambda").dtype == torch.float32
    assert half.gates.w_a.data_ptr() == rec.gates.w_a.data_ptr()       # shared, not copied
    assert half.w_x.dtype == half.conv.dtype == torch.bfloat16
    # deepseek-moe-16b: an expert's slice of the stacked experts, the leading
    # dense layer, and a router that stays float32 when the weights are
    # stored in bf16 (the compute copy is then the weights themselves)
    _, jparams, tparams = _weights("deepseek-moe-16b")
    unit = jparams["units"]["0"]["moe"]
    np.testing.assert_array_equal(tparams.blocks[1].moe.w_in[3].numpy(),
                                  np.asarray(unit["w_in"][1, 3]))
    np.testing.assert_array_equal(tparams.blocks[0].moe.shared.w_out.numpy(),
                                  np.asarray(unit["shared"]["w_out"]["w"][0]))
    np.testing.assert_array_equal(tparams.head_layers[0].mlp.w_gate.numpy(),
                                  np.asarray(jparams["head_layers"][0]["mlp"]["w_gate"]["w"]))
    stored = interop.lm_params_from_numpy(reduced("deepseek-moe-16b"),
                                          jax.tree.map(np.asarray, jparams), "cpu",
                                          torch.bfloat16)
    assert stored.compute(torch.bfloat16) is stored
    router = stored.blocks[1].moe.router
    assert router.dtype == torch.float32 and stored.blocks[1].moe.w_in.dtype == torch.bfloat16
    np.testing.assert_array_equal(router.numpy(), np.asarray(unit["router"]["w"][1]))
    built = build_model(reduced("deepseek-moe-16b"), param_dtype=torch.bfloat16,
                        device="cpu").init(0)
    assert built.blocks[0].moe.router.dtype == torch.float32
    assert built.head_layers[0].mlp.w_in.dtype == torch.bfloat16


def test_unported_archs_and_training_raise():
    assert list_archs() == sorted(ARCHS)
    for name in ("xlstm-125m", "whisper-medium", "qwen2-vl-72b"):
        with pytest.raises(NotImplementedError, match="item 16"):
            get_arch(name)
        with pytest.raises(NotImplementedError, match="item 16"):
            reduced(name)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    cfg = reduced("qwen3-4b")
    for change in (dict(block_pattern=("mlstm", "slstm")), dict(rope="mrope"),
                   dict(enc_dec=True)):
        with pytest.raises(NotImplementedError, match="item 16"):
            build_model(dataclasses.replace(cfg, **change), device="cpu")
    m = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        m.loss_fn(m.init(0), {})


def test_profile_serve_runs_on_the_cpu():
    from repro_torch.launch import profile_serve

    for arch, n_layers, param_dtype in (("smollm-360m", 2, torch.float32),
                                        ("recurrentgemma-2b", 5, torch.float32),
                                        ("deepseek-moe-16b", 3, torch.bfloat16)):
        out = profile_serve.profile_serve(arch=arch, batch=2, prompt_len=12,
                                          decode_steps=2, device="cpu",
                                          param_dtype=param_dtype)
        assert out["layers"] == n_layers and out["decode"]["steps"] == 2
        for phase in ("prefill", "decode"):
            assert out[phase]["wall_ms"] > 0 and out[phase]["device_ms"] is None
