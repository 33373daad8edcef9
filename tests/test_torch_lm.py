"""The LM serving path against the reference, on the CPU, with the reference's
weights injected.

Reduced configs of the four dense archs the port runs (qwen3-4b: GQA with
qk_norm; smollm-360m: 3/1 heads of width 20; minicpm-2b: MHA, odd vocab;
chatglm3-6b: half-dim RoPE). The reference's ``model.init`` tree goes through
``interop.lm_params_from_numpy``; the same numpy tokens go through both
packages' ``forward_full``, ``prefill``, ``grow_cache`` and ``decode_step``.

Tolerances, each relative to the largest |value| of the reference's tensor:

* float32 compute: 1e-4. The two sides add the same products in another
  order (ATen's and XLA's CPU matmuls, the flash plain version's chunks),
  which moves two-layer logits by at most 1.8e-6 of their scale (measured).
* bf16 compute: ``BF16_TOL`` = 3e-2, measured on these configs at 1.7e-2 at
  most (logits, hidden states and caches). bf16 keeps 8 bits, and XLA's CPU
  fusions keep some intermediates in float32 where ATen rounds each op to
  bf16, so single elements differ by a few bf16 steps.
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
from repro.models import transformer as jtransformer
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, layers, transformer

ARCHS = ["qwen3-4b", "smollm-360m", "minicpm-2b", "chatglm3-6b"]
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
        grown = {"units": [{k: v.clone() for k, v in port["grown"]["units"][0].items()}]}
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
    for leaf in ("k", "v"):
        _close(port["caches"]["units"][0][leaf], ref["caches"]["units"][0][leaf], tol,
               f"prefill cache {leaf}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grow_cache_and_decode_match_reference(arch, dt):
    ref, port = _runs(arch, dt)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    for leaf in ("k", "v"):
        assert port["grown"]["units"][0][leaf].shape[-2] == MAX_LEN
        _close(port["grown"]["units"][0][leaf], ref["grown"]["units"][0][leaf], tol,
               f"grown cache {leaf}")
        _close(port["after"]["units"][0][leaf], ref["after"]["units"][0][leaf], tol,
               f"cache after decode {leaf}")
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


@pytest.mark.parametrize("arch", ARCHS)
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
    out = serve.generate(arch="qwen3-4b", batch=2, prompt_len=10, gen_len=4, device="cpu")
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


def test_unported_archs_and_training_raise():
    assert list_archs() == sorted(ARCHS)
    for name in ("deepseek-moe-16b", "recurrentgemma-2b", "xlstm-125m", "whisper-medium",
                 "qwen2-vl-72b", "llama4-scout-17b-a16e"):
        with pytest.raises(NotImplementedError, match="item 16"):
            get_arch(name)
        with pytest.raises(NotImplementedError, match="item 16"):
            reduced(name)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    cfg = reduced("qwen3-4b")
    for change in (dict(n_experts=4, experts_per_token=2), dict(block_pattern=("local",)),
                   dict(rope="mrope"), dict(enc_dec=True), dict(n_dense_layers=1)):
        with pytest.raises(NotImplementedError, match="item 16"):
            build_model(dataclasses.replace(cfg, **change), device="cpu")
    m = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        m.loss_fn(m.init(0), {})


def test_profile_serve_runs_on_the_cpu():
    from repro_torch.launch import profile_serve

    out = profile_serve.profile_serve(arch="smollm-360m", batch=2, prompt_len=12,
                                      decode_steps=2, device="cpu")
    assert out["layers"] == 2 and out["decode"]["steps"] == 2
    for phase in ("prefill", "decode"):
        assert out[phase]["wall_ms"] > 0 and out[phase]["device_ms"] is None
