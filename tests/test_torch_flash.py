"""The flash-attention plain version against the reference, on the CPU.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors runs
``ref.flash_attention_ref``, the plain version of the CUDA kernel, which walks
the reference's KV chunks. It is held against the reference's
``ops.flash_attention`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it), the reference's exact
``ref.attention_ref`` and its ``chunked_causal_attention`` with a window and a
query offset. All get the same numpy inputs.

Tolerances: float32 within 1e-5 absolute (the outputs are weighted means of
N(0, 1) values; the two sides add the same terms in another order, which
moves them by about 1e-7). bf16 within 2e-2, the reference's own tolerance
for its bf16 kernel test: each output is rounded to bf16 (8 bits) on both
sides from float32 values that differ in the last bits, so one rounding step
(up to 2^-7 of the value) can separate them. The CUDA kernel itself is held
against this plain version on the card (``test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

F32_ATOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_code():
    """Give back the memory mappings of this module's compiled JAX code, so
    an xdist worker that also runs the reference's fuzz cases stays under
    ``vm.max_map_count``."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) \
        else t.to(torch.float32).numpy()


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,tile,dtype", [
    (1, 2, 2, 32, 32, True, 32, "f32"),
    (1, 2, 2, 64, 32, True, 32, "f32"),
    (1, 2, 2, 100, 32, True, 32, "f32"),
    (1, 2, 2, 160, 32, True, 32, "f32"),
    (1, 2, 2, 96, 32, False, 32, "f32"),          # non-causal
    (2, 8, 2, 64, 16, True, 32, "f32"),           # GQA 8/2
    (1, 1, 1, 100, 32, True, 64, "f32"),          # unaligned seq, tile 64
    (1, 2, 2, 64, 32, True, 32, "bf16"),
    (1, 36, 36, 32, 64, True, 32, "f32"),         # Dh 64 at 36/36 heads
    (1, 32, 2, 32, 128, True, 32, "bf16"),        # chatglm3's 32/2 heads, Dh 128
], ids=["s32", "s64", "s100", "s160", "noncausal", "gqa8_2", "unaligned", "bf16",
        "dh64_36_36", "chatglm3_32_2"])
def test_plain_flash_matches_reference_kernel(b, hq, hkv, s, d, causal, tile, dtype):
    q, k, v = _qkv(b * 10 + s, b, hq, hkv, s, s, d)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jops.flash_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                causal=causal, tile_q=tile, tile_k=tile)
    ops.reset_launch_counts()
    got = ops.flash_attention(*_torch((q, k, v), tdt), causal=causal)
    assert got.dtype == tdt and got.shape == (b, hq, s, d)
    tol = F32_ATOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    assert ops.launch_counts()["flash_attention"] == 0     # CPU tensors: no launch
    assert flash.launches == 0


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_exact_attention(causal):
    b, hq, hkv, s, d = 2, 6, 3, 77, 24
    q, k, v = _qkv(5, b, hq, hkv, s, s, d)
    rep = hq // hkv
    kk = np.repeat(k, rep, 1).reshape(b * hq, s, d)
    vv = np.repeat(v, rep, 1).reshape(b * hq, s, d)
    want = jref.attention_ref(jnp.asarray(q.reshape(b * hq, s, d)), jnp.asarray(kk),
                              jnp.asarray(vv), causal=causal)
    got = ref.flash_attention_ref(*_torch((q, k, v)), causal=causal, chunk_size=32)
    np.testing.assert_allclose(_np(got).reshape(b * hq, s, d), _np(want), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("sq,skv,window,q_offset,chunk,hq,hkv,d", [
    (37, 100, 16, 63, 32, 4, 2, 16),      # prefill continuation: the last 37 positions
    (64, 64, 8, 0, 16, 4, 2, 16),         # sliding window
    (40, 130, 0, 90, 64, 4, 2, 16),       # offset, no window, ragged chunks
    (20, 50, 8, 200, 32, 4, 2, 16),       # every key outside the window: rows with no live key
    (48, 48, 16, 0, 16, 10, 1, 256),      # recurrentgemma-2b's local attention: MQA, Dh 256
], ids=["continuation", "window", "offset", "no_live_key", "mqa_dh256_window"])
def test_plain_flash_matches_reference_chunked_attention(sq, skv, window, q_offset, chunk,
                                                         hq, hkv, d):
    q, k, v = _qkv(sq + skv, 1, hq, hkv, sq, skv, d)
    want = jattention.chunked_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), chunk_size=chunk, window=window,
        q_offset=q_offset)
    ops.reset_launch_counts()
    got = attention.chunked_causal_attention(*_torch((q, k, v)), chunk_size=chunk,
                                             window=window, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    assert ops.launch_counts()["flash_attention"] == 0


def test_rows_with_no_live_key_take_the_sentinel_value():
    """The reference's -1e30 sentinel gives a row with no live key weight 1 on
    every key of every chunk, its zero padding included (not -inf, not NaN)."""
    q, k, v = _qkv(3, 1, 2, 2, 5, 50, 8)
    got = ref.flash_attention_ref(*_torch((q, k, v)), window=4, q_offset=100,
                                  chunk_size=32)
    want = v.sum(axis=2, keepdims=True) / flash.dead_row_count(50, 32)
    np.testing.assert_allclose(_np(got), np.broadcast_to(want, got.shape), rtol=1e-6,
                               atol=1e-7)
    assert flash.dead_row_count(50, 32) == 64


def test_kv_len_masks_the_tail():
    """``kv_len`` masks keys at and past it: the same as cutting them off."""
    q, k, v = _qkv(4, 1, 4, 2, 30, 30, 16)
    tq, tk, tv = _torch((q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False, kv_len=17)
    want = ops.flash_attention(tq, tk[:, :, :17], tv[:, :, :17], causal=False)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_ATOL)


def test_flash_rejects_mismatched_heads():
    q, k, v = _torch(_qkv(1, 1, 3, 2, 8, 8, 4))
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q, k, v)
