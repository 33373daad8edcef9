"""Wrapper of the CUDA flash-attention forward kernel (``csrc/flash_attention.cu``).

Replaces ``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:84``)
and computes the function of the reference's ``chunked_causal_attention``
(``src/repro/models/attention.py:37``): softmax attention of ``q (B, Hq, Sq,
Dh)`` over ``k, v (B, Hkv, Skv, Dh)`` with the ``-1e30`` mask sentinel, causal
or not, with a ``kv_len`` mask, a sliding ``window`` and a ``q_offset``. GQA
heads read their kv head directly; nothing is padded. The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between them by the
tensor's device.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention", "dead_row_count", "ROUTES"]

#: Launches of the kernel since the counter was last set to 0.
launches = 0

#: The two kernels of ``csrc/flash_attention.cu``, as ``flash_route`` numbers them.
ROUTES = ("f32_pipe", "wgmma")

#: The kernel the last launch took (the library's own routing rule).
last_route: str | None = None

_DTYPES = (torch.float32, torch.bfloat16)


def dead_row_count(skv: int, chunk_size: int) -> int:
    """The reference's normalizer of a row with no live key: ``Skv`` keys
    padded to a multiple of its chunk size, each weighted ``exp(0) = 1``."""
    return -(-skv // chunk_size) * chunk_size


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None, window: int = 0,
                    q_offset: int = 0, chunk_size: int = 1024) -> torch.Tensor:
    """``o (B, Hq, Sq, Dh)`` in q's dtype, computed by the CUDA kernel.

    ``chunk_size`` is the reference's KV chunk; it sets only the value of a
    row with no live key (see ``dead_row_count``). Empty inputs return
    without a launch (an empty grid is an error)."""
    # repro: allow[R3] the launch counter and route of ops.launch_counts (host-side launches)
    global launches, last_route
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hkv < 1 or hq % hkv:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)} "
                         f"(Hq must be a multiple of Hkv)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 or bfloat16, like q")
    kv_len = skv if kv_len is None else int(kv_len)
    lib = _build.load("flash_attention")
    if not (1 <= dh <= lib.flash_max_head_dim() and 0 <= kv_len <= skv
            and window >= 0 and q_offset >= 0 and b * hq <= 65535
            and q_offset + sq < 2**31 and chunk_size >= 1):
        raise ValueError(f"kernel takes Dh <= {lib.flash_max_head_dim()}, 0 <= kv_len <= "
                         f"Skv, window >= 0, q_offset >= 0, B*Hq <= 65535; got Dh={dh} "
                         f"kv_len={kv_len} Skv={skv} window={window} q_offset={q_offset} "
                         f"B*Hq={b * hq}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:    # no key at all: the reference's accumulator stays 0
        return out.zero_()
    bf16 = int(q.dtype == torch.bfloat16)
    route = ROUTES[lib.flash_route(bf16, dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr())]
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bf16, b, hq, hkv, sq, skv, dh, int(causal), kv_len,
            window, q_offset, float(dead_row_count(skv, chunk_size)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_error_string(err).decode()}")
    launches += 1
    last_route = route
    return out
