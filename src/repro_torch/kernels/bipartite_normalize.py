"""Triton scale-apply kernel of the bipartite normalization.

Replaces ``scale_apply_pallas`` (``src/repro/kernels/bipartite_normalize.py:35``):
``out = A * s1[:, None] * s2[None, :]`` per block of a ``(B, M, N)`` stack,
with ``s1 = rsqrt(max(d1, eps))`` and ``s2 = rsqrt(max(d2, eps))`` computed
by the caller (``ops.bipartite_normalize`` needs those vectors anyway, and
``torch.rsqrt`` there keeps the result bit-equal to the plain formula; the
kernel never uses Triton's approximate rsqrt).

Bound on an H100: bytes. One read and one write of the stack — at the LAMC
atom shape (128, 8192, 2048) float32 that is 17.2 GB, ~5.1 ms at 3.35 TB/s —
against one multiply pair per element. The work is a pure elementwise pass
with two broadcast vectors: no reuse, no tensor-core work, nothing to stage
in shared memory, so Triton's masked 2-D blocks with 16-byte vector loads
meet the bound as well as CUDA C++ would. Offsets are 64-bit: the stack
holds 2^31 elements at that shape.

``triton`` is imported inside the launching function: the module must import
on machines without it.
"""

from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["scale_apply", "BLOCK_M", "BLOCK_N", "NUM_WARPS"]

BLOCK_M = 16
BLOCK_N = 256
NUM_WARPS = 4

#: Launches of the kernel since the counter was last set to 0.
launches = 0


@functools.cache
def triton_kernel():
    """``(triton, the @triton.jit scale-apply kernel)``, defined at first use."""
    import triton
    import triton.language as tl

    @triton.jit
    def scale_apply_kernel(a_ptr, s1_ptr, s2_ptr, out_ptr, M, N,
                           BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr):
        pid_m = tl.program_id(0)
        pid_n = tl.program_id(1)
        b = tl.program_id(2).to(tl.int64)
        rows = pid_m * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = pid_n * BLOCK_N + tl.arange(0, BLOCK_N)
        rmask = rows < M
        cmask = cols < N
        s1 = tl.load(s1_ptr + b * M + rows, mask=rmask)
        s2 = tl.load(s2_ptr + b * N + cols, mask=cmask)
        offs = b * M * N + rows.to(tl.int64)[:, None] * N + cols[None, :]
        mask = rmask[:, None] & cmask[None, :]
        a = tl.load(a_ptr + offs, mask=mask)
        tl.store(out_ptr + offs, (a * s1[:, None]) * s2[None, :], mask=mask)

    return triton, scale_apply_kernel


def scale_apply(a: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
    """``a (B, M, N) * s1 (B, M)[..., None] * s2 (B, N)[..., None, :]`` by
    the Triton kernel, into a new tensor."""
    # repro: allow[R3] the launch counter of ops.launch_counts (host-side launches)
    global launches
    if a.ndim != 3:
        raise ValueError(f"expected a (B, M, N), got {tuple(a.shape)}")
    b, m, n = a.shape
    if tuple(s1.shape) != (b, m) or tuple(s2.shape) != (b, n):
        raise ValueError(f"scales {tuple(s1.shape)}, {tuple(s2.shape)} do not "
                         f"match a {tuple(a.shape)}")
    for name, t in (("a", a), ("s1", s1), ("s2", s2)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{name} must lie on a's CUDA device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if b > 65535:
        raise ValueError(f"at most 65535 blocks per launch, got {b}")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    triton, kernel = triton_kernel()
    grid = (triton.cdiv(m, BLOCK_M), triton.cdiv(n, BLOCK_N), b)
    with torch.cuda.device(a.device):
        binary = kernel[grid](a, s1, s2, out, m, n, BLOCK_M=BLOCK_M, BLOCK_N=BLOCK_N,
                              num_warps=NUM_WARPS)
    _build.note_triton_launch(binary)
    launches += 1
    return out
