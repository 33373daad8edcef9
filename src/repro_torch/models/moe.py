"""Mixture-of-Experts layer: top-k routing, per-row capacity, grouped expert
products, shared experts, the Switch-style load-balance loss.

Mirrors the reference's ``src/repro/models/moe.py``:

* routing in float32: softmax of ``x @ router``, the ``top_k`` largest
  probabilities (ties to the lower expert index, as ``lax.top_k`` breaks
  them), renormalized by ``max(sum, 1e-9)``;
* capacity per sequence row, ``C = ceil(S * top_k / E * capacity_factor)``:
  a (token, k) pair's slot is its rank among the row's pairs routed to the
  same expert in row-major (s, k) order, and pairs with slot >= C are
  dropped (add nothing);
* the experts as grouped products over a ``(B, E, C, d)`` buffer, then the
  shared experts' MLP added.

The reference dispatches and combines through one-hot einsums (so that GSPMD
partitions them); here each kept pair is scattered into its buffer slot and
its expert output gathered back by index, which gives the same values (the
slots are unique) without the ``2 B S E C d`` products of the one-hot form.
The combine weights each gathered output by its gate rounded to the compute
dtype and sums over k in float32, as the reference's einsum accumulates.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from . import layers

__all__ = ["MoE", "row_capacity", "moe_apply", "count_dropped"]


def row_capacity(seq_len: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    return max(1, math.ceil(seq_len * top_k / n_experts * capacity_factor))


class MoE(nn.Module):
    """``router (d, E)`` (always float32), ``w_in``/``w_gate (E, d, ff)``,
    ``w_out (E, ff, d)`` and, with shared experts, ``shared``: a gated MLP of
    width ``ff * n_shared``. Scales as the reference's ``moe_init``."""

    def __init__(self, d: int, d_ff: int, n_experts: int, n_shared: int, *,
                 dtype=torch.float32, device=None, gen=None):
        super().__init__()
        w = layers._weight
        self.router = w((d, n_experts), d ** -0.5, torch.float32, device, gen)
        self.w_in = w((n_experts, d, d_ff), d ** -0.5, dtype, device, gen)
        self.w_gate = w((n_experts, d, d_ff), d ** -0.5, dtype, device, gen)
        self.w_out = w((n_experts, d_ff, d), d_ff ** -0.5, dtype, device, gen)
        if n_shared > 0:
            self.shared = layers.MLP(d, d_ff * n_shared, dtype=dtype, device=device, gen=gen)


_DROPPED: list | None = None


@contextlib.contextmanager
def count_dropped():
    """Collect, for each ``moe_apply`` call inside, the number of (token, k)
    pairs its capacity dropped, as a 0-dim device tensor (read after the
    block: nothing synchronizes inside)."""
    global _DROPPED
    outer, _DROPPED = _DROPPED, []
    try:
        yield _DROPPED
    finally:
        _DROPPED = outer


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns ``(out (B, S, d), aux_loss scalar)``."""
    b, s, d = x.shape
    e = p.w_in.shape[0]
    c = row_capacity(s, top_k, e, capacity_factor)

    # routing (float32); a stable descending sort puts equal probabilities
    # in index order
    probs = torch.softmax(x.to(torch.float32) @ p.router, dim=-1)       # (B, S, E)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :top_k], experts[..., :top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style)
    first = nn.functional.one_hot(experts[..., 0], e).to(torch.float32)
    aux = e * torch.sum(probs.mean(dim=(0, 1)) * first.mean(dim=(0, 1)))

    # per-row slots: each (token, k) pair's rank among the row's pairs routed
    # to its expert, in row-major (s, k) order; the running counts are
    # scanned along the innermost axis (an outer-axis scan is many times
    # slower on the card)
    flat = experts.reshape(b, 1, s * top_k)
    onehot = nn.functional.one_hot(flat[:, 0], e).to(torch.int32).transpose(1, 2)
    rank = torch.cumsum(onehot.contiguous(), dim=-1, dtype=torch.int32)  # (B, E, S*K)
    slots = (rank.gather(1, flat) - 1).reshape(b, s, top_k)
    keep = slots < c
    if _DROPPED is not None:
        _DROPPED.append((~keep).sum())

    # dispatch: each kept pair's token into its expert's slot; the dropped
    # ones into a spare slot C that is cut off (no data-dependent shape, so
    # no host sync)
    rows = torch.arange(b, device=x.device)[:, None, None]
    slots = slots.clamp_max(c)
    buf = x.new_zeros((b, e, c + 1, d))
    buf[rows, experts, slots] = x[:, :, None, :].expand(b, s, top_k, d)
    buf = buf[:, :, :c]

    h = torch.einsum("becd,edf->becf", buf, p.w_in.to(x.dtype))
    g = torch.einsum("becd,edf->becf", buf, p.w_gate.to(x.dtype))
    g = layers.silu(g) if act == "silu" else layers.gelu(g)
    out_buf = torch.einsum("becf,efd->becd", h * g, p.w_out.to(x.dtype))

    # combine: every pair's slot output, weighted by its rounded gate (0 where
    # dropped), summed over k in float32
    weights = torch.where(keep, gates.to(x.dtype).to(torch.float32), 0.0)
    rows, slots = rows[..., 0], slots.clamp_max(c - 1)
    out = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    for k in range(top_k):
        picked = out_buf[rows, experts[..., k], slots[..., k]]
        out += weights[..., k, None] * picked.to(torch.float32)
    out = out.to(x.dtype)
    if hasattr(p, "shared"):
        out = out + layers.mlp(p.shared, x, act=act)
    return out, aux
