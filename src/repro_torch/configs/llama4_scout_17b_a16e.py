"""Llama-4 Scout 17B-active / 16 experts. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

MoE with 16 routed experts, top-1 routing, plus one shared expert (Scout's
published layout); early-fusion multimodality is out of scope for the LM
backbone cells (text path only).
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    n_experts=16,
    n_shared_experts=1,
    experts_per_token=1,
    moe_d_ff=8192,
    rope="standard",
    norm="rmsnorm",
    act="silu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
    notes="MoE top-1, 1 shared expert; early fusion frontend not modeled",
)

REDUCED = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    n_experts=4,
    n_shared_experts=1,
    experts_per_token=1,
    moe_d_ff=128,
    rope="standard",
)

register(FULL, REDUCED)
