"""Qwen3-4B. [hf:Qwen/Qwen3-4B; hf]

GQA kv=8 with QK-RMSNorm (qk_norm) and head_dim 128.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope="standard",
    norm="rmsnorm",
    act="silu",
    source="hf:Qwen/Qwen3-8B family",
)

REDUCED = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
)

register(FULL, REDUCED)
