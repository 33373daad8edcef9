"""RecurrentGemma-2B (Griffin). [arXiv:2402.19427; hf]

Hybrid: repeating (RG-LRU, RG-LRU, local-attention) unit — 1 attention per
2 recurrent blocks; local window 2048; MQA (kv=1). Sub-quadratic decode
state, so the long_500k cell runs for this arch.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    window=2048,
    block_pattern=("rglru", "rglru", "local"),
    rope="standard",
    norm="rmsnorm",
    act="gelu",
    source="arXiv:2402.19427",
    notes="RG-LRU + local attn 1:2; window 2048; 26 = 8 units + 2 tail rglru",
)

REDUCED = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    d_ff=192,
    vocab_size=256,
    head_dim=32,
    window=16,
    block_pattern=("rglru", "rglru", "local"),
    act="gelu",
)

register(FULL, REDUCED)
