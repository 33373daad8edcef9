"""SmolLM-360M. [hf:HuggingFaceTB/SmolLM-360M; hf]

Llama-architecture small model. 15 heads / 5 KV heads do not divide the
model-axis 16 — the sharding policy replicates attention heads and keeps
TP on d_ff/vocab (runtime/shardings.py).
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    rope="standard",
    norm="rmsnorm",
    act="silu",
    source="hf:HuggingFaceTB/SmolLM-360M",
)

REDUCED = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=2,
    d_model=60,
    n_heads=3,
    n_kv_heads=1,
    d_ff=160,
    vocab_size=256,
)

register(FULL, REDUCED)
