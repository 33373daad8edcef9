"""ChatGLM3-6B. [arXiv:2406.12793; hf]

GQA with 2 KV heads; 2D RoPE (rotary on the first half of the head dim).
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    rope="half",
    norm="rmsnorm",
    act="silu",
    source="arXiv:2406.12793",
    notes="RoPE 2d (half-dim rotation), GQA kv=2",
)

REDUCED = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    rope="half",
)

register(FULL, REDUCED)
