"""MiniCPM-2B. [arXiv:2404.06395; hf]

Llama-like dense arch (MHA, 36 heads); trained with the WSD schedule —
provided in optim/schedule.py and used by examples/train_lm.py. The odd
vocab (122753) is padded to 122880 for mesh divisibility (see
runtime/shardings.pad_vocab; logits for pad ids are masked at -inf).
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    rope="standard",
    norm="rmsnorm",
    act="silu",
    source="arXiv:2404.06395",
    notes="WSD schedule; vocab padded 122753->122880 for sharding",
)

REDUCED = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=253,  # odd on purpose: exercises vocab padding
)

register(FULL, REDUCED)
