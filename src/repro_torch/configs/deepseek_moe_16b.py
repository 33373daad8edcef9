"""DeepSeekMoE 16B. [arXiv:2401.06066; hf]

Fine-grained experts: 64 routed (top-6) + 2 shared, expert ff width 1408;
the first layer is a dense MLP (width 10944) per the released config.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    n_dense_layers=1,
    dense_d_ff=10_944,
    rope="standard",
    norm="rmsnorm",
    act="silu",
    source="arXiv:2401.06066",
    notes="2 shared + 64 routed top-6, fine-grained; first layer dense",
)

REDUCED = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    n_experts=8,
    n_shared_experts=2,
    experts_per_token=2,
    moe_d_ff=48,
    n_dense_layers=1,
    dense_d_ff=128,
    capacity_factor=8.0,  # reduced config: no dropping, so prefill->decode
                          # consistency tests isolate cache correctness
)

register(FULL, REDUCED)
