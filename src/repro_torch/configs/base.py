"""Architecture + shape configuration system (the port's own copy).

Every architecture the port runs is a frozen ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``) with the reference's ``FULL`` and ``REDUCED``
values, registered by name for ``--arch <id>`` selection. Shape cells
(train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeConfig``s;
``cells()`` enumerates the live (arch x shape) grid with the long_500k skip
for full-attention archs. The reference registers more architectures; the
port registers only those whose path it runs, and names the others in
``NOT_PORTED``: asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "NOT_PORTED", "register", "get_arch",
           "list_archs", "cells", "reduced", "param_count", "active_param_count"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert ff width (0 -> d_ff)
    n_dense_layers: int = 0        # leading dense layers (deepseek style)
    dense_d_ff: int = 0            # ff width of those dense layers
    capacity_factor: float = 1.25  # MoE dispatch overflow margin
    # --- attention / positional ---
    rope: str = "standard"         # standard | half (2d) | mrope
    qk_norm: bool = False
    window: int = 0                # sliding-window size for local attention
    block_pattern: tuple[str, ...] = ("attn",)  # repeating unit; see transformer.py
    # --- misc ---
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 0           # fixed encoder length (whisper frames)
    frontend: str = "none"         # none | frames | patches (stub embeddings)
    frontend_len: int = 0          # stub positions prepended/provided
    tie_embeddings: bool = True
    notes: str = ""
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1)/O(window) in sequence length —
        the long_500k eligibility criterion."""
        return self.family in ("hybrid", "ssm")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline
        MODEL_FLOPS and memory sanity checks."""
        d, hd = self.d_model, self.head_dim_
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d

        def mlp_p(ff):
            return 3 * d * ff  # gated: w_in, w_gate, w_out

        total = self.vocab_size * d  # embedding (tied head)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        pattern = self.block_pattern
        for li in range(self.n_layers):
            kind = pattern[li % len(pattern)]
            if kind in ("attn", "local"):
                total += attn
            elif kind == "rglru":
                d_rnn = self.d_ff // 3  # lru width heuristic (see rglru.py)
                total += 2 * d * d_rnn + 4 * d_rnn  # in/out proj + gates
            elif kind == "mlstm":
                total += 5 * d * d  # q,k,v,o,skip projections
            elif kind == "slstm":
                h = max(self.n_heads, 1)
                total += 6 * d * d + 4 * d * d // h  # 4 gates (+recurrent) + out + skip
            if kind in ("attn", "local", "rglru"):
                if self.is_moe and li >= self.n_dense_layers:
                    ff = self.moe_d_ff or self.d_ff
                    total += self.n_experts * mlp_p(ff)
                    total += self.n_shared_experts * mlp_p(ff)
                    total += d * self.n_experts  # router
                elif self.d_ff > 0:
                    ff = self.dense_d_ff if (self.is_moe and li < self.n_dense_layers) else self.d_ff
                    total += mlp_p(ff)
        if self.enc_dec:
            # encoder blocks + decoder cross-attention
            total += self.n_enc_layers * (attn + mlp_p(self.d_ff))
            total += self.n_layers * attn  # cross-attn per decoder layer
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-to experts) — the N
        in MODEL_FLOPS = 6*N_active*D for MoE archs."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        per_expert = 3 * d * ff
        inactive = (self.n_experts - self.experts_per_token) * per_expert
        layers_moe = self.n_layers - self.n_dense_layers
        return self.param_count() - layers_moe * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, ArchConfig] = {}

_ARCH_MODULES = [
    "chatglm3_6b",
    "smollm_360m",
    "minicpm_2b",
    "qwen3_4b",
    "recurrentgemma_2b",
    "deepseek_moe_16b",
    "llama4_scout_17b_a16e",
]

#: The reference's other registered architectures: their blocks (xLSTM,
#: encoder-decoder, M-RoPE) or workloads are not ported yet.
NOT_PORTED = ("qwen2-vl-72b", "xlstm-125m", "whisper-medium", "lamc-coclustering")


def register(cfg: ArchConfig, reduced_cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced_cfg
    return cfg


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__package__}.{mod}")


def _lookup(table: dict[str, ArchConfig], name: str) -> ArchConfig:
    _load_all()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP queue 1, item 16); "
            f"the port runs {sorted(_REGISTRY)}")
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return table[name]


def get_arch(name: str) -> ArchConfig:
    return _lookup(_REGISTRY, name)


def reduced(name: str) -> ArchConfig:
    """CPU-smoke-test-sized config of the same family."""
    return _lookup(_REDUCED, name)


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def cells(include_skipped: bool = False):
    """The (arch x shape) grid of the ported archs. Yields (arch, shape, live, why)."""
    _load_all()
    for name in _ARCH_MODULES:
        cfg = _REGISTRY[name.replace("_", "-")]
        for shape in SHAPES.values():
            live, why = True, ""
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                live, why = False, ("full-attention arch: 512k decode needs "
                                    "sub-quadratic attention")
            if live or include_skipped:
                yield cfg, shape, live, why


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (embedding + blocks): ``cfg.param_count()``."""
    return cfg.param_count()


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token: ``cfg.active_param_count()``."""
    return cfg.active_param_count()
