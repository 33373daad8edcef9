"""Device placement, float32 policy and seeded generators for the port.

Entry points take ``device="cuda"`` by default: the port is meant to run on
the card, and a machine without one has to ask for the CPU explicitly
(``device="cpu"``, as the tests do) instead of being moved there quietly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "fp32_policy", "seeded_generator"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fp32_policy() -> None:
    """Keep every float32 product in full float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def seeded_generator(device: torch.device, *words: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integer ``words``.

    The words name one random stream (for example ``(plan.seed, stream,
    resample)``); ``np.random.SeedSequence`` mixes them so neighbouring
    streams are independent.
    """
    seed = int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0]) & (2**63 - 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
