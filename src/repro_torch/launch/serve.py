"""LM serving launcher: batched prefill, then a decode loop over KV caches.

``python -m repro_torch.launch.serve --arch qwen3-4b --full-config`` serves
the full qwen3-4b on the card (random weights from ``seed``); ``--arch
deepseek-moe-16b --full-config --param-dtype bfloat16`` the full
deepseek-moe-16b, whose float32 masters (16.2 B parameters) would not fit
the card, with its weights stored in bf16 (the same bits: the reference
casts each matrix to the compute dtype at every use); ``--device cpu`` runs
a reduced config on the CPU. As the reference's
``src/repro/launch/serve.py``: prompts are drawn with
``np.random.default_rng(seed)`` (so they are the reference's prompts), the
prefill fills the caches, ``grow_cache`` makes them decode buffers of
``prompt_len + gen_len`` (in its default bf16, as the reference calls it),
and each decode step takes the argmax (or a sample) of the last logits.
Every prefill attention layer goes through the flash kernel on the card.

Parameters come from a ``torch.Generator`` seeded from ``seed``; JAX's
threefry bits cannot be reproduced, so ``_generate`` takes the model, its
weights and the prompts, and the tests inject the reference's weights
(``interop.lm_params_from_numpy``). Times are host clock around work that
ends in a device synchronization.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs.base import get_arch, reduced
from ..models import Model, build_model, transformer

__all__ = ["PARAM_DTYPES", "generate", "main"]

#: ``--param-dtype`` choices.
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def _generate(model: Model, params, prompts: torch.Tensor, gen_len: int, *,
              greedy: bool = True, seed: int = 0) -> dict:
    """Serve ``prompts (B, prompt_len)`` for ``gen_len`` tokens: the first from
    the prefill's last logits, the rest from decode steps."""
    cfg, dev = model.cfg, model.device
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen_len
    _sync(dev)
    t0 = time.perf_counter()
    last_logits, caches = model.prefill(params, prompts)
    cache = transformer.grow_cache(cfg, caches, prompt_len, max_len)
    del caches
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    finite = torch.isfinite(last_logits).all()
    tok = torch.argmax(last_logits, -1)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, tok, cache, prompt_len + i)
        finite &= torch.isfinite(logits).all()
        if greedy:
            tok = torch.argmax(logits, -1)
        else:
            probs = torch.softmax(logits.to(torch.float32), -1)
            tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
        out_tokens.append(tok)
    seqs = torch.stack(out_tokens, dim=1)                    # (B, gen)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "tokens": seqs.to(torch.int32).cpu().numpy(),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tokens_per_s": batch * (gen_len - 1) / max(decode_s, 1e-9),
        "logits_finite": bool(finite),
    }


def generate(*, arch: str, batch: int, prompt_len: int, gen_len: int,
             use_reduced: bool = True, seed: int = 0, greedy: bool = True,
             device: str | torch.device = "cuda", param_dtype=torch.float32) -> dict:
    """Serve random prompts through ``arch`` with random weights, stored in
    ``param_dtype`` (float32 masters by default)."""
    cfg = reduced(arch) if use_reduced else get_arch(arch)
    model = build_model(cfg, param_dtype=param_dtype, device=device)
    params = model.init(seed)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                              dtype=torch.long, device=model.device)
    return _generate(model, params, prompts, gen_len, greedy=greedy, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", choices=sorted(PARAM_DTYPES), default="float32",
                    help="how the weights are stored (bfloat16 to serve a model whose "
                         "float32 masters do not fit)")
    args = ap.parse_args(argv)
    out = generate(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
                   gen_len=args.gen, use_reduced=not args.full_config,
                   greedy=not args.sample, device=args.device,
                   param_dtype=PARAM_DTYPES[args.param_dtype])
    print(json.dumps({
        "batch": args.batch, "gen": args.gen,
        "prefill_s": round(out["prefill_s"], 3),
        "decode_s": round(out["decode_s"], 3),
        "tokens_per_s": round(out["tokens_per_s"], 1),
        "sample_tokens": out["tokens"][0][:8].tolist(),
    }))


if __name__ == "__main__":
    main()
