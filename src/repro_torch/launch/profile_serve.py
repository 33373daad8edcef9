"""Where the LM serving path spends its time: ``torch.profiler`` over one
prefill and a few decode steps.

``python -m repro_torch.launch.profile_serve --full-config`` profiles the full
qwen3-4b on the card (batch 4, prompt 2048) after one untimed warm-up pass
(``--arch recurrentgemma-2b --prompt-len 3000`` the hybrid, ``--arch
deepseek-moe-16b --param-dtype bfloat16`` the MoE model with its weights
stored in bf16); ``--device cpu`` profiles a reduced config on the CPU. For each phase it
prints the host wall time, the device time (the sum of the kernels'
self time, CUDA only), the device's idle share ``1 - device / wall``, and
the operators and kernels that take the most device time. The profiler
adds host time to every operator, so the wall times here are above the
unprofiled ones of ``launch.serve``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs.base import get_arch, reduced
from ..models import build_model, transformer
from .serve import PARAM_DTYPES

__all__ = ["profile_serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase(fn, device: torch.device, rows: int) -> dict:
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:rows]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if device.type == "cuda" else None,
        "idle_share": 1.0 - device_ms / wall_ms if device.type == "cuda" else None,
        "host_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "top_device": [{"name": e.key[:80], "device_ms": e.self_device_time_total / 1e3,
                        "calls": e.count} for e in top if e.self_device_time_total > 0],
    }


@torch.inference_mode()
def profile_serve(*, arch: str = "qwen3-4b", batch: int = 4, prompt_len: int = 2048,
                  decode_steps: int = 3, use_reduced: bool = True, seed: int = 0,
                  device: str | torch.device = "cuda", rows: int = 12,
                  param_dtype=torch.float32) -> dict:
    """Profile one prefill and ``decode_steps`` decode steps (after a warm-up
    of each) of ``arch`` with random weights from ``seed``, stored in
    ``param_dtype``."""
    cfg = reduced(arch) if use_reduced else get_arch(arch)
    model = build_model(cfg, param_dtype=param_dtype, device=device)
    dev = model.device
    params = model.init(seed)
    prompts = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.long, device=dev)
    max_len = prompt_len + 1 + 2 * decode_steps
    logits, caches = model.prefill(params, prompts)                 # warm-up
    cache = transformer.grow_cache(cfg, caches, prompt_len, max_len)
    del caches
    tok = torch.argmax(logits, -1)
    pos = prompt_len
    for _ in range(decode_steps):
        logits, cache = model.decode_step(params, tok, cache, pos)
        pos += 1
    _sync(dev)

    def decode():
        nonlocal pos
        for _ in range(decode_steps):
            model.decode_step(params, tok, cache, pos)
            pos += 1

    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "prompt": prompt_len,
            "device": str(dev),
            "prefill": _phase(lambda: model.prefill(params, prompts), dev, rows),
            "decode": {"steps": decode_steps, **_phase(decode, dev, rows)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=3)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", choices=sorted(PARAM_DTYPES), default="float32")
    args = ap.parse_args(argv)
    out = profile_serve(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
                        decode_steps=args.decode_steps, use_reduced=not args.full_config,
                        device=args.device, param_dtype=PARAM_DTYPES[args.param_dtype])
    for phase in ("prefill", "decode"):
        print(json.dumps({"phase": phase, **{k: out[k] for k in ("arch", "layers", "batch",
                                                                   "prompt", "device")},
                          **out[phase]}))


if __name__ == "__main__":
    main()
