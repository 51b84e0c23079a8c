"""Runnable serving driver: prefill a batch of prompts, then decode tokens
step by step with the KV cache, greedy (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --reduced --device cpu --prompt-len 32 --decode-tokens 16 --batch 2

The dense decoders and the MoE ones (``--arch qwen2-moe-a2.7b`` or
``mixtral-8x22b``, the latter with its sliding window) run.  On the card
(the default ``--device cuda``) the prefill's attention runs kernel K8.  Weights are random, drawn from ``--seed``, and so are the
prompt tokens.  The cache is allocated once at prompt + decode capacity;
the reference pads it to that capacity after prefill, with the same
result.  ``--mesh`` (serving on a device mesh) raises: the mesh, its
collectives and the parameter sharding are ported
(:mod:`repro_torch.launch.mesh`, :mod:`repro_torch.launch.sharding`), the
sequence-sharded decode is not (ROADMAP.md Queue A 11.7).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch.models.api import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: Model, params, *, batch: int, prompt_len: int,
          decode_tokens: int, seed: int = 0, cache: Optional[dict] = None
          ) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    ``decode_tokens - 1`` greedy decode steps (the first token comes from the
    prefill's logits).  ``cache``: one of capacity ``prompt_len +
    decode_tokens`` to reuse; made here by default.  Returns the tokens
    (batch, decode_tokens), the last logits, the cache and the host-clock
    seconds of the prefill and of the decode loop (each ending in a
    synchronize on the card)."""
    cfg = model.cfg
    dev = params.embed.device
    cap = prompt_len + decode_tokens
    if cache is None:
        cache = model.init_cache(batch, cap, dtype=params.embed.dtype)
    gen = generator_for(seed + 1, dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, cache=cache)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens = [tok]
        t0 = time.perf_counter()
        for i in range(decode_tokens - 1):
            logits, cache = model.decode_step(params, cache, tok, prompt_len + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
            out_tokens.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out_tokens, dim=1), "logits": logits,
            "cache": cache, "prompt": tokens, "prefill_s": prefill_s,
            "decode_s": decode_s}


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--mesh", default="", help="e.g. 4x2 (data x model); "
                    "not ported yet (ROADMAP.md Queue A 11.7)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: serving on a device mesh needs the sequence-sharded "
            "decode, not ported yet (ROADMAP.md Queue A 11.7)")
    cfg: ModelConfig = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    params = model.init(args.seed)
    res = serve(model, params, batch=args.batch, prompt_len=args.prompt_len,
                decode_tokens=args.decode_tokens, seed=args.seed)
    print(f"prefill {args.prompt_len} tokens: {res['prefill_s']:.2f}s "
          f"(logits {tuple(res['logits'].shape)})")
    toks = res["tokens"]
    dt = res["decode_s"]
    print(f"decoded {toks.shape[1]} tokens/seq in {dt:.2f}s "
          f"({args.batch * toks.shape[1] / max(dt, 1e-9):.1f} tok/s)")
    print("sampled token ids (first seq):", toks[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
