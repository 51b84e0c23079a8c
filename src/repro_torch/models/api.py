"""Model API: ``build_model(cfg)`` -> :class:`Model` (port of
``repro/models/api.py``).

One object per architecture exposing ``init`` / ``prefill`` /
``decode_step`` / ``init_cache`` for the dense decoders.  The other
families raise ``NotImplementedError`` naming the ROADMAP.md entry that
ports them; the training ``loss`` and the reference's sharding and dry-run
interpretations of the parameter tree (``param_specs``,
``param_structs``, ``cache_specs``, ``cache_structs``) come with the
training slice and the distributed runtime (Queue A 10b and 11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_maker

_UNPORTED_FAMILIES = {
    "moe": "MoE routing (qwen2-moe, mixtral; ROADMAP.md Queue A 11)",
    "ssm": "Mamba2 (mamba2-130m; ROADMAP.md Queue A 11)",
    "hybrid": "Mamba2 and MoE (jamba; ROADMAP.md Queue A 11)",
    "audio": "the encoder-decoder (whisper; ROADMAP.md Queue A 11)",
    "vlm": "the prefix-LM mask (paligemma; ROADMAP.md Queue A 11)",
}


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., tfm.Decoder]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[..., dict]


def build_model(cfg: ModelConfig, *,
                device: str | torch.device = DEFAULT_DEVICE) -> Model:
    """The model of ``cfg`` on ``device`` (resolved when parameters or a
    cache are made: without a card, ``"cuda"`` raises there).

    The reference's ``q_chunk``/``kv_chunk`` set its jnp attention tiling
    and ``remat``/``loss_chunk`` its training memory; the port's attention
    tile is kernel K8's own and training is not ported, so it takes none of
    them."""
    if cfg.family != "dense":
        reason = _UNPORTED_FAMILIES.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(f"{cfg.name}: {reason} is not ported yet")

    def init(seed: int | torch.Generator) -> tfm.Decoder:
        dev = resolve_device(device)
        return tfm.decoder_params(
            init_maker(generator_for(seed, dev), cfg.dtype, dev), cfg)

    def prefill_fn(params, batch: dict, *, cache=None):
        return tfm.prefill(params, cfg, batch["tokens"],
                           prefix_emb=batch.get("image_emb"), cache=cache)

    def decode_fn(params, cache, tokens, pos, *, window=None,
                  seq_shard_axis=None):
        return tfm.decode_step(params, cfg, cache, tokens, pos, window=window,
                               seq_shard_axis=seq_shard_axis)

    def init_cache(batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return tfm.init_decode_cache(cfg, batch, max_len, dtype,
                                     resolve_device(device))

    return Model(cfg, init, prefill_fn, decode_fn, init_cache)
