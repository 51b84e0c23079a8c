"""Model API: ``build_model(cfg)`` -> :class:`Model` (port of
``repro/models/api.py``).

One object per architecture exposing ``init`` / ``param_specs`` /
``param_structs`` / ``loss`` / ``prefill`` / ``decode_step`` /
``init_cache`` for the dense and MoE decoders (qwen2-moe, mixtral with its
sliding window).  The other families raise
``NotImplementedError`` naming the ROADMAP.md entry that ports them.
``param_specs(axis_sizes)`` and ``param_structs()`` are the reference's
sharding and shape interpretations of the parameter tree, by
``named_parameters`` name (:func:`repro_torch.models.transformer.param_specs`);
the cache's (``cache_specs``, ``cache_structs``) come with the analysis
(Queue A 11.8).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_maker

_PORTED_FAMILIES = ("dense", "moe")
_UNPORTED_FAMILIES = {
    "ssm": "Mamba2 (mamba2-130m; ROADMAP.md Queue A 11.4)",
    "hybrid": "Mamba2 (jamba; ROADMAP.md Queue A 11.4)",
    "audio": "the encoder-decoder (whisper; ROADMAP.md Queue A 11.6)",
    "vlm": "the prefix-LM mask (paligemma; ROADMAP.md Queue A 11.5)",
}


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., tfm.Decoder]
    param_specs: Callable[[dict], dict]
    param_structs: Callable[[], dict]
    loss: Callable[[tfm.Decoder, dict], torch.Tensor]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[..., dict]


def build_model(cfg: ModelConfig, *,
                device: str | torch.device = DEFAULT_DEVICE,
                remat: bool = True, loss_chunk: int = 512) -> Model:
    """The model of ``cfg`` on ``device`` (resolved when parameters or a
    cache are made: without a card, ``"cuda"`` raises there).

    ``loss(params, batch)`` is :func:`repro_torch.models.transformer.make_loss`
    with ``remat`` (recompute each block in the backward) and
    ``loss_chunk`` (the cross-entropy's chunk); the parameters come from
    ``init`` without gradients, so a trainer calls
    ``params.requires_grad_()`` first, or differentiates the loss of the
    flat dict :func:`~repro_torch.models.transformer.flat_params` with
    ``torch.func``.  The reference's
    ``q_chunk``/``kv_chunk`` set its jnp attention tiling; the port's
    attention tile is kernel K8's own, so it takes neither."""
    if cfg.family not in _PORTED_FAMILIES:
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

    def param_specs(axis_sizes: dict[str, int]) -> dict[str, tuple]:
        return tfm.param_specs(cfg, axis_sizes)

    def param_structs() -> dict[str, torch.Tensor]:
        return tfm.param_structs(cfg)

    loss = tfm.make_loss(cfg, remat=remat, loss_chunk=loss_chunk)
    return Model(cfg, init, param_specs, param_structs, loss, prefill_fn,
                 decode_fn, init_cache)
