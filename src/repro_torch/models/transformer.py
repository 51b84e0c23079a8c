"""Decoder-only transformer for serving (port of ``repro/models/transformer.py``).

The reference stacks each parameter leaf of a pattern position over the
periods and scans over them; the port keeps one module per layer
(:class:`Decoder`, an ``nn.ModuleList`` of blocks) and loops.  Layer
``p * len(pattern) + i`` is pattern position ``i`` of period ``p``.  The
decode cache keeps the reference's layout: per pattern position, k and v
stacked over the periods, (periods, B, S_cap, KV, hd); prefill and decode
write into it in place.

Entry points: :func:`forward_hidden`, :func:`make_loss` (the training
loss), :func:`prefill` (last-token logits in float32, and the cache) and
:func:`decode_step` (one token, float32 logits).  The training drivers
hold the parameters as a flat dict of tensors (:func:`flat_params`, the
``named_parameters`` names) and the loss reads such a dict as the decoder
(:func:`nest`), which is what ``torch.func.grad`` differentiates;
:func:`param_specs` and :func:`param_structs` are the reference's sharding
and shape interpretations of the same tree.  Attention blocks with a
dense or MoE FFN (:mod:`repro_torch.models.moe`) are ported, with the
sliding window (``window``, or ``cfg.sliding_window``); Mamba and
cross-attention blocks and the VLM prefix raise ``NotImplementedError``
(ROADMAP.md Queue A 11.4-11.6).
"""
from __future__ import annotations

import types
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (chunked_xent, fit_spec, layernorm,
                                       rmsnorm, transforms_active)

_UNPORTED_BLOCKS = {
    "mamba": "Mamba2 blocks (mamba2, jamba; ROADMAP.md Queue A 11.4)",
    "cross": "cross-attention blocks (whisper; ROADMAP.md Queue A 11.6)",
}


class Decoder(torch.nn.Module):
    """The decoder's parameters: ``embed`` (V, D), ``blocks`` (one
    ``ModuleDict`` per layer: ``pre_norm``, ``attn``, ``mlp_norm``, and
    ``mlp`` or ``moe``), ``final_norm`` and, unless the embeddings are tied,
    ``unembed`` (D, V)."""

    def __init__(self, embed, blocks, final_norm, unembed=None):
        super().__init__()
        self.embed = embed
        self.blocks = torch.nn.ModuleList(blocks)
        self.final_norm = final_norm
        if unembed is None:
            self.register_parameter("unembed", None)
        else:
            self.unembed = unembed


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _norm_params(make, path: str, cfg: ModelConfig) -> torch.nn.ParameterDict:
    p = {"scale": make(f"{path}.scale", (cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = make(f"{path}.bias", (cfg.d_model,), "zeros")
    return torch.nn.ParameterDict(p)


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def check_block(spec: BlockSpec) -> None:
    """Raise for a block kind the port does not run yet."""
    if spec.kind != "attn":
        raise NotImplementedError(f"{_UNPORTED_BLOCKS['mamba']} are not ported yet")
    if spec.cross:
        raise NotImplementedError(f"{_UNPORTED_BLOCKS['cross']} are not ported yet")


def _block_params(make, path: str, cfg: ModelConfig,
                  spec: BlockSpec) -> torch.nn.ModuleDict:
    check_block(spec)
    p = {"pre_norm": _norm_params(make, f"{path}.pre_norm", cfg),
         "attn": attn_lib.attn_params(
             make, f"{path}.attn", d_model=cfg.d_model, num_heads=cfg.num_heads,
             num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
             qkv_bias=cfg.qkv_bias),
         "mlp_norm": _norm_params(make, f"{path}.mlp_norm", cfg)}
    if spec.moe:
        p["moe"] = moe_lib.moe_params(
            make, f"{path}.moe", d_model=cfg.d_model, moe_d_ff=cfg.moe_d_ff,
            num_experts=cfg.num_experts,
            num_shared_experts=cfg.num_shared_experts,
            activation=cfg.activation)
    elif cfg.d_ff:
        p["mlp"] = mlp_lib.mlp_params(
            make, f"{path}.mlp", d_model=cfg.d_model, d_ff=cfg.d_ff,
            activation=cfg.activation)
    return torch.nn.ModuleDict(p)


def decoder_params(make, cfg: ModelConfig, *, prefix: str = "dec") -> Decoder:
    """One block per layer, made in the reference's leaf order (embed,
    blocks, final norm, unembed)."""
    pat, _ = cfg.resolve_pattern()
    for spec in pat:
        check_block(spec)
    embed = make(f"{prefix}.embed", (cfg.vocab_size, cfg.d_model), ("normal", 0.02))
    blocks = [_block_params(make, f"{prefix}.blocks.{layer}", cfg,
                            pat[layer % len(pat)])
              for layer in range(cfg.num_layers)]
    final_norm = _norm_params(make, f"{prefix}.final_norm", cfg)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = make(f"{prefix}.unembed", (cfg.d_model, cfg.vocab_size),
                       ("normal", 0.02))
    return Decoder(embed, blocks, final_norm, unembed)


# The reference's sharding of the leaves outside attention and the FFN
# (repro/models/transformer.py:41-105); a routed MoE leaf is looked up by
# "moe.<leaf>", every other leaf by its own name.
PARAM_SPECS = {"embed": ("model", None), "unembed": (None, "model"),
               "scale": (None,), "bias": (None,),
               **attn_lib.PARAM_SPECS, **mlp_lib.PARAM_SPECS,
               **moe_lib.PARAM_SPECS}


def _spec_key(name: str) -> str:
    last2 = ".".join(name.rsplit(".", 2)[-2:])
    return last2 if last2 in PARAM_SPECS else name.rsplit(".", 1)[-1]


def _meta_maker(dtype: torch.dtype):
    def make(path, shape, init=None) -> torch.nn.Parameter:
        del path, init
        return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                              device="meta"),
                                  requires_grad=False)
    return make


def param_structs(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Every parameter as a meta tensor of its shape and ``cfg.dtype``,
    by its ``named_parameters`` name (the reference's ``struct_maker``)."""
    model = decoder_params(_meta_maker(cfg.dtype), cfg)
    return {name: p.data for name, p in model.named_parameters()}


def param_specs(cfg: ModelConfig, axis_sizes: dict[str, int]
                ) -> dict[str, tuple]:
    """Every parameter's sharding as the reference's ``spec_maker`` gives
    it for mesh axes of ``axis_sizes``: one entry a dimension (None or an
    axis name), a sharding that does not divide its dimension replaced by
    None.  The reference stacks a pattern position's layers and so has one
    more leading None; the port's layers are leaves of their own."""
    return {name: fit_spec(t.shape, PARAM_SPECS[_spec_key(name)], axis_sizes)
            for name, t in param_structs(cfg).items()}


def flat_params(params: Decoder) -> dict[str, torch.Tensor]:
    """The decoder's parameters as a flat dict by ``named_parameters``
    name, detached (the same storage)."""
    return {name: p.detach() for name, p in params.named_parameters()}


def nest(flat: dict[str, torch.Tensor], cfg: ModelConfig):
    """A flat parameter dict (:func:`flat_params`' names) as the structure
    the forward reads: ``embed``, ``blocks`` (nested dicts a layer:
    ``attn``, ``moe`` and its ``shared``, ...), ``final_norm``,
    ``unembed``.  The tensors are the dict's own, so a
    ``torch.func`` transform of a function of ``flat`` sees through."""
    blocks = [{} for _ in range(cfg.num_layers)]
    top: dict = {"final_norm": {}, "unembed": None}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            node = blocks[int(parts[1])]
            for part in parts[2:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = t
        elif parts[0] == "final_norm":
            top["final_norm"][parts[1]] = t
        else:
            top[name] = t
    return types.SimpleNamespace(blocks=blocks, **top)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _embed(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params.embed[tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _check_forward(prefix_emb, enc_out) -> None:
    if prefix_emb is not None:
        raise attn_lib.unported("prefix_len")
    if enc_out is not None:
        raise attn_lib.unported("cross_kv")


def _ffn(cfg: ModelConfig, bp, x: torch.Tensor, *, decode: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x + the block's FFN (dense, MoE or none) -> (x, MoE aux loss).  At
    decode MoE takes the reference's no-drop settings (capacity factor E,
    groups of max(B, 8) tokens)."""
    h = apply_norm(cfg, bp["mlp_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in bp:
        kw = (dict(capacity_factor=float(cfg.num_experts),
                   group_size=max(x.shape[0], 8)) if decode
              else dict(capacity_factor=cfg.capacity_factor))
        h, aux = moe_lib.moe(bp["moe"], h, num_experts=cfg.num_experts,
                             top_k=cfg.top_k, activation=cfg.activation,
                             num_shared_experts=cfg.num_shared_experts, **kw)
    elif cfg.d_ff:
        h = mlp_lib.mlp(bp["mlp"], h, activation=cfg.activation)
    else:
        h = torch.zeros_like(x)
    return x + h, aux


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


def _block(cfg: ModelConfig, bp, x: torch.Tensor, window: Optional[int]
           ) -> tuple[torch.Tensor, torch.Tensor]:
    h = apply_norm(cfg, bp["pre_norm"], x)
    x = x + attn_lib.attention(bp["attn"], h, causal=True, window=window,
                               **_attn_kwargs(cfg))
    return _ffn(cfg, bp, x)


def forward_hidden(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
                   prefix_emb: Optional[torch.Tensor] = None,
                   enc_out: Optional[torch.Tensor] = None,
                   window: Optional[int] = None,
                   remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed + blocks + final norm.  Returns (hidden (B, S, D), moe_aux),
    the MoE blocks' aux losses summed over the layers (0 without MoE).
    ``window``: the sliding window, ``cfg.sliding_window`` by default.
    ``remat``: under autograd,
    keep only each block's input and recompute the block in the backward
    (``torch.utils.checkpoint`` per block, where the reference wraps each
    period in ``jax.checkpoint``); under a ``torch.func`` transform, where
    checkpointing cannot run, every block's activations are kept."""
    _check_forward(prefix_emb, enc_out)
    window = window if window is not None else cfg.sliding_window
    x = _embed(params, cfg, tokens)
    remat = remat and torch.is_grad_enabled() and not transforms_active()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params.blocks:
        x, a = (checkpoint(_block, cfg, bp, x, window, use_reentrant=False)
                if remat else _block(cfg, bp, x, window))
        aux = aux + a
    x = apply_norm(cfg, params.final_norm, x)
    return x, aux


def _unembed(params: Decoder, cfg: ModelConfig) -> torch.Tensor:
    """(V, D), as the reference's ``_unembed``."""
    if cfg.tie_embeddings:
        return params.embed
    return params.unembed.T


def make_loss(cfg: ModelConfig, *, remat: bool = True, loss_chunk: int = 512,
              window: Optional[int] = None, moe_aux_weight: float = 0.01):
    """``loss(params, batch)`` -> 0-dim float32 training loss: the mean
    next-token cross-entropy of ``batch["labels"]`` (B, S) after
    ``batch["tokens"]`` (B, S), over ``batch["loss_mask"]`` where given
    (:func:`~repro_torch.models.common.chunked_xent`, ``loss_chunk``
    positions at a time), plus ``moe_aux_weight`` x the MoE aux loss
    summed over the layers; ``window`` the sliding window
    (``cfg.sliding_window`` by default).  ``params``: a :class:`Decoder`, or a flat
    dict of its tensors (:func:`flat_params`; read through :func:`nest`).
    Differentiate it with ``torch.autograd`` after
    ``params.requires_grad_()``, or a dict with ``torch.func.grad``;
    ``remat`` recomputes each block in the backward.  A ``prefix_emb`` or ``enc_out`` in the batch raises
    ``NotImplementedError``, as the forward does."""

    def loss(params, batch: dict) -> torch.Tensor:
        if isinstance(params, dict):
            params = nest(params, cfg)
        h, aux = forward_hidden(params, cfg, batch["tokens"],
                                prefix_emb=batch.get("prefix_emb"),
                                enc_out=batch.get("enc_out"), window=window,
                                remat=remat)
        nll = chunked_xent(h, _unembed(params, cfg), batch["labels"],
                           chunk=loss_chunk, mask=batch.get("loss_mask"))
        return nll + moe_aux_weight * aux

    return loss


def prefill(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_emb: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            window: Optional[int] = None,
            cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt ``tokens`` (B, S), writing each layer's
    roped k and v into positions [0, S) of the decode cache.  ``cache``: one
    made by :func:`init_decode_cache` with capacity >= S, written in place
    (serving allocates it once at prompt + decode capacity); by default one
    of capacity S in the parameters' dtype, as the reference returns.
    Returns (last-token logits (B, V) float32, cache).  ``window``: the
    sliding window, ``cfg.sliding_window`` by default; the cache stays full
    length (the reference's layout), the window a mask at decode."""
    _check_forward(prefix_emb, enc_out)
    window = window if window is not None else cfg.sliding_window
    pat, _ = cfg.resolve_pattern()
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    if cache is None:
        cache = init_decode_cache(cfg, b, s, dtype=x.dtype, device=x.device)
    if cache["pos0"]["k"].shape[2] < s:
        raise ValueError(f"prefill: cache capacity {cache['pos0']['k'].shape[2]} "
                         f"< prompt length {s}")
    for layer, bp in enumerate(params.blocks):
        period, i = divmod(layer, len(pat))
        c = cache[f"pos{i}"]
        h = apply_norm(cfg, bp["pre_norm"], x)
        h, (k, v) = attn_lib.attention(bp["attn"], h, causal=True,
                                       window=window, return_kv=True,
                                       **_attn_kwargs(cfg))
        c["k"][period, :, :s] = k
        c["v"][period, :, :s] = v
        x, _ = _ffn(cfg, bp, x + h)
    x = apply_norm(cfg, params.final_norm, x)
    logits = x[:, -1].float() @ _unembed(params, cfg).float().T
    return logits, cache


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """``{"pos{i}": {"k", "v"}}``, each (periods, B, max_len, KV, hd) of
    zeros, as the reference lays it out."""
    pat, periods = cfg.resolve_pattern()
    device = resolve_device(device)
    shape = (periods, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {}
    for i, spec in enumerate(pat):
        check_block(spec)
        cache[f"pos{i}"] = {name: torch.zeros(shape, dtype=dtype, device=device)
                            for name in ("k", "v")}
    return cache


def decode_step(params: Decoder, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int, *,
                window: Optional[int] = None,
                seq_shard_axis: Optional[str] = None
                ) -> tuple[torch.Tensor, dict]:
    """One-token serve step.  tokens: (B, 1); pos: tokens already in the
    cache.  Writes each layer's k and v at ``pos`` in place.  Returns
    (logits (B, V) float32, cache).  ``window``: the sliding window,
    ``cfg.sliding_window`` by default (a mask over the full-length cache)."""
    window = window if window is not None else cfg.sliding_window
    pat, _ = cfg.resolve_pattern()
    x = _embed(params, cfg, tokens)
    for layer, bp in enumerate(params.blocks):
        period, i = divmod(layer, len(pat))
        c = cache[f"pos{i}"]
        h = apply_norm(cfg, bp["pre_norm"], x)
        h, _ = attn_lib.decode_attention(
            bp["attn"], h, {"k": c["k"][period], "v": c["v"][period]}, pos,
            window=window, seq_shard_axis=seq_shard_axis, **_attn_kwargs(cfg))
        x, _ = _ffn(cfg, bp, x + h, decode=True)
    x = apply_norm(cfg, params.final_norm, x)
    logits = x[:, 0].float() @ _unembed(params, cfg).float().T
    return logits, cache
