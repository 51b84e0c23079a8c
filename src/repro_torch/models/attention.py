"""Grouped-query attention for prefill and KV-cache decode (port of
``repro/models/attention.py``).

Prefill attention runs kernel K8 (:func:`repro_torch.kernels.ops.flash_attention`)
on a CUDA tensor and its plain PyTorch version on a CPU tensor.  The
reference's own ``_flash`` is a jnp online softmax that computes the same
function for causal or bidirectional self-attention without a prefix
(scores in float32 from ``q k^T hd^-0.5``, masked to -1e30, output
divided by ``max(l, 1e-30)``); the reference's Pallas kernel K8 was
written for exactly that function.  A sliding window on causal
self-attention (the reference's ``_sliding``: keys ``qpos - window <
kpos <= qpos``) runs through K8 too, which takes the window and skips the
key tiles below the band.  One-token decode attends over the cache in
plain PyTorch, as the reference's ``_cache_attn`` does in jnp, the window
a mask over the full-length cache; the new token's key and value are
written into the cache in place where the reference uses
``dynamic_update_slice``.

Prefill attention is differentiable on both devices: on a CUDA tensor K8's
forward with a plain backward
(:class:`repro_torch.kernels.flash_attention.FlashAttention`), on the CPU
autograd of the plain version.

Still to port, and raising ``NotImplementedError``: the prefix-LM mask,
cross-attention and the sequence-sharded decode (ROADMAP.md Queue A 11.5,
11.6 and 11.7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope

NEG_INF = -1e30

_CROSS = ("cross-attention (the encoder-decoder, whisper; ROADMAP.md "
          "Queue A 11.6)")
_UNPORTED = {
    "prefix_len": "the prefix-LM mask (paligemma; ROADMAP.md Queue A 11.5)",
    "cross_kv": _CROSS,
    "cross": _CROSS,
    "seq_shard_axis": "the sequence-sharded decode (ROADMAP.md Queue A "
                      "11.7)",
}


def unported(feature: str) -> NotImplementedError:
    return NotImplementedError(f"{feature}: {_UNPORTED[feature]} is not "
                               "ported yet")


# The reference's sharding of each leaf over the "model" axis (its heads'
# dimension), as spec tuples (repro/models/attention.py:32-40).
PARAM_SPECS = {"wq": (None, "model"), "wk": (None, "model"),
               "wv": (None, "model"), "wo": ("model", None),
               "bq": ("model",), "bk": ("model",), "bv": ("model",)}


def attn_params(make, prefix: str, *, d_model: int, num_heads: int,
                num_kv_heads: int, head_dim: int, qkv_bias: bool,
                cross: bool = False) -> torch.nn.ParameterDict:
    """Parameters of one attention block, weights kept flattened as
    (D, H*hd) as the reference stores them."""
    del cross
    p = {
        "wq": make(f"{prefix}.wq", (d_model, num_heads * head_dim)),
        "wk": make(f"{prefix}.wk", (d_model, num_kv_heads * head_dim)),
        "wv": make(f"{prefix}.wv", (d_model, num_kv_heads * head_dim)),
        "wo": make(f"{prefix}.wo", (num_heads * head_dim, d_model)),
    }
    if qkv_bias:
        p["bq"] = make(f"{prefix}.bq", (num_heads * head_dim,), "zeros")
        p["bk"] = make(f"{prefix}.bk", (num_kv_heads * head_dim,), "zeros")
        p["bv"] = make(f"{prefix}.bv", (num_kv_heads * head_dim,), "zeros")
    return torch.nn.ParameterDict(p)


def _project_qkv(params, x, kv_x, num_heads, num_kv_heads, head_dim):
    b, s, _ = x.shape
    sk = kv_x.shape[1]
    q = x @ params["wq"]
    k = kv_x @ params["wk"]
    v = kv_x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, sk, num_kv_heads, head_dim)
    v = v.reshape(b, sk, num_kv_heads, head_dim)
    return q, k, v


def attention(params, x: torch.Tensor, *, num_heads: int, num_kv_heads: int,
              head_dim: int, rope_theta: Optional[float] = 1e4,
              causal: bool = True, window: Optional[int] = None,
              prefix_len: int = 0, cross_kv: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full self-attention sublayer for prefill.  x: (B, S, D).

    ``return_kv``: also return the (roped) K/V, (B, S, KV, hd) each, so
    prefill can populate the decode cache.  The reference's
    ``q_chunk``/``kv_chunk`` set its jnp tiling; the port's tile is K8's
    own, so it takes neither.  Positions are 0 .. S-1 (the reference's
    ``positions`` override has no caller).  ``window`` slides over causal
    attention only, as the reference's; bidirectional attention ignores
    it."""
    if prefix_len:
        raise unported("prefix_len")
    if cross_kv is not None:
        raise unported("cross_kv")
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, x, num_heads, num_kv_heads, head_dim)
    if rope_theta is not None:
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=window if causal else None)
    out = out.reshape(b, s, num_heads * head_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = DEFAULT_DEVICE) -> dict:
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, max_len, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
    }


def decode_attention(params, x: torch.Tensor, cache: dict, pos: int, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: Optional[float] = 1e4,
                     window: Optional[int] = None,
                     seq_shard_axis: Optional[str] = None,
                     cross: bool = False) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, D); cache k/v: (B, S_cap, KV, hd);
    ``pos``: the number of tokens already cached.  The new token's key and
    value are written into ``cache`` at ``pos`` in place; returns (out,
    cache).  ``window``: attend the keys ``pos - window < kpos <= pos``."""
    if seq_shard_axis is not None:
        raise unported("seq_shard_axis")
    if cross:
        raise unported("cross")
    b = x.shape[0]
    pos = int(pos)
    q, k_new, v_new = _project_qkv(params, x, x, num_heads, num_kv_heads, head_dim)
    if rope_theta is not None:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k_new = apply_rope(k_new, posv, rope_theta)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    out = _cache_attn(q, cache["k"], cache["v"], pos, window)
    out = out.reshape(b, 1, num_heads * head_dim) @ params["wo"]
    return out, cache


def _cache_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: int, window: Optional[int] = None) -> torch.Tensor:
    """q (B, 1, H, hd) against the whole cache k/v (B, S_cap, KV, hd),
    positions ``<= pos`` (and ``> pos - window``) only; float32 scores and
    softmax."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, 1, kv, h // kv, hd)
    s_ = torch.einsum("bqgrd,bkgd->bqgrk", qg, k.float()) * (hd ** -0.5)
    kpos = torch.arange(k.shape[1], device=k.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    s_ = torch.where(valid, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bqgrk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
