"""Shared model-building machinery (port of ``repro/models/common.py``).

The reference defines every parameter tree once, as a function of a
*maker* ``make(path, shape, spec, init)``.  The port keeps the protocol
for the one interpretation serving needs: :func:`init_maker` returns a
maker that draws an initialized :class:`torch.nn.Parameter` with the
reference's distributions from a :class:`torch.Generator`.  The
reference's ``spec_maker``/``struct_maker`` (sharding and the dry-run)
come as :func:`fit_spec` (the sharding, used by
:func:`repro_torch.models.transformer.param_specs`) and meta tensors
(the structs, :func:`repro_torch.models.transformer.param_structs`).

Also here: RMSNorm/LayerNorm, RoPE and the activations, float32 inside and
cast back to the input's dtype as in the reference, and
:func:`chunked_xent`, the training loss's cross-entropy.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Maker = Callable[..., torch.nn.Parameter]


# ---------------------------------------------------------------------------
# Maker protocol
# ---------------------------------------------------------------------------

def init_maker(generator: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> Maker:
    """make(path, shape, init=None) -> initialized parameter.  Init kinds:
    ``("normal", std)`` | ``"ones"`` | ``"zeros"`` | ``None``, which is normal
    with std ``fan_in ** -0.5``, fan_in = ``shape[-2]`` (``shape[-1]`` for a
    vector).  Normal draws are float32, then cast to ``dtype``, as in the
    reference.  ``path`` names the leaf; the draws come from ``generator``
    in the order the leaves are made (the reference folds the path into its
    key instead, which torch cannot reproduce).  The reference's
    ``("uniform", bound)`` kind has no user among the ported modules and
    raises."""

    def make(path: str, shape: Sequence[int], init=None) -> torch.nn.Parameter:
        shape = tuple(shape)
        if init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif init is None or (isinstance(init, tuple) and init[0] == "normal"):
            if init is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                std = fan_in ** -0.5
            else:
                std = init[1]
            t = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
            t = t.mul_(std).to(dtype)
        else:
            raise ValueError(f"{path}: init {init!r} is not ported")
        return torch.nn.Parameter(t, requires_grad=False)

    return make


def fit_spec(shape: Sequence[int], spec: tuple,
             axis_sizes: dict[str, int]) -> tuple:
    """The reference's ``spec_maker`` on one leaf: ``spec`` (one entry a
    dimension: None, an axis name or a tuple of them; missing entries
    None) with every sharding whose axes' combined size does not divide its
    dimension replaced by None."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, names in zip(shape, spec):
        total = 1
        for n in (() if names is None else
                  names if isinstance(names, tuple) else (names,)):
            total *= axis_sizes.get(n, 1)
        out.append(names if names is not None and dim % total == 0 else None)
    return tuple(out)


def transforms_active() -> bool:
    """Whether a ``torch.func`` transform (``grad``, ``vmap``) is running.
    Saved-tensor hooks, which ``torch.utils.checkpoint`` recomputes
    through, do not run under one."""
    return torch._C._are_functorch_transforms_active()


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": _gelu,
    "silu": F.silu,
    "relu": torch.relu,
    "squared_relu": squared_relu,
    "tanh": torch.tanh,
}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Split-half
    rotation in float32, cast back to ``x.dtype``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs           # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never holds the (B, S, V) logits)
# ---------------------------------------------------------------------------

def _chunk_nll(h: torch.Tensor, emb32: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Sum over one chunk of the masked negative log-likelihoods, from its
    float32 logits (B, c, V)."""
    logits = h.float() @ emb32.T
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - tgt) * mask)


def chunked_xent(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, *,
                 chunk: int = 512,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of the hidden states ``h`` (B, S, D)
    against ``labels`` (B, S) under the output embedding ``emb`` (V, D),
    over the positions where ``mask`` (B, S; default all) is 1 -> 0-dim
    float32.  As the reference's: the logits are float32 and made
    ``chunk`` positions at a time (a ragged S is padded with mask 0), so
    the (B, S, V) logits never exist at once; under autograd each chunk is
    recomputed in the backward (``torch.utils.checkpoint``) rather than
    kept.  Under a ``torch.func`` transform, where that recompute cannot
    run (:func:`transforms_active`), the chunks' logits are kept for the
    backward."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    mask = (torch.ones((b, s), dtype=torch.float32, device=h.device)
            if mask is None else mask.float())
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    emb32 = emb.float()
    keep = (torch.is_grad_enabled() and (h.requires_grad or emb.requires_grad)
            and not transforms_active())
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for a in range(0, s + pad, chunk):
        args = (h[:, a:a + chunk], emb32, labels[:, a:a + chunk],
                mask[:, a:a + chunk])
        tot = tot + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                     if keep else _chunk_nll(*args))
    return tot / torch.clamp(torch.sum(mask), min=1.0)
