"""Shared model-building machinery (port of ``repro/models/common.py``).

The reference defines every parameter tree once, as a function of a
*maker* ``make(path, shape, spec, init)``.  The port keeps the protocol
for the one interpretation serving needs: :func:`init_maker` returns a
maker that draws an initialized :class:`torch.nn.Parameter` with the
reference's distributions from a :class:`torch.Generator`.  The
reference's ``spec_maker``/``struct_maker`` (sharding and the dry-run)
wait for the distributed runtime (ROADMAP.md Queue A 10b), and
``chunked_xent`` for the training loss (Queue A 11).

Also here: RMSNorm/LayerNorm, RoPE and the activations, float32 inside and
cast back to the input's dtype as in the reference.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

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
