"""Plain PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``).

They compute what the reference's oracles compute, with the one change of
layout the port makes: :func:`saga_correct` takes the worker axis natively
(table (W, J, D), idx (W,)) and, as an oracle, leaves its inputs intact.
"""
from __future__ import annotations

import torch


def partial_sqdist(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z: (W, p), y: (p,) -> per-worker squared distances (W,)."""
    d = z.float() - y.float()[None]
    return torch.sum(d * d, dim=-1)


def partial_sqdist_segments(z: torch.Tensor, y: torch.Tensor,
                            seg_ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """z: (W, p), y: (p,), seg_ids: (p,) block ids -> (W, num_segments)
    per-(worker, block) squared distances."""
    d2 = (z.float() - y.float()[None]) ** 2
    onehot = (seg_ids.long()[None, :] == torch.arange(
        num_segments, device=z.device)[:, None]).float()
    return d2 @ onehot.T


def weighted_sum(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i w[i] z[i] / sum(w); z: (W, p), w: (W,) -> (p,)."""
    return (w.float() @ z.float()) / torch.sum(w.float())


def weiszfeld_step(z: torch.Tensor, y: torch.Tensor,
                   floor: float = 1e-8) -> torch.Tensor:
    d = torch.sqrt(partial_sqdist(z, y))
    inv = 1.0 / torch.clamp(d, min=floor)
    return weighted_sum(z, inv)


def geomed(z: torch.Tensor, iters: int = 32) -> torch.Tensor:
    y = torch.mean(z.float(), dim=0)
    for _ in range(iters):
        y = weiszfeld_step(z, y)
    return y.to(z.dtype)


def saga_correct(grad: torch.Tensor, table: torch.Tensor, avg: torch.Tensor,
                 idx: torch.Tensor):
    """grad: (W, p), table: (W, J, p), avg: (W, p), idx: (W,).
    Returns (msg, new_avg, new_table); the inputs are not modified."""
    j = table.shape[1]
    w_ids = torch.arange(grad.shape[0], device=grad.device)
    old = table[w_ids, idx].float()
    g = grad.float()
    msg = g - old + avg.float()
    new_avg = avg.float() + (g - old) / j
    new_table = table.clone()
    new_table[w_ids, idx] = grad.to(table.dtype)
    return msg.to(grad.dtype), new_avg.to(avg.dtype), new_table


def coordinate_median(z: torch.Tensor) -> torch.Tensor:
    """z: (W, p) -> (p,) elementwise median (even W: the midpoint of the two
    middle values, as ``jnp.median``)."""
    return torch.quantile(z.float(), 0.5, dim=0,
                          interpolation="midpoint").to(z.dtype)


def trimmed_mean(z: torch.Tensor, trim: int) -> torch.Tensor:
    s = torch.sort(z, dim=0).values
    w = z.shape[0]
    return torch.mean(s[trim:w - trim].float(), dim=0).to(z.dtype)


def masked_neighbor_reduce(exchange: torch.Tensor, mask: torch.Tensor,
                           trim: int = 0) -> torch.Tensor:
    """exchange: (R, S, d), mask: (R, S) -> (R, d) per-receiver masked
    trimmed mean over the sender axis (trim=0: plain masked mean).
    Sort-based: non-neighbours fill to +inf, ranks [trim, n-trim) survive."""
    z = exchange.float()
    n = torch.sum(mask.float(), dim=1)
    s = torch.sort(torch.where(mask[:, :, None] > 0, z, torch.inf), dim=1).values
    ranks = torch.arange(z.shape[1], device=z.device)[None, :, None]
    keep = (ranks >= trim) & (ranks < (n[:, None, None] - trim))
    return (torch.sum(torch.where(keep, s, 0.0), dim=1)
            / torch.clamp(n - 2 * trim, min=1.0)[:, None])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Naive softmax attention oracle.  q/k/v: (BH, S, hd) -> (BH, S, hd)
    float32."""
    s, hd = q.shape[1], q.shape[2]
    sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (hd ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        sc = torch.where(mask[None], sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float())
