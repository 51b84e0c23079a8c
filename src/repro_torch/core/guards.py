"""Fault containment and round-health verdicts (port of
``repro/core/guards.py``).

* :func:`guard_mask` -- a (W,) validity mask in {0, 1}: a row is
  quarantined when it holds a non-finite coordinate, or when its norm
  exceeds ``multiplier`` times the median norm of the finite rows.  The
  mask folds into the rules' ``row_weights``, so a quarantined row gets
  weight exactly 0; :func:`pairwise_guard_mask` is the per-edge form of the
  decentralized exchange, one median per receiver.
* :func:`sanitize_rows` -- zero the quarantined rows, so that ``0 * NaN``
  cannot reach a weighted sum.
* :func:`guarded_flat_call` -- a flat rule with the mask folded in, giving
  on a clean round (every row valid) the bits of the unguarded call.  The
  reference runs both the unguarded and the masked rule and selects one
  with ``jnp.where``; this port reads :func:`all_valid` on the host once
  and runs only the branch it needs, which gives the same result.
* :func:`round_verdict` -- accept or reject a round from the aggregate's
  norm: non-finite, or (after ``warmup`` accepted rounds) a one-sided
  z-score above ``zmax`` against the EMA carried in the (4,) health vector.
  A rejected round keeps its parameters, optimizer state and variance-
  reduction state; the step builders hold them (the SAGA table is restored
  row by row, never copied whole).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.collectives import psum

# Rows with norms at or below this floor are never magnitude-quarantined.
_NORM_FLOOR = 1e-12

# The health vector: [EMA of the aggregate norm, EMA of its square,
# rejected rounds, accepted rounds], float32.
HEALTH_WIDTH = 4


def init_health(device: str | torch.device = "cpu") -> torch.Tensor:
    """Zeroed (HEALTH_WIDTH,) float32 health vector."""
    return torch.zeros((HEALTH_WIDTH,), dtype=torch.float32, device=device)


def _row_stats(z, lead: int, axis_names=()):
    """Per-row (non-finite count, squared norm of the finite coordinates)
    over the trailing axes of ``z``, whose first ``lead`` axes index the
    rows; ``z`` may be a dict of such leaves, added in sorted-name order
    (the reference's leaf order).  With ``axis_names`` (coordinates sharded
    across ranks) both are summed over them."""
    if isinstance(z, dict):
        stats = [_row_stats(z[k], lead) for k in sorted(z)]
        bad, sq = stats[0]
        for b, s in stats[1:]:
            bad, sq = bad + b, sq + s
    else:
        zf = z.float().reshape(tuple(z.shape[:lead]) + (-1,))
        finite = torch.isfinite(zf)
        bad = torch.sum((~finite).float(), dim=-1)
        sq = torch.sum(torch.where(finite, zf, 0.0) ** 2, dim=-1)
    return psum(bad, axis_names), psum(sq, axis_names)


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of ``x`` over its last axis where ``valid`` (mean of the two
    middle valid values); +inf with no valid entry."""
    s = torch.sort(torch.where(valid, x, torch.inf), dim=-1).values
    n = torch.sum(valid.to(torch.int64), dim=-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = n // 2
    return (0.5 * (torch.gather(s, -1, lo) + torch.gather(s, -1, hi)))[..., 0]


def guard_mask(msgs: torch.Tensor, *, multiplier: float = 10.0,
               base_weights: Optional[torch.Tensor] = None,
               axis_names=()) -> torch.Tensor:
    """(W,) float32 mask in {0, 1} for a (W, D) message buffer: 0 for a row
    with a non-finite coordinate, or with a norm above ``multiplier`` x the
    median norm of the finite rows of positive ``base_weights``
    (``multiplier <= 0`` turns the magnitude gate off).  ``axis_names``:
    the mesh axes the coordinates are sharded over (the row statistics are
    summed over them, so every rank gets the same mask)."""
    bad, sq = _row_stats(msgs, 1, axis_names)
    finite_row = bad == 0
    mask = finite_row
    if multiplier > 0:
        norms = torch.sqrt(sq)
        votes = finite_row
        if base_weights is not None:
            votes = votes & (base_weights > 0)
        med = _masked_median(norms, votes)
        limit = torch.clamp(multiplier * med, min=_NORM_FLOOR)
        mask = mask & ((norms <= limit) | (norms <= _NORM_FLOOR))
    return mask.float()


def pairwise_guard_mask(exchange, mask: torch.Tensor, *,
                        multiplier: float = 10.0) -> torch.Tensor:
    """(R, S) float32 mask for an (R, S, D) per-edge exchange (or a dict of
    (R, S, *shape) leaves) under the (R, S) neighbour mask: each receiver
    judges its own in-edges, with the median norm of its unmasked finite
    senders."""
    bad, sq = _row_stats(exchange, 2)
    finite_rs = bad == 0
    out = finite_rs
    if multiplier > 0:
        norms = torch.sqrt(sq)
        med = _masked_median(norms, finite_rs & (mask > 0))       # (R,)
        limit = torch.clamp(multiplier * med, min=_NORM_FLOOR)[:, None]
        out = out & ((norms <= limit) | (norms <= _NORM_FLOOR))
    return out.float()


def sanitize_rows(msgs, mask: torch.Tensor):
    """Zero the rows (entries of the leading axes) that ``mask``
    quarantines, in a tensor or in each leaf of a dict; an all-ones mask
    returns the same values."""
    if isinstance(msgs, dict):
        return {k: sanitize_rows(v, mask) for k, v in msgs.items()}
    m = mask.reshape(tuple(mask.shape) + (1,) * (msgs.dim() - mask.dim()))
    return torch.where(m > 0, msgs, torch.zeros_like(msgs))


def all_valid(mask: torch.Tensor) -> torch.Tensor:
    """0-dim bool: no row or edge was quarantined."""
    return torch.all(mask >= 1.0)


def guarded_flat_call(flat_fn: Callable[..., Any], buf: torch.Tensor,
                      mask: torch.Tensor, *,
                      row_weights: Optional[torch.Tensor] = None) -> Any:
    """Run a flat rule with the guard mask folded into its row weights.  On
    a clean round (one host read of :func:`all_valid`) this is the
    unguarded call itself, so its bits are the unguarded call's; otherwise
    the quarantined rows are zeroed and weighted 0."""
    if bool(all_valid(mask)):
        return (flat_fn(buf) if row_weights is None
                else flat_fn(buf, row_weights=row_weights))
    weights = mask if row_weights is None else row_weights * mask
    return flat_fn(sanitize_rows(buf, mask), row_weights=weights)


def select_tree(pred: torch.Tensor, on_true, on_false):
    """``torch.where(pred, a, b)`` over matching tensors, dicts or tuples of
    tensors: a branch-free hold (the steps themselves read the verdict once
    and keep the old objects, which gives the same values)."""
    if isinstance(on_true, torch.Tensor):
        return torch.where(pred, on_true, on_false)
    if isinstance(on_true, dict):
        return {k: select_tree(pred, v, on_false[k]) for k, v in on_true.items()}
    vals = [select_tree(pred, a, b) for a, b in zip(on_true, on_false)]
    return type(on_true)(*vals) if hasattr(on_true, "_fields") else tuple(vals)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm (0-dim float32) of a tensor or a dict of tensors."""
    leaves = tree.values() if isinstance(tree, dict) else (tree,)
    sq = None
    for z in leaves:
        zs = torch.sum(z.float() ** 2)
        sq = zs if sq is None else sq + zs
    return torch.sqrt(sq)


def round_verdict(agg_norm: torch.Tensor, health: torch.Tensor, *,
                  decay: float = 0.9, zmax: float = 6.0, warmup: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept or reject one round -> (0-dim bool accept, new health).

    Reject when the aggregate norm is non-finite, or (after ``warmup``
    accepted rounds) when its one-sided z-score against the EMA
    exceeds ``zmax`` (the z denominator has a 5 % relative floor).  The EMA
    moves only on accepted rounds; ``zmax <= 0`` keeps the finite check
    alone."""
    ema, ema_sq = health[0], health[1]
    rejected, seen = health[2], health[3]
    agg_norm = agg_norm.float()
    finite = torch.isfinite(agg_norm)
    if zmax > 0:
        var = torch.clamp(ema_sq - ema * ema, min=0.0)
        scale = torch.sqrt(var) + 0.05 * ema + _NORM_FLOOR
        z = (agg_norm - ema) / scale
        accept = finite & ((seen < warmup) | (z <= zmax))
    else:
        accept = finite
    norm0 = torch.where(finite, agg_norm, 0.0)
    d = torch.where(seen > 0.5, torch.tensor(decay, dtype=torch.float32,
                                             device=health.device), 0.0)
    new_ema = torch.where(accept, d * ema + (1.0 - d) * norm0, ema)
    new_sq = torch.where(accept, d * ema_sq + (1.0 - d) * norm0 * norm0,
                         ema_sq)
    okf = accept.float()
    new_health = torch.stack([new_ema, new_sq, rejected + (1.0 - okf),
                              seen + okf])
    return accept, new_health
