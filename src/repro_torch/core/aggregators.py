"""Robust aggregation rules over the packed (W, D) message matrix (port of
``repro/core/aggregators.py``'s flat engine).

Every rule maps a (W, D) buffer to the (D,) float32 aggregate and takes an
optional ``row_weights`` (W,) vector; ``None`` keeps the unweighted path and
weight 0 removes a row exactly.  Ported rules: ``mean`` (the non-robust
baseline) and ``geomed`` (the paper's geometric median).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.geomed import weiszfeld_flat

FlatAggregator = Callable[..., torch.Tensor]  # (W, D)[, row_weights] -> (D,)

# Guards weight-sum divisions when every row is dropped (all weights 0).
_WEIGHT_FLOOR = 1e-8


def mean_flat(buf: torch.Tensor, *, row_weights=None) -> torch.Tensor:
    if row_weights is None:
        return torch.mean(buf.float(), dim=0)
    w = row_weights.float()
    num = torch.sum(buf.float() * w[:, None], dim=0)
    return num / torch.clamp(torch.sum(w), min=_WEIGHT_FLOOR)


def geomed_flat(buf: torch.Tensor, *, max_iters: int = 64, tol: float = 1e-6,
                row_weights=None) -> torch.Tensor:
    return weiszfeld_flat(buf, max_iters=max_iters, tol=tol,
                          row_weights=row_weights)


_FLAT_REGISTRY: dict[str, Callable[[dict], FlatAggregator]] = {
    "mean": lambda o: mean_flat,
    "geomed": lambda o: functools.partial(
        geomed_flat, max_iters=o.get("max_iters", 64), tol=o.get("tol", 1e-6)),
}

AGGREGATOR_NAMES = tuple(_FLAT_REGISTRY)

# The reference's rules that the port does not carry yet.
UNPORTED = ("median", "trimmed_mean", "krum", "geomed_groups",
            "centered_clip", "geomed_blockwise")


def get_flat_aggregator(name: str, **opts) -> FlatAggregator:
    """Build a flat aggregator ``fn(buf (W, D)) -> (D,) f32`` by name.
    Options: ``max_iters``, ``tol`` (geomed)."""
    if opts.get("diagnostics"):
        raise ValueError("aggregation diagnostics are not ported yet "
                         "(ROADMAP.md Queue A item 7)")
    try:
        build = _FLAT_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; ported: "
            f"{', '.join(sorted(_FLAT_REGISTRY))}; still to port from the "
            f"reference: {', '.join(UNPORTED)} (ROADMAP.md Queue A item 4)"
        ) from None
    return build(opts)
