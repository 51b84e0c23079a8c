"""Scalar step metrics (port of ``repro/telemetry/metrics.py``)."""
from __future__ import annotations

import torch


def honest_variance(honest: torch.Tensor, num_honest: int) -> torch.Tensor:
    """Mean squared deviation of the honest messages around their mean (the
    paper's bottom-row variance curves): ``sum_w ||z_w - z_bar||^2 / W_h``.
    ``honest`` is the packed (W_h, D) buffer; the result stays on its
    device."""
    h32 = honest.float()
    return torch.sum((h32 - torch.mean(h32, dim=0)[None]) ** 2) / num_honest


def health_metrics(health, accepted) -> dict:
    """Round-health scalars of the guards' verdict: ``{}`` when guards are
    off (``health`` None), else this round's verdict (1.0 accepted, 0.0
    rejected), the rejected-round count and the aggregate-norm EMA."""
    if health is None:
        return {}
    return {"round_accepted": accepted.float(),
            "rejected_rounds": health[2],
            "agg_norm_ema": health[0]}


def staleness_metrics(slot_staleness) -> dict:
    """``{"mean_staleness": ...}`` of the round's per-slot counters, or
    ``{}`` without staleness weights (``None``)."""
    if slot_staleness is None:
        return {}
    return {"mean_staleness": torch.mean(slot_staleness.float())}
