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
