"""Geometric median via the Weiszfeld algorithm, paper eq. (6) (port of
``repro/core/geomed.py``'s flat engine).

    y^{t+1} = sum_w a_w z_w / d_w  /  max(sum_w a_w / d_w, 1e-8),
    d_w = max(||z_w - y^t||, 1e-8)

from the coordinate-wise mean, stopped after ``max_iters`` iterations or
once the iterate moves no more than ``tol`` -- the semantics of the
reference's ``weiszfeld_pytree``/``weiszfeld_flat``.  ``a_w`` are the
optional ``row_weights`` (weight 0 removes a row exactly).

Each iteration runs kernel K2 (``partial_sqdist``), a few (W,)-sized
PyTorch ops, then kernel K3 (``weighted_sum``) on a CUDA device, or their
plain versions on the CPU.  The early stop reads the iterate's move on the
host after every iteration -- one device-to-host sync per iteration -- so
the loop runs exactly the iterations the reference's ``while_loop`` runs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ops

# Distance floor; plays the role of Weiszfeld smoothing so the iteration is
# well defined when y coincides with one of the points.
_DIST_FLOOR = 1e-8


class WeiszfeldInfo(NamedTuple):
    """Convergence facts of one Weiszfeld solve."""

    residual: float  # final iterate move (inf if 0 iterations)
    iters: int       # iterations run
    converged: bool  # residual <= tol


def weiszfeld_flat(buf: torch.Tensor, *, max_iters: int = 64,
                   tol: float = 1e-6,
                   row_weights: torch.Tensor | None = None,
                   return_info: bool = False):
    """Geometric median of one packed (W, D) message matrix -> (D,)
    float32 (and a :class:`WeiszfeldInfo` with ``return_info``)."""
    if buf.dim() != 2:
        raise ValueError(f"weiszfeld_flat expects (W, D), got {tuple(buf.shape)}")
    z = buf.float().contiguous()
    rw = None if row_weights is None else row_weights.float()
    y = torch.mean(z, dim=0)
    # The reference compares its float32 move with tol rounded to float32.
    tol = float(torch.tensor(tol, dtype=torch.float32))
    delta, it = math.inf, 0
    while it < max_iters and delta > tol:
        inv = 1.0 / torch.clamp(torch.sqrt(ops.partial_sqdist(z, y)),
                                min=_DIST_FLOOR)
        if rw is not None:
            inv = inv * rw
        wsum = torch.clamp(torch.sum(inv), min=_DIST_FLOOR)
        y_new = ops.weighted_sum(z, inv) / wsum
        delta = float(torch.sqrt(torch.sum((y_new - y) ** 2)))
        y, it = y_new, it + 1
    if return_info:
        return y, WeiszfeldInfo(residual=delta, iters=it,
                                converged=delta <= tol)
    return y
