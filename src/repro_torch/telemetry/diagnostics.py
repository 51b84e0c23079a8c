"""Aggregation diagnostics (port of ``repro/telemetry/diagnostics.py``).

Every robust rule computes a per-worker suspicion signal -- geomed's
implicit Weiszfeld weights, Krum's scores, centered clipping's clip scales
-- and :class:`AggDiagnostics` is the fixed set of fields the rules return
beside the aggregate when called with ``diagnostics=True``.  The fields
are the same for every rule; a rule fills what it has and leaves the
neutral defaults (``score`` zeros, ``selected`` -1, ``clip_frac`` 0,
``converged`` True) elsewhere.  Every field is a tensor on the buffer's
device.

On the master path the per-worker fields are (W,); on the masked,
decentralized path (R, S), which :func:`reduce_masked_diagnostics` folds
into a per-sender (S,) summary.  The distances come from kernel K2 on a
CUDA device (``partial_sqdist``, its masked route for the (R, S) form) and
from its plain version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.collectives import psum

# The Weiszfeld distance floor: guards the inverse-distance weights.
_FLOOR = 1e-8


class AggDiagnostics(NamedTuple):
    """Per-round aggregation diagnostics."""

    dist: torch.Tensor       # (W,) | (R, S) distance of each message to the aggregate
    weight: torch.Tensor     # (W,) | (R, S) implicit weight, sums to 1
    score: torch.Tensor      # (W,) | (R, S) Krum scores (zeros for other rules)
    selected: torch.Tensor   # () | (R,) int32 Krum choice; -1 for other rules
    clip_frac: torch.Tensor  # () fraction of live rows clipped (centered_clip)
    residual: torch.Tensor   # () final Weiszfeld move (geomed family)
    iters: torch.Tensor      # () int32 Weiszfeld iterations run
    converged: torch.Tensor  # () bool (True for non-iterative rules)


def _normalize(w: torch.Tensor) -> torch.Tensor:
    return w / torch.clamp(torch.sum(w), min=_FLOOR)


def _scalars(dev, shape, *, selected=None, clip_frac=None, residual=None,
             iters=None, converged=None):
    def t(x, default, dtype):
        return torch.as_tensor(default if x is None else x, dtype=dtype,
                               device=dev)
    sel = (torch.full(shape, -1, dtype=torch.int32, device=dev)
           if selected is None else t(selected, None, torch.int32))
    return dict(selected=sel,
                clip_frac=t(clip_frac, 0.0, torch.float32),
                residual=t(residual, 0.0, torch.float32),
                iters=t(iters, 0, torch.int32),
                converged=t(converged, True, torch.bool))


def flat_diagnostics(buf: torch.Tensor, agg: torch.Tensor, *,
                     row_weights: Optional[torch.Tensor] = None,
                     axis_names=(),
                     weight=None, score=None, selected=None, clip_frac=None,
                     residual=None, iters=None,
                     converged=None) -> AggDiagnostics:
    """:class:`AggDiagnostics` of a flat (W, D) round with aggregate ``agg``
    (D,).  Rule-specific fields are keyword overrides; by default the
    weight is the Weiszfeld implicit weight ``rw / max(dist, 1e-8)``,
    normalized.  ``axis_names``: the mesh axes the coordinates are sharded
    over; the rows' squared distances are summed over them, so every rank
    holds the same struct."""
    z = ops.messages(buf).contiguous()
    dist = torch.sqrt(psum(ops.partial_sqdist(z, agg.float().contiguous()),
                           axis_names))
    if weight is None:
        rw = (torch.ones_like(dist) if row_weights is None
              else row_weights.float())
        weight = rw / torch.clamp(dist, min=_FLOOR)
    return AggDiagnostics(
        dist=dist, weight=_normalize(weight.float()),
        score=torch.zeros_like(dist) if score is None else score.float(),
        **_scalars(dist.device, (), selected=selected, clip_frac=clip_frac,
                   residual=residual, iters=iters, converged=converged))


def masked_diagnostics(exchange: torch.Tensor, out: torch.Tensor,
                       mask: torch.Tensor, *, axis_names=(), score=None,
                       selected=None, clip_frac=None, residual=None,
                       iters=None, converged=None) -> AggDiagnostics:
    """:class:`AggDiagnostics` of a masked (R, S, D) exchange with
    per-receiver aggregates ``out`` (R, D) under the (possibly weighted)
    (R, S) ``mask``: dead edges (mask 0) get distance and weight exactly 0,
    and their rows are not read.  ``axis_names``: the mesh axes the
    coordinates are sharded over (the squared distances are summed over
    them)."""
    m = mask.float().contiguous()
    sq = psum(ops.partial_sqdist(ops.messages(exchange),
                                 out.float().contiguous(), m), axis_names)
    live = (m > 0).float()
    dist = torch.sqrt(sq) * live
    inv = m / torch.clamp(torch.sqrt(sq), min=_FLOOR)
    weight = inv / torch.clamp(torch.sum(inv, dim=1, keepdim=True), min=_FLOOR)
    return AggDiagnostics(
        dist=dist, weight=weight,
        score=torch.zeros_like(dist) if score is None else score.float(),
        **_scalars(dist.device, (m.shape[0],), selected=selected,
                   clip_frac=clip_frac, residual=residual, iters=iters,
                   converged=converged))


def reduce_masked_diagnostics(diag: AggDiagnostics, mask: torch.Tensor, *,
                              axis_names=()) -> AggDiagnostics:
    """Fold (R, S) masked diagnostics into a per-sender (S,) summary:
    ``dist`` and ``score`` are means over the receivers that hear the
    sender, ``weight`` the total weight it received (renormalized),
    ``selected`` the sender Krum picked most often (-1 if never).  The
    receiver rows may lie on several ranks (one a rank on the
    decentralized gather path): every sum over receivers is then summed
    over ``axis_names`` as well, and every rank holds the same summary."""
    live = (mask > 0).float()
    num_receivers, num_senders = mask.shape

    def rsum(x):
        return psum(torch.sum(x, dim=0), axis_names)

    cnt = torch.clamp(rsum(live), min=1.0)
    dist = rsum(diag.dist * live) / cnt
    weight = _normalize(rsum(diag.weight * live))
    score = rsum(diag.score * live) / cnt
    senders = torch.arange(num_senders, device=mask.device)
    sel_counts = rsum((diag.selected.long()[:, None] == senders[None]).float())
    selected = torch.where(torch.sum(sel_counts) > 0,
                           torch.argmax(sel_counts).to(torch.int32),
                           torch.tensor(-1, dtype=torch.int32,
                                        device=mask.device))
    nrec = rsum(torch.ones((num_receivers,), dtype=torch.float32,
                           device=mask.device))

    def rmean(x):   # mean over receivers of a per-call scalar
        return rsum(x.float().expand(num_receivers)) / nrec

    return AggDiagnostics(
        dist=dist, weight=weight, score=score, selected=selected,
        clip_frac=rmean(diag.clip_frac), residual=rmean(diag.residual),
        iters=rmean(diag.iters).to(torch.int32),
        converged=rmean(diag.converged) >= 1.0 - 1e-6)


def diagnostics_metrics(diag: AggDiagnostics, prefix: str = "diag_") -> dict:
    """The struct as ``{"diag_dist": ..., ...}`` metric entries."""
    return {prefix + k: v for k, v in diag._asdict().items()}
