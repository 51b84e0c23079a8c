"""Masked-neighbourhood counterparts of every aggregation rule (port of
``repro/topology/masked.py``'s flat engine).

Decentralized training has no master: node r robustly aggregates only the
messages of its neighbourhood N(r) + {r}.  Every rule here takes

* ``exchange`` -- the packed (R, S, D) buffer: row r is what receiver r
  sees from each of the S senders (per-edge attacks make it
  receiver-dependent, hence the dense layout);
* ``mask``     -- (R, S) float32 neighbour mask: ``mask[r, s] = 0`` senders
  must not influence receiver r's result;

and returns the (R, D) float32 per-receiver aggregates.  Restriction is by
mask, never by slicing the sender axis: non-neighbours are weighted to
zero, filled with +inf out of sorts, or masked out of pairwise distances.

Kernels on a CUDA device (their plain versions on the CPU):

* ``trimmed_mean`` -- K7 ``masked_neighbor_reduce`` (one launch per step;
  its "select" kernel up to trim 16, "rank" beyond);
* ``geomed``, ``geomed_groups``, ``geomed_blockwise`` -- the masked
  Weiszfeld :func:`masked_weiszfeld`: K7 with trim 0 (its "sum" kernel) for
  the initial masked mean, then per iteration one K2 launch on its masked
  route and one K3 launch for all receivers at once (their
  receiver-batched form); both read only the neighbours' rows;
* ``mean`` (mixing-weighted) -- one K3 launch.

Every kernel takes any number of senders and receivers that fits in memory.

``median``, ``krum`` and ``centered_clip`` are torch ops, as the
reference's are jnp, in float32.  A bf16 exchange (the bf16 wire) goes to
the kernels as it is.

K7 reduces by 0/1 counts (a sender with mask > 0 counts once).  Staleness
weights come in as ``row_weights`` (S,), which :func:`masked_aggregate_flat`
multiplies into the mask's sender columns (and ``mixing``'s); given them,
the trimmed mean takes the reference's torch form (its neighbour count
``int(sum_s mask)``) and the masked Weiszfeld starts from the weighted mean
(K3) instead of K7's count mean, as the reference's step uses K7 only when
``row_weights is None``.

:func:`masked_aggregate` takes an exchange given as a dict of (R, S,
*shape) leaves: through the flat engine, or with ``perleaf=True`` leaf by
leaf, as the reference's pre-packing rules (the ``packed=False`` baseline:
each kernel once per leaf, the Weiszfeld rules' distances added over the
leaves, Krum's over the leaves concatenated).

``diagnostics=True`` returns ``(out, AggDiagnostics)`` with (R, S)
receiver-by-sender fields (:func:`repro_torch.telemetry.masked_diagnostics`;
the distances by the masked, receiver-batched K2).

Across ranks (:mod:`repro_torch.collectives`, the decentralized
``decentralized_aggregate``) the rules take the reference's
``axis_names``, the mesh axes the coordinates are sharded over: the
Weiszfeld rules sum their (R, S) distance partials and their moves over
them, Krum its (R, S, S) Gram partials (symmetrized after the sum), and
centered clipping its residual norms; the coordinate-wise rules need no
sum.  ``sync_axes`` are axes over which each Weiszfeld stop is maxed, so
that ranks iterating different receivers stop together.  With no axes
every rule runs the single-process program.
:func:`masked_weiszfeld_segments` is the per-block masked Weiszfeld of a
coordinate slice (the sharded ``geomed_blockwise``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch

from repro_torch.collectives import pmax, psum
from repro_torch.core import packing
from repro_torch.core.geomed import WeiszfeldInfo, _f32_tol
from repro_torch.kernels import ops
from repro_torch.telemetry.diagnostics import masked_diagnostics

# The reference's floor for distances and for weight sums.
_DIST_FLOOR = 1e-8


def _weighted_mean(ex: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-receiver weighted mean over the sender axis: ex (R, S, D),
    weights (R, S) -> (R, D) (kernel K3, receiver-batched)."""
    weights = weights.contiguous()
    denom = torch.clamp(torch.sum(weights, dim=1), min=_DIST_FLOOR)
    return ops.weighted_sum(ex, weights) / denom[:, None]


def masked_mean(exchange: torch.Tensor, mask: torch.Tensor, *,
                mixing: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked neighbourhood mean.  With ``mixing`` (rows of the doubly
    stochastic matrix) this is one DGD gossip step; without, the uniform
    mean over the masked senders."""
    weights = mask if mixing is None else mixing * mask
    return _weighted_mean(ops.messages(exchange), weights)


def _masked_sorted(z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stable sort of the sender axis with non-neighbours filled to +inf."""
    return torch.sort(torch.where(mask[:, :, None] > 0, z, torch.inf),
                      dim=1, stable=True).values


def masked_median(exchange: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over each masked neighbourhood; the median's
    ranks come from the neighbour count (mean of the two middle values)."""
    z = exchange.float()
    n = torch.sum(mask, dim=1).to(torch.int64)                  # (R,)
    s = _masked_sorted(z, mask)
    d = z.shape[2]

    def sel(i):
        return torch.gather(s, 1, i[:, None, None].expand(-1, 1, d))[:, 0]

    return 0.5 * (sel((n - 1) // 2) + sel(n // 2))


def masked_trimmed_mean(exchange: torch.Tensor, mask: torch.Tensor, *,
                        trim: int, weighted: bool = False
                        ) -> torch.Tensor:
    """Coordinate-wise trimmed mean per neighbourhood: drop the ``trim``
    largest and smallest masked entries per coordinate, average the rest
    (kernel K7).  Every neighbourhood must have > 2 * trim members
    (``validate_schedule`` checks the graph).  With ``weighted`` (the mask
    carries staleness weights) the neighbour count is ``int(sum_s mask[r,
    s])``, the reference's, and the rule runs in torch."""
    if not weighted:
        return ops.masked_neighbor_reduce(ops.messages(exchange),
                                          mask.contiguous(), trim=trim)
    n = torch.sum(mask, dim=1).to(torch.int64)                  # (R,)
    s = _masked_sorted(exchange.float(), mask)
    ranks = torch.arange(s.shape[1], device=s.device)[None, :, None]
    keep = (ranks >= trim) & (ranks < (n - trim)[:, None, None])
    return (torch.sum(torch.where(keep, s, 0.0), dim=1)
            / torch.clamp(n - 2 * trim, min=1).float()[:, None])


def masked_weiszfeld(exchange: torch.Tensor, mask: torch.Tensor, *,
                     max_iters: int = 64, tol: float = 1e-6,
                     weighted: bool = False, axis_names=(), sync_axes=(),
                     return_info: bool = False):
    """Per-receiver geometric median of the masked neighbourhood, all
    receivers in lockstep: from the masked mean (K7, trim 0; the weighted
    mean by K3 when the mask is ``weighted``), each
    iteration takes the (R, S) distances (K2, masked: 0 for a
    non-neighbour, whose row is not read), the weights ``inv = mask /
    max(sqrt(sq), 1e-8)`` and the weighted means (K3), and one host read of
    ``sqrt(max_r move_r)`` decides the one stop for all receivers (``tol``,
    or ``max_iters``).  Non-neighbours get weight 0, so the restriction is
    exact.  ``exchange`` may be a column slice of a wider buffer."""
    ys, info = _masked_weiszfeld_leaves([exchange], mask, max_iters=max_iters,
                                        tol=tol, weighted=weighted,
                                        axis_names=axis_names,
                                        sync_axes=sync_axes)
    return (ys[0], info) if return_info else ys[0]


def _masked_weiszfeld_leaves(leaves, mask: torch.Tensor, *, max_iters: int,
                             tol: float, weighted: bool, axis_names=(),
                             sync_axes=()):
    """The masked Weiszfeld loop over the (R, S, d_l) blocks of one
    exchange: each block starts from its masked mean, each iteration adds
    the blocks' masked K2 distances in block order (then over
    ``axis_names``) and runs K3 on each block; the stop reads
    ``sqrt(max_r move_r)``, the moves summed over ``axis_names`` and the
    result maxed over ``sync_axes`` (the reference's ``_global_delta``).
    -> ([(R, d_l) float32 iterates], WeiszfeldInfo)."""
    zs = [ops.messages(z) for z in leaves]
    mask = mask.contiguous()
    ys = [_weighted_mean(z, mask) if weighted
          else ops.masked_neighbor_reduce(z, mask, trim=0) for z in zs]
    tol = _f32_tol(tol)
    delta, it = math.inf, 0
    while it < max_iters and delta > tol:
        sq = None
        for z, y in zip(zs, ys):
            part = ops.partial_sqdist(z, y, mask)               # (R, S)
            sq = part if sq is None else sq + part
        sq = psum(sq, axis_names)
        inv = mask / torch.clamp(torch.sqrt(sq), min=_DIST_FLOOR)
        move = None
        for i, (z, y) in enumerate(zip(zs, ys)):
            ys[i] = _weighted_mean(z, inv)
            part = torch.sum((ys[i] - y) ** 2, dim=1)
            move = part if move is None else move + part
        # Every rank reads the same stop: the loop's next collective waits
        # for all of them.
        delta = float(pmax(torch.sqrt(torch.max(psum(move, axis_names))),
                           sync_axes))
        it += 1
    return ys, WeiszfeldInfo(residual=delta, iters=it, converged=delta <= tol)


def masked_geomed_groups(exchange: torch.Tensor, mask: torch.Tensor, *,
                         num_groups: int, max_iters: int = 64,
                         tol: float = 1e-6, axis_names=(),
                         sync_axes=()) -> torch.Tensor:
    """Geomed of masked group means: senders keep their global contiguous
    group ids ``(s * G) // S``, each receiver averages the members inside
    its neighbourhood, and groups with no member there drop out."""
    grouped, gmask = _masked_group_means(exchange, mask, num_groups)
    return masked_weiszfeld(grouped, gmask, max_iters=max_iters, tol=tol,
                            axis_names=axis_names, sync_axes=sync_axes)


def _masked_group_means(exchange: torch.Tensor, mask: torch.Tensor,
                        num_groups: int):
    """Each receiver's means of its members of the global contiguous sender
    groups -> ((R, G, D) float32, the (R, G) mask of non-empty groups)."""
    s_tot = mask.shape[1]
    gids = (torch.arange(s_tot, device=mask.device) * num_groups) // s_tot
    onehot = (gids[None, :] == torch.arange(
        num_groups, device=mask.device)[:, None]).float()       # (G, S)
    counts = mask @ onehot.T                                    # (R, G)
    w = mask[:, None, :] * onehot[None]                         # (R, G, S)
    grouped = torch.bmm(w, exchange.float()) / torch.clamp(
        counts, min=1.0)[:, :, None]                            # (R, G, D)
    return grouped, (counts > 0).float()


def masked_geomed_blockwise(exchange: torch.Tensor, mask: torch.Tensor, *,
                            spec: packing.PackSpec, max_iters: int = 64,
                            tol: float = 1e-6, weighted: bool = False,
                            axis_names=(), sync_axes=(),
                            return_info: bool = False):
    """Per-block masked geometric median: each leaf's coordinate slice of
    the packed buffer runs its own lockstep masked Weiszfeld (read in
    place), one block after another; padding aggregates to zero.  With
    ``return_info``, one :class:`WeiszfeldInfo` per block as well."""
    z = ops.messages(exchange)
    solved = [masked_weiszfeld(z[:, :, a:b], mask, max_iters=max_iters,
                               tol=tol, weighted=weighted,
                               axis_names=axis_names, sync_axes=sync_axes,
                               return_info=True)
              for a, b in spec.boundaries]
    out = packing.assemble([p for p, _ in solved], pad=spec.pad,
                           batch_shape=(z.shape[0],), device=z.device)
    if return_info:
        return out, [i for _, i in solved]
    return out


def masked_krum(exchange: torch.Tensor, mask: torch.Tensor, *,
                num_byzantine: int, axis_names=(),
                return_scores: bool = False):
    """Per-receiver Krum over the masked neighbourhood: a candidate's score
    sums its ``m_r - B - 2`` smallest distances to other neighbourhood
    members (clipped to >= 1; the guarantee is void below Krum's bound),
    and the winning sender's message is selected.  With ``axis_names`` the
    (R, S, S) Gram partials are summed over them, so every rank selects
    the same sender and keeps its own slice of it.  ``return_scores``:
    also the (R, S) scores (+inf off the mask) and the (R,) choices."""
    z = exchange.float()
    sq = torch.sum(z ** 2, dim=-1)                              # (R, S)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(z, z.transpose(1, 2))
    if axis_names:
        # Restore the exact symmetry the sum may lose, as flat_sq_dists.
        d2 = psum(d2, axis_names)
        d2 = 0.5 * (d2 + d2.transpose(1, 2))
    s_tot = mask.shape[1]
    pair = (mask[:, :, None] * mask[:, None, :]
            * (1.0 - torch.eye(s_tot, device=z.device))[None])
    d2 = torch.where(pair > 0, torch.clamp(d2, min=0.0), torch.inf)
    m_r = torch.sum(mask, dim=1).to(torch.int64)                # (R,)
    n_near = torch.minimum(torch.clamp(m_r - num_byzantine - 2, min=1),
                           torch.clamp(m_r - 1, min=1))
    ranks = torch.arange(s_tot, device=z.device)[None, None, :]
    contrib = torch.where(ranks < n_near[:, None, None],
                          torch.sort(d2, dim=2).values, 0.0)
    scores = torch.where(mask > 0, torch.sum(contrib, dim=2), torch.inf)
    best = torch.argmin(scores, dim=1)                          # (R,)
    out = z[torch.arange(z.shape[0], device=z.device), best]
    if return_scores:
        return out, scores, best
    return out


def masked_centered_clip(exchange: torch.Tensor, mask: torch.Tensor, *,
                         radius: float = 1.0, iters: int = 3,
                         axis_names=()) -> torch.Tensor:
    """Centered clipping per neighbourhood: iterate from the masked median,
    each sender's influence clipped to ``radius`` by its residual norm
    (summed over ``axis_names``)."""
    return _masked_centered_clip_leaves([exchange], mask, radius=radius,
                                        iters=iters, axis_names=axis_names)[0]


def _masked_centered_clip_leaves(leaves, mask: torch.Tensor, *, radius: float,
                                 iters: int, axis_names=()
                                 ) -> list[torch.Tensor]:
    """Centered clipping on the (R, S, d_l) blocks of one exchange, each
    sender's residual norm taken over all blocks (added in block order,
    then over ``axis_names``)."""
    zs = [z.float() for z in leaves]
    vs = [masked_median(z, mask) for z in zs]
    denom = torch.clamp(torch.sum(mask, dim=1), min=_DIST_FLOOR)
    for _ in range(iters):
        diffs = [z - v[:, None] for z, v in zip(zs, vs)]
        sq = None
        for dl in diffs:
            part = torch.sum(dl * dl, dim=-1)
            sq = part if sq is None else sq + part
        sq = psum(sq, axis_names)
        scale = torch.clamp(radius / torch.clamp(torch.sqrt(sq), min=1e-12),
                            max=1.0)
        w = mask * scale
        vs = [v + torch.sum(w[:, :, None] * dl, dim=1) / denom[:, None]
              for v, dl in zip(vs, diffs)]
    return vs


def masked_weiszfeld_segments(ex: torch.Tensor, mask: torch.Tensor,
                              seg_ids: torch.Tensor, num_segments: int, *,
                              axis_names=(), max_iters: int = 64,
                              tol: float = 1e-6) -> torch.Tensor:
    """Per-block masked Weiszfeld on a coordinate slice (the decentralized
    ``comm="sharded"`` form of ``geomed_blockwise``): ``ex`` (R, S, c) is
    every receiver's view of every sender's slice, ``seg_ids`` (c,) the
    block of each coordinate (padding in the dummy block ``num_segments -
    1``).  All blocks of all receivers run in lockstep from the masked
    mean: one (R, S, num_segments) sum of per-block squared distances over
    ``axis_names`` an iteration, each coordinate weighted by its block's
    inverse distances, stopped when the largest (receiver, block) move
    (summed over the axes) reaches ``tol`` -> (R, c) float32.  Segment
    sums in plain torch (``index_add_``), as the reference's
    ``segment_sum``."""
    ex32 = ex.float()
    r, s_tot, _ = ex32.shape
    seg = seg_ids.to(device=ex32.device, dtype=torch.int64)

    def seg_psum(part):
        out = torch.zeros(part.shape[:-1] + (num_segments,),
                          dtype=torch.float32, device=part.device)
        return psum(out.index_add_(part.dim() - 1, seg, part), axis_names)

    mask = mask.float()
    denom0 = torch.clamp(torch.sum(mask, dim=1), min=_DIST_FLOOR)
    y = torch.sum(mask[:, :, None] * ex32, dim=1) / denom0[:, None]
    tol = _f32_tol(tol)
    delta, it = math.inf, 0
    while it < max_iters and delta > tol:
        diff = ex32 - y[:, None]                                  # (R, S, c)
        sq = seg_psum(diff * diff)                                # (R, S, L)
        inv = mask[:, :, None] / torch.clamp(torch.sqrt(sq), min=_DIST_FLOOR)
        w_coord = inv[:, :, seg]                                  # (R, S, c)
        denom = torch.sum(inv, dim=1)[:, seg]                     # (R, c)
        y_new = (torch.sum(w_coord * ex32, dim=1)
                 / torch.clamp(denom, min=_DIST_FLOOR))
        move = seg_psum((y_new - y) ** 2)                         # (R, L)
        y = y_new
        delta = float(torch.sqrt(torch.max(move)))
        it += 1
    return y


def _iters(o: dict) -> dict:
    """The Weiszfeld rules' loop options and axes out of ``opts``."""
    return dict(max_iters=o.get("max_iters", 64), tol=o.get("tol", 1e-6),
                axis_names=o.get("axis_names", ()),
                sync_axes=o.get("sync_axes", ()))


# name -> masked rule (exchange, mask, spec, opts); the reference's names,
# the same set as core.aggregators._FLAT_REGISTRY.
_MASKED: dict[str, Any] = {
    "mean": lambda ex, m, spec, o: masked_mean(ex, m, mixing=o.get("mixing")),
    "median": lambda ex, m, spec, o: masked_median(ex, m),
    "trimmed_mean": lambda ex, m, spec, o: masked_trimmed_mean(
        ex, m, trim=o.get("trim", 1), weighted=o["weighted"]),
    "geomed": lambda ex, m, spec, o: masked_weiszfeld(
        ex, m, weighted=o["weighted"], **_iters(o)),
    "geomed_groups": lambda ex, m, spec, o: masked_geomed_groups(
        ex, m, num_groups=o["num_groups"], **_iters(o)),
    "geomed_blockwise": lambda ex, m, spec, o: masked_geomed_blockwise(
        ex, m, spec=spec, weighted=o["weighted"], **_iters(o)),
    "krum": lambda ex, m, spec, o: masked_krum(
        ex, m, num_byzantine=o.get("num_byzantine", 0),
        axis_names=o.get("axis_names", ())),
    "centered_clip": lambda ex, m, spec, o: masked_centered_clip(
        ex, m, radius=o.get("clip_radius", 1.0),
        axis_names=o.get("axis_names", ())),
}

MASKED_AGGREGATOR_NAMES = tuple(_MASKED)


# ---- The per-leaf rules: dicts of (R, S, *shape) leaves -> (R, *shape) ----


def _leaf_rows3(z: torch.Tensor) -> torch.Tensor:
    """An (R, S, *shape) leaf as its (R, S, d_l) exchange: a view of a
    contiguous leaf, or of a leaf broadcast over the receivers."""
    return ops.messages(z).reshape(z.shape[0], z.shape[1], -1)


def _per_leaf(exchange: dict, fn) -> dict:
    """``fn`` on each leaf's (R, S, d_l) exchange, back to (R, *shape)."""
    return {k: fn(_leaf_rows3(z)).reshape(z.shape[:1] + z.shape[2:]).to(z.dtype)
            for k, z in exchange.items()}


def _from_leaves(exchange: dict, ys) -> dict:
    """(R, d_l) results in sorted-name order -> (R, *shape) leaves."""
    return {k: y.reshape(exchange[k].shape[:1] + exchange[k].shape[2:]
                         ).to(exchange[k].dtype)
            for k, y in zip(sorted(exchange), ys)}


def _sorted_rows3(exchange: dict) -> list[torch.Tensor]:
    return [_leaf_rows3(exchange[k]) for k in sorted(exchange)]


def _krum_perleaf(ex, m, o):
    flat = torch.cat([z.float() for z in _sorted_rows3(ex)], dim=-1)
    _, _, best = masked_krum(flat, m, num_byzantine=o.get("num_byzantine", 0),
                             axis_names=o.get("axis_names", ()),
                             return_scores=True)
    rows = torch.arange(m.shape[0], device=m.device)
    return {k: z[rows, best] for k, z in ex.items()}


def _geomed_groups_perleaf(ex, m, o):
    parts = [_masked_group_means(z, m, o["num_groups"]) for z in _sorted_rows3(ex)]
    ys, _ = _masked_weiszfeld_leaves(
        [g for g, _ in parts], parts[0][1], weighted=False, **_iters(o))
    return _from_leaves(ex, ys)


# name -> per-leaf masked rule (exchange dict, mask, opts): the reference's
# leaf-by-leaf dispatch, each kernel launched once per leaf.
_MASKED_PERLEAF: dict[str, Any] = {
    "mean": lambda ex, m, o: _per_leaf(
        ex, lambda z: masked_mean(z, m, mixing=o.get("mixing"))),
    "median": lambda ex, m, o: _per_leaf(ex, lambda z: masked_median(z, m)),
    "trimmed_mean": lambda ex, m, o: _per_leaf(
        ex, lambda z: masked_trimmed_mean(z, m, trim=o.get("trim", 1),
                                          weighted=o["weighted"])),
    "geomed": lambda ex, m, o: _from_leaves(ex, _masked_weiszfeld_leaves(
        _sorted_rows3(ex), m, weighted=o["weighted"], **_iters(o))[0]),
    "geomed_groups": _geomed_groups_perleaf,
    "geomed_blockwise": lambda ex, m, o: _per_leaf(ex, lambda z: masked_weiszfeld(
        z, m, weighted=o["weighted"], **_iters(o))),
    "krum": _krum_perleaf,
    "centered_clip": lambda ex, m, o: _from_leaves(
        ex, _masked_centered_clip_leaves(_sorted_rows3(ex), m,
                                         radius=o.get("clip_radius", 1.0),
                                         iters=3,
                                         axis_names=o.get("axis_names", ()))),
}

assert set(_MASKED_PERLEAF) == set(_MASKED)


def _weigh(mask: torch.Tensor, row_weights: Optional[torch.Tensor],
           opts: dict) -> torch.Tensor:
    """The mask (and ``opts["mixing"]``) with its sender columns scaled by
    ``row_weights``; sets ``opts["weighted"]``."""
    mask = mask.float()
    if row_weights is not None:
        cols = row_weights.float()[None, :]
        mask = mask * cols
        if opts.get("mixing") is not None:
            opts["mixing"] = opts["mixing"] * cols
    opts["weighted"] = row_weights is not None
    return mask


def masked_aggregate_flat(name: str, buf: torch.Tensor, mask: torch.Tensor,
                          *, spec: Optional[packing.PackSpec] = None,
                          row_weights: Optional[torch.Tensor] = None,
                          diagnostics: bool = False,
                          **opts) -> torch.Tensor:
    """Flat masked engine: packed (R, S, D) exchange -> (R, D) float32
    per-receiver aggregates.  ``spec`` is needed by ``geomed_blockwise``
    only (its leaf boundaries).  Options: ``mixing`` (mean), ``max_iters``,
    ``tol``, ``num_groups``, ``trim``, ``num_byzantine``, ``clip_radius``,
    and across ranks ``axis_names``/``sync_axes`` (the axes the
    coordinates are sharded over, and the axes whose Weiszfeld loops stop
    together; see the module docstring).
    ``row_weights`` (S,) are per-sender staleness weights: they scale the
    mask's (and ``mixing``'s) sender columns here, and the rules K7 runs by
    0/1 counts take their weighted forms.  ``diagnostics=True`` returns
    ``(out, AggDiagnostics)``."""
    if name not in _MASKED:
        raise ValueError(
            f"unknown masked aggregator {name!r}; known: "
            f"{', '.join(sorted(_MASKED))}")
    if name == "geomed_blockwise" and spec is None:
        raise ValueError(
            "masked_aggregate_flat('geomed_blockwise') needs spec= for the "
            "block boundaries")
    mask = _weigh(mask, row_weights, opts)
    if not diagnostics:
        return _MASKED[name](buf, mask, spec, opts)
    extras = {}
    if name in ("geomed", "geomed_blockwise"):
        fn = masked_weiszfeld if name == "geomed" else functools.partial(
            masked_geomed_blockwise, spec=spec)
        out, info = fn(buf, mask, weighted=opts["weighted"],
                       return_info=True, **_iters(opts))
        infos = [info] if name == "geomed" else info
        extras = dict(residual=max(i.residual for i in infos),
                      iters=max(i.iters for i in infos),
                      converged=all(i.converged for i in infos))
    elif name == "krum":
        out, scores, best = masked_krum(
            buf, mask, num_byzantine=opts.get("num_byzantine", 0),
            axis_names=opts.get("axis_names", ()), return_scores=True)
        # Off-mask scores are +inf sentinels; zero them to keep the
        # struct finite.
        extras = dict(score=torch.where(mask > 0, scores, 0.0), selected=best)
    else:
        out = _MASKED[name](buf, mask, spec, opts)
    diag = masked_diagnostics(buf, out, mask,
                              axis_names=opts.get("axis_names", ()), **extras)
    if name == "centered_clip":
        # A live sender whose residual to the final centre exceeds the
        # radius had its influence clipped this round.
        live = (mask > 0).float()
        clipped = live * (diag.dist > opts.get("clip_radius", 1.0))
        diag = diag._replace(clip_frac=torch.sum(clipped)
                             / torch.clamp(torch.sum(live), min=1.0))
    return out, diag



def masked_aggregate(name: str, exchange, mask: torch.Tensor, *,
                     perleaf: bool = False, diagnostics: bool = False,
                     row_weights: Optional[torch.Tensor] = None,
                     spec: Optional[packing.PackSpec] = None, **opts):
    """Masked aggregation of a dict of (R, S, *shape) leaves -> (R, *shape)
    leaves (a tensor exchange, laid out by ``spec``, goes to
    :func:`masked_aggregate_flat`).  By default a pack -> flat rule ->
    unpack shim; ``perleaf=True`` is the per-leaf baseline
    (``_MASKED_PERLEAF``: K7, the masked K2 and K3 on each leaf).
    Diagnostics are a flat-engine feature: they route a per-leaf call
    through the packed engine, as the reference does.  Options and
    ``row_weights`` as :func:`masked_aggregate_flat`."""
    if name not in _MASKED:
        raise ValueError(
            f"unknown masked aggregator {name!r}; known: "
            f"{', '.join(sorted(_MASKED))}")
    if isinstance(exchange, torch.Tensor):
        return masked_aggregate_flat(name, exchange, mask, spec=spec,
                                     row_weights=row_weights,
                                     diagnostics=diagnostics, **opts)
    if perleaf and not diagnostics:
        return _MASKED_PERLEAF[name](exchange, _weigh(mask, row_weights, opts),
                                     opts)
    spec = packing.pack_spec(exchange, batch_ndim=2)
    out = masked_aggregate_flat(name, spec.pack(exchange, batch_ndim=2), mask,
                                spec=spec, row_weights=row_weights,
                                diagnostics=diagnostics, **opts)
    if diagnostics:
        out, diag = out
        return spec.unpack(out, batch_ndim=1), diag
    return spec.unpack(out, batch_ndim=1)
