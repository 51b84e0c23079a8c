"""Robust aggregation rules over the packed (W, D) message matrix (port of
``repro/core/aggregators.py``'s flat engine).

Every rule maps a (W, D) buffer to the (D,) float32 aggregate and takes an
optional ``row_weights`` (W,) vector; ``None`` keeps the unweighted path and
weight 0 removes a row exactly.  Rules, as in the reference's registry:

* ``mean``             -- the non-robust baseline.
* ``median``           -- coordinate-wise median [11] (kernel K4 on the card).
* ``trimmed_mean``     -- coordinate-wise ``trim``-trimmed mean [12] (K5).
* ``geomed``           -- the paper's geometric median (K2, K3).
* ``geomed_groups``    -- geometric median of contiguous group means.
* ``krum``             -- Krum selection [14]; needs B in advance.
* ``centered_clip``    -- centered clipping from the coordinate median (K4).
* ``geomed_blockwise`` -- one geometric median per leaf of the packed
  buffer (K6, K3).

The weighted forms of ``median`` and ``trimmed_mean`` sort with the weights
along each coordinate in plain PyTorch on both devices, as the reference
computes them outside any kernel; so do Krum's Gram product and its (W, W)
sort.  A bf16 buffer (the bf16 wire) goes to the kernels as it is; the
torch-side pieces compute in float32, where the reference casts.

Every rule also takes ``diagnostics=False``; True returns ``(aggregate,
AggDiagnostics)`` (:mod:`repro_torch.telemetry.diagnostics`: each row's
distance to the aggregate by kernel K2, the rule's implicit weights, Krum's
scores and choice, the clip fraction, the Weiszfeld residual, iterations
and convergence).  False runs the program it ran before.

Across ranks (:mod:`repro_torch.collectives`) the rules take the
reference's ``axis_names`` -- the mesh axes the coordinates of the rows
are sharded over, whose per-row partials (Weiszfeld and clip distances,
Krum's Gram product, the diagnostics' distances) are summed over them --
and the Weiszfeld rules ``sync_axes`` as well (:mod:`repro_torch.core.geomed`).
Empty axes run the single-process program.

The pytree API (:func:`get_aggregator`) takes a dict of (W, *shape) leaves
and returns (*shape) leaves: by default a pack -> flat rule -> unpack shim
(``_REGISTRY``); with ``perleaf=True`` the reference's pre-packing per-leaf
rules (``_PERLEAF_REGISTRY``, the ``RobustConfig(packed=False)`` baseline),
which launch each kernel once per leaf: median K4 and trimmed_mean K5 on
each leaf's (W, d_l) matrix, the Weiszfeld rules K2 on every leaf then K3
on every leaf each iteration (:func:`weiszfeld_pytree`), Krum's Gram over
the leaves concatenated.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import packing
from repro_torch.core.geomed import (weiszfeld_blockwise_flat, weiszfeld_flat,
                                     weiszfeld_pytree)
from repro_torch.kernels import ops
from repro_torch.collectives import psum
from repro_torch.telemetry.diagnostics import flat_diagnostics

FlatAggregator = Callable[..., torch.Tensor]  # (W, D)[, row_weights] -> (D,)
Tree = dict[str, torch.Tensor]
Aggregator = Callable[[Tree], Tree]  # leaves (W, *shape) -> leaves (*shape)

# Guards weight-sum divisions when every row is dropped (all weights 0).
_WEIGHT_FLOOR = 1e-8


def _sorted_with_weights(buf: torch.Tensor, row_weights: torch.Tensor):
    """Per-coordinate ascending sort of ``buf`` with the weight vector
    permuted along each coordinate's sort order -> (vals, wsort).  Stable,
    as ``jnp.argsort`` is."""
    vals, order = torch.sort(buf.float(), dim=0, stable=True)
    return vals, row_weights.float()[order]


def mean_flat(buf: torch.Tensor, *, row_weights=None, axis_names=(),
              diagnostics: bool = False) -> torch.Tensor:
    if row_weights is None:
        out = torch.mean(buf.float(), dim=0)
    else:
        w = row_weights.float()
        num = torch.sum(buf.float() * w[:, None], dim=0)
        out = num / torch.clamp(torch.sum(w), min=_WEIGHT_FLOOR)
    if not diagnostics:
        return out
    # The mean's implicit weight is the (normalized) row weights.
    rw = (torch.ones((buf.shape[0],), device=buf.device)
          if row_weights is None else row_weights.float())
    return out, flat_diagnostics(buf, out, row_weights=row_weights,
                                 axis_names=axis_names, weight=rw)


def median_flat(buf: torch.Tensor, *, row_weights=None, axis_names=(),
                diagnostics: bool = False) -> torch.Tensor:
    if diagnostics:
        out = median_flat(buf, row_weights=row_weights)
        return out, flat_diagnostics(buf, out, row_weights=row_weights,
                                     axis_names=axis_names)
    if row_weights is None:
        return ops.coordinate_median(ops.messages(buf).contiguous())
    # Weighted median per coordinate: the smallest value whose cumulative
    # weight reaches half the total mass (dropped rows carry zero mass and
    # can never be selected unless everything is dropped).
    vals, wsort = _sorted_with_weights(buf, row_weights)
    cum = torch.cumsum(wsort, dim=0)
    half = 0.5 * torch.sum(row_weights.float())
    sel = torch.argmax((cum >= half).to(torch.uint8), dim=0)       # (D,)
    return torch.gather(vals, 0, sel[None])[0]


def trimmed_mean_flat(buf: torch.Tensor, *, trim: int,
                      row_weights=None, axis_names=(),
                      diagnostics: bool = False) -> torch.Tensor:
    w = buf.shape[0]
    if 2 * trim >= w:
        raise ValueError(f"trim={trim} too large for W={w}")
    if diagnostics:
        out = trimmed_mean_flat(buf, trim=trim, row_weights=row_weights)
        return out, flat_diagnostics(buf, out, row_weights=row_weights,
                                     axis_names=axis_names)
    if row_weights is None:
        return ops.trimmed_mean(ops.messages(buf).contiguous(), trim=trim)
    # Weight-MASS trimming: per coordinate, drop the trim/W fraction of the
    # total weight mass from each tail and average what remains (unit
    # weights give the unweighted rule; zero-weight rows occupy no mass).
    vals, wsort = _sorted_with_weights(buf, row_weights)
    total = torch.sum(row_weights.float())
    lo = (trim / w) * total
    hi = ((w - trim) / w) * total
    cum = torch.cumsum(wsort, dim=0)
    kept = torch.clamp(torch.minimum(cum, hi) - torch.maximum(cum - wsort, lo),
                       min=0.0)
    return torch.sum(kept * vals, dim=0) / torch.clamp(hi - lo,
                                                       min=_WEIGHT_FLOOR)


def geomed_flat(buf: torch.Tensor, *, max_iters: int = 64, tol: float = 1e-6,
                axis_names=(), sync_axes=(), row_weights=None,
                diagnostics: bool = False) -> torch.Tensor:
    axes = dict(axis_names=axis_names, sync_axes=sync_axes)
    if diagnostics:
        out, info = weiszfeld_flat(buf, max_iters=max_iters, tol=tol,
                                   row_weights=row_weights, return_info=True,
                                   **axes)
        # The inverse-distance weight at the fixed point IS each message's
        # implicit Weiszfeld weight.
        return out, flat_diagnostics(buf, out, row_weights=row_weights,
                                     axis_names=axis_names,
                                     residual=info.residual, iters=info.iters,
                                     converged=info.converged)
    return weiszfeld_flat(buf, max_iters=max_iters, tol=tol,
                          row_weights=row_weights, **axes)


def _group_onehot(w: int, num_groups: int, device) -> torch.Tensor:
    """(G, W) membership of the contiguous worker groups of [10]/[18]
    (block sizes differ by at most one)."""
    ids = (torch.arange(w, device=device) * num_groups) // w
    return (ids[None, :] == torch.arange(num_groups, device=device)[:, None]
            ).float()


def group_means(z: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Contiguous-block group means over the worker axis of a (W, ...)
    tensor -> (num_groups, ...)."""
    w = z.shape[0]
    flat = z.reshape(w, -1).float()
    onehot = _group_onehot(w, num_groups, z.device)
    sums = onehot @ flat
    counts = torch.sum(onehot, dim=1)
    return (sums / counts[:, None]).reshape((num_groups,) + tuple(z.shape[1:])
                                            ).to(z.dtype)


def geomed_groups_flat(buf: torch.Tensor, *, num_groups: int,
                       max_iters: int = 64, tol: float = 1e-6,
                       axis_names=(), sync_axes=(),
                       row_weights=None, diagnostics: bool = False
                       ) -> torch.Tensor:
    axes = dict(axis_names=axis_names, sync_axes=sync_axes)
    if diagnostics:
        # The solve runs on the group means; each worker's distance and
        # weight are taken against the final aggregate.  The weighted form
        # reports no loop facts, as in the reference.
        info = {}
        if row_weights is None:
            grouped = group_means(buf.float(), num_groups)
            out, winfo = weiszfeld_flat(grouped, max_iters=max_iters, tol=tol,
                                        return_info=True, **axes)
            info = dict(residual=winfo.residual, iters=winfo.iters,
                        converged=winfo.converged)
        else:
            out = geomed_groups_flat(buf, num_groups=num_groups,
                                     max_iters=max_iters, tol=tol,
                                     row_weights=row_weights, **axes)
        return out, flat_diagnostics(buf, out, row_weights=row_weights,
                                     axis_names=axis_names, **info)
    if row_weights is None:
        grouped = group_means(buf.float(), num_groups)              # (G, D)
        return weiszfeld_flat(grouped, max_iters=max_iters, tol=tol, **axes)
    # Weighted group means; each group enters the outer Weiszfeld with its
    # total member mass (a group of all-dropped rows has mass 0).
    wts = row_weights.float()
    onehot = _group_onehot(buf.shape[0], num_groups, buf.device)
    sums = onehot @ (buf.float() * wts[:, None])
    mass = onehot @ wts
    grouped = sums / torch.clamp(mass, min=_WEIGHT_FLOOR)[:, None]
    return weiszfeld_flat(grouped, max_iters=max_iters, tol=tol,
                          row_weights=mass, **axes)


def flat_sq_dists(flat: torch.Tensor, axis_names=()) -> torch.Tensor:
    """(W, W) pairwise squared distances of packed (W, D) messages, by the
    Gram product (a float32 matmul: TF32 must stay off for it).  When the
    rows are coordinate shards the partial Grams are summed over
    ``axis_names`` (squared distances are separable over any partition of
    the coordinates; the reference's ``_partial_gram_sq_dists``)."""
    flat = flat.float()
    sq = torch.sum(flat ** 2, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)
    if axis_names:
        # A ring all-reduce sums each entry in an order of its own, so the
        # sum may lose the exact symmetry of the local partials; restoring
        # it keeps Krum's exact ties (the closest pair's scores) resolved
        # to the lower row, as on one process.
        d2 = psum(d2, axis_names)
        d2 = 0.5 * (d2 + d2.T)
    return torch.clamp(d2, min=0.0)


def krum_scores(d2: torch.Tensor, num_byzantine: int) -> torch.Tensor:
    """Krum scores from a (W, W) squared-distance matrix: per row, the sum
    of the W-B-2 smallest off-diagonal entries (self-distance masked to
    +inf)."""
    w = d2.shape[0]
    d2 = torch.clamp(d2, min=0.0) + torch.diag(
        torch.full((w,), float("inf"), dtype=d2.dtype, device=d2.device))
    n_near = max(w - num_byzantine - 2, 1)
    return torch.sum(torch.sort(d2, dim=1).values[:, :n_near], dim=1)


def krum_flat(buf: torch.Tensor, *, num_byzantine: int, axis_names=(),
              row_weights=None, diagnostics: bool = False) -> torch.Tensor:
    """Krum [14] on the packed buffer: score = sum of squared distances to
    the W-B-2 nearest other messages; output the winning row."""
    if row_weights is None:
        scores = krum_scores(flat_sq_dists(buf, axis_names), num_byzantine)
        best = torch.argmin(scores)
        out = buf.float()[best]
        if diagnostics:
            # Winner takes all: the implicit weight is a one-hot.
            return out, _krum_diagnostics(buf, out, None, scores, best,
                                          axis_names)
        return out
    # Weighted Krum: dropped rows (weight 0) are neither neighbours nor
    # candidates, the neighbour count shrinks to the live rows, and live
    # scores are divided by their weight.
    w = buf.shape[0]
    big = torch.tensor(1e30, dtype=torch.float32, device=buf.device)
    wts = row_weights.float()
    alive = wts > 0.0
    d2 = flat_sq_dists(buf, axis_names) + torch.diag(big.expand(w))
    d2 = torch.where(alive[None, :], d2, big)
    ds = torch.sort(d2, dim=1).values
    m = torch.sum(alive.to(torch.int32))
    n_near = torch.clamp(m - num_byzantine - 2, 1, max(w - 1, 1))
    keep = (torch.arange(w, device=buf.device)[None, :] < n_near) & (ds < big)
    scores = torch.sum(torch.where(keep, ds, 0.0), dim=1)
    scores = torch.where(alive, scores / torch.clamp(wts, min=_WEIGHT_FLOOR),
                         big)
    best = torch.argmin(scores)
    out = buf.float()[best]
    if diagnostics:
        return out, _krum_diagnostics(buf, out, row_weights, scores, best,
                                      axis_names)
    return out


def _krum_diagnostics(buf, out, row_weights, scores, best, axis_names):
    onehot = (torch.arange(buf.shape[0], device=buf.device) == best).float()
    return flat_diagnostics(buf, out, row_weights=row_weights,
                            axis_names=axis_names, weight=onehot,
                            score=scores, selected=best)


def centered_clip_flat(buf: torch.Tensor, *, radius: float = 1.0,
                       iters: int = 3, axis_names=(), row_weights=None,
                       diagnostics: bool = False) -> torch.Tensor:
    """Centered clipping (Karimireddy et al. 2021): v <- v + mean_w
    clip(m_w - v, radius), iterated from the coordinate median (the
    weighted median and weight-normalized means with ``row_weights``)."""
    b32 = buf.float()
    if row_weights is None:
        v = median_flat(buf)
    else:
        v = median_flat(b32, row_weights=row_weights)
        wnorm = row_weights.float()
        wnorm = wnorm / torch.clamp(torch.sum(wnorm), min=_WEIGHT_FLOOR)
    for _ in range(iters):
        diffs = b32 - v[None]
        sq = psum(torch.sum(diffs * diffs, dim=-1), axis_names)
        scale = torch.clamp(radius / torch.clamp(torch.sqrt(sq), min=1e-12),
                            max=1.0)
        if row_weights is None:
            v = v + torch.mean(diffs * scale[:, None], dim=0)
        else:
            v = v + torch.sum(diffs * (scale * wnorm)[:, None], dim=0)
    if diagnostics:
        # Implicit weight: each row's share of the last clipped update;
        # clip_frac counts the live rows whose residual was clipped.
        w = buf.shape[0]
        if row_weights is None:
            base = torch.full((w,), 1.0 / w, device=buf.device)
            live = torch.ones((w,), device=buf.device)
        else:
            base, live = wnorm, (row_weights.float() > 0).float()
        clip_frac = (torch.sum(live * (scale < 1.0))
                     / torch.clamp(torch.sum(live), min=1.0))
        return v, flat_diagnostics(buf, v, row_weights=row_weights,
                                   axis_names=axis_names,
                                   weight=base * scale, clip_frac=clip_frac)
    return v


def geomed_blockwise_flat(buf: torch.Tensor, *, spec: packing.PackSpec,
                          max_iters: int = 64, tol: float = 1e-6,
                          axis_names=(), sync_axes=(),
                          row_weights=None, diagnostics: bool = False
                          ) -> torch.Tensor:
    """Per-leaf geometric median on the packed buffer: each leaf's
    coordinate slice stops on its own (the reference's independent per-leaf
    loops); padding coordinates aggregate to zero."""
    axes = dict(axis_names=axis_names, sync_axes=sync_axes)
    if diagnostics:
        out, infos = weiszfeld_blockwise_flat(
            buf, spec.boundaries, max_iters=max_iters, tol=tol,
            row_weights=row_weights, return_info=True, **axes)
        # The worst block: largest residual and iteration count.
        return out, flat_diagnostics(
            buf, out, row_weights=row_weights, axis_names=axis_names,
            residual=max(i.residual for i in infos),
            iters=max(i.iters for i in infos),
            converged=all(i.converged for i in infos))
    return weiszfeld_blockwise_flat(buf, spec.boundaries, max_iters=max_iters,
                                    tol=tol, row_weights=row_weights, **axes)


# name -> builder(spec, opts) -> FlatAggregator; the reference's names.
def _axes(o: dict, sync: bool = False) -> dict:
    """The collective axes among the options ``o``."""
    out = dict(axis_names=o.get("axis_names", ()))
    if sync:
        out["sync_axes"] = o.get("sync_axes", ())
    return out


_FLAT_REGISTRY: dict[str, Callable[[packing.PackSpec, dict], FlatAggregator]] = {
    "mean": lambda spec, o: functools.partial(
        mean_flat, diagnostics=o.get("diagnostics", False), **_axes(o)),
    "median": lambda spec, o: functools.partial(
        median_flat, diagnostics=o.get("diagnostics", False), **_axes(o)),
    "trimmed_mean": lambda spec, o: functools.partial(
        trimmed_mean_flat, trim=o.get("trim", 1),
        diagnostics=o.get("diagnostics", False), **_axes(o)),
    "geomed": lambda spec, o: functools.partial(
        geomed_flat, max_iters=o.get("max_iters", 64), tol=o.get("tol", 1e-6),
        diagnostics=o.get("diagnostics", False), **_axes(o, sync=True)),
    "geomed_groups": lambda spec, o: functools.partial(
        geomed_groups_flat, num_groups=o["num_groups"],
        max_iters=o.get("max_iters", 64), tol=o.get("tol", 1e-6),
        diagnostics=o.get("diagnostics", False), **_axes(o, sync=True)),
    "krum": lambda spec, o: functools.partial(
        krum_flat, num_byzantine=o.get("num_byzantine", 0),
        diagnostics=o.get("diagnostics", False), **_axes(o)),
    "centered_clip": lambda spec, o: functools.partial(
        centered_clip_flat, radius=o.get("clip_radius", 1.0),
        diagnostics=o.get("diagnostics", False), **_axes(o)),
    "geomed_blockwise": lambda spec, o: functools.partial(
        geomed_blockwise_flat, spec=spec,
        max_iters=o.get("max_iters", 64), tol=o.get("tol", 1e-6),
        diagnostics=o.get("diagnostics", False), **_axes(o, sync=True)),
}

# ---- The pytree API: dicts of (W, *shape) leaves -> dicts of (*shape) ----


def _via_flat(stacked: Tree, *, name: str, opts: dict) -> Tree:
    spec = packing.pack_spec(stacked)
    out = get_flat_aggregator(name, spec, **opts)(spec.pack(stacked))
    return spec.unpack(out, batch_ndim=0)


def _leaf_rows(z: torch.Tensor) -> torch.Tensor:
    """A (W, *shape) leaf as its contiguous (W, d_l) matrix."""
    return ops.messages(z).reshape(z.shape[0], -1).contiguous()


def _per_leaf(stacked: Tree, fn) -> Tree:
    """``fn`` on each leaf's (W, d_l) matrix, back to (*shape) in its dtype."""
    return {k: fn(_leaf_rows(z)).reshape(z.shape[1:]).to(z.dtype)
            for k, z in stacked.items()}


def mean_agg_perleaf(stacked: Tree) -> Tree:
    return _per_leaf(stacked, lambda z: torch.mean(z.float(), dim=0))


def median_agg_perleaf(stacked: Tree) -> Tree:
    return _per_leaf(stacked, ops.coordinate_median)


def trimmed_mean_agg_perleaf(stacked: Tree, *, trim: int) -> Tree:
    def leaf(z):
        if 2 * trim >= z.shape[0]:
            raise ValueError(f"trim={trim} too large for W={z.shape[0]}")
        return ops.trimmed_mean(z, trim=trim)
    return _per_leaf(stacked, leaf)


def geomed_agg_perleaf(stacked: Tree, *, max_iters: int = 64,
                       tol: float = 1e-6, axis_names=(),
                       sync_axes=()) -> Tree:
    return weiszfeld_pytree(stacked, max_iters=max_iters, tol=tol,
                            axis_names=axis_names, sync_axes=sync_axes)


def geomed_groups_agg_perleaf(stacked: Tree, *, num_groups: int,
                              max_iters: int = 64, tol: float = 1e-6,
                              axis_names=(), sync_axes=()) -> Tree:
    grouped = {k: group_means(z, num_groups) for k, z in stacked.items()}
    return weiszfeld_pytree(grouped, max_iters=max_iters, tol=tol,
                            axis_names=axis_names, sync_axes=sync_axes)


def krum_agg_perleaf(stacked: Tree, *, num_byzantine: int,
                     axis_names=()) -> Tree:
    """Krum over the leaves concatenated in sorted-name order; with
    ``axis_names`` (model-sharded leaves) the reference's
    ``_distributed_krum``."""
    flat = torch.cat([stacked[k].reshape(stacked[k].shape[0], -1).float()
                      for k in sorted(stacked)], dim=-1)
    best = torch.argmin(krum_scores(flat_sq_dists(flat, axis_names),
                                    num_byzantine))
    return {k: z[best] for k, z in stacked.items()}


def centered_clip_agg_perleaf(stacked: Tree, *, radius: float = 1.0,
                              iters: int = 3, axis_names=()) -> Tree:
    names = sorted(stacked)
    z32 = {k: stacked[k].float() for k in names}
    v = median_agg_perleaf(z32)
    for _ in range(iters):
        diffs = {k: z32[k] - v[k][None] for k in names}
        sq = None
        for k in names:
            part = torch.sum(diffs[k].reshape(diffs[k].shape[0], -1) ** 2, dim=-1)
            sq = part if sq is None else sq + part
        sq = psum(sq, axis_names)
        scale = torch.clamp(radius / torch.clamp(torch.sqrt(sq), min=1e-12),
                            max=1.0)
        v = {k: v[k] + torch.mean(
            diffs[k] * scale.reshape((-1,) + (1,) * (diffs[k].dim() - 1)), dim=0)
            for k in names}
    return {k: v[k].to(stacked[k].dtype) for k in names}


def geomed_blockwise_agg_perleaf(stacked: Tree, *, max_iters: int = 64,
                                 tol: float = 1e-6, axis_names=(),
                                 sync_axes=()) -> Tree:
    return {k: weiszfeld_pytree({k: z}, max_iters=max_iters, tol=tol,
                                axis_names=axis_names,
                                sync_axes=sync_axes)[k]
            for k, z in stacked.items()}


def _shim(name: str) -> Callable[[dict], Aggregator]:
    return lambda opts: functools.partial(_via_flat, name=name, opts=opts)


_REGISTRY: dict[str, Callable[[dict], Aggregator]] = {
    name: _shim(name) for name in _FLAT_REGISTRY}

_PERLEAF_REGISTRY: dict[str, Callable[[dict], Aggregator]] = {
    "mean": lambda o: mean_agg_perleaf,
    "median": lambda o: median_agg_perleaf,
    "geomed": lambda o: functools.partial(
        geomed_agg_perleaf, max_iters=o.get("max_iters", 64),
        tol=o.get("tol", 1e-6), **_axes(o, sync=True)),
    "geomed_groups": lambda o: functools.partial(
        geomed_groups_agg_perleaf, num_groups=o["num_groups"],
        max_iters=o.get("max_iters", 64), tol=o.get("tol", 1e-6),
        **_axes(o, sync=True)),
    "trimmed_mean": lambda o: functools.partial(
        trimmed_mean_agg_perleaf, trim=o.get("trim", 1)),
    "krum": lambda o: functools.partial(
        krum_agg_perleaf, num_byzantine=o.get("num_byzantine", 0),
        **_axes(o)),
    "centered_clip": lambda o: functools.partial(
        centered_clip_agg_perleaf, radius=o.get("clip_radius", 1.0),
        **_axes(o)),
    "geomed_blockwise": lambda o: functools.partial(
        geomed_blockwise_agg_perleaf, max_iters=o.get("max_iters", 64),
        tol=o.get("tol", 1e-6), **_axes(o, sync=True)),
}

assert set(_REGISTRY) == set(_FLAT_REGISTRY) == set(_PERLEAF_REGISTRY), (
    "aggregator registries out of sync: every rule needs a pytree shim, a "
    "flat engine entry, and a per-leaf baseline")

AGGREGATOR_NAMES = tuple(_FLAT_REGISTRY)

# The reference's rules that the port does not carry yet.
UNPORTED: tuple[str, ...] = ()


def get_aggregator(name: str, *, perleaf: bool = False, **opts) -> Aggregator:
    """Build a pytree aggregator by name: leaves (W, *shape) -> leaves
    (*shape).  Options as :func:`get_flat_aggregator` (no diagnostics);
    ``perleaf=True`` selects the per-leaf baseline instead of the packed
    engine's shim."""
    registry = _PERLEAF_REGISTRY if perleaf else _REGISTRY
    try:
        build = registry[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; known: "
            f"{', '.join(sorted(registry))}") from None
    return build(opts)


def get_flat_aggregator(name: str, spec: packing.PackSpec | None,
                        **opts) -> FlatAggregator:
    """Build a flat aggregator ``fn(buf (W, D)) -> (D,) f32`` by name.

    ``spec`` is the buffer's :class:`~repro_torch.core.packing.PackSpec`
    (``geomed_blockwise`` reads its leaf boundaries; the other rules take
    ``None`` as well).  Options: ``max_iters``, ``tol`` (Weiszfeld rules),
    ``num_groups``, ``trim``, ``num_byzantine``, ``clip_radius``,
    ``diagnostics`` (True: the rule returns ``(aggregate,
    AggDiagnostics)``), and ``axis_names``/``sync_axes`` for rows that are
    coordinate shards across ranks."""
    try:
        build = _FLAT_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; known: "
            f"{', '.join(sorted(_FLAT_REGISTRY))}") from None
    if name == "geomed_blockwise" and spec is None:
        raise ValueError("geomed_blockwise needs the buffer's PackSpec")
    return build(spec, opts)
