"""Geometric median via the Weiszfeld algorithm, paper eq. (6) (port of
``repro/core/geomed.py``'s flat engine and its pytree form).

    y^{t+1} = sum_w a_w z_w / d_w  /  max(sum_w a_w / d_w, 1e-8),
    d_w = max(||z_w - y^t||, 1e-8)

from the coordinate-wise mean, stopped after ``max_iters`` iterations or
once the iterate moves no more than ``tol`` -- the semantics of the
reference's ``weiszfeld_pytree``/``weiszfeld_flat``.  ``a_w`` are the
optional ``row_weights`` (weight 0 removes a row exactly).

Each iteration runs kernel K2 (``partial_sqdist``), a few (W,)-sized
PyTorch ops, then kernel K3 (``weighted_sum``) on a CUDA device, or their
plain versions on the CPU.  A bf16 buffer is read as it is (the kernels'
bf16 routes); the iterate is float32.  The early stop reads the iterate's move on the
host after every iteration -- one device-to-host sync per iteration -- so
the loop runs exactly the iterations the reference's ``while_loop`` runs.
:func:`weiszfeld_pytree` runs the same loop on a dict of per-leaf (W,
*shape) messages: each iteration adds the leaves' K2 distances in leaf
order and runs K3 on each leaf.

:func:`weiszfeld_blockwise_flat` solves one geometric median per block of
coordinates (a pytree leaf of the packed buffer, ``geomed_blockwise``).
The reference runs an independent loop per block; here every block runs in
lockstep and keeps its own stop: one kernel K6 sweep per iteration gives
all (W, L) per-block distances, each still-active block takes one K3 sum
over its column slice, and one host read of the (L,) moves per iteration
freezes every block whose move reached ``tol`` or that has run
``max_iters``.  A frozen block keeps its iterate and launches nothing
more, so each block runs exactly the iterations of its own loop in the
reference.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

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


def _f32_tol(tol: float) -> float:
    """The reference compares its float32 move with tol rounded to float32."""
    return float(torch.tensor(tol, dtype=torch.float32))


def weiszfeld_flat(buf: torch.Tensor, *, max_iters: int = 64,
                   tol: float = 1e-6,
                   row_weights: torch.Tensor | None = None,
                   return_info: bool = False):
    """Geometric median of one packed (W, D) message matrix -> (D,)
    float32 (and a :class:`WeiszfeldInfo` with ``return_info``)."""
    if buf.dim() != 2:
        raise ValueError(f"weiszfeld_flat expects (W, D), got {tuple(buf.shape)}")
    ys, info = _weiszfeld_leaves([buf], max_iters=max_iters, tol=tol,
                                 row_weights=row_weights)
    return (ys[0], info) if return_info else ys[0]


def _weiszfeld_leaves(leaves: Sequence[torch.Tensor], *, max_iters: int,
                      tol: float, row_weights: torch.Tensor | None):
    """The Weiszfeld loop over the (W, d_l) blocks of one message matrix:
    each iteration adds the blocks' K2 distances in block order and runs K3
    on each block.  -> ([(d_l,) float32 iterates], WeiszfeldInfo)."""
    zs = [ops.messages(z).contiguous() for z in leaves]   # bf16 stays bf16
    rw = None if row_weights is None else row_weights.float()
    ys = [torch.mean(z, dim=0, dtype=torch.float32) for z in zs]
    tol = _f32_tol(tol)
    delta, it = math.inf, 0
    while it < max_iters and delta > tol:
        sq = None
        for z, y in zip(zs, ys):
            part = ops.partial_sqdist(z, y)
            sq = part if sq is None else sq + part
        inv = 1.0 / torch.clamp(torch.sqrt(sq), min=_DIST_FLOOR)
        if rw is not None:
            inv = inv * rw
        wsum = torch.clamp(torch.sum(inv), min=_DIST_FLOOR)
        move = None
        for i, (z, y) in enumerate(zip(zs, ys)):
            ys[i] = ops.weighted_sum(z, inv) / wsum
            part = torch.sum((ys[i] - y) ** 2)
            move = part if move is None else move + part
        delta = float(torch.sqrt(move))
        it += 1
    return ys, WeiszfeldInfo(residual=delta, iters=it, converged=delta <= tol)


def weiszfeld_pytree(stacked: dict[str, torch.Tensor], *, max_iters: int = 64,
                     tol: float = 1e-6,
                     row_weights: torch.Tensor | None = None,
                     return_info: bool = False):
    """Geometric median of W messages given as a dict of (W, *shape) leaves
    (the per-leaf baseline's layout) -> a dict of (*shape) leaves in the
    leaves' dtypes (and a :class:`WeiszfeldInfo` with ``return_info``).
    Distances are over the whole message, all leaves, in sorted-name
    order; the iterate is float32 until the end."""
    names = sorted(stacked)
    w = stacked[names[0]].shape[0]
    ys, info = _weiszfeld_leaves([stacked[k].reshape(w, -1) for k in names],
                                 max_iters=max_iters, tol=tol,
                                 row_weights=row_weights)
    out = {k: y.reshape(stacked[k].shape[1:]).to(stacked[k].dtype)
           for k, y in zip(names, ys)}
    return (out, info) if return_info else out


@functools.lru_cache(maxsize=64)
def segment_ids(boundaries: tuple[tuple[int, int], ...], dim: int,
                device: torch.device) -> torch.Tensor:
    """(dim,) int32 block id of each coordinate, from the blocks' static
    (start, stop) ranges; a coordinate in no block gets id ``len(boundaries)``
    (outside ``[0, L)``, so kernel K6 counts it nowhere)."""
    ids = torch.full((dim,), len(boundaries), dtype=torch.int32)
    for block, (a, b) in enumerate(boundaries):
        ids[a:b] = block
    return ids.to(device)


def weiszfeld_blockwise_flat(buf: torch.Tensor,
                             boundaries: Sequence[tuple[int, int]], *,
                             max_iters: int = 64, tol: float = 1e-6,
                             row_weights: torch.Tensor | None = None,
                             return_info: bool = False):
    """Geometric median of each block ``buf[:, a:b]`` of one packed (W, D)
    message matrix, every block with its own stop -> (D,) float32 (and one
    :class:`WeiszfeldInfo` per block with ``return_info``).  Coordinates
    in no block (padding) aggregate to 0."""
    if buf.dim() != 2:
        raise ValueError(f"weiszfeld_blockwise_flat expects (W, D), got "
                         f"{tuple(buf.shape)}")
    z = ops.messages(buf).contiguous()
    blocks = tuple((int(a), int(b)) for a, b in boundaries)
    seg = segment_ids(blocks, z.shape[1], z.device)
    rw = None if row_weights is None else row_weights.float()
    y = torch.zeros((z.shape[1],), dtype=torch.float32, device=z.device)
    for a, b in blocks:
        y[a:b] = torch.mean(z[:, a:b], dim=0, dtype=torch.float32)
    tol = _f32_tol(tol)
    delta = [math.inf] * len(blocks)
    iters = [0] * len(blocks)

    def still_active(ids):
        return [i for i in ids if iters[i] < max_iters and delta[i] > tol]

    active = still_active(range(len(blocks)))
    while active:
        sq = ops.partial_sqdist_segments(z, y, seg, num_segments=len(blocks))
        inv = 1.0 / torch.clamp(torch.sqrt(sq), min=_DIST_FLOOR)   # (W, L)
        if rw is not None:
            inv = inv * rw[:, None]
        wsum = torch.clamp(torch.sum(inv, dim=0), min=_DIST_FLOOR)  # (L,)
        inv = inv.t().contiguous()                                  # (L, W)
        moves = []
        for i in active:
            a, b = blocks[i]
            y_new = ops.weighted_sum(z[:, a:b], inv[i]) / wsum[i]
            moves.append(torch.sum((y_new - y[a:b]) ** 2))
            y[a:b] = y_new
        for i, move in zip(active, torch.sqrt(torch.stack(moves)).tolist()):
            delta[i], iters[i] = move, iters[i] + 1
        active = still_active(active)
    if return_info:
        return y, [WeiszfeldInfo(residual=d, iters=n, converged=d <= tol)
                   for d, n in zip(delta, iters)]
    return y
