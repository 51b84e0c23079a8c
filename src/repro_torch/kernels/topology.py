"""K7: the masked neighbourhood (trimmed) mean of the decentralized step
(port of ``repro/kernels/topology.py``).

:func:`masked_neighbor_reduce_call` takes the dense (R, S, D) exchange --
row r is what receiver r sees from each of the S senders -- and the (R, S)
neighbour mask, and returns (R, D) float32: per receiver and coordinate,
the mean of the masked senders' values after dropping the ``trim`` largest
and the ``trim`` smallest, divided by ``max(n_r - 2 * trim, 1)`` with
``n_r = sum_s mask[r, s]``.  ``trim = 0`` is the masked mean.

It launches the CUDA kernels of ``csrc/topology.cu`` on a float32 or
bfloat16 exchange (the bf16 wire: the bf16 route loads it as it is and
gives the bits of the float32 kernel on ``exchange.float()``) and a float32
mask, for any R, S and D that fit in memory, reading only the members' rows
(``mask > 0``).  The library picks the kernel from ``trim`` and reports it
back: "sum" for trim 0 (the fixed-order masked sum), "select" for trims up
to 16 (the trim largest and smallest kept in registers, then the values
between them summed), "rank" beyond (each value ranked against the others;
correct, not fast).  :data:`ROUTE_LAUNCHES` counts each route, and
:data:`SELECT_LAYOUT_LAUNCHES` each layout of "select": "pairs" (two
bfloat16 coordinates a thread, their 16-bit keys ordered two at a time) for
a bfloat16 exchange with a 4-byte aligned base and even strides, "one"
(one coordinate a thread) for everything else.
:func:`masked_neighbor_reduce_plain` is the same function in plain
PyTorch (sort with the non-neighbours ordered after every member, keep
ranks ``[trim, n - trim)``), which the CPU path runs and the card's checks
compare against.  Both order a member's NaN above +inf, as torch.sort does,
and neither lets a non-member's value (inf or NaN included) into the result.

The kernel reduces by 0/1 counts: a mask entry counts as a neighbour when
it is > 0.  Masks that carry staleness weights take the torch rules instead
(``row_weights`` in :mod:`repro_torch.topology.masked`), as the reference
sends them to its jnp engine (``decentralized_step.py:872``, K7 only when
``row_weights is None``); the guards' masks stay 0/1, so guarded rounds
keep K7.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.weiszfeld import batch_strides

_SIGNATURES = {
    f"masked_neighbor_reduce_{sfx}": [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    for sfx in _build.SUFFIX.values()}

ROUTES = ("sum", "select", "rank")   # the route codes 0, 1, 2 of csrc/topology.cu
# Launches per route (reset with the others by ops.reset_launch_counts).
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
# "select"'s layouts, the codes 0, 1 of csrc/topology.cu, and their launches
# (reset with the others).
SELECT_LAYOUTS = ("one", "pairs")
SELECT_LAYOUT_LAUNCHES = dict.fromkeys(SELECT_LAYOUTS, 0)


def _pow2_at_least(n: int) -> int:
    return 1 if n <= 1 else 2 * _pow2_at_least((n + 1) // 2)


def _sort_minmax_ops(trim: int) -> int:
    """Integer min/max of "select"'s first sort at ``trim``: the bitonic
    network on the next power of two of 2 * trim slots, as the kernel runs
    it (a compare-exchange with a pad slot is a move, one of two pads
    nothing), counted backwards from the 2 * trim slots it reads (the
    compiler drops the rest)."""
    n, live = _pow2_at_least(2 * trim), 2 * trim
    pad = [i >= live for i in range(n)]
    events = []                     # ("cx", i, l) or ("move", from, to)
    k = 2
    while k <= n:
        j = k >> 1
        while j:
            for i in range(n):
                l = i ^ j
                if l > i and not (pad[i] and pad[l]):
                    up = (i & k) == 0
                    if pad[i] or pad[l]:
                        events.append(("move", l if pad[i] else i, i if up else l))
                        pad[i], pad[l] = not up, up
                    else:
                        events.append(("cx", i, l))
            j >>= 1
        k <<= 1
    need, ops = set(range(live)), 0
    for kind, a, b in reversed(events):
        if kind == "cx":
            used = (a in need) + (b in need)
            ops += used
            if used:
                need |= {a, b}
        else:
            hit = b in need
            need -= {a, b}
            if hit:
                need.add(a)
    return ops


def select_minmax_ops(members: int, trim: int) -> int:
    """Integer min/max that "select" runs for one receiver of ``members``
    members at ``1 <= trim <= 16``, a key word (a coordinate in the "one"
    layout, a pair in "pairs"), when its first 2,048 senders hold them all:
    the first 2 * trim sorted at once, then 4 * trim for each later member
    (the insert into both arrays, 4 * trim - 2, and the median of three, 2);
    with fewer than 2 * trim, the inserts alone."""
    if not 1 <= trim <= 16:
        raise ValueError(f"select serves 1 <= trim <= 16, got {trim}")
    if members < 2 * trim:
        return members * (4 * trim - 2)
    return _sort_minmax_ops(trim) + (members - 2 * trim) * 4 * trim


def check_inputs(exchange: torch.Tensor, mask: torch.Tensor, trim: int) -> None:
    """exchange (R, S, D) float32 or bfloat16 and mask (R, S) float32, on one
    device; trim >= 0.  Raises on anything else."""
    _build.check_dtype("masked_neighbor_reduce", exchange, "exchange")
    if mask.dtype != torch.float32:
        raise TypeError(f"masked_neighbor_reduce: mask must be float32, got "
                        f"{mask.dtype}")
    if exchange.dim() != 3 or tuple(mask.shape) != tuple(exchange.shape[:2]):
        raise ValueError(f"masked_neighbor_reduce: exchange "
                         f"{tuple(exchange.shape)} and mask "
                         f"{tuple(mask.shape)} do not agree")
    if exchange.device != mask.device:
        raise ValueError("masked_neighbor_reduce: inputs lie on different "
                         "devices")
    if trim < 0:
        raise ValueError(f"masked_neighbor_reduce: trim must be >= 0, got {trim}")


def masked_neighbor_reduce_plain(exchange: torch.Tensor, mask: torch.Tensor,
                                 trim: int) -> torch.Tensor:
    z = exchange.float()
    n = torch.sum(mask, dim=1)                                  # (R,)
    # Non-members are filled with NaN, which torch.sort puts last: they sort
    # after every member, a NaN member included, so a kept NaN member gives
    # NaN, as in the kernel, and no non-member value is ever kept.
    s = torch.sort(torch.where(mask[:, :, None] > 0, z, torch.nan),
                   dim=1).values
    ranks = torch.arange(z.shape[1], device=z.device)[None, :, None]
    keep = (ranks >= trim) & (ranks < (n[:, None, None] - trim))
    return (torch.sum(torch.where(keep, s, 0.0), dim=1)
            / torch.clamp(n - 2 * trim, min=1.0)[:, None])


def masked_neighbor_reduce_call(exchange: torch.Tensor, mask: torch.Tensor,
                                trim: int) -> torch.Tensor:
    """exchange (R, S, D), mask (R, S) -> (R, D) float32, on the card.
    ``exchange`` may be a column slice or a broadcast over receivers (read
    in place)."""
    check_inputs(exchange, mask, trim)
    if exchange.device.type != "cuda":
        raise ValueError("masked_neighbor_reduce: tensors must lie on a CUDA "
                         "device")
    if not mask.is_contiguous():
        raise ValueError("masked_neighbor_reduce: mask must be contiguous")
    r, ss, rs = batch_strides(exchange)
    s, d = exchange.shape[1:]
    lib = _build.load("topology", _SIGNATURES)
    out = torch.empty((r, d), dtype=torch.float32, device=exchange.device)
    code, layout = ctypes.c_int(-1), ctypes.c_int(-1)
    with torch.cuda.device(exchange.device):
        rc = getattr(lib, "masked_neighbor_reduce_"
                     + _build.SUFFIX[exchange.dtype])(
            _build.ptr(exchange), _build.ptr(mask), _build.ptr(out), r, s, d,
            rs, ss, int(trim), ctypes.byref(code), ctypes.byref(layout),
            ctypes.c_void_p(_build.stream_of(exchange)))
    _build.check(lib, rc, "masked_neighbor_reduce")
    route = ROUTES[code.value]
    _build.count("masked_neighbor_reduce", exchange.dtype, route)
    ROUTE_LAUNCHES[route] += 1
    if route == "select":
        SELECT_LAYOUT_LAUNCHES[SELECT_LAYOUTS[layout.value]] += 1
    return out
