"""K1: fused SAGA correction + in-place table update (port of
``repro/kernels/saga_correct.py``).

For every worker w with drawn row r = idx[w], in one sweep:

    msg[w]     = g[w] - table[w, r] + avg[w]
    avg[w]    += (g[w] - table[w, r]) / J
    table[w, r] = g[w]          (after the old row is read)

The TPU kernel handles one worker's (J, p) table and is vmapped; this one
takes the worker axis natively -- table (W, J, D), idx (W,) -- and updates
``avg`` and ``table`` in place, as the TPU kernel's
``input_output_aliases={2: 2}`` intends, so no copy of the table is made.

The client-row route (``rows`` given, (W,) int64) works on state resident
per client under partial participation: table (C, J, D), avg (C, D), and
worker w reads and writes ``table[rows[w], idx[w]]`` and ``avg[rows[w]]``
in place, so the cohort's rows are never gathered into a copy.

On the bf16 wire the state and the messages are bfloat16 (half the
table's bytes): :func:`saga_correct_call` launches the kernel's bf16 route,
which rounds after every operation as PyTorch's bf16 ops (and the
reference's jnp engine) do, so :func:`saga_correct_plain` on bf16 tensors
is the same function.  The rows
must be distinct (the participation plan's cohorts are): two workers on one
client would race.  Nothing checks that on the card, to keep the host out
of the step.  A row outside [0, C), like an index outside [0, J), gives
that worker a NaN message and leaves the state untouched.
:data:`ROUTE_LAUNCHES` counts the launches of each route.

:func:`saga_correct_call` launches the CUDA kernel
(``csrc/saga_correct.cu``); :func:`saga_correct_plain` is the same
function in plain PyTorch, which the CPU path runs and the card's checks
compare against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {f"saga_correct_{sfx}": [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p] for sfx in _build.SUFFIX.values()}

ROUTES = ("workers", "clients")   # rows=None, rows given
# Launches per route (reset with the others by ops.reset_launch_counts).
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def check_inputs(grad: torch.Tensor, table: torch.Tensor, avg: torch.Tensor,
                 idx: torch.Tensor, rows: torch.Tensor | None = None) -> None:
    """Shapes (W, D), (W, J, D), (W, D), (W,) -- or, with (W,) ``rows``,
    table (C, J, D) and avg (C, D); grad, table and avg all float32 or all
    bfloat16, int64 indices, one device.  Raises on anything else."""
    for name, t in (("grad", grad), ("table", table), ("avg", avg)):
        _build.check_dtype("saga_correct", t, name)
    if not grad.dtype == table.dtype == avg.dtype:
        raise TypeError(f"saga_correct: grad, table and avg must share a "
                        f"dtype, got {grad.dtype}, {table.dtype}, {avg.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"saga_correct: idx must be int64, got {idx.dtype}")
    if table.dim() != 3 or grad.dim() != 2:
        raise ValueError(f"saga_correct: need grad (W, D) and table (W, J, D), "
                         f"got {tuple(grad.shape)} and {tuple(table.shape)}")
    c, _, d = table.shape
    w = grad.shape[0]
    if rows is None and c != w:
        raise ValueError(f"saga_correct: table has {c} rows for {w} workers; "
                         "pass rows= for a table resident per client")
    if (tuple(grad.shape) != (w, d) or tuple(avg.shape) != (c, d)
            or tuple(idx.shape) != (w,)
            or (rows is not None and tuple(rows.shape) != (w,))):
        raise ValueError(
            f"saga_correct: shapes grad {tuple(grad.shape)}, table "
            f"{tuple(table.shape)}, avg {tuple(avg.shape)}, idx "
            f"{tuple(idx.shape)}"
            + ("" if rows is None else f", rows {tuple(rows.shape)}")
            + " do not agree")
    if rows is not None and rows.dtype != torch.int64:
        raise TypeError(f"saga_correct: rows must be int64, got {rows.dtype}")
    tensors = (grad, table, avg, idx) + (() if rows is None else (rows,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("saga_correct: inputs lie on different devices")


def saga_correct_plain(grad: torch.Tensor, table: torch.Tensor,
                       avg: torch.Tensor, idx: torch.Tensor,
                       rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version; returns msg (W, D) and updates ``avg`` and
    ``table`` in place (their rows ``rows`` when given).  On bf16 tensors
    each operation rounds to bf16."""
    # A 0-dim device tensor as divisor: PyTorch's CUDA division turns a
    # host-scalar divisor into a reciprocal multiply, which can differ from
    # the kernel's IEEE division by an ulp.
    j = torch.tensor(float(table.shape[1]), device=grad.device)
    if rows is None:
        w_ids = torch.arange(grad.shape[0], device=grad.device)
        delta = grad - table[w_ids, idx]
        msg = delta + avg
        avg.copy_(avg + delta / j)
        table[w_ids, idx] = grad
        return msg
    delta = grad - table[rows, idx]
    a = avg[rows]
    msg = delta + a
    avg[rows] = a + delta / j
    table[rows, idx] = grad
    return msg


def saga_correct_call(grad: torch.Tensor, table: torch.Tensor,
                      avg: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; returns msg
    (W, D) and updates ``avg`` and ``table`` in place (their rows ``rows``
    when given)."""
    check_inputs(grad, table, avg, idx, rows)
    if grad.device.type != "cuda":
        raise ValueError("saga_correct_call: tensors must lie on a CUDA device")
    named = (("grad", grad), ("table", table), ("avg", avg), ("idx", idx))
    if rows is not None:
        named += (("rows", rows),)
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"saga_correct_call: {name} must be contiguous")
    c, j, d = table.shape
    w = grad.shape[0]
    if w > 65535:
        raise ValueError(f"saga_correct_call: W={w} exceeds the grid's 65,535")
    msg = torch.empty_like(grad)
    lib = _build.load("saga_correct", _SIGNATURES)
    with torch.cuda.device(grad.device):
        rc = getattr(lib, f"saga_correct_{_build.SUFFIX[grad.dtype]}")(
            _build.ptr(grad), _build.ptr(table), _build.ptr(avg),
            _build.ptr(idx), None if rows is None else _build.ptr(rows),
            _build.ptr(msg), w, j, c, d,
            ctypes.c_void_p(_build.stream_of(grad)))
    _build.check(lib, rc, "saga_correct")
    route = "workers" if rows is None else "clients"
    _build.count("saga_correct", grad.dtype, route)
    ROUTE_LAUNCHES[route] += 1
    return msg
