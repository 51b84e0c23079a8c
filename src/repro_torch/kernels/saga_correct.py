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

:func:`saga_correct_call` launches the CUDA kernel
(``csrc/saga_correct.cu``); :func:`saga_correct_plain` is the same
function in plain PyTorch, which the CPU path runs and the card's checks
compare against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {"saga_correct_f32": [ctypes.c_void_p] * 5 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]}


def check_inputs(grad: torch.Tensor, table: torch.Tensor, avg: torch.Tensor,
                 idx: torch.Tensor) -> None:
    """Shapes (W, D), (W, J, D), (W, D), (W,); float32 state, int64
    indices, one device.  Raises on anything else."""
    for name, t in (("grad", grad), ("table", table), ("avg", avg)):
        if t.dtype != torch.float32:
            raise TypeError(f"saga_correct: {name} must be float32, got "
                            f"{t.dtype} (bf16 comes with ROADMAP.md Queue A 7)")
    if idx.dtype != torch.int64:
        raise TypeError(f"saga_correct: idx must be int64, got {idx.dtype}")
    if table.dim() != 3 or grad.dim() != 2:
        raise ValueError(f"saga_correct: need grad (W, D) and table (W, J, D), "
                         f"got {tuple(grad.shape)} and {tuple(table.shape)}")
    w, _, d = table.shape
    if (tuple(grad.shape) != (w, d) or tuple(avg.shape) != (w, d)
            or tuple(idx.shape) != (w,)):
        raise ValueError(
            f"saga_correct: shapes grad {tuple(grad.shape)}, table "
            f"{tuple(table.shape)}, avg {tuple(avg.shape)}, idx "
            f"{tuple(idx.shape)} do not agree")
    if len({t.device for t in (grad, table, avg, idx)}) != 1:
        raise ValueError("saga_correct: inputs lie on different devices")


def saga_correct_plain(grad: torch.Tensor, table: torch.Tensor,
                       avg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version; returns msg (W, D) and updates ``avg`` and
    ``table`` in place."""
    w_ids = torch.arange(grad.shape[0], device=grad.device)
    delta = grad - table[w_ids, idx]
    msg = delta + avg
    # A 0-dim device tensor as divisor: PyTorch's CUDA division turns a
    # host-scalar divisor into a reciprocal multiply, which can differ from
    # the kernel's IEEE division by an ulp.
    j = torch.tensor(float(table.shape[1]), device=grad.device)
    avg.copy_(avg + delta / j)
    table[w_ids, idx] = grad
    return msg


def saga_correct_call(grad: torch.Tensor, table: torch.Tensor,
                      avg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; returns msg
    (W, D) and updates ``avg`` and ``table`` in place."""
    check_inputs(grad, table, avg, idx)
    if grad.device.type != "cuda":
        raise ValueError("saga_correct_call: tensors must lie on a CUDA device")
    for name, t in (("grad", grad), ("table", table), ("avg", avg), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"saga_correct_call: {name} must be contiguous")
    w, j, d = table.shape
    if w > 65535:
        raise ValueError(f"saga_correct_call: W={w} exceeds the grid's 65,535")
    msg = torch.empty_like(grad)
    lib = _build.load("saga_correct", _SIGNATURES)
    with torch.cuda.device(grad.device):
        rc = lib.saga_correct_f32(
            _build.ptr(grad), _build.ptr(table), _build.ptr(avg),
            _build.ptr(idx), _build.ptr(msg), w, j, d,
            ctypes.c_void_p(_build.stream_of(grad)))
    _build.check(lib, rc, "saga_correct")
    _build.LAUNCHES["saga_correct"] += 1
    return msg
