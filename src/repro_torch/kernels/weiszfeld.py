"""K2 and K3: the two sweeps of a Weiszfeld iteration (port of
``repro/kernels/weiszfeld.py``).

* :func:`partial_sqdist_call` -- per-worker squared distance
  ``||z_w - y||^2`` of a (W, D) message matrix to a (D,) iterate -> (W,).
  Two passes on the card (per-block partial sums, then one fixed-order
  reduction per worker), so the result is the same bits on every run.
* :func:`weighted_sum_call`   -- unnormalized ``sum_w a_w z_w`` -> (D,).

Both launch the CUDA kernels of ``csrc/weiszfeld.cu`` on float32 inputs;
``*_plain`` are the same functions in plain PyTorch, which the CPU path
runs and the card's checks compare against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "partial_sqdist_scratch_cols": [ctypes.c_longlong],
    "partial_sqdist_f32": [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    "weighted_sum_f32": [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
}

# Shared memory holds the weights: W * 4 bytes within the 48 KB default.
MAX_WORKERS = 12_288


def check_inputs(what: str, z: torch.Tensor, v: torch.Tensor,
                 v_len: int) -> None:
    """z (W, D) float32 and a float32 vector of length ``v_len`` on the same
    device.  Raises on anything else."""
    if z.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"{what}: inputs must be float32, got {z.dtype} and "
                        f"{v.dtype} (bf16 comes with ROADMAP.md Queue A 7)")
    if z.dim() != 2 or tuple(v.shape) != (v_len,):
        raise ValueError(f"{what}: shapes {tuple(z.shape)} and "
                         f"{tuple(v.shape)} do not agree")
    if z.device != v.device:
        raise ValueError(f"{what}: inputs lie on different devices")


def _check_launchable(what: str, *tensors: torch.Tensor) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on a CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if tensors[0].shape[0] > min(65535, MAX_WORKERS):
        raise ValueError(f"{what}: W={tensors[0].shape[0]} exceeds "
                         f"{min(65535, MAX_WORKERS)}")


def partial_sqdist_plain(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = z - y[None]
    return torch.sum(d * d, dim=-1)


def weighted_sum_plain(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return a @ z


def partial_sqdist_call(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z (W, D), y (D,) -> (W,) float32, on the card."""
    check_inputs("partial_sqdist", z, y, z.shape[-1])
    _check_launchable("partial_sqdist", z, y)
    w, d = z.shape
    lib = _build.load("weiszfeld", _SIGNATURES)
    scratch = torch.empty((w, lib.partial_sqdist_scratch_cols(d)),
                          dtype=torch.float32, device=z.device)
    out = torch.empty((w,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = lib.partial_sqdist_f32(
            _build.ptr(z), _build.ptr(y), _build.ptr(scratch), _build.ptr(out),
            w, d, ctypes.c_void_p(_build.stream_of(z)))
    _build.check(lib, rc, "partial_sqdist")
    _build.LAUNCHES["partial_sqdist"] += 1
    return out


def weighted_sum_call(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """z (W, D), a (W,) -> (D,) float32 = sum_w a[w] z[w], on the card."""
    check_inputs("weighted_sum", z, a, z.shape[0])
    _check_launchable("weighted_sum", z, a)
    w, d = z.shape
    lib = _build.load("weiszfeld", _SIGNATURES)
    out = torch.empty((d,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = lib.weighted_sum_f32(
            _build.ptr(z), _build.ptr(a), _build.ptr(out), w, d,
            ctypes.c_void_p(_build.stream_of(z)))
    _build.check(lib, rc, "weighted_sum")
    _build.LAUNCHES["weighted_sum"] += 1
    return out
