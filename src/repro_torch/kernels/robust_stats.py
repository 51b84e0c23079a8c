"""K4 and K5: per-coordinate order statistics over the worker axis (port of
``repro/kernels/robust_stats.py``).

* :func:`coordinate_median_call` -- the median of each column of a (W, D)
  message matrix -> (D,); for even W the mean of the two middle order
  statistics (``jnp.median``'s midpoint, not ``torch.median``'s lower
  median).
* :func:`trimmed_mean_call` -- per column, drop the ``trim`` smallest and
  the ``trim`` largest values and average the rest; ``2 * trim < W``.

Both launch the CUDA kernels of ``csrc/robust_stats.cu`` on float32
inputs, for any W >= 1 (up to 454 workers a block stages its columns in
shared memory; past that it counts ranks from global memory); ``*_plain`` are the same functions in plain PyTorch (a sort along
the worker axis), which the CPU path runs and the card's checks compare
against.  A column holding a NaN gives an unspecified value on the card
(see the source); the plain versions sort NaN last.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "coordinate_median_f32": [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    "trimmed_mean_f32": [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}


def check_inputs(what: str, z: torch.Tensor) -> None:
    """z (W, D) float32 with W >= 1.  Raises on anything else."""
    if z.dtype != torch.float32:
        raise TypeError(f"{what}: z must be float32, got {z.dtype} (bf16 "
                        "comes with ROADMAP.md Queue A 7)")
    if z.dim() != 2 or z.shape[0] == 0:
        raise ValueError(f"{what}: z must be (W, D) with W >= 1, got "
                         f"{tuple(z.shape)}")


def check_trim(z: torch.Tensor, trim: int) -> None:
    w = z.shape[0]
    if trim < 0 or 2 * trim >= w:
        raise ValueError(f"trim={trim} too large for W={w}")


def _check_launchable(what: str, z: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on a CUDA device")
    if not z.is_contiguous():
        raise ValueError(f"{what}: z must be contiguous")


def coordinate_median_plain(z: torch.Tensor) -> torch.Tensor:
    s = torch.sort(z, dim=0).values
    w = z.shape[0]
    if w % 2:
        return s[w // 2]
    return (s[w // 2 - 1] + s[w // 2]) * 0.5


def trimmed_mean_plain(z: torch.Tensor, trim: int) -> torch.Tensor:
    s = torch.sort(z, dim=0).values
    return torch.mean(s[trim:z.shape[0] - trim], dim=0)


def _launch(what: str, fn: str, z: torch.Tensor, *extra) -> torch.Tensor:
    _check_launchable(what, z)
    w, d = z.shape
    lib = _build.load("robust_stats", _SIGNATURES)
    out = torch.empty((d,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = getattr(lib, fn)(_build.ptr(z), _build.ptr(out), w, d, *extra,
                              ctypes.c_void_p(_build.stream_of(z)))
    _build.check(lib, rc, what)
    _build.LAUNCHES[what] += 1
    return out


def coordinate_median_call(z: torch.Tensor) -> torch.Tensor:
    """z (W, D) -> (D,) float32 per-coordinate median, on the card."""
    check_inputs("coordinate_median", z)
    return _launch("coordinate_median", "coordinate_median_f32", z)


def trimmed_mean_call(z: torch.Tensor, trim: int) -> torch.Tensor:
    """z (W, D) -> (D,) float32 per-coordinate ``trim``-trimmed mean, on the
    card."""
    check_inputs("trimmed_mean", z)
    check_trim(z, trim)
    return _launch("trimmed_mean", "trimmed_mean_f32", z, int(trim))
