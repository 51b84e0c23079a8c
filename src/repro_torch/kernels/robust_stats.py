"""K4 and K5: per-coordinate order statistics over the worker axis (port of
``repro/kernels/robust_stats.py``).

* :func:`coordinate_median_call` -- the median of each column of a (W, D)
  message matrix -> (D,); for even W the mean of the two middle order
  statistics (``jnp.median``'s midpoint, not ``torch.median``'s lower
  median).
* :func:`trimmed_mean_call` -- per column, drop the ``trim`` smallest and
  the ``trim`` largest values and average the rest; ``2 * trim < W``.

Both launch the CUDA kernels of ``csrc/robust_stats.cu`` on float32 or
bfloat16 z (the bf16 wire: the bf16 route loads it as it is and gives the
bits of the float32 kernel on ``z.float()``), for any W >= 1, and return
float32.  Up to :data:`NETWORK_CAP` workers both sort each
column in registers with one sorting network (:func:`median_network_pairs`
lists its compare-exchanges), NaN sorted last as the plain version sorts
it.  K4 on a bfloat16 z with D even and a 4-byte aligned base orders two
columns a thread: one 4-byte load a row, 16-bit keys two to a word (b, or
b ^ 0x7fff for b < 0, every NaN above +inf: the order of the upcast values,
-0 below +0, as Hopper's float min/max orders them too) and the same network
on packed 16-bit min/max, one instruction for both columns (:data:`MEDIAN_LAYOUT_LAUNCHES` counts "pairs" and "one";
its instruction floor is half the float32 route's); K5 takes the same views
two columns a thread on the same keys, its kept ranks unkeyed and summed
per column (:data:`TRIMMED_LAYOUT_LAUNCHES`).  K4 gives the plain
version's bits; K5 sums the kept ranks in ascending
rank order (rtol 1e-5 against the plain version, the same bits on every
launch) and gives NaN exactly when a column holds more than ``trim`` NaN,
as the plain version does.  Past that cap each column's values are ranked
by counting (up to 454 workers from a slab in shared memory, past that
from global memory), and a column holding a NaN gives an unspecified value
(see the source).  ``*_plain`` are the same functions in plain PyTorch (a
sort along the worker axis, in float32 for a bf16 z), which the CPU path
runs and the card's checks compare against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "coordinate_median_f32": [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    # The bf16 route reports its layout (the codes 0, 1 of MEDIAN_LAYOUTS).
    "coordinate_median_bf16": [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p],
}
_SIGNATURES["trimmed_mean_f32"] = [ctypes.c_void_p] * 2 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES["trimmed_mean_bf16"] = [ctypes.c_void_p] * 2 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ctypes.c_void_p]

# K4's and K5's layouts and their launches (reset with the others by
# ops.reset_launch_counts): "pairs" (a bfloat16 z on the network route with D
# even and a 4-byte aligned base: two columns a thread, their 16-bit keys
# ordered two at a time) and "one" (one column a thread: every float32 z,
# every other bfloat16 z, and past the network route).
MEDIAN_LAYOUTS = ("one", "pairs")
MEDIAN_LAYOUT_LAUNCHES = dict.fromkeys(MEDIAN_LAYOUTS, 0)
TRIMMED_LAYOUT_LAUNCHES = dict.fromkeys(MEDIAN_LAYOUTS, 0)


# K4 and K5's network route: W up to NETWORK_CAP, one network per multiple
# of NETWORK_STEP workers (the constants kNetCap and kNetStep of the source).
NETWORK_CAP = 128
NETWORK_STEP = 8


def median_network_pairs(w: int) -> tuple[int, list[tuple[int, int]]]:
    """The network for ``w <= NETWORK_CAP`` workers, as K4 and K5 run it:
    (N, the compare-exchanges (a, b), a < b, min to a, in order) for the
    N = w rounded up to a multiple of NETWORK_STEP wires, those past w
    holding +inf.  Batcher's odd-even merge sort on the next power of two,
    without the compare-exchanges that touch a wire >= N."""
    if not 1 <= w <= NETWORK_CAP:
        raise ValueError(f"the network route takes 1 <= W <= {NETWORK_CAP}, got {w}")
    n = -(-w // NETWORK_STEP) * NETWORK_STEP
    p2 = 1 << (n - 1).bit_length()
    pairs = []
    for sp in range(p2.bit_length() - 1):
        p = 1 << sp
        for sk in range(sp, -1, -1):
            k = 1 << sk
            for j in range(k % p, p2 - k, 2 * k):
                for i in range(k):
                    a, b = i + j, i + j + k
                    if b < n and a // (2 * p) == b // (2 * p):
                        pairs.append((a, b))
    return n, pairs


def median_network_ops(w: int) -> int:
    """Float min/max a coordinate that K4's network route needs at ``w``
    workers: the compare-exchange outputs that can reach the ranks the
    kernel reads ((N - NETWORK_STEP) // 2 .. N // 2), counted backwards from
    them (the compiler drops the rest)."""
    n, pairs = median_network_pairs(w)
    need = set(range((n - NETWORK_STEP) // 2, n // 2 + 1))
    ops = 0
    for a, b in reversed(pairs):
        used = (a in need) + (b in need)
        if used:
            ops += used
            need.update((a, b))
    return ops


def trimmed_network_ops(w: int) -> int:
    """Float min/max a coordinate that K5's network route needs at ``w``
    workers: every compare-exchange of the network, two each (the kept
    range depends on the runtime trim, so the compiler can drop none)."""
    return 2 * len(median_network_pairs(w)[1])


def check_inputs(what: str, z: torch.Tensor) -> None:
    """z (W, D) float32 or bfloat16 with W >= 1.  Raises on anything else."""
    _build.check_dtype(what, z)
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
    s = torch.sort(z.float(), dim=0).values
    w = z.shape[0]
    if w % 2:
        return s[w // 2]
    return (s[w // 2 - 1] + s[w // 2]) * 0.5


def trimmed_mean_plain(z: torch.Tensor, trim: int) -> torch.Tensor:
    s = torch.sort(z.float(), dim=0).values
    return torch.mean(s[trim:z.shape[0] - trim], dim=0)


def _launch(what: str, z: torch.Tensor, *extra) -> torch.Tensor:
    _check_launchable(what, z)
    w, d = z.shape
    lib = _build.load("robust_stats", _SIGNATURES)
    out = torch.empty((d,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = getattr(lib, f"{what}_{_build.SUFFIX[z.dtype]}")(
            _build.ptr(z), _build.ptr(out), w, d, *extra,
            ctypes.c_void_p(_build.stream_of(z)))
    _build.check(lib, rc, what)
    _build.count(what, z.dtype)
    return out


def _launch_counted(what: str, z: torch.Tensor, counts: dict, *extra) -> torch.Tensor:
    """_launch, with the bf16 route's layout reported into ``counts``."""
    layout = ctypes.c_int(0)
    out = _launch(what, z, *extra,
                  *((ctypes.byref(layout),) if z.dtype == torch.bfloat16 else ()))
    counts[MEDIAN_LAYOUTS[layout.value]] += 1
    return out


def coordinate_median_call(z: torch.Tensor) -> torch.Tensor:
    """z (W, D) -> (D,) float32 per-coordinate median, on the card."""
    check_inputs("coordinate_median", z)
    return _launch_counted("coordinate_median", z, MEDIAN_LAYOUT_LAUNCHES)


def trimmed_mean_call(z: torch.Tensor, trim: int) -> torch.Tensor:
    """z (W, D) -> (D,) float32 per-coordinate ``trim``-trimmed mean, on the
    card."""
    check_inputs("trimmed_mean", z)
    check_trim(z, trim)
    return _launch_counted("trimmed_mean", z, TRIMMED_LAYOUT_LAUNCHES, int(trim))
