"""K2, K3 and K6: the sweeps of a Weiszfeld iteration (port of
``repro/kernels/weiszfeld.py``).

* :func:`partial_sqdist_call` -- per-worker squared distance
  ``||z_w - y||^2`` of a (W, D) message matrix to a (D,) iterate -> (W,).
  Partial sums per chunk of 2,048 coordinates, then one fixed-order
  reduction per worker, so the result is the same bits on every run: in
  two passes (two kernels and a scratch buffer), or, for a bfloat16 z whose
  base is 16-byte aligned and whose strides are multiples of 8 elements, in
  one launch with no scratch: each row's chunks spread over a thread-block
  cluster, whose other blocks send their partials into its first block's
  shared memory, and the first block sums them in the two passes' order
  (:data:`SQDIST_LAYOUT_LAUNCHES` counts "cluster" and "two-pass").  With a ``mask`` of z's leading shape it takes
  its masked route: the rows of ``mask <= 0`` are not read and their
  distance is exactly 0 (:data:`SQDIST_ROUTE_LAUNCHES` counts each route).
* :func:`weighted_sum_call`   -- unnormalized ``sum_w a_w z_w`` -> (D,).
  It reads only the rows whose weight is not 0 (a zero-weight row holding
  inf or NaN contributes nothing, in the plain version too: mask-0 senders
  do not influence the result), splits them in a fixed order, so the
  result is the same bits on every run and for every receiver of a batch.

Both also take a leading receiver axis, the decentralized step's masked
Weiszfeld: ``partial_sqdist`` on (R, S, D) and (R, D) gives (R, S),
``weighted_sum`` on (R, S, D) and (R, S) gives (R, D) -- one launch for all
R receivers, a grid dimension over R.  The matrix ``z`` may be a column
slice of a wider buffer, and its receiver stride may be 0 (one matrix
shared by every receiver, ``expand``): it is read in place.  Any W, S and R
that fit in memory.
* :func:`partial_sqdist_segments_call` -- per-(worker, segment) squared
  distances -> (W, L), given each coordinate's segment id (an id outside
  ``[0, L)`` counts nowhere).  One launch: the block that finishes last
  for each group of 4 workers sums their partials in a fixed order, so the
  same bits each run.

All launch the CUDA kernels of ``csrc/weiszfeld.cu``, with z in float32
or bfloat16 (the bf16 wire: the kernel's bf16 route loads it as it is and
gives the bits of the float32 kernel on ``z.float()``) and everything else
in float32; ``*_plain`` are the same functions in plain PyTorch (on a bf16
z, the same function of ``z.float()``), which the CPU path runs and the
card's checks compare against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "partial_sqdist_scratch_cols": [ctypes.c_longlong],
    "partial_sqdist_masked_scratch_cols": [ctypes.c_longlong],
    "partial_sqdist_segments_chunks": [ctypes.c_longlong],
    "partial_sqdist_cluster_fits": [ctypes.c_void_p] + [ctypes.c_longlong] * 3,
    "partial_sqdist_cluster_bf16": [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p],
}
for _sfx in _build.SUFFIX.values():
    _SIGNATURES.update({
        f"partial_sqdist_{_sfx}": [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p],
        f"partial_sqdist_masked_{_sfx}": [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p],
        f"weighted_sum_{_sfx}": [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p],
        f"partial_sqdist_segments_{_sfx}": [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    })

# K6's arrival counters (one int32 per group of workers; sized by rows, which
# is more), kept per (device, stream): zeroed once when made or grown, and
# left at zero by every launch.
_ARRIVALS: dict[tuple[int, int], torch.Tensor] = {}

SQDIST_ROUTES = ("unmasked", "masked")
# K2 launches per route (reset with the others by ops.reset_launch_counts).
SQDIST_ROUTE_LAUNCHES = dict.fromkeys(SQDIST_ROUTES, 0)
# The unmasked route's layouts and their launches (reset with the others):
# "cluster" (a bfloat16 z the one-launch kernel takes) and "two-pass" (every
# float32 z and every other bfloat16 view).
SQDIST_LAYOUTS = ("cluster", "two-pass")
SQDIST_LAYOUT_LAUNCHES = dict.fromkeys(SQDIST_LAYOUTS, 0)


def check_inputs(what: str, z: torch.Tensor, v: torch.Tensor,
                 v_shape: tuple[int, ...], *, batched: bool = False) -> None:
    """z (W, D) -- or, with ``batched``, also (R, S, D) -- float32 or
    bfloat16, and a float32 tensor of shape ``v_shape`` on the same device.
    Raises on anything else."""
    _build.check_dtype(what, z)
    if v.dtype != torch.float32:
        raise TypeError(f"{what}: the second input must be float32, got "
                        f"{v.dtype}")
    if z.dim() not in ((2, 3) if batched else (2,)) \
            or tuple(v.shape) != tuple(v_shape):
        raise ValueError(f"{what}: shapes {tuple(z.shape)} and "
                         f"{tuple(v.shape)} do not agree")
    if z.device != v.device:
        raise ValueError(f"{what}: inputs lie on different devices")


def check_mask(z: torch.Tensor, mask: torch.Tensor) -> None:
    """mask float32 of z's leading shape ((W,) or (R, S)), on z's device."""
    if mask.dtype != torch.float32:
        raise TypeError(f"partial_sqdist: mask must be float32, got {mask.dtype}")
    if tuple(mask.shape) != tuple(z.shape[:-1]) or mask.device != z.device:
        raise ValueError(f"partial_sqdist: mask {tuple(mask.shape)} on "
                         f"{mask.device} does not match z {tuple(z.shape)} on "
                         f"{z.device}")


def check_segments(z: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int) -> None:
    """seg_ids (D,) int32 on z's device, num_segments >= 0."""
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"partial_sqdist_segments: seg_ids must be int32, got "
                        f"{seg_ids.dtype}")
    if tuple(seg_ids.shape) != (z.shape[-1],) or seg_ids.device != z.device:
        raise ValueError(f"partial_sqdist_segments: seg_ids {tuple(seg_ids.shape)}"
                         f" on {seg_ids.device} does not match z "
                         f"{tuple(z.shape)} on {z.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")


def _check_launchable(what: str, z: torch.Tensor, *rest: torch.Tensor,
                      strided: bool = False) -> None:
    """On a CUDA device and contiguous; with ``strided`` the matrix ``z``
    may have rows ``ld >= D`` floats apart (and receivers any stride >=
    0)."""
    if z.device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on a CUDA device")
    if strided:
        batch_strides(z)
    else:
        rest = (z, *rest)
    if not all(t.is_contiguous() for t in rest):
        raise ValueError(f"{what}: inputs must be contiguous")


def row_stride(z: torch.Tensor) -> int:
    """The distance in elements between z's rows, when its coordinates are
    contiguous within each row (a contiguous matrix or a column slice of
    one); raises otherwise."""
    w, d = z.shape[-2:]
    if (d > 1 and z.stride(-1) != 1) or (w > 1 and z.stride(-2) < d):
        raise ValueError(f"z of shape {tuple(z.shape)} and strides "
                         f"{z.stride()} has no row-major layout")
    return max(z.stride(-2), d)


def batch_strides(z: torch.Tensor) -> tuple[int, int, int]:
    """(R, ld, rs) of a (W, D) or (R, S, D) matrix whose rows are
    row-major (:func:`row_stride`): receivers ``rs >= 0`` elements apart (0
    for a single matrix, or one broadcast to every receiver)."""
    ld = row_stride(z)
    if z.dim() == 2:
        return 1, ld, 0
    if z.stride(0) < 0:
        raise ValueError(f"z of strides {z.stride()} has a negative "
                         "receiver stride")
    return z.shape[0], ld, z.stride(0) if z.shape[0] > 1 else 0


def partial_sqdist_plain(z: torch.Tensor, y: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    d = z.float() - y.unsqueeze(-2)
    sq = torch.sum(d * d, dim=-1)
    return sq if mask is None else torch.where(mask > 0, sq, 0.0)


def weighted_sum_plain(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    # A row of weight exactly 0 contributes nothing, even one holding inf or
    # NaN (where 0 * inf would give NaN), as in the kernel, which never reads
    # it.  On finite rows the product's order is unchanged.
    z = torch.where((a != 0).unsqueeze(-1), z.float(), 0.0)
    if z.dim() == 3:
        return torch.bmm(a.unsqueeze(1), z).squeeze(1)
    return a @ z


def partial_sqdist_segments_plain(z: torch.Tensor, y: torch.Tensor,
                                  seg_ids: torch.Tensor,
                                  num_segments: int) -> torch.Tensor:
    d = z.float() - y[None]
    onehot = (seg_ids[None, :] == torch.arange(
        num_segments, device=z.device, dtype=seg_ids.dtype)[:, None])
    return (d * d) @ onehot.to(torch.float32).T


def partial_sqdist_call(z: torch.Tensor, y: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """z (W, D), y (D,) -> (W,) float32; or z (R, S, D), y (R, D) ->
    (R, S); on the card.  ``z`` may be a column slice or a broadcast (read
    in place).  With ``mask`` (z's leading shape, contiguous) only the rows
    of ``mask > 0`` are read; the others give exactly 0."""
    check_inputs("partial_sqdist", z, y, z.shape[:-2] + z.shape[-1:],
                 batched=True)
    if mask is not None:
        check_mask(z, mask)
    _check_launchable("partial_sqdist", z, y,
                      *(() if mask is None else (mask,)), strided=True)
    r, ld, rs = batch_strides(z)
    w, d = z.shape[-2:]
    lib = _build.load("weiszfeld", _SIGNATURES)
    sfx = _build.SUFFIX[z.dtype]
    out = torch.empty(z.shape[:-1], dtype=torch.float32, device=z.device)
    stream = ctypes.c_void_p(_build.stream_of(z))
    route = "unmasked" if mask is None else "masked"
    layout = None
    with torch.cuda.device(z.device):
        if mask is None and z.dtype == torch.bfloat16 \
                and lib.partial_sqdist_cluster_fits(_build.ptr(z), d, ld, rs):
            layout = "cluster"
            rc = lib.partial_sqdist_cluster_bf16(
                _build.ptr(z), _build.ptr(y), _build.ptr(out), r, w, d, ld, rs,
                stream)
        elif mask is None:
            layout = "two-pass"
            scratch = torch.empty((r * w, lib.partial_sqdist_scratch_cols(d)),
                                  dtype=torch.float32, device=z.device)
            rc = getattr(lib, f"partial_sqdist_{sfx}")(
                _build.ptr(z), _build.ptr(y), _build.ptr(scratch),
                _build.ptr(out), r, w, d, ld, rs, stream)
        else:
            scratch = torch.empty(
                (r * w, lib.partial_sqdist_masked_scratch_cols(d)),
                dtype=torch.float32, device=z.device)
            rc = getattr(lib, f"partial_sqdist_masked_{sfx}")(
                _build.ptr(z), _build.ptr(y), _build.ptr(mask),
                _build.ptr(scratch), _build.ptr(out), r, w, d, ld, rs, stream)
    _build.check(lib, rc, "partial_sqdist")
    _build.count("partial_sqdist", z.dtype, route)
    SQDIST_ROUTE_LAUNCHES[route] += 1
    if layout is not None:
        SQDIST_LAYOUT_LAUNCHES[layout] += 1
    return out


def weighted_sum_call(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """z (W, D), a (W,) -> (D,) float32 = sum_w a[w] z[w]; or z (R, S, D),
    a (R, S) -> (R, D); on the card.  ``z`` may be a column slice
    ``buf[..., lo:hi]`` or a broadcast (read in place)."""
    check_inputs("weighted_sum", z, a, z.shape[:-1], batched=True)
    _check_launchable("weighted_sum", z, a, strided=True)
    r, ld, rs = batch_strides(z)
    w, d = z.shape[-2:]
    lib = _build.load("weiszfeld", _SIGNATURES)
    out = torch.empty(z.shape[:-2] + (d,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = getattr(lib, f"weighted_sum_{_build.SUFFIX[z.dtype]}")(
            _build.ptr(z), _build.ptr(a), _build.ptr(out), r, w, d, ld, rs,
            ctypes.c_void_p(_build.stream_of(z)))
    _build.check(lib, rc, "weighted_sum")
    _build.count("weighted_sum", z.dtype)
    return out


def _arrival_counters(device: torch.device, stream: int,
                      rows: int) -> torch.Tensor:
    """K6's (>= rows,) zeroed int32 counters for launches on ``stream``;
    grown (zeroed again, on that stream) when a call needs more rows."""
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < rows:
        size = max(rows, 2 * buf.numel() if buf is not None else 1024)
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def partial_sqdist_segments_call(z: torch.Tensor, y: torch.Tensor,
                                 seg_ids: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """z (W, D), y (D,), seg_ids (D,) int32 -> (W, num_segments) float32,
    on the card, in one kernel launch."""
    check_inputs("partial_sqdist_segments", z, y, z.shape[-1:])
    check_segments(z, seg_ids, num_segments)
    _check_launchable("partial_sqdist_segments", z, y, seg_ids)
    w, d = z.shape
    out = torch.empty((w, num_segments), dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out
    lib = _build.load("weiszfeld", _SIGNATURES)
    nchunks = lib.partial_sqdist_segments_chunks(d)
    partial = torch.empty((w, num_segments, nchunks), dtype=torch.float32,
                          device=z.device)
    span = torch.empty((w, nchunks, 2), dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        stream = _build.stream_of(z)
        arrived = _arrival_counters(z.device, stream, w)
        rc = getattr(lib, f"partial_sqdist_segments_{_build.SUFFIX[z.dtype]}")(
            _build.ptr(z), _build.ptr(y), _build.ptr(seg_ids),
            _build.ptr(partial), _build.ptr(span), _build.ptr(arrived),
            _build.ptr(out), w, d, num_segments, ctypes.c_void_p(stream))
    _build.check(lib, rc, "partial_sqdist_segments")
    _build.count("partial_sqdist_segments", z.dtype)
    return out
