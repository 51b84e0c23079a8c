"""Device dispatch over the kernels (port of ``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
a CUDA device goes to the hand-written kernel, whose wrapper raises if it
cannot launch.  There is no fallback from the card to the plain version.
Each kernel wrapper counts its launches (:func:`launch_counts`).

The message operands (z, the exchange, K1's state) may be float32 or
bfloat16, the bf16 wire's buffers: each kernel has a bf16 route, launched
for a bf16 tensor as it is (:func:`bf16_launch_counts` counts those
launches), and each plain version takes bf16 too.  Any other dtype
(float16 included) raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import robust_stats as rs
from repro_torch.kernels import saga_correct as sc
from repro_torch.kernels import topology as tp
from repro_torch.kernels import weiszfeld as wz


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def messages(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` in a dtype the kernels take: float32 and bfloat16 (the bf16
    wire's buffer, which the kernels' bf16 routes read as it is) unchanged,
    anything else cast to float32.  Strides are kept."""
    return buf if buf.dtype in _build.SUFFIX else buf.float()


def saga_correct(grad: torch.Tensor, table: torch.Tensor, avg: torch.Tensor,
                 idx: torch.Tensor, rows: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """K1: msg (W, D); ``avg`` (W, D) and ``table`` (W, J, D) are updated in
    place.  With ``rows`` ((W,) distinct int64 client rows) the state is
    resident per client, table (C, J, D) and avg (C, D), and only rows
    ``rows`` move."""
    sc.check_inputs(grad, table, avg, idx, rows)
    if _on_card(grad):
        return sc.saga_correct_call(grad, table, avg, idx, rows)
    return sc.saga_correct_plain(grad, table, avg, idx, rows)


def partial_sqdist(z: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """K2: z (W, D), y (D,) -> (W,) squared distances; batched over
    receivers, z (R, S, D), y (R, D) -> (R, S).  With ``mask`` (z's leading
    shape) the rows of ``mask <= 0`` are not read and give exactly 0."""
    wz.check_inputs("partial_sqdist", z, y, z.shape[:-2] + z.shape[-1:],
                    batched=True)
    if mask is not None:
        wz.check_mask(z, mask)
    if _on_card(z):
        return wz.partial_sqdist_call(z, y, mask)
    return wz.partial_sqdist_plain(z, y, mask)


def weighted_sum(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K3: z (W, D), a (W,) -> (D,) = sum_w a[w] z[w], unnormalized;
    batched over receivers, z (R, S, D), a (R, S) -> (R, D)."""
    wz.check_inputs("weighted_sum", z, a, z.shape[:-1], batched=True)
    if _on_card(z):
        return wz.weighted_sum_call(z, a)
    return wz.weighted_sum_plain(z, a)


def partial_sqdist_segments(z: torch.Tensor, y: torch.Tensor,
                            seg_ids: torch.Tensor, *,
                            num_segments: int) -> torch.Tensor:
    """K6: z (W, D), y (D,), seg_ids (D,) int32 -> (W, num_segments)
    per-(worker, segment) squared distances; an id outside
    ``[0, num_segments)`` (padding) counts nowhere."""
    wz.check_inputs("partial_sqdist_segments", z, y, z.shape[-1:])
    wz.check_segments(z, seg_ids, num_segments)
    if _on_card(z):
        return wz.partial_sqdist_segments_call(z, y, seg_ids, num_segments)
    return wz.partial_sqdist_segments_plain(z, y, seg_ids, num_segments)


def coordinate_median(z: torch.Tensor) -> torch.Tensor:
    """K4: z (W, D) -> (D,) per-coordinate median (even W: the mean of the
    two middle values)."""
    rs.check_inputs("coordinate_median", z)
    if _on_card(z):
        return rs.coordinate_median_call(z)
    return rs.coordinate_median_plain(z)


def trimmed_mean(z: torch.Tensor, *, trim: int = 1) -> torch.Tensor:
    """K5: z (W, D) -> (D,) per-coordinate mean without the ``trim``
    smallest and ``trim`` largest values; ``2 * trim < W``."""
    rs.check_inputs("trimmed_mean", z)
    rs.check_trim(z, trim)
    if _on_card(z):
        return rs.trimmed_mean_call(z, trim)
    return rs.trimmed_mean_plain(z, trim)


def masked_neighbor_reduce(exchange: torch.Tensor, mask: torch.Tensor, *,
                           trim: int = 0) -> torch.Tensor:
    """K7: exchange (R, S, D), mask (R, S) -> (R, D) per-receiver masked
    mean without the ``trim`` largest and smallest masked values per
    coordinate, over ``max(n_r - 2 * trim, 1)``."""
    tp.check_inputs(exchange, mask, trim)
    if _on_card(exchange):
        return tp.masked_neighbor_reduce_call(exchange, mask, trim)
    return tp.masked_neighbor_reduce_plain(exchange, mask, trim)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """K8: q (B, S, H, hd), k and v (B, S, KV, hd) -> (B, S, H, hd) in q's
    dtype; GQA reads key/value head ``h // (H // KV)`` (no repeat).  The
    reference's ``q_block``/``kv_block`` set its Pallas tiling; the port's
    tile is the kernel's own, so it takes neither.  Differentiable: on the
    card through :class:`~repro_torch.kernels.flash_attention.FlashAttention`
    (K8 forward, plain backward), on the CPU by autograd of the plain
    version.  ``window``: None, or a sliding window >= 1 (causal only):
    keys ``qpos - window < kpos <= qpos``, the reference's ``_sliding``."""
    fa.check_inputs(q, k, v)
    fa.check_window(window, causal)
    if _on_card(q):
        return fa.FlashAttention.apply(q, k, v, causal, window)
    return fa.flash_attention_plain(q, k, v, causal, window=window)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_build.LAUNCHES)


def bf16_launch_counts() -> dict[str, int]:
    """Launches of the bf16 routes since the last reset, per kernel and per
    ``"<kernel> <route>"`` of K1, K2 and K7; kernels with none are absent."""
    return dict(_build.BF16_LAUNCHES)


def reset_launch_counts() -> None:
    """Zero every kernel's count, the bf16 routes' counts, and the
    per-route counts of K1 (``saga_correct.ROUTE_LAUNCHES``), K2
    (``weiszfeld.SQDIST_ROUTE_LAUNCHES`` and
    ``weiszfeld.SQDIST_LAYOUT_LAUNCHES``), K4 and K5
    (``robust_stats.MEDIAN_LAYOUT_LAUNCHES`` and
    ``robust_stats.TRIMMED_LAYOUT_LAUNCHES``), K7
    (``topology.ROUTE_LAUNCHES`` and ``topology.SELECT_LAYOUT_LAUNCHES``) and
    K8 (``flash_attention.VARIANT_LAUNCHES`` and ``WINDOW_LAUNCHES``)."""
    for counts in (_build.LAUNCHES, sc.ROUTE_LAUNCHES, wz.SQDIST_ROUTE_LAUNCHES,
                   wz.SQDIST_LAYOUT_LAUNCHES, rs.MEDIAN_LAYOUT_LAUNCHES,
                   rs.TRIMMED_LAYOUT_LAUNCHES,
                   tp.ROUTE_LAUNCHES, tp.SELECT_LAYOUT_LAUNCHES,
                   fa.VARIANT_LAUNCHES, fa.WINDOW_LAUNCHES):
        for name in counts:
            counts[name] = 0
    _build.BF16_LAUNCHES.clear()
