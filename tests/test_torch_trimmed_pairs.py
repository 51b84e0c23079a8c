"""K5's bf16 pairs layout (``csrc/robust_stats.cu``, ``trimmed_pairs_kernel``),
on the CPU.

The layout takes the views of K4's pairs layout: each row's 4-byte word
holds a column pair, ``median_keys`` keys both halves (NaN above +inf), and
the whole network of ``robust_stats.median_network_pairs`` runs on the
words with packed signed 16-bit min/max (the kept range depends on the
runtime trim, so nothing is pruned).  Each half's kept ranks
[trim, W - trim) are unkeyed to their float32 values (``pair_raw``: the
sign spread back over the half, a NaN key giving back a NaN) and added in
ascending rank order from +0, then divided by W - 2 trim; there is no NaN
count: a column whose highest kept key is a NaN's (more than trim NaN)
gets NaN.  The claim is
the float32 network kernel's bits on the upcast matrix.  Here the route is
emulated in numpy at every W from 1 to 128 with four trims each, on bit
patterns holding NaN of both signs, +-inf, +-0, subnormals, ties and NaN
counts of trim and trim + 1, and held bit for bit against the float32
network emulated in torch (``tests/torch_network.py``), and by value
against the plain version.  No JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import robust_stats as rs
from test_torch_median_pairs import _columns, _median_keys, _same
from test_torch_select_keys import _halves
from torch_network import network_trimmed_mean


def _trims(w: int) -> list[int]:
    """0, 1, (W - 1) // 2 and 20, where 2 trim < W."""
    return sorted({t for t in (0, 1, (w - 1) // 2, 20) if 2 * t < w})


def _sorted_pair_keys(bits: np.ndarray) -> tuple[np.ndarray, int]:
    """The words' keys through the whole network: (N, 2, d / 2) int16
    (halves low, high) and the packed min/max run, one a compare-exchange
    side for both columns."""
    w, d = bits.shape
    n, cx = rs.median_network_pairs(w)
    lo, hi = _halves(_median_keys(bits[:, 0::2] | (bits[:, 1::2] << 16)))
    v = np.full((n, 2, d // 2), 0x7FFF, dtype=np.int16)   # kPairTop's halves
    v[:w, 0], v[:w, 1] = lo, hi
    for a, b in cx:
        x, y = v[a].copy(), v[b].copy()
        v[a], v[b] = np.minimum(x, y), np.maximum(x, y)
    return v, 2 * len(cx)


def _unkey(k: np.ndarray) -> np.ndarray:
    """pair_raw on int16 keys, as float32: the half's raw bfloat16 bits
    (the sign spread over the other 15 bits flipped back), a NaN key
    (above +inf's, sign clear) giving back a NaN."""
    k16 = k.astype(np.int64) & 0xFFFF
    raw = np.where(k16 & 0x8000, k16 ^ 0x7FFF, k16)
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _pairs_route(v: np.ndarray, w: int, trim: int) -> np.ndarray:
    """trimmed_pairs_kernel's sum and division on the sorted keys:
    (d,) float32, column 2p from the low half, 2p + 1 from the high."""
    acc = np.zeros(v.shape[1:], dtype=np.float32)
    with np.errstate(invalid="ignore"):
        for r in range(v.shape[0]):
            if trim <= r < w - trim:
                acc = acc + _unkey(v[r])
        acc = acc / np.float32(w - 2 * trim)
    # NaN (the float32 kernel's NAN) where the highest kept key is a NaN's.
    acc = np.where(v[w - trim - 1].astype(np.int64) > 0x7F80, np.float32(np.nan), acc)
    out = np.empty(2 * v.shape[2], dtype=np.float32)
    out[0::2], out[1::2] = acc[0], acc[1]
    return out


def _patterns(w: int) -> np.ndarray:
    """_columns' bit patterns, plus columns holding trim and trim + 1 NaN
    (both signs) for each trim of the sweep, and columns of +-inf at both
    tails."""
    rng = np.random.default_rng(1000 + w)
    bits = _columns(w, 24, rng)
    extra = []
    for t in _trims(w):
        for count, sign in ((t, 0x0000), (t + 1, 0x8000)):
            col = bits[:, rng.integers(0, bits.shape[1])].copy()
            col[rng.permutation(w)[:min(count, w)]] = 0x7FC0 | sign
            extra.append(col)
    tails = bits[:, :2].copy()
    tails[: w // 3, 0] = 0x7F80
    tails[w - w // 3:, 0] = 0xFF80
    tails[::2, 1] = 0xFF80
    extra += [tails[:, 0], tails[:, 1]]
    if len(extra) % 2:
        extra.append(bits[:, 0])
    return np.concatenate([bits, np.stack(extra, axis=1)], axis=1)


@pytest.mark.parametrize("w", range(1, rs.NETWORK_CAP + 1))
def test_trimmed_pairs_route_gives_the_float32_network_bits(w):
    """Every W of the network, trims 0, 1, (W - 1) // 2 and 20 where valid:
    the pairs route's bits equal the float32 network's on the upcast (NaN
    exactly where it has NaN, NaN equal to NaN), the plain version's values
    at rtol 1e-5, and the min/max run is trimmed_network_ops(W)."""
    bits = _patterns(w)
    v, n_ops = _sorted_pair_keys(bits)
    assert n_ops == rs.trimmed_network_ops(w)
    if w == 70:
        assert n_ops == 1500
    z = torch.from_numpy((bits << 16).astype(np.uint32).view(np.float32))
    for trim in _trims(w):
        got = _pairs_route(v, w, trim)
        assert _same(got, network_trimmed_mean(z, trim).numpy()), (w, trim)
        want = rs.trimmed_mean_plain(z.bfloat16(), trim).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want)), (w, trim)
        fin = np.isfinite(want)
        assert np.array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want[fin]).max(initial=0)))


def test_trimmed_layout_counts_reset_and_stay_zero_on_the_cpu():
    """K5's layout counts: the plain version on the CPU launches nothing,
    and ``reset_launch_counts`` zeroes them with the rest."""
    rs.TRIMMED_LAYOUT_LAUNCHES["pairs"] = 3
    ops.reset_launch_counts()
    ops.trimmed_mean(torch.randn((9, 30)).bfloat16(), trim=2)
    assert rs.TRIMMED_LAYOUT_LAUNCHES == {"one": 0, "pairs": 0}
