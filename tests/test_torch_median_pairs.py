"""K4's bf16 pairs layout (``csrc/robust_stats.cu``, ``median_pairs_kernel``),
on the CPU.

The layout orders two bfloat16 columns at once: each row's 4-byte word holds
a column pair, ``median_keys`` turns both halves into 16-bit keys (a NaN
half first loses its sign bit; then b for b >= 0, b ^ 0x7fff for b < 0,
the sign spread over the half by one ``prmt``), and K4's pruned network runs
on the words with packed signed 16-bit min/max.  Its claim is that it gives
the float32 kernel's bits on the upcast matrix.  Here ``median_keys`` is
checked against ``order_key`` of the upcast on all 65,536 bfloat16 bit
patterns in either half of a word, and the route is emulated in numpy --
the keys, the words through ``robust_stats.median_network_pairs`` with
int16 min/max per half, a rank reading NaN where its key lies above +inf's,
the unkeyed values and ``(a + b) * 0.5`` in float32 -- for every W from 1 to
128 on bit patterns holding NaN of both signs, +-inf, +-0, subnormals and
ties.  It must equal the float32 network's selection in key order bit for
bit (Hopper's FMNMX orders -0 below +0 too, so the card's float32 kernel
gives those bits, zeros included: ``tests/test_torch_gpu.py``), and the
torch emulation of the float network (``tests/torch_network.py``) and the
plain version by value (torch's CPU minimum and sort leave the order of -0
and +0 open).  No JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import robust_stats as rs
from repro_torch.kernels import weiszfeld as wz
from test_torch_select_keys import _halves, _key32, _pair_values
from torch_network import network_median

ALL = np.arange(1 << 16, dtype=np.uint32)
OTHER = np.random.default_rng(1).permutation(ALL)
PAD = 0x7FFF7FFF   # kPairTop
INF_KEY = 0x7F80   # +inf's key: a key above it is a NaN or a pad


def _median_keys(w: np.ndarray) -> np.ndarray:
    """median_keys on 32-bit words of two raw bfloat16 values."""
    w = w.astype(np.uint32)
    t = (w & 0x7FFF7FFF) + 0x007F007F
    w = w & ~(t & 0x80008000)
    sign = (np.where(w & 0x8000, 0xFFFF, 0)
            | np.where(w & 0x80000000, 0xFFFF0000, 0)).astype(np.uint32)   # prmt 0xbb99
    return w ^ (sign & 0x7FFF7FFF)


def _nan16(bits: np.ndarray) -> np.ndarray:
    return (bits & 0x7FFF) > INF_KEY


@pytest.mark.parametrize("half", ["low", "high"])
def test_median_keys_order_like_the_float32_keys(half):
    """Every bit pattern in either half: a non-NaN value's key orders as
    order_key of the upcast (ties and -0 < +0 included) and gives back its
    bits, every NaN keys above +inf and at most the pad, and the other half
    of the word never changes its key."""
    words = ALL | (OTHER << 16) if half == "low" else OTHER | (ALL << 16)
    i = 0 if half == "low" else 1
    k16 = _halves(_median_keys(words))[i].astype(np.int64)
    other = _halves(_median_keys(OTHER | (OTHER << 16)))[0].astype(np.int64)
    assert np.array_equal(_halves(_median_keys(words))[1 - i].astype(np.int64), other)
    nan = _nan16(ALL)
    assert int(nan.sum()) == 254
    assert bool(np.all((k16[nan] > INF_KEY) & (k16[nan] <= 0x7FFF)))
    k32 = _key32(ALL[~nan]).astype(np.int64)
    fin = k16[~nan]
    by32 = np.argsort(k32, kind="stable")
    assert bool(np.all(np.diff(fin[by32]) > 0))   # distinct values, same order
    assert int(fin.max()) == INF_KEY and k16[0] == 0 and k16[0x8000] == -1
    back = _pair_values(fin.astype(np.uint32) & 0xFFFF) & 0xFFFF
    assert np.array_equal(back, ALL[~nan])


def _columns(w: int, pairs: int, rng) -> np.ndarray:
    """(w, 2 * pairs) raw bfloat16 bits: ordinary values with ties, and
    columns rich in NaN (both signs, several payloads), +-inf, +-0 and
    subnormals; some columns NaN in their median ranks."""
    d = 2 * pairs
    vals = (torch.from_numpy(rng.standard_normal((w, d)).astype(np.float32))
            .bfloat16().view(torch.int16).numpy().view(np.uint16).astype(np.uint32))
    specials = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81,
                         0xFFFF, 0x0001, 0x8001, 0x007F, 0x807F, 0x3F80, 0xBF80],
                        dtype=np.uint32)
    pick = rng.random((w, d))
    vals = np.where(pick < 0.3, specials[rng.integers(0, len(specials), (w, d))], vals)
    vals[:, : d // 4] = np.round(vals[:, : d // 4].astype(np.int64) / 64).astype(np.uint32) * 64
    vals[: (w + 1) // 2, d // 4: d // 4 + 2] = 0x7FC0      # NaN at every median rank
    vals[:, d // 4 + 2: d // 4 + 4] = rng.choice([0x0000, 0x8000], (w, 2))
    return vals & 0xFFFF


def _pairs_route(bits: np.ndarray) -> np.ndarray:
    """median_pairs_kernel emulated: (w, d) raw bits, d even -> (d,) float32."""
    w, d = bits.shape
    n, cx = rs.median_network_pairs(w)
    words = bits[:, 0::2] | (bits[:, 1::2] << 16)
    keys = _median_keys(words)
    lo_h, hi_h = _halves(keys)
    wires = [[lo_h[i].copy(), hi_h[i].copy()] for i in range(w)]
    pad = _halves(np.array([PAD], dtype=np.uint32))
    wires += [[np.full(d // 2, pad[0][0]), np.full(d // 2, pad[1][0])]
              for _ in range(n - w)]
    for a, b in cx:
        for h in range(2):
            x, y = wires[a][h], wires[b][h]
            wires[a][h], wires[b][h] = np.minimum(x, y), np.maximum(x, y)

    def value(r):
        out = np.empty(d, dtype=np.float32)
        for h in range(2):
            k = wires[r][h].astype(np.int64)
            raw = (_pair_values(k.astype(np.uint32) & 0xFFFF) & 0xFFFF) << 16
            v = raw.astype(np.uint32).view(np.float32)
            out[h::2] = np.where(k > INF_KEY, np.float32(np.nan), v)
        return out
    lo, hi = (w - 1) // 2, w // 2
    if lo == hi:
        return value(lo)
    return (value(lo) + value(hi)) * np.float32(0.5)


def _key_order_median(bits: np.ndarray) -> np.ndarray:
    """The float32 network's result with -0 ordered below +0 (Hopper's
    FMNMX): each column's upcast values sorted by order_key, NaN last, a
    rank of W - #NaN or more reading NaN."""
    w, _ = bits.shape
    f = (bits << 16).astype(np.uint32).view(np.float32)
    nan = np.isnan(f)
    k = np.where(nan, np.iinfo(np.int64).max, _key32(bits).astype(np.int64))
    s = np.take_along_axis(f, np.argsort(k, axis=0, kind="stable"), axis=0)
    s = np.where(np.arange(w)[:, None] >= w - nan.sum(0), np.float32(np.nan), s)
    lo, hi = (w - 1) // 2, w // 2
    return s[lo] if lo == hi else (s[lo] + s[hi]) * np.float32(0.5)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise equal, NaN equal to NaN (the card writes its canonical NaN)."""
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb)
                and np.array_equal(a[~na].view(np.uint32), b[~nb].view(np.uint32)))


@pytest.mark.parametrize("w", range(1, rs.NETWORK_CAP + 1))
def test_pairs_route_gives_the_float32_network_bits(w):
    """The pairs route at every W of the network: the float32 network's
    bits in key order (zeros' signs included), the torch emulation of the
    float network and the plain version by value, NaN exactly where they
    have it."""
    bits = _columns(w, 24, np.random.default_rng(w))
    got = _pairs_route(bits)
    assert _same(got, _key_order_median(bits))
    z = torch.from_numpy((bits << 16).astype(np.uint32).view(np.float32))
    for want in (network_median(z).numpy(),
                 rs.coordinate_median_plain(z.bfloat16()).numpy()):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert bool(np.all((got == want) | np.isnan(got)))
    assert bool(np.isnan(got[12:14]).all())   # the columns NaN at the median ranks


def test_layout_counts_reset_and_stay_zero_on_the_cpu():
    """K2's and K4's layout counts: the plain versions on the CPU launch
    nothing, and ``reset_launch_counts`` zeroes them with the rest."""
    wz.SQDIST_LAYOUT_LAUNCHES["cluster"] = 2
    rs.MEDIAN_LAYOUT_LAUNCHES["pairs"] = 5
    ops.reset_launch_counts()
    z = torch.randn((7, 30)).bfloat16()
    ops.partial_sqdist(z, torch.zeros(30))
    ops.coordinate_median(z)
    assert wz.SQDIST_LAYOUT_LAUNCHES == {"cluster": 0, "two-pass": 0}
    assert rs.MEDIAN_LAYOUT_LAUNCHES == {"one": 0, "pairs": 0}
