"""K7 "select" and its pairs layout (``csrc/topology.cu``), on the CPU.

The layout orders two bfloat16 coordinates at once by 16-bit keys, two in a
32-bit word, with packed signed 16-bit min/max.  Its claim is that it keeps
and drops exactly the values the float32 kernel keeps and drops on the
upcast exchange, so it gives that kernel's bits.  Here the key arithmetic,
written as the kernel writes it (``pair_keys`` and ``add_pair``), is checked
against ``order_key`` of the upcast on every one of the 65,536 bfloat16 bit
patterns, in both halves of a word; and the route itself -- the first
2 * trim members sorted on a bitonic network whose pad slots are tracked at
compile time, then the insert into both arrays and the median of three --
is emulated in numpy with each key width and held bitwise against the
other, and at rtol 1e-5 against the plain version, with ties, +-0, +-inf, a
NaN member and a huge row.  The card's tests (``tests/test_torch_gpu.py``)
hold the kernels themselves.  :func:`topology.select_minmax_ops`, which
the instruction floor of ``chip_smoke.py`` counts with, is checked against
the emulation's own count.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import topology as tp

INT_MAX = np.iinfo(np.int32).max


def _key32(bits16: np.ndarray) -> np.ndarray:
    """order_key of the upcast float32 values of raw bfloat16 bits."""
    b = (bits16.astype(np.uint32) << 16).view(np.int32)
    k = np.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return np.where(np.isnan(b.view(np.float32)), INT_MAX, k)


def _pair_keys(w: np.ndarray) -> np.ndarray:
    """pair_keys on 32-bit words of two raw bfloat16 values."""
    w = w.astype(np.uint32)
    nan = (((w & 0x7FFF7FFF) + 0x007F007F) >> 15) & 0x00010001
    w = (w & ~(nan * 0xFFFF)) | (nan * 0x7FFF)
    return w ^ (((w >> 15) & 0x00010001) * 0x7FFF)


def _pair_values(k: np.ndarray) -> np.ndarray:
    """add_pair's raw bits of both halves of a key word."""
    return k ^ (((k >> 15) & 0x00010001) * 0x7FFF)


def _halves(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The low and high 16 bits of words, as signed keys."""
    return ((w & 0xFFFF).astype(np.uint16).view(np.int16),
            (w >> 16).astype(np.uint16).view(np.int16))


ALL = np.arange(1 << 16, dtype=np.uint32)
OTHER = np.random.default_rng(0).permutation(ALL)


@pytest.mark.parametrize("half", ["low", "high"])
def test_pair_keys_order_like_the_float32_keys(half):
    """Every bit pattern in either half: the 16-bit key orders as order_key
    of the upcast (ties and -0 < +0 included), every NaN maps to 0x7fff above
    +inf, and no key reaches the bottom pad."""
    words = ALL | (OTHER << 16) if half == "low" else OTHER | (ALL << 16)
    k16 = _halves(_pair_keys(words))[0 if half == "low" else 1].astype(np.int64)
    k32 = _key32(ALL).astype(np.int64)
    by32 = np.argsort(k32, kind="stable")
    assert bool(np.all(np.diff(k16[by32]) >= 0))
    pairs = np.unique(np.stack([k32, k16]), axis=1)
    assert pairs.shape[1] == len(np.unique(k32)) == len(np.unique(k16))
    nan = np.isnan((ALL << 16).view(np.float32))
    assert int(nan.sum()) == 254 and bool(np.all(k16[nan] == 0x7FFF))
    assert int(k16[~nan].max()) == 0x7F80 and int(k16.min()) > -(1 << 15)
    assert k16[0] == 0 and k16[0x8000] == -1          # +0 above -0


def test_pair_values_give_back_each_half():
    """The kept key's value bits: the raw bits for every non-NaN half, and a
    NaN for a NaN half; the other half of the word never moves."""
    words = ALL | (OTHER << 16)
    v = _pair_values(_pair_keys(words))
    for got, raw in zip(_halves(v), _halves(words)):
        got, raw = got.view(np.uint16), raw.view(np.uint16)
        nan = np.isnan((raw.astype(np.uint32) << 16).view(np.float32))
        assert bool(np.all(got[~nan] == raw[~nan]))
        assert bool(np.all(got[nan] == 0x7FFF))


def _network(n: int, live: int):
    """The kernel's bitonic network on n slots, slots from live on pads:
    ("cx", i, l, up) for a compare-exchange of two keys, ("move", from, to)
    where a key meets a pad."""
    pad = [i >= live for i in range(n)]
    k = 2
    while k <= n:
        j = k >> 1
        while j:
            for i in range(n):
                l = i ^ j
                if l > i and not (pad[i] and pad[l]):
                    up = (i & k) == 0
                    if pad[i] or pad[l]:
                        yield "move", (l if pad[i] else i), (i if up else l)
                        pad[i], pad[l] = not up, up
                    else:
                        yield "cx", i, l, up
            j >>= 1
        k <<= 1


def _select(keys: np.ndarray, values: np.ndarray, trim: int) -> tuple[np.ndarray, int]:
    """The select route on (m, ...) member keys in member order: the kept
    values summed in float32 in the kernel's order, and the min/max run."""
    m, t = keys.shape[0], trim
    acc = np.zeros(keys.shape[1:], np.float32)
    vals = {int(k): v for k, v in zip(keys.reshape(-1).tolist(), values.reshape(-1).tolist())}
    ops_run = 0
    lo_pad, hi_pad = np.iinfo(keys.dtype).min, np.iinfo(keys.dtype).max
    top = np.full((t,) + keys.shape[1:], lo_pad, keys.dtype)
    bot = np.full((t,) + keys.shape[1:], hi_pad, keys.dtype)
    j = 0
    if m >= 2 * t:
        n = tp._pow2_at_least(2 * t)
        a = [keys[i] if i < 2 * t else None for i in range(n)]
        for ev in _network(n, 2 * t):
            if ev[0] == "move":
                v, a[ev[1]] = a[ev[1]], None
                a[ev[2]] = v
            else:
                _, i, l, up = ev
                lo, hi = np.minimum(a[i], a[l]), np.maximum(a[i], a[l])
                a[i], a[l] = (lo, hi) if up else (hi, lo)
                ops_run += 2
        for i in range(t):
            bot[i], top[i] = a[i], a[2 * t - 1 - i]
        j = 2 * t
    for seen in range(j, m):
        k = keys[seen]
        if seen >= 2 * t:
            out = np.maximum(bot[t - 1], np.minimum(k, top[t - 1]))
            acc += np.vectorize(vals.__getitem__, otypes=[np.float32])(out)
            ops_run += 2
        top[1:], bot[1:] = (np.maximum(top[1:], np.minimum(top[:-1], k)),
                            np.minimum(bot[1:], np.maximum(bot[:-1], k)))
        top[0], bot[0] = np.maximum(top[0], k), np.minimum(bot[0], k)
        ops_run += 4 * t - 2
    return acc, ops_run


def _bf16_exchange(m: int, d: int, seed: int) -> np.ndarray:
    """(m, d) raw bfloat16 bits with ties, +-0, +-inf, a NaN and a huge row."""
    x = np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)
    x[1] = x[0]
    x[2, :4] = 0.0
    x[3, :4] = -0.0
    x[4, 4:6] = np.inf
    x[4, 6:8] = -np.inf
    x[5, 8:10] = np.nan
    x[6, 10:] = 1e30
    return (torch.from_numpy(x).bfloat16().view(torch.int16).numpy()
            .view(np.uint16).astype(np.uint32))


@pytest.mark.parametrize("trim", [1, 2, 3, 5, 12, 16])
@pytest.mark.parametrize("m", [0, 1, 24, 33, 45])
def test_select_pairs_emulation_equals_float32_keys_and_plain(trim, m):
    """The route on 16-bit key words (two coordinates a word) and on 32-bit
    keys keeps the same values in the same order: the same float32 bits; and
    the plain version's result at rtol 1e-5 (exactly 0 with m <= 2 * trim);
    select_minmax_ops counts the min/max the emulation ran, a word."""
    d = 16
    bits = _bf16_exchange(max(m, 8), d, seed=trim * 100 + m)[:m]
    upcast = (bits << 16).view(np.float32)
    k32 = _key32(bits)
    got32, ops32 = _select(k32, upcast, trim)
    words = bits[:, 0::2] | (bits[:, 1::2] << 16)
    k16 = np.stack(_halves(_pair_keys(words)), -1)      # (m, d / 2, 2)
    v16 = np.stack(_halves(_pair_values(_pair_keys(words))), -1).view(np.uint16)
    got16, ops16 = _select(k16, (v16.astype(np.uint32) << 16).view(np.float32), trim)
    got16 = got16.reshape(d)
    assert np.array_equal(got16.view(np.int32), got32.view(np.int32))
    assert ops16 == ops32 and (m == 0 or ops32 == tp.select_minmax_ops(m, trim))
    want = tp.masked_neighbor_reduce_plain(torch.from_numpy(upcast.copy())[None],
                                           torch.ones((1, m)), trim)[0].numpy()
    res = got32 / np.float32(max(m - 2 * trim, 1))
    if m <= 2 * trim:
        assert not res.any() and not want.any()
    assert bool(np.isfinite(res).all())
    np.testing.assert_allclose(res, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_select_minmax_ops_counts_the_whole_network_without_pads():
    """With 2 * trim a power of two no slot is a pad: the full bitonic
    network, two min/max a compare-exchange; fewer members than 2 * trim
    run the inserts alone."""
    for t in (1, 2, 4, 8, 16):
        n = 2 * t
        stages = n.bit_length() - 1
        assert tp.select_minmax_ops(n, t) == 2 * (n // 2) * stages * (stages + 1) // 2
        assert tp.select_minmax_ops(n + 3, t) == tp.select_minmax_ops(n, t) + 3 * 4 * t
    assert tp.select_minmax_ops(23, 12) == 23 * 46
    assert tp.select_minmax_ops(36, 12) == 336 + 12 * 48
    with pytest.raises(ValueError, match="1 <= trim <= 16"):
        tp.select_minmax_ops(36, 17)


def test_select_layout_counts_reset_and_stay_zero_on_the_cpu():
    """The plain version on the CPU launches nothing, so no layout counts;
    reset_launch_counts zeroes them with the rest."""
    tp.SELECT_LAYOUT_LAUNCHES["pairs"] = 4
    ops.reset_launch_counts()
    ex = torch.randn(2, 9, 6).bfloat16()
    for trim in (1, 3):
        ops.masked_neighbor_reduce(ex, torch.ones(2, 9), trim=trim)
    assert tp.SELECT_LAYOUT_LAUNCHES == {"one": 0, "pairs": 0}
