"""The Fig. 6 aggregation rules of the PyTorch port against the JAX reference.

The same numpy (W, D) buffers go through each reference flat engine and its
port on the CPU, where kernels K4-K6 run as their plain PyTorch versions;
those plain versions are also held against the reference's Pallas kernels
in interpret mode and against ``ref.py``.  Tolerance 1e-6 (rtol and atol,
float32) unless a test states another with its reason.  The CUDA kernels
themselves are held against the plain versions by ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import attacks as jattacks
from repro.core import geomed as jgeomed
from repro.core import packing as jpacking
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import aggregators, attacks, geomed, packing
from repro_torch.kernels import ops, ref
from repro_torch.kernels import robust_stats as rs
from repro_torch.kernels import weiszfeld as wz
from torch_network import network_median as _network_median
from torch_network import network_sort as _network_sort

TOL = dict(rtol=1e-6, atol=1e-6)
NEW_RULES = ("median", "trimmed_mean", "krum", "geomed_groups",
             "centered_clip", "geomed_blockwise")
OPTS = dict(num_groups=3, trim=2, num_byzantine=2, clip_radius=1.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _buf(w, d=300, seed=0):
    """(W, D) messages: an honest cloud and two far-away rows."""
    rng = np.random.default_rng(seed)
    buf = 0.3 * rng.standard_normal((w, d)).astype(np.float32) + 1.0
    buf[-2:] = -3.0 + rng.standard_normal((2, d)).astype(np.float32)
    return buf


def _weights(kind, w):
    if kind == "fractional":
        return np.linspace(0.2, 1.0, w).astype(np.float32)
    if kind == "zero_row":
        rw = np.ones(w, np.float32)
        rw[1] = 0.0
        return rw
    return None


def _specs(buf, sizes, pad_to=1):
    """The reference's and the port's PackSpec of ``buf`` cut into leaves of
    ``sizes`` (named so that sorted order is the given order)."""
    tree, off = {}, 0
    for i, n in enumerate(sizes):
        tree[f"l{i}"] = buf[:, off:off + n]
        off += n
    return (jpacking.pack_spec(tree, pad_to=pad_to),
            packing.pack_spec({k: _t(v) for k, v in tree.items()},
                              pad_to=pad_to))


def _both(name, buf, rw, spec_sizes=(100, 150, 50), pad_to=1, **opts):
    """(port, reference) aggregate of ``buf`` under rule ``name``."""
    jspec, tspec = _specs(buf, spec_sizes, pad_to)
    opts = {**OPTS, **opts}
    jkw = {} if rw is None else {"row_weights": jnp.asarray(rw)}
    tkw = {} if rw is None else {"row_weights": _t(rw)}
    # Compiled once per case: cheaper than the reference's op-by-op dispatch.
    want = jax.jit(jagg.get_flat_aggregator(name, jspec, **opts))(
        jnp.asarray(buf), **jkw)
    got = aggregators.get_flat_aggregator(name, tspec, **opts)(_t(buf), **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("weights", [None, "fractional", "zero_row"])
@pytest.mark.parametrize("w", [7, 8])
@pytest.mark.parametrize("name", NEW_RULES)
def test_flat_rule_matches_reference(name, w, weights):
    buf = _buf(w, seed=w)
    rw = _weights(weights, w)
    got, want = _both(name, buf, rw)
    tol = TOL
    if name == "trimmed_mean" and rw is not None:
        # The weight-mass trim subtracts cumulative weight sums, and XLA's
        # cumsum adds in a tree order on the CPU: a last-place difference
        # in a cumulative weight moves the kept mass by that much.
        tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)
    if rw is None:   # unit weights: the two far rows are outvoted
        assert float(np.median(got)) > 0.5, "the aggregate left the honest cloud"


@pytest.mark.parametrize("weights", [None, "fractional"])
@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_order_rules_with_ties(name, weights):
    """Ties in a column: the selected values do not depend on the order in
    which the stable sort (or the kernel's rank count) meets equal values."""
    rng = np.random.default_rng(3)
    buf = np.round(2 * rng.standard_normal((8, 64))).astype(np.float32) / 2
    rw = _weights(weights, 8)
    got, want = _both(name, buf, rw, spec_sizes=(64,))
    np.testing.assert_allclose(got, want, **TOL)
    # The same rows in another order give the same answer.
    perm = rng.permutation(8)
    got_p, _ = _both(name, buf[perm], None if rw is None else rw[perm],
                     spec_sizes=(64,))
    np.testing.assert_allclose(got_p, got, **TOL)


@pytest.mark.parametrize("name,trim", [("median", 2), ("trimmed_mean", 2),
                                       ("trimmed_mean", 150),
                                       ("centered_clip", 2)])
def test_order_rules_match_reference_past_454_workers(name, trim):
    """455 workers (past the 454 whose columns fit K4/K5's shared memory),
    with ties, at narrow D: the coordinate-wise rules agree with the
    reference."""
    rng = np.random.default_rng(trim)
    buf = np.round(2 * rng.standard_normal((455, 24))).astype(np.float32) / 2
    buf[:40] += 30.0
    got, want = _both(name, buf, None, spec_sizes=(24,), trim=trim)
    np.testing.assert_allclose(got, want, **TOL)


def _blockwise_buf(w=9):
    """Four leaves whose geometric medians converge at different speeds:
    a tight cloud, two spread ones and one whose rows all agree."""
    rng = np.random.default_rng(5)
    sizes = (5, 12, 30, 7)
    cols = []
    for n, spread in zip(sizes, (0.01, 1.0, 3.0, 0.0)):
        leaf = 1.0 + spread * rng.standard_normal((w, n)).astype(np.float32)
        leaf[-2:] = -4.0 + rng.standard_normal((2, n)).astype(np.float32)
        cols.append(leaf)
    return np.concatenate(cols, axis=1), sizes


@pytest.mark.parametrize("weights", [None, "fractional", "zero_row"])
def test_geomed_blockwise_stops_each_block_like_the_reference(weights):
    buf, sizes = _blockwise_buf()
    rw = _weights(weights, buf.shape[0])
    jspec, tspec = _specs(buf, sizes, pad_to=8)
    assert tspec.pad > 0 and tspec.boundaries == jspec.boundaries
    padded = np.concatenate(
        [buf, np.zeros((buf.shape[0], tspec.pad), np.float32)], axis=1)
    got, infos = geomed.weiszfeld_blockwise_flat(
        _t(padded), tspec.boundaries, row_weights=None if rw is None else _t(rw),
        return_info=True)
    want = jagg.geomed_blockwise_flat(
        jnp.asarray(padded), spec=jspec,
        row_weights=None if rw is None else jnp.asarray(rw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[tspec.dim:].any(), "padding must aggregate to 0"
    # Each block runs exactly the iterations of its own loop in the reference.
    ref_iters = []
    for (a, b), info in zip(tspec.boundaries, infos):
        _, j_info = jgeomed.weiszfeld_flat(
            jnp.asarray(padded[:, a:b]),
            row_weights=None if rw is None else jnp.asarray(rw),
            return_info=True)
        ref_iters.append(int(j_info.iters))
        assert info.converged == bool(j_info.converged)
    assert [i.iters for i in infos] == ref_iters
    assert len(set(ref_iters)) >= 3, f"blocks should stop apart: {ref_iters}"


def test_geomed_blockwise_iteration_cap():
    """max_iters caps every block, as it caps each per-leaf loop."""
    buf, sizes = _blockwise_buf()
    jspec, tspec = _specs(buf, sizes)
    got, infos = geomed.weiszfeld_blockwise_flat(_t(buf), tspec.boundaries,
                                                 max_iters=3, tol=0.0,
                                                 return_info=True)
    assert [i.iters for i in infos] == [3] * 4
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jagg.geomed_blockwise_flat(
            jnp.asarray(buf), spec=jspec, max_iters=3, tol=0.0)), **TOL)
    y0, infos0 = geomed.weiszfeld_blockwise_flat(_t(buf), tspec.boundaries,
                                                 max_iters=0, return_info=True)
    assert [i.iters for i in infos0] == [0] * 4
    np.testing.assert_allclose(y0.numpy(), buf.mean(axis=0), **TOL)


def test_segment_ids_mark_padding_outside_the_blocks():
    ids = geomed.segment_ids(((0, 3), (3, 4)), 6, torch.device("cpu"))
    assert ids.dtype == torch.int32 and ids.tolist() == [0, 0, 0, 1, 2, 2]


# -- plain K4, K5, K6 against the reference kernels ---------------------------

SHAPES = [(7, 300), (8, 300), (3, 1), (16, 512)]


def _pad(x, tile=512):
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, (-x.shape[-1]) % tile)])


@pytest.mark.parametrize("w,p", SHAPES)
def test_coordinate_median_plain_vs_reference(w, p):
    z = np.random.default_rng(w * p).standard_normal((w, p)).astype(np.float32)
    got = ops.coordinate_median(_t(z)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.coordinate_median(
        jnp.asarray(z), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.coordinate_median(z)))
    np.testing.assert_allclose(ref.coordinate_median(_t(z)).numpy(), got, **TOL)


@pytest.mark.parametrize("w", [1, 2, 3, 7, 8, 69, 70, 71, 127, 128])
def test_median_network_gives_the_plain_bits(w):
    """K4's network route (W <= 128 on the card) emulated on the CPU: the
    plain version's bits at odd and even W, with ties, +-inf, and NaN that
    sorts last (a column of mostly NaN gives NaN); fewer min/max a
    coordinate than the rank count's W^2 comparisons."""
    rng = np.random.default_rng(w)
    z = rng.standard_normal((w, 96)).astype(np.float32)
    z[:, 32:64] = np.round(2 * z[:, 32:64]) / 2          # ties
    z[: w // 3, 64:70] = np.inf
    z[w // 3: w // 2 + 1, 66:72] = -np.inf
    z[: (w + 1) // 2, 72:76] = np.nan                  # the median's rank is NaN
    z[:1, 76:80] = np.nan
    got = _network_median(_t(z))
    torch.testing.assert_close(got, rs.coordinate_median_plain(_t(z)),
                               rtol=0, atol=0, equal_nan=True)
    assert rs.median_network_ops(w) < max(w * w, 64)
    if w == 70:
        assert rs.median_network_ops(w) == 1163


def _trimmed_columns(w: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(w, D) columns for K5's network test and each column's count of rows
    at +-1e6 (0 for the others): random values, ties, +-inf in random
    counts, one column for each NaN count 1..w, and k = 1, 2, 3 rows at
    +1e6 and k at -1e6."""
    z = rng.standard_normal((w, 64 + w + 24)).astype(np.float32)
    huge = np.zeros(z.shape[1], np.int64)
    z[:, 32:48] = np.round(2 * z[:, 32:48]) / 2
    for c in range(48, 64):
        rows = rng.permutation(w)
        pos, neg = rng.integers(0, w + 1, 2)
        z[rows[:pos], c] = np.inf
        z[rows[pos:pos + neg], c] = -np.inf
    for c in range(1, w + 1):
        z[rng.permutation(w)[:c], 63 + c] = np.nan
    for i in range(24):
        k = 1 + i // 8
        if 2 * k <= w:
            rows = rng.permutation(w)
            c = 64 + w + i
            z[rows[:k], c] = 1e6 * (1 + rng.random(k))
            z[rows[k:2 * k], c] = -1e6 * (1 + rng.random(k))
            huge[c] = k
    return z, huge


@pytest.mark.parametrize("n", range(rs.NETWORK_STEP, rs.NETWORK_CAP + 1,
                                    rs.NETWORK_STEP))
def test_trimmed_network_matches_the_plain_mean(n):
    """K5's network route (W <= 128 on the card) emulated on the CPU for
    the eight W of the network of ``n`` wires and every trim with
    2 trim < W: the kept ranks [trim, W - trim) of the sorted wires summed
    in ascending rank order in float32 (one predicated add per wire, as
    the kernel adds) and divided by W - 2 trim, NaN where #NaN > trim.
    Held against ``trimmed_mean_plain`` at rtol 1e-5 (|got - want| <=
    1e-5 (|want| + max|want|): the sums run in other orders), with NaN and
    +-inf exactly where the plain version has them; rows of +-1e6 leave no
    trace once every one is dropped (trim >= their count)."""
    rng = np.random.default_rng(n)
    ws = range(n - rs.NETWORK_STEP + 1, n + 1)
    cols = [_trimmed_columns(w, rng) for w in ws]
    # One network run for the bucket: every W's columns side by side.
    wide = torch.cat([torch.nn.functional.pad(_t(z), (0, 0, 0, n - w),
                                              value=np.inf)
                      for w, (z, _) in zip(ws, cols)], dim=1)
    n_, pairs = rs.median_network_pairs(n)
    assert n_ == n
    v = _network_sort(wide, n, pairs)
    assert rs.trimmed_network_ops(n) == 2 * len(pairs)
    start = 0
    for w, (z, huge) in zip(ws, cols):
        d = z.shape[1]
        wires = [x[start:start + d] for x in v]
        start += d
        trims = torch.arange((w + 1) // 2)[:, None]
        acc = torch.zeros((len(trims), d))
        for r in range(n):
            keep = (r >= trims) & (r < w - trims)
            acc = torch.where(keep, acc + wires[r], acc)
        nan = torch.isnan(_t(z)).sum(0)
        got = torch.where(nan > trims, torch.nan, acc / (w - 2 * trims))
        for t in range(len(trims)):
            want = rs.trimmed_mean_plain(_t(z), t)
            ok = torch.from_numpy(huge <= t)        # the +-1e6 rows all dropped
            g, x = got[t][ok], want[ok]
            assert torch.equal(torch.isnan(g), torch.isnan(x)), (w, t)
            inf = torch.isinf(x)
            assert torch.equal(g[inf], x[inf]), (w, t)
            fin = torch.isfinite(x)
            scale = float(x[fin].abs().max())
            assert bool(((g[fin] - x[fin]).abs()
                         <= 1e-5 * (x[fin].abs() + scale)).all()), (w, t)
            assert bool(torch.isfinite(got[t][torch.from_numpy(huge > 0) & ok]).all())


@pytest.mark.parametrize("w,p", SHAPES)
def test_trimmed_mean_plain_vs_reference(w, p):
    z = np.random.default_rng(w + p).standard_normal((w, p)).astype(np.float32)
    trim = (w - 1) // 2
    got = ops.trimmed_mean(_t(z), trim=trim).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.trimmed_mean(
        jnp.asarray(z), trim=trim, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.trimmed_mean(z, trim)), **TOL)
    np.testing.assert_allclose(ref.trimmed_mean(_t(z), trim).numpy(), got, **TOL)


@pytest.mark.parametrize("w,p", SHAPES)
def test_partial_sqdist_segments_plain_vs_reference(w, p):
    rng = np.random.default_rng(w * 31 + p)
    z = rng.standard_normal((w, p)).astype(np.float32)
    y = z.mean(axis=0) + 0.1 * rng.standard_normal(p).astype(np.float32)
    # Three blocks, and ids 3 and -1 that belong to no block.
    seg = rng.integers(-1, 4, p).astype(np.int32)
    got = ops.partial_sqdist_segments(_t(z), _t(y), _t(seg), num_segments=3)
    assert got.shape == (w, 3)
    want = np.asarray(jops.partial_sqdist_segments(
        jnp.asarray(z), jnp.asarray(y), jnp.asarray(seg), num_segments=3,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.partial_sqdist_segments(z, y, seg, 3)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        ref.partial_sqdist_segments(_t(z), _t(y), _t(seg), 3).numpy(),
        got.numpy(), rtol=1e-6, atol=1e-5)
    # The blocks and the coordinates in none of them split the full distance.
    full = ops.partial_sqdist(_t(z), _t(y)).numpy()
    outside = ((z - y) ** 2)[:, (seg < 0) | (seg >= 3)].sum(axis=1)
    np.testing.assert_allclose(got.numpy().sum(axis=1) + outside, full,
                               rtol=1e-5, atol=1e-5)


def test_weighted_sum_reads_a_column_slice_in_place():
    z = np.random.default_rng(2).standard_normal((7, 40)).astype(np.float32)
    a = np.linspace(0.5, 2.0, 7).astype(np.float32)
    zs = _t(z)[:, 10:25]
    assert not zs.is_contiguous() and wz.row_stride(zs) == 40
    np.testing.assert_allclose(ops.weighted_sum(zs, _t(a)).numpy(),
                               a @ z[:, 10:25], **TOL)
    with pytest.raises(ValueError, match="row-major"):
        wz.row_stride(_t(z).T)


def test_new_kernel_wrappers_refuse_cpu_and_bad_inputs():
    z = _t(_buf(5, 16))
    with pytest.raises(ValueError, match="CUDA"):
        rs.coordinate_median_call(z)
    with pytest.raises(ValueError, match="CUDA"):
        rs.trimmed_mean_call(z, 1)
    with pytest.raises(ValueError, match="CUDA"):
        wz.partial_sqdist_segments_call(z, z[0], torch.zeros(16, dtype=torch.int32), 2)
    with pytest.raises(TypeError, match="float32"):
        ops.coordinate_median(z.double())
    with pytest.raises(TypeError, match="int32"):
        ops.partial_sqdist_segments(z, z[0], torch.zeros(16, dtype=torch.int64),
                                    num_segments=2)


def test_over_trim_raises():
    buf = _t(_buf(6, 10))
    for trim in (3, 4):
        with pytest.raises(ValueError, match="too large"):
            aggregators.trimmed_mean_flat(buf, trim=trim)
        with pytest.raises(ValueError, match="too large"):
            ops.trimmed_mean(buf, trim=trim)
        with pytest.raises(ValueError, match="too large"):
            aggregators.get_flat_aggregator("trimmed_mean", None, trim=trim)(
                buf, row_weights=torch.ones(6))
    aggregators.trimmed_mean_flat(buf, trim=2)


# -- attacks and the registry ---------------------------------------------------

@pytest.mark.parametrize("name", ["alie", "ipm"])
def test_alie_and_ipm_match_reference(name):
    honest = _buf(6, 12, seed=7)[:4]
    cfg = dict(name=name, num_byzantine=3, alie_z=1.5, ipm_eps=0.7)
    want = jattacks.apply_attack(jattacks.AttackConfig(**cfg),
                                 jnp.asarray(honest), None)
    got = attacks.apply_attack(attacks.AttackConfig(**cfg), _t(honest))
    assert got.shape == (7, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_every_reference_rule_is_ported():
    assert aggregators.UNPORTED == ()
    assert set(aggregators.AGGREGATOR_NAMES) == set(jagg._FLAT_REGISTRY)
    for name in ("alie", "ipm"):
        assert name in attacks.ATTACK_NAMES and name not in attacks.UNPORTED
    with pytest.raises(ValueError, match="PackSpec"):
        aggregators.get_flat_aggregator("geomed_blockwise", None)
