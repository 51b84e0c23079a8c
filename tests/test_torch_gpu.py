"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and decides in its body whether
a CUDA device is present, skipping without one.  This file imports torch
and the port only (no JAX), so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: K1 is elementwise in the plain version's order, so it agrees
to within 1 ulp and its table bitwise; K2, K3, K5 and K6 sum in another
order than PyTorch, so they agree to rtol 1e-5 (atol 1e-5 x max|plain|);
K5 on its network route (W <= 128) also gives NaN exactly where the plain
version does and the same bits on every launch;
K4 selects, so it is bitwise: at every W on its network route (W <= 128,
NaN sorted last as the plain version sorts it), and for odd W (within 1
ulp for even W) on the rank count past it.  K6 adds in another order than
its plain version (rtol 1e-5) but in one fixed order: the same bits on
every launch.
K8 (flash attention) computes in float32 in another order than its plain
version: rtol/atol 2e-5 in float32 and 2e-2 in bfloat16, the tolerances of
``tests/test_kernels.py``.  Its wgmma route (bfloat16, hd 64 and 128) also
rounds p to bfloat16 for p . v, which moves the output by at most 2^-8
max|v|, far less in practice since the rounding errors take both signs
(``tests/test_torch_models.py`` measures it on the CPU): it is held at the
same 2e-2.
K3, the masked route of K2 and K7 read only the rows of nonzero weight or
of mask > 0, and their plain versions leave those rows out too (a row of
weight 0 holding inf or NaN contributes nothing), so they are held at
rtol 1e-5 like the others, non-finite inputs included.  Every kernel takes any size that fits in
memory: K4/K5 past 454 workers, K7 past 450 senders, K2/K3 past 12,288
rows and every kernel past 65,535 rows or receivers on a grid dimension are
held against the plain versions too.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.data import ijcnn1_like, logreg_loss, partition
from repro_torch.kernels import ops
from repro_torch.kernels import robust_stats as rs
from repro_torch.kernels import saga_correct as sc
from repro_torch.kernels import topology as tp
from repro_torch.kernels import weiszfeld as wz
from repro_torch.optim import get_optimizer

SHAPES = [(7, 300), (3, 1), (16, 512), (70, 39_760)]
ORDER_SHAPES = [(w, p) for w in (7, 8, 70) for p in (300, 39_760)]
J = 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 ulps between two tensors."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _close(got, want, rtol=1e-5):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))


def _inputs(w, p, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((w, p), generator=g, device="cuda")
    y = z.mean(0) + 0.1 * torch.randn((p,), generator=g, device="cuda")
    a = torch.rand((w,), generator=g, device="cuda") + 0.5
    grad = torch.randn((w, p), generator=g, device="cuda")
    table = torch.randn((w, J, p), generator=g, device="cuda")
    idx = torch.randint(0, J, (w,), generator=g, device="cuda")
    return z, y, a, grad, table, table.mean(1), idx


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", SHAPES)
def test_weiszfeld_kernels_vs_plain(w, p):
    _need_card()
    z, y, a, *_ = _inputs(w, p)
    _close(wz.partial_sqdist_call(z, y), wz.partial_sqdist_plain(z, y))
    _close(wz.weighted_sum_call(z, a), wz.weighted_sum_plain(z, a))
    # Two passes, fixed reduction order, no atomics: the same bits each run.
    assert torch.equal(wz.partial_sqdist_call(z, y), wz.partial_sqdist_call(z, y))


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", SHAPES)
def test_saga_kernel_vs_plain(w, p):
    _need_card()
    *_, grad, table, avg, idx = _inputs(w, p)
    tab_k, avg_k = table.clone(), avg.clone()
    msg_k = sc.saga_correct_call(grad, tab_k, avg_k, idx)
    msg_p = sc.saga_correct_plain(grad, table, avg, idx)
    torch.cuda.synchronize()
    assert _ulps(msg_k, msg_p) <= 1 and _ulps(avg_k, avg) <= 1
    assert torch.equal(tab_k, table)


@pytest.mark.gpu
def test_saga_kernel_out_of_range_index_poisons_only_the_message():
    _need_card()
    *_, grad, table, avg, idx = _inputs(4, 64)
    idx[1] = J
    tab0, avg0 = table.clone(), avg.clone()
    msg = sc.saga_correct_call(grad, table, avg, idx)
    torch.cuda.synchronize()
    assert bool(torch.isnan(msg[1]).all()) and bool(torch.isfinite(msg[0]).all())
    assert torch.equal(table[1], tab0[1]) and torch.equal(avg[1], avg0[1])


def _client_inputs(c, j, p, w, seed=0):
    """A (c, j, p) resident table, its (c, p) avg, (w, p) gradients, (w,)
    distinct client rows from a permutation and (w,) drawn samples."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn((c, j, p), generator=g, device="cuda")
    grad = torch.randn((w, p), generator=g, device="cuda")
    rows = torch.randperm(c, generator=g, device="cuda")[:w]
    idx = torch.randint(0, j, (w,), generator=g, device="cuda")
    return grad, table, table.mean(1), idx, rows


@pytest.mark.gpu
@pytest.mark.parametrize("c,j,p,w", [(13, 3, 300, 7), (9, 5, 1, 9),
                                     (40, 4, 39_760, 11)])
def test_saga_kernel_client_rows_vs_plain(c, j, p, w):
    """K1's client-row route: bitwise the plain version, and only the
    drawn (row, idx) entries and avg rows change."""
    _need_card()
    grad, table, avg, idx, rows = _client_inputs(c, j, p, w)
    tab_k, avg_k = table.clone(), avg.clone()
    tab_p, avg_p = table.clone(), avg.clone()
    ops.reset_launch_counts()
    msg_k = ops.saga_correct(grad, tab_k, avg_k, idx, rows)
    msg_p = sc.saga_correct_plain(grad, tab_p, avg_p, idx, rows)
    torch.cuda.synchronize()
    assert sc.ROUTE_LAUNCHES == {"workers": 0, "clients": 1}
    assert torch.equal(msg_k, msg_p) and torch.equal(avg_k, avg_p)
    assert torch.equal(tab_k, tab_p)
    touched = torch.zeros((c, j), dtype=torch.bool, device="cuda")
    touched[rows, idx] = True
    assert torch.equal(tab_k[~touched], table[~touched])
    others = torch.ones(c, dtype=torch.bool, device="cuda")
    others[rows] = False
    assert torch.equal(avg_k[others], avg[others])


@pytest.mark.gpu
def test_saga_kernel_out_of_range_client_row_poisons_only_the_message():
    _need_card()
    grad, table, avg, idx, rows = _client_inputs(6, 3, 64, 3)
    rows[1] = 6
    tab0, avg0 = table.clone(), avg.clone()
    msg = sc.saga_correct_call(grad, table, avg, idx, rows)
    torch.cuda.synchronize()
    assert bool(torch.isnan(msg[1]).all()) and bool(torch.isfinite(msg[0]).all())
    keep = torch.ones(6, dtype=torch.bool, device="cuda")
    keep[rows[[0, 2]]] = False
    assert torch.equal(table[keep], tab0[keep]) and torch.equal(avg[keep], avg0[keep])


@pytest.mark.gpu
def test_saga_kernel_without_rows_is_the_worker_route():
    """rows=None: the worker route, the same bits as rows = 0..W-1."""
    _need_card()
    *_, grad, table, avg, idx = _inputs(7, 300)
    tab_a, avg_a, tab_b, avg_b = table.clone(), avg.clone(), table.clone(), avg.clone()
    ops.reset_launch_counts()
    msg_a = sc.saga_correct_call(grad, tab_a, avg_a, idx)
    msg_b = sc.saga_correct_call(grad, tab_b, avg_b, idx,
                                 torch.arange(7, device="cuda"))
    torch.cuda.synchronize()
    assert sc.ROUTE_LAUNCHES == {"workers": 1, "clients": 1}
    assert torch.equal(msg_a, msg_b) and torch.equal(tab_a, tab_b)
    assert torch.equal(avg_a, avg_b)


@pytest.mark.gpu
def test_cuda_dispatch_counts_launches():
    _need_card()
    z, y, a, grad, table, avg, idx = _inputs(7, 300)
    ops.reset_launch_counts()
    ops.partial_sqdist(z, y)
    ops.weighted_sum(z, a)
    ops.saga_correct(grad, table, avg, idx)
    ops.coordinate_median(z)
    ops.trimmed_mean(z, trim=2)
    ops.partial_sqdist_segments(z, y, torch.zeros(300, dtype=torch.int32,
                                                  device="cuda"), num_segments=2)
    ops.masked_neighbor_reduce(z[None], torch.ones(1, 7, device="cuda"), trim=1)
    qkv = torch.zeros((1, 4, 2, 16), device="cuda")
    ops.flash_attention(qkv, qkv, qkv)
    assert ops.launch_counts() == {
        "saga_correct": 1, "partial_sqdist": 1, "weighted_sum": 1,
        "coordinate_median": 1, "trimmed_mean": 1, "partial_sqdist_segments": 1,
        "masked_neighbor_reduce": 1, "flash_attention": 1}


@pytest.mark.gpu
def test_cuda_step_matches_cpu_plain_path():
    """Ten steps on the card track the plain CPU path from the same data,
    state and sample draws (the Weiszfeld stop may end one iteration
    apart, hence rtol 1e-4)."""
    _need_card()
    data = ijcnn1_like(0, n=240, device="cpu")
    wd = partition({"a": data.x, "b": data.y}, 12, seed=1, device="cpu")
    cfg = RobustConfig(aggregator="geomed", vr="saga", attack="sign_flip",
                       num_byzantine=5)
    draws = np.random.default_rng(0).integers(0, 20, (10, 12))
    out = {}
    for dev in ("cuda", "cpu"):
        init_fn, step_fn = make_federated_step(
            logreg_loss(0.01), wd, cfg, get_optimizer("sgd", 0.02), device=dev)
        st = init_fn({"w": torch.zeros(22)}, 0)
        for idx in draws:
            st, _ = step_fn(st, sample_idx=idx)
        out[dev] = st.params["w"].cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("w,p", ORDER_SHAPES)
def test_order_stat_kernels_vs_plain(w, p, ties):
    _need_card()
    z, *_ = _inputs(w, p, seed=w + p)
    if ties:   # many equal values in every column
        z = torch.round(2 * z) / 2
    med = rs.coordinate_median_call(z)
    want = rs.coordinate_median_plain(z)
    if w % 2:
        assert torch.equal(med, want)
    else:
        assert _ulps(med, want) <= 1
    for trim in (0, 1, (w - 1) // 2):
        _close(rs.trimmed_mean_call(z, trim), rs.trimmed_mean_plain(z, trim))


@pytest.mark.gpu
def test_order_stat_kernels_take_their_largest_w():
    """Any W: up to 454 workers a block stages its columns in shared memory,
    past that it counts ranks from global memory; both against the plain
    versions, with ties, at odd and even W."""
    _need_card()
    for w, p in [(454, 1000), (455, 1000), (1000, 300), (5000, 130)]:
        z, *_ = _inputs(w, p, seed=w)
        for zz in (z, torch.round(2 * z) / 2):
            med = rs.coordinate_median_call(zz)
            want = rs.coordinate_median_plain(zz)
            if w % 2:
                assert torch.equal(med, want), w
            else:
                assert _ulps(med, want) <= 1, w
            for trim in (1, 100, (w - 1) // 2):
                _close(rs.trimmed_mean_call(zz, trim), rs.trimmed_mean_plain(zz, trim))
        assert torch.equal(rs.trimmed_mean_call(z, 7), rs.trimmed_mean_call(z, 7))
    with pytest.raises(ValueError, match="too large"):
        rs.trimmed_mean_call(z[:4], 2)


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", ORDER_SHAPES)
def test_segment_sqdist_kernel_vs_plain(w, p):
    """Four blocks in contiguous ranges, the last coordinates in none (ids
    4 and -1 both mean "no block"), as a packed buffer with padding gives."""
    _need_card()
    z, y, *_ = _inputs(w, p, seed=3 * w + p)
    cuts = [0, p // 7, p // 3, p // 2, p - p // 10, p]
    seg = torch.empty(p, dtype=torch.int32, device="cuda")
    for s_id, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        seg[a:b] = s_id
    seg[p - p // 20:] = -1
    got = wz.partial_sqdist_segments_call(z, y, seg, 4)
    _close(got, wz.partial_sqdist_segments_plain(z, y, seg, 4))
    # Deterministic: a fixed order, no float atomics.
    assert torch.equal(got, wz.partial_sqdist_segments_call(z, y, seg, 4))
    # Scattered ids, and a segment that holds no coordinate.
    g = torch.Generator(device="cuda").manual_seed(p)
    seg = torch.randint(-1, 6, (p,), generator=g, device="cuda").to(torch.int32)
    _close(wz.partial_sqdist_segments_call(z, y, seg, 7),
           wz.partial_sqdist_segments_plain(z, y, seg, 7))


NETWORK_WIDTHS = [1, 2, 3, 7, 8, 69, 70, 71, rs.NETWORK_CAP - 1,
                  rs.NETWORK_CAP, rs.NETWORK_CAP + 1]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("w", NETWORK_WIDTHS)
def test_median_network_route_gives_the_plain_bits(w, ties):
    """K4's network route (W <= 128) at odd and even W, its cap and one
    past it (the rank count), with and without ties, +-inf in columns and
    a ragged D: the plain version's bits (equal values; NaN equal to NaN),
    NaN sorted last on the network route, and the same bits on a second
    launch."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(w)
    d = 4_099
    z = torch.randn((w, d), generator=g, device="cuda")
    if ties:
        z = torch.round(2 * z) / 2
    z[: w // 3 + 1, 2000:2100] = float("inf")
    z[w // 3 + 1: w // 2 + 1, 2050:2150] = float("-inf")
    clean = torch.ones(d, dtype=torch.bool, device="cuda")
    if w <= rs.NETWORK_CAP:   # the rank count leaves a NaN column unspecified
        z[: (w + 1) // 2, 2200:2210] = float("nan")
        z[:1, 2210:2220] = float("nan")
        clean[2200:2220] = False
        assert bool(torch.isnan(rs.coordinate_median_plain(z)[2200:2210]).all())
    got = rs.coordinate_median_call(z)
    want = rs.coordinate_median_plain(z)
    if w % 2 or w <= rs.NETWORK_CAP:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert _ulps(got[clean], want[clean]) <= 1
    assert torch.equal(_bits(got), _bits(rs.coordinate_median_call(z)))


def _trimmed_network_inputs(w: int, trim: int, ties: bool, seed: int):
    """(w, 2,000) columns for K5's network route at ``trim``: random values
    (rounded to halves with ``ties``), +inf and -inf in random counts, ``trim``
    NaN (a finite result) and ``trim + 1`` NaN (NaN) in some columns, and
    ``trim`` rows of +1e6 and ``trim`` of -1e6 in others (all dropped)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = 2_000
    z = torch.randn((w, d), generator=g, device="cuda")
    if ties:
        z = torch.round(2 * z) / 2
    u = torch.rand((w, d), generator=g, device="cuda")
    rows = torch.argsort(torch.rand((w, d), generator=g, device="cuda"), dim=0)
    counts = torch.randint(0, w + 1, (2, d), generator=g, device="cuda")
    inf_cols = slice(100, 300)
    pos = rows < counts[0]
    neg = (rows >= counts[0]) & (rows < counts[0] + counts[1])
    z[:, inf_cols] = torch.where(pos, torch.inf, torch.where(neg, -torch.inf, z))[:, inf_cols]
    for lo, hi, k in ((300, 400, trim), (400, 500, min(trim + 1, w))):
        z[:, lo:hi] = torch.where(rows[:, lo:hi] < k, torch.nan, z[:, lo:hi])
    big = torch.where(rows < trim, 1e6 * (1 + u),
                      torch.where(rows < 2 * trim, -1e6 * (1 + u), z))
    z[:, 500:700] = big[:, 500:700]
    return z


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", range(rs.NETWORK_STEP, rs.NETWORK_CAP + 1,
                                    rs.NETWORK_STEP))
def test_trimmed_network_route_vs_plain(n, ties):
    """K5's network route at every W of the network of ``n`` wires and trim
    0, 1 and (W - 1) // 2: rtol 1e-5 against the plain version on the
    finite results (it sums in rank order), NaN exactly where the plain
    version gives NaN (#NaN > trim, or +inf and -inf both kept), the same
    +-inf, rows of +-1e6 leaving no trace once dropped, and the same bits on
    a second launch."""
    _need_card()
    for w in range(n - rs.NETWORK_STEP + 1, n + 1):
        for trim in sorted({0, 1, (w - 1) // 2}):
            if 2 * trim >= w:
                continue
            z = _trimmed_network_inputs(w, trim, ties, seed=w * 7 + trim)
            got = rs.trimmed_mean_call(z, trim)
            want = rs.trimmed_mean_plain(z, trim)
            torch.cuda.synchronize()
            assert torch.equal(torch.isnan(got), torch.isnan(want)), (w, trim)
            assert bool(torch.isnan(got[400:500]).all()), (w, trim)
            inf = torch.isinf(want)
            assert torch.equal(got[inf], want[inf]), (w, trim)
            fin = torch.isfinite(want)
            if trim:
                assert bool(fin[500:700].all()) and float(want[500:700].abs().max()) < 10
            _close(got[fin], want[fin])
            assert torch.equal(_bits(got), _bits(rs.trimmed_mean_call(z, trim)))


@pytest.mark.gpu
@pytest.mark.parametrize("w,kernel", [(1, "trimmed_network_kernel"),
                                      (70, "trimmed_network_kernel"),
                                      (rs.NETWORK_CAP, "trimmed_network_kernel"),
                                      (rs.NETWORK_CAP + 1, "order_stat_kernel"),
                                      (455, "order_stat_global_kernel")])
def test_trimmed_mean_routes_by_worker_count(w, kernel):
    """K5 runs its network kernel up to 128 workers and the rank count past
    it (from shared memory up to 454 workers, from global memory past
    that): one kernel a call, named in the profiler's device records, and
    the result within rtol 1e-5 of the plain version."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    z, *_ = _inputs(w, 3_000, seed=w)
    trim = (w - 1) // 3
    _close(rs.trimmed_mean_call(z, trim), rs.trimmed_mean_plain(z, trim))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rs.trimmed_mean_call(z, trim)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and kernel in names[0], names


def _segment_ids(case: str, d: int) -> tuple[torch.Tensor, int]:
    """(D,) int32 ids and L for K6's cases over chunks of 4,096
    coordinates."""
    idx = torch.arange(d, device="cuda")
    if case == "one segment a chunk":
        return (idx // 4096).to(torch.int32), (d + 4095) // 4096
    if case == "crossing chunks":       # cuts inside chunks, a 1-coordinate leaf
        cuts = torch.tensor([1000, 5000, 5001, 9000], device="cuda")
        return torch.bucketize(idx, cuts, right=True).to(torch.int32), 5
    if case == "scattered":
        g = torch.Generator(device="cuda").manual_seed(d)
        return torch.randint(-1, 10, (d,), generator=g, device="cuda").to(torch.int32), 9
    if case == "empty segments":        # ids 0, 1, 3: 2 and 4 hold nothing
        seg = torch.bucketize(idx, torch.tensor([3000, 7000], device="cuda"),
                              right=True).to(torch.int32)
        return torch.where(seg == 2, 3, seg).to(torch.int32), 5
    # padding: ids -1 and L past the last leaf and in a band inside it
    seg = (idx * 3 // d).to(torch.int32)
    seg[d - 300:] = -1
    seg[4000:4300] = 3
    return seg, 3


SEGMENT_CASES = ["one segment a chunk", "crossing chunks", "scattered",
                 "empty segments", "padding"]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [12_324, 12_325])   # float4 loads; scalar loads
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_sqdist_one_launch_vs_plain(case, d):
    """K6 against its plain version (rtol 1e-5) on chunks of one segment,
    chunks that cross segment boundaries, scattered ids, segments that hold
    no coordinate (exactly 0) and padding ids; the same bits on three
    back-to-back launches (the arrival counters are back at 0 after a
    launch), and one launch per call."""
    _need_card()
    from repro_torch.kernels import ops
    z, y, *_ = _inputs(7, d, seed=d)
    seg, nseg = _segment_ids(case, d)
    want = wz.partial_sqdist_segments_plain(z, y, seg, nseg)
    ops.reset_launch_counts()
    runs = [wz.partial_sqdist_segments_call(z, y, seg, nseg) for _ in range(3)]
    assert ops.launch_counts()["partial_sqdist_segments"] == 3
    _close(runs[0], want)
    for other in runs[1:]:
        assert torch.equal(_bits(other), _bits(runs[0]))
    held = torch.bincount(seg[(seg >= 0) & (seg < nseg)].long(), minlength=nseg)
    assert bool((runs[0][:, held == 0] == 0).all())


@pytest.mark.gpu
def test_segment_sqdist_is_one_kernel_launch():
    """One call of K6 runs exactly one kernel on the card (the profiler's
    device records), with no finish pass and no memset."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    z, y, *_ = _inputs(70, 39_760, seed=5)
    seg, nseg = _segment_ids("crossing chunks", 39_760)
    wz.partial_sqdist_segments_call(z, y, seg, nseg)   # makes the counters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wz.partial_sqdist_segments_call(z, y, seg, nseg)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "sqdist_segments_kernel" in names[0], names


@pytest.mark.gpu
def test_segment_sqdist_calls_of_other_widths_share_one_stream():
    """Calls of different W queued back to back on one stream (the
    counters of the wider call serve the narrower, and grow for a wider
    one), and W past 65,535 rows of one grid dimension."""
    _need_card()
    d = 9_000
    seg, nseg = _segment_ids("crossing chunks", d)
    calls = []
    for w in (70, 7, 2_000, 70):
        z, y, *_ = _inputs(w, d, seed=w)
        calls.append((z, y, wz.partial_sqdist_segments_call(z, y, seg, nseg)))
    for z, y, got in calls:
        _close(got, wz.partial_sqdist_segments_plain(z, y, seg, nseg))
    assert torch.equal(_bits(calls[0][2]), _bits(calls[3][2]))
    g = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn((65_537, 300), generator=g, device="cuda")
    y = z[:5].mean(0)
    seg = (torch.arange(300, device="cuda") % 4).to(torch.int32)
    _close(wz.partial_sqdist_segments_call(z, y, seg, 4),
           wz.partial_sqdist_segments_plain(z, y, seg, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", [(7, 300), (70, 39_760)])
def test_weighted_sum_kernel_reads_a_column_slice(w, p):
    _need_card()
    z, _, a, *_ = _inputs(w, p)
    lo, hi = p // 5, p - p // 3
    zs = z[:, lo:hi]
    assert not zs.is_contiguous()
    got = wz.weighted_sum_call(zs, a)
    _close(got, wz.weighted_sum_plain(zs.contiguous(), a))
    assert torch.equal(got, wz.weighted_sum_call(zs.contiguous(), a))


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["median", "trimmed_mean", "krum",
                                 "geomed_groups", "centered_clip",
                                 "geomed_blockwise"])
def test_cuda_step_matches_cpu_for_every_rule(agg):
    """Five steps of each Fig. 6 rule on the card track the plain CPU path
    (alie, the attack written against coordinate-wise rules)."""
    _need_card()
    data = ijcnn1_like(0, n=240, device="cpu")
    wd = partition({"a": data.x, "b": data.y}, 12, seed=1, device="cpu")
    cfg = RobustConfig(aggregator=agg, vr="saga", attack="alie",
                       num_byzantine=5, trim=5)
    draws = np.random.default_rng(1).integers(0, 20, (5, 12))
    out = {}
    for dev in ("cuda", "cpu"):
        init_fn, step_fn = make_federated_step(
            logreg_loss(0.01), wd, cfg, get_optimizer("sgd", 0.02), device=dev)
        st = init_fn({"w": torch.zeros(22)}, 0)
        for idx in draws:
            st, _ = step_fn(st, sample_idx=idx)
        out[dev] = st.params["w"].cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-5)


# -- the decentralized slice: K7 and the receiver-batched K2/K3 ---------------------

MASKED_SHAPES = [(7, 7, 300), (5, 9, 129), (3, 4, 1), (70, 70, 39_760)]


def _masked_inputs(r, s, d, ties, seed=0):
    """An (R, S, D) exchange and an (R, S) 0/1 mask with every receiver
    keeping at least 2 * 3 + 1 senders where S allows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ex = torch.randn((r, s, d), generator=g, device="cuda")
    if ties:
        ex = torch.round(ex * 2.0) / 2.0
    mask = (torch.rand((r, s), generator=g, device="cuda") < 0.7).float()
    mask[:, : min(s, 7)] = 1.0
    return ex, mask


@pytest.mark.gpu
@pytest.mark.parametrize("trim", [0, 1, 2, 3])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("r,s,d", MASKED_SHAPES)
def test_masked_neighbor_reduce_kernel_vs_plain(r, s, d, ties, trim):
    """K7 against its plain version at ragged R, S, D, with and without
    ties, at rtol 1e-5 (it sums the survivors in sender order)."""
    _need_card()
    from repro_torch.kernels import topology as tp
    ex, mask = _masked_inputs(r, s, d, ties)
    _close(tp.masked_neighbor_reduce_call(ex, mask, trim),
           tp.masked_neighbor_reduce_plain(ex, mask, trim))


@pytest.mark.gpu
def test_masked_neighbor_reduce_kernel_reads_slices_and_broadcasts():
    _need_card()
    from repro_torch.kernels import topology as tp
    ex, mask = _masked_inputs(6, 9, 300, True)
    cols = ex[:, :, 40:250]
    _close(tp.masked_neighbor_reduce_call(cols, mask, 2),
           tp.masked_neighbor_reduce_plain(cols.contiguous(), mask, 2))
    shared = ex[0][None].expand(6, 9, 300)
    _close(tp.masked_neighbor_reduce_call(shared, mask, 1),
           tp.masked_neighbor_reduce_plain(shared.contiguous(), mask, 1))
    # Past 450 senders (the most whose (S, 128) slab fits one block's shared
    # memory), every route.
    ex, mask = _masked_inputs(3, 460, 130, True)
    for trim in (0, 2, 20):
        for view in (ex[:, :, 3:120], ex[1][None].expand(3, 460, 130)):
            _close(tp.masked_neighbor_reduce_call(view, mask, trim),
                   tp.masked_neighbor_reduce_plain(view.contiguous(), mask, trim))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("s", [451, 1000, 2048])
def test_masked_neighbor_reduce_kernel_at_many_senders(s, ties):
    """K7 at any S, each route against the plain version and counted as the
    route the library picks by trim: "sum" (trim 0), "select" (1, 12 and
    16, the largest its template serves), "rank" (17 and (n - 1) // 2 for
    the smallest neighbourhood n); two launches give the same bits on every
    route."""
    _need_card()
    from repro_torch.kernels import topology as tp
    ex, mask = _masked_inputs(3, s, 70, ties, seed=s)
    n = int(mask.sum(1).min())
    for trim in (0, 1, 12, 16, 17, (n - 1) // 2):
        ops.reset_launch_counts()
        got = tp.masked_neighbor_reduce_call(ex, mask, trim)
        route = "sum" if trim == 0 else "select" if trim <= 16 else "rank"
        assert tp.ROUTE_LAUNCHES == {k: int(k == route) for k in tp.ROUTES}
        _close(got, tp.masked_neighbor_reduce_plain(ex, mask, trim))
        assert torch.equal(got, tp.masked_neighbor_reduce_call(ex, mask, trim))


@pytest.mark.gpu
def test_member_lists_span_chunks():
    """5,000 senders: the member lists are compacted 2,048 senders at a time,
    and the first chunk holds fewer than 2 * trim members.  K7 (every
    route), the masked K2 and K3 against their plain versions."""
    _need_card()
    from repro_torch.kernels import topology as tp
    ex, mask = _masked_inputs(3, 5000, 70, True, seed=5)
    mask[:, :2048] = 0.0
    mask[:, [10, 500, 1000, 1500, 2000]] = 1.0
    mask[:, 4096:] = 1.0
    for trim in (0, 1, 12, 16, 17):
        _close(tp.masked_neighbor_reduce_call(ex, mask, trim),
               tp.masked_neighbor_reduce_plain(ex, mask, trim))
    y = ex.mean(1)
    _close(wz.partial_sqdist_call(ex, y, mask), wz.partial_sqdist_plain(ex, y, mask))
    a = mask * torch.rand(mask.shape, device="cuda")
    _close(wz.weighted_sum_call(ex, a), wz.weighted_sum_plain(ex, a))


@pytest.mark.gpu
@pytest.mark.parametrize("trim", [1, 12, 20])
def test_masked_neighbor_reduce_kernel_drops_huge_rows_without_trace(trim):
    """Rows 1e6 times larger than the rest, fewer than trim of them on each
    side: once dropped they leave no trace in the sum (no cancellation), so
    the kernel holds the plain version at rtol 1e-5 of the honest scale.  A
    receiver with n <= 2 * trim members gives exactly 0."""
    _need_card()
    from repro_torch.kernels import topology as tp
    ex, mask = _masked_inputs(4, 70, 300, False, seed=trim)
    mask[:, :] = 1.0
    big = min(trim, 10)
    ex[:, :big] = 1e6 * (1.0 + ex[:, :big].abs())
    ex[:, big:2 * big] = -1e6 * (1.0 + ex[:, big:2 * big].abs())
    mask[3] = 0.0
    mask[3, :2 * trim] = 1.0      # exactly 2 * trim members
    got = tp.masked_neighbor_reduce_call(ex, mask, trim)
    want = tp.masked_neighbor_reduce_plain(ex, mask, trim)
    assert float(want[:3].abs().max()) < 10.0
    _close(got, want)
    assert torch.equal(got[3], torch.zeros(300, device="cuda"))


@pytest.mark.gpu
def test_masked_neighbor_reduce_kernel_orders_nan_like_the_sort():
    """A member's NaN counts as the largest value, as torch.sort orders it:
    among the trim largest it is dropped; a kept NaN (trim 0) gives NaN, in
    the kernel and in the plain version alike (which orders the non-members
    after every member, NaN included); a non-member's NaN or inf is never
    read, and never reaches the plain version's result either."""
    _need_card()
    from repro_torch.kernels import topology as tp
    ex, mask = _masked_inputs(3, 48, 64, False)
    mask[:, :36] = 1.0
    mask[:, 36:] = 0.0
    ex[:, 36:, :8] = float("inf")
    ex[:, 37:, 8:16] = float("nan")
    ex[:, 2, :4] = float("nan")
    for trim in (1, 12, 17):
        got = tp.masked_neighbor_reduce_call(ex, mask, trim)
        assert bool(torch.isfinite(got).all())
        _close(got, tp.masked_neighbor_reduce_plain(ex, mask, trim))
    got = tp.masked_neighbor_reduce_call(ex, mask, 0)
    want = tp.masked_neighbor_reduce_plain(ex, mask, 0)
    assert bool(torch.isnan(got[:, :4]).all()) and bool(torch.isnan(want[:, :4]).all())
    assert bool(torch.isfinite(got[:, 4:]).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    full = torch.ones((3, 36), device="cuda")
    exf = ex[:, :36]
    torch.testing.assert_close(tp.masked_neighbor_reduce_call(exf, full, 0),
                               tp.masked_neighbor_reduce_plain(exf, full, 0),
                               rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.gpu
def test_masked_neighbor_reduce_kernel_takes_every_receiver():
    """Past 65,535 receivers (the grid's y limit) the blocks walk on; each
    route gives the plain version's rows, counted per route."""
    _need_card()
    from repro_torch.kernels import topology as tp
    ops.reset_launch_counts()
    for trim, s in [(0, 5), (1, 5), (17, 40)]:
        ex, mask = _masked_inputs(70_000, s, 3, False)
        mask[:, :] = 1.0
        _close(tp.masked_neighbor_reduce_call(ex, mask, trim),
               tp.masked_neighbor_reduce_plain(ex, mask, trim))
    assert tp.ROUTE_LAUNCHES == {"sum": 1, "select": 1, "rank": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,d", MASKED_SHAPES + [(3, 451, 4097)])
def test_partial_sqdist_masked_route_vs_plain(r, s, d):
    """K2's masked route: 0 for a non-member (also a receiver with no
    member), the plain version's distances on the mask, each receiver
    bitwise its R = 1 call and two launches the same bits; a column slice and
    a broadcast read in place; an all-ones mask agrees with the unmasked
    route at rtol 1e-5."""
    _need_card()
    ex, mask = _masked_inputs(r, s, d, False, seed=d)
    mask[0] = 0.0
    g = torch.Generator(device="cuda").manual_seed(2)
    y = ex.mean(1) + 0.1 * torch.randn((r, d), generator=g, device="cuda")
    ops.reset_launch_counts()
    got = wz.partial_sqdist_call(ex, y, mask)
    assert wz.SQDIST_ROUTE_LAUNCHES == {"unmasked": 0, "masked": 1}
    _close(got, wz.partial_sqdist_plain(ex, y, mask))
    assert torch.equal(got[0], torch.zeros(s, device="cuda"))
    assert torch.equal(got, torch.where(mask > 0, got, 0.0))
    assert torch.equal(got, wz.partial_sqdist_call(ex, y, mask))
    for i in {0, r - 1}:
        assert torch.equal(got[i], wz.partial_sqdist_call(ex[i], y[i], mask[i]))
    ones = torch.ones_like(mask)
    _close(wz.partial_sqdist_call(ex, y, ones), wz.partial_sqdist_call(ex, y))
    if d > 2:
        cols = ex[:, :, 1:d - 1]
        yc = y[:, 1:d - 1].contiguous()
        assert torch.equal(wz.partial_sqdist_call(cols, yc, mask),
                           wz.partial_sqdist_call(cols.contiguous(), yc, mask))
    shared = ex[1 % r][None].expand(r, s, d)
    assert torch.equal(wz.partial_sqdist_call(shared, y, mask),
                       wz.partial_sqdist_call(shared.contiguous(), y, mask))


@pytest.mark.gpu
def test_weiszfeld_kernels_take_every_row_count():
    """K2 (both routes) and K3 past 12,288 rows (K3's compaction runs in
    chunks of 2,048 weights) and past 65,535 rows or receivers (the grid's
    y and z limits), against the plain versions; two launches the same
    bits."""
    _need_card()
    for w, d in [(12_289, 300), (70_000, 5)]:
        z, y, a, *_ = _inputs(w, d, seed=w)
        a = a * (torch.rand((w,), device="cuda") < 0.6)
        mask = (a != 0).float()
        for got, want in [(wz.partial_sqdist_call(z, y), wz.partial_sqdist_plain(z, y)),
                          (wz.partial_sqdist_call(z, y, mask),
                           wz.partial_sqdist_plain(z, y, mask)),
                          (wz.weighted_sum_call(z, a), wz.weighted_sum_plain(z, a))]:
            _close(got, want)
        assert torch.equal(wz.weighted_sum_call(z, a), wz.weighted_sum_call(z, a))
        assert torch.equal(wz.partial_sqdist_call(z, y, mask),
                           wz.partial_sqdist_call(z, y, mask))
    ex, mask = _masked_inputs(70_000, 3, 5, False)
    y = ex.mean(1)
    _close(wz.partial_sqdist_call(ex, y), wz.partial_sqdist_plain(ex, y))
    _close(wz.partial_sqdist_call(ex, y, mask), wz.partial_sqdist_plain(ex, y, mask))
    _close(wz.weighted_sum_call(ex, mask), wz.weighted_sum_plain(ex, mask))
    z, y, *_ = _inputs(70_000, 5)
    seg = torch.tensor([0, 0, 1, -1, 1], dtype=torch.int32, device="cuda")
    _close(wz.partial_sqdist_segments_call(z, y, seg, 2),
           wz.partial_sqdist_segments_plain(z, y, seg, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,d", MASKED_SHAPES)
def test_batched_weiszfeld_kernels_vs_plain(r, s, d):
    """K2/K3 with a receiver axis against their plain versions (rtol 1e-5);
    each receiver's row is bitwise the unbatched master-path call on that
    receiver's matrix, and a slice or a broadcast is read in place."""
    _need_card()
    ex, _ = _masked_inputs(r, s, d, False)
    g = torch.Generator(device="cuda").manual_seed(1)
    y = ex.mean(1) + 0.1 * torch.randn((r, d), generator=g, device="cuda")
    a = torch.rand((r, s), generator=g, device="cuda") + 0.5
    sq, ws = wz.partial_sqdist_call(ex, y), wz.weighted_sum_call(ex, a)
    _close(sq, wz.partial_sqdist_plain(ex, y))
    _close(ws, wz.weighted_sum_plain(ex, a))
    for i in {0, r - 1}:
        assert torch.equal(sq[i], wz.partial_sqdist_call(ex[i], y[i]))
        assert torch.equal(ws[i], wz.weighted_sum_call(ex[i], a[i]))
    if d > 2:
        cols = ex[:, :, 1:d - 1]
        assert torch.equal(wz.partial_sqdist_call(cols, y[:, 1:d - 1].contiguous()),
                           wz.partial_sqdist_call(cols.contiguous(),
                                                  y[:, 1:d - 1].contiguous()))
    shared = ex[0][None].expand(r, s, d)
    assert torch.equal(wz.weighted_sum_call(shared, a),
                       wz.weighted_sum_call(shared.contiguous(), a))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 4097])
@pytest.mark.parametrize("r,s", [(4, 9), (3, 1)])
def test_weighted_sum_kernel_skips_zero_weight_rows(r, s, d):
    """K3 reads only the rows of nonzero weight: half the weights 0, one
    receiver with all 0 (exactly 0 out), one with a single nonzero weight
    (exactly w * z), W = 1, ragged D; a column slice and a shared (rs = 0)
    matrix read in place, and each receiver bitwise its R = 1 call."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(d + s)
    buf = torch.randn((r, s, d + 5), generator=g, device="cuda")
    ex = buf[:, :, :d].contiguous()
    a = (torch.rand((r, s), generator=g, device="cuda") + 0.5) \
        * (torch.rand((r, s), generator=g, device="cuda") < 0.5)
    a[0] = 0.0
    a[1] = 0.0
    a[1, s // 2] = 0.75
    got = wz.weighted_sum_call(ex, a)
    _close(got, wz.weighted_sum_plain(ex, a))
    assert torch.equal(got[0], torch.zeros(d, device="cuda"))
    assert torch.equal(got[1], 0.75 * ex[1, s // 2])
    for i in range(r):
        assert torch.equal(got[i], wz.weighted_sum_call(ex[i], a[i]))
    cols = buf[:, :, 1:d + 1]
    assert torch.equal(wz.weighted_sum_call(cols, a),
                       wz.weighted_sum_call(cols.contiguous(), a))
    shared = ex[2][None].expand(r, s, d)
    assert torch.equal(wz.weighted_sum_call(shared, a),
                       wz.weighted_sum_call(shared.contiguous(), a))
    assert torch.equal(got, wz.weighted_sum_call(ex, a))   # the same bits each run


@pytest.mark.gpu
def test_weighted_sum_kernel_skips_non_finite_zero_weight_rows():
    """A row of weight 0 that holds inf or NaN contributes nothing, in K3
    and in its plain version alike (the reference's masked engine promises
    that mask-0 senders do not influence the result); so does a mask-0 row
    in the masked K2, which gives exactly 0 there."""
    _need_card()
    ex, _ = _masked_inputs(3, 6, 300, False)
    a = torch.ones((3, 6), device="cuda")
    a[:, 2] = 0.0
    ex[:, 2, :7] = float("inf")
    ex[:, 2, 7:9] = float("nan")
    got = wz.weighted_sum_call(ex, a)
    want = wz.weighted_sum_plain(ex, a)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    _close(got, want)
    keep = torch.tensor([0, 1, 3, 4, 5], device="cuda")
    _close(got, wz.weighted_sum_plain(ex[:, keep], a[:, keep]))
    y = ex[:, keep].mean(1)
    sq = wz.partial_sqdist_call(ex, y, a)
    assert bool((sq[:, 2] == 0).all())
    _close(sq, wz.partial_sqdist_plain(ex, y, a))


DECENTRALIZED_RULES = ["mean", "median", "trimmed_mean", "geomed",
                       "geomed_groups", "geomed_blockwise", "krum",
                       "centered_clip"]


@pytest.mark.gpu
@pytest.mark.parametrize("gossip", ["gradient", "params"])
@pytest.mark.parametrize("agg", DECENTRALIZED_RULES)
def test_decentralized_cuda_steps_match_cpu(agg, gossip):
    """Five decentralized steps of each rule on an erdos_renyi graph on the
    card track the plain CPU path from the same data and draws (rtol 1e-4:
    the Weiszfeld stop may end one iteration apart), and launch K7 for
    trimmed_mean and the batched K2/K3 for geomed."""
    _need_card()
    data = ijcnn1_like(0, n=240, device="cpu")
    wd = partition({"a": data.x, "b": data.y}, 12, seed=1, device="cpu")
    cfg = RobustConfig(aggregator=agg, vr="saga", attack="alie",
                       num_byzantine=3, trim=2, num_groups=4,
                       topology="erdos_renyi", topology_p=0.6, gossip=gossip)
    draws = np.random.default_rng(2).integers(0, 20, (5, 12))
    out = {}
    for dev in ("cuda", "cpu"):
        init_fn, step_fn = make_federated_step(
            logreg_loss(0.01), wd, cfg, get_optimizer("sgd", 0.02), device=dev)
        st = init_fn({"w": torch.zeros(22)}, 0)
        ops.reset_launch_counts()
        for idx in draws:
            st, _ = step_fn(st, sample_idx=idx)
        counts = ops.launch_counts()
        out[dev] = st.params["w"].cpu()
    assert out["cuda"].shape == (15, 22)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-5)
    if agg == "trimmed_mean":
        assert counts["masked_neighbor_reduce"] == 0  # the CPU run counts none
    init_fn, step_fn = make_federated_step(
        logreg_loss(0.01), wd, cfg, get_optimizer("sgd", 0.02), device="cuda")
    st = init_fn({"w": torch.zeros(22)}, 0)
    ops.reset_launch_counts()
    st, _ = step_fn(st, sample_idx=draws[0])
    counts = ops.launch_counts()
    if agg == "trimmed_mean":
        assert counts["masked_neighbor_reduce"] == 1, counts
    if agg == "geomed":
        assert counts["partial_sqdist"] == counts["weighted_sum"] >= 1, counts
        assert counts["masked_neighbor_reduce"] == 1, counts


# -- the serving slice: K8 flash attention ------------------------------------

# (B, S, H, KV, hd, causal): tests/test_kernels.py:120-125, a ragged MQA
# head of 128, and the per-layer shape of the served qwen2-7b.
FLASH_SHAPES = [(2, 64, 4, 2, 16, True), (1, 100, 2, 2, 32, True),
                (2, 37, 4, 4, 8, False), (1, 192, 2, 1, 64, True),
                (2, 300, 7, 1, 128, True), (4, 2048, 28, 4, 128, True)]
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _flash_inputs(b, s, h, kv, hd, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, n, hd), generator=g, device="cuda").to(dtype)
            for n in (h, kv, kv)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,hd,causal", FLASH_SHAPES)
def test_flash_attention_kernel_vs_plain(b, s, h, kv, hd, causal, dtype):
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(b, s, h, kv, hd, dtype)
    got = fa.flash_attention_call(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v, causal).float(),
                               **FLASH_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [1, 48, 200, 256])
def test_flash_attention_kernel_takes_every_head_dim(hd):
    """Head dims that fill no compile-time width exactly, and the widest."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(2, 77, 4, 2, hd, torch.float32, seed=hd)
    for causal in (True, False):
        torch.testing.assert_close(fa.flash_attention_call(q, k, v, causal),
                                   fa.flash_attention_plain(q, k, v, causal),
                                   **FLASH_TOL[torch.float32])
    big = torch.zeros((1, 4, 1, 264), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_call(big, big, big, True)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_projections_in_place():
    """q, k and v as head views of (B, S, heads * hd) projections (and of one
    fused qkv buffer), and a float32 output from bfloat16 inputs.  The SIMT
    kernel computes in float32 throughout, so its float32 output is held at
    2e-5 (asked for with ``route="simt"``: these bf16 inputs at hd 64 take
    the wgmma route by default, whose bf16 p is held at 2e-2 below and in
    test_flash_attention_wgmma_reads_projections_in_place)."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kv, hd = 2, 130, 6, 2, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    fused = torch.randn((b, s, (h + 2 * kv) * hd), generator=g,
                        device="cuda").to(torch.bfloat16)
    q = fused[..., : h * hd].view(b, s, h, hd)
    k = fused[..., h * hd:(h + kv) * hd].view(b, s, kv, hd)
    v = fused[..., (h + kv) * hd:].view(b, s, kv, hd)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), True, torch.float32)
    got = fa.flash_attention_call(q, k, v, True, torch.float32, route="simt")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])
    torch.testing.assert_close(fa.flash_attention_call(q, k, v, True).float(),
                               want, **FLASH_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_cuda_serving_matches_cpu_plain_path():
    """The reduced qwen2-7b in float32: prefill of a ragged prompt and four
    decode steps on the card track the CPU path from the same weights and
    tokens (rtol 1e-4: K8 and the matmuls sum in another order), and the
    prefill launches K8 once per layer and the decode steps never."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("qwen2-7b").reduced()
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    steps = torch.randint(0, cfg.vocab_size, (4, 2, 1),
                          generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        p = params.to(dev)
        cache = model.init_cache(2, 41, dtype=torch.float32)
        logits = []
        with torch.no_grad():
            ops.reset_launch_counts()
            lg, cache = model.prefill(p, {"tokens": tokens.to(dev)}, cache=cache)
            prefill_launches = ops.launch_counts()["flash_attention"]
            logits.append(lg.cpu())
            ops.reset_launch_counts()
            for i, tok in enumerate(steps):
                lg, cache = model.decode_step(p, cache, tok.to(dev), 37 + i)
                logits.append(lg.cpu())
            decode_launches = ops.launch_counts()["flash_attention"]
        out[dev] = (torch.stack(logits), prefill_launches, decode_launches)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    assert out["cuda"][1:] == (cfg.num_layers, 0)
    assert out["cpu"][1:] == (0, 0)


# -- K8's wgmma route (bfloat16, hd 64 and 128) ---------------------------------

WGMMA_SEQ = [1, 63, 64, 65, 127, 128, 129, 300, 2048]


def _run_route(fa, q, k, v, causal, out_dtype=None):
    """One flash_attention_call -> (output, the route that launched)."""
    before = dict(fa.VARIANT_LAUNCHES)
    out = fa.flash_attention_call(q, k, v, causal, out_dtype)
    torch.cuda.synchronize()
    ran = [r for r in fa.VARIANTS if fa.VARIANT_LAUNCHES[r] > before[r]]
    assert len(ran) == 1, ran
    return out, ran[0]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("s", WGMMA_SEQ)
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_wgmma_vs_plain(hd, s, causal):
    """Ragged S around the 128-row/128-key tiles, both masks; GQA 2:1; the
    wgmma route ran, and two launches give the same bits."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    b = 1 if s == 2048 else 2
    q, k, v = _flash_inputs(b, s, 4, 2, hd, torch.bfloat16, seed=s + hd)
    got, route = _run_route(fa, q, k, v, causal)
    assert route == "wgmma" and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v, causal).float(),
                               **FLASH_TOL[torch.bfloat16])
    assert torch.equal(got, _run_route(fa, q, k, v, causal)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (7, 1), (14, 2)],
                         ids=["mha", "gqa2", "mqa", "gqa7"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_wgmma_head_groups(hd, h, kv):
    """H / KV of 1, 2 and 7, and MQA, causal and bidirectional."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(2, 129, h, kv, hd, torch.bfloat16, seed=h * kv)
    for causal in (True, False):
        got, route = _run_route(fa, q, k, v, causal)
        assert route == "wgmma"
        torch.testing.assert_close(
            got.float(), fa.flash_attention_plain(q, k, v, causal).float(),
            **FLASH_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_wgmma_reads_projections_in_place(hd):
    """q, k and v as head views of one fused (B, S, (H + 2 KV) hd) buffer
    (TMA reads them through their strides), a batch of one (its stride is
    never used), and a float32 output."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    for b in (2, 1):
        s, h, kv = 130, 6, 2
        g = torch.Generator(device="cuda").manual_seed(hd + b)
        fused = torch.randn((b, s, (h + 2 * kv) * hd), generator=g,
                            device="cuda").to(torch.bfloat16)
        q = fused[..., : h * hd].view(b, s, h, hd)
        k = fused[..., h * hd:(h + kv) * hd].view(b, s, kv, hd)
        v = fused[..., (h + kv) * hd:].view(b, s, kv, hd)
        assert not q.is_contiguous()
        want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                        v.contiguous(), True, torch.float32)
        for out_dtype in (torch.bfloat16, torch.float32):
            got, route = _run_route(fa, q, k, v, True, out_dtype)
            assert route == "wgmma" and got.dtype == out_dtype
            torch.testing.assert_close(got.float(), want, **FLASH_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd,offset", [
    (torch.float32, 64, 0), (torch.float32, 128, 0), (torch.bfloat16, 32, 0),
    (torch.bfloat16, 48, 0), (torch.bfloat16, 256, 0), (torch.bfloat16, 64, 1)],
    ids=["f32-64", "f32-128", "bf16-32", "bf16-48", "bf16-256", "bf16-64-unaligned"])
def test_flash_attention_other_inputs_take_the_simt_route(dtype, hd, offset):
    """float32, head dims other than 64 and 128, and a view whose base is not
    16-byte aligned run the SIMT kernel, at their tolerances; a forced
    "simt" route serves bf16 at hd 128."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(hd)
    buf = torch.randn((2, 77, 4, hd + offset), generator=g, device="cuda").to(dtype)
    q = buf[..., offset:]
    k, v = q[:, :, :2], q[:, :, 2:]
    assert fa.variant(dtype, hd, fa.tma_aligned(q, k, v)) == "simt"
    got, route = _run_route(fa, q, k, v, True)
    assert route == "simt"
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, True).float(), **FLASH_TOL[dtype])
    q, k, v = _flash_inputs(1, 65, 2, 1, 128, torch.bfloat16)
    before = fa.VARIANT_LAUNCHES["simt"]
    forced = fa.flash_attention_call(q, k, v, True, route="simt")
    assert fa.VARIANT_LAUNCHES["simt"] == before + 1
    torch.testing.assert_close(forced.float(), fa.flash_attention_plain(q, k, v, True).float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_serving_prefill_runs_the_wgmma_route():
    """The reduced qwen2-7b in bfloat16 (head dim 64) launches K8 once per
    layer of the prefill, all on the wgmma route, and never in a decode
    step."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model
    cfg = get_config("qwen2-7b").reduced()
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(1)).cuda()
    cache = model.init_cache(2, 38, dtype=torch.bfloat16)
    want = fa.variant(torch.bfloat16, cfg.resolved_head_dim, True)
    assert want == "wgmma"
    with torch.no_grad():
        ops.reset_launch_counts()
        lg, cache = model.prefill(params, {"tokens": tokens}, cache=cache)
        assert fa.VARIANT_LAUNCHES[want] == cfg.num_layers
        assert sum(fa.VARIANT_LAUNCHES.values()) == cfg.num_layers
        ops.reset_launch_counts()
        model.decode_step(params, cache, tokens[:, -1:], 37)
        assert fa.VARIANT_LAUNCHES == {"wgmma": 0, "simt": 0}
    assert bool(torch.isfinite(lg).all())


# -- the bf16 routes of K1-K7 (the bf16 wire) ------------------------------------
#
# K2-K7 only load bfloat16 in place of float32 (the conversion is exact), so
# each bf16 route is held bitwise against the float32 kernel on the upcast
# input laid out alike (a slice of the upcast buffer for a slice: both then
# take the same load path, 4-element or scalar, and sum in the same order),
# and at rtol 1e-5 against the plain version; K1 rounds after every
# operation as the plain version's bf16 ops do, so it is held bitwise against
# the plain version on bf16 tensors.  The shapes are tests/test_kernels.py's
# sweep (ragged p, odd W), workload B's width and the routes past each cap.

BF16_SHAPES = [(7, 300), (8, 64), (3, 1), (70, 39_760)]


def _bf16_inputs(w, p, seed=0):
    z, y, a, *_ = _inputs(w, p, seed)
    zb = z.bfloat16()
    zb[min(1, w - 1)] = zb[0]                      # ties after the rounding
    return zb, y, a


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bits of a float32 or bfloat16 tensor, as integers."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", BF16_SHAPES)
def test_bf16_flat_routes_equal_float32_kernel_on_upcast(w, p):
    """K2, K3, K4, K5 and K6 on a bf16 z: float32 out, the bits of the
    float32 kernel on z.float(), and the plain version at rtol 1e-5."""
    _need_card()
    zb, y, a = _bf16_inputs(w, p, seed=w + p)
    zf = zb.float()
    seg = (torch.arange(p, device="cuda") * 3 // max(p, 1)).to(torch.int32)
    trim = (w - 1) // 2 if w < 5 else 2
    pairs = {
        "partial_sqdist": (lambda z: wz.partial_sqdist_call(z, y),
                           wz.partial_sqdist_plain(zb, y)),
        "weighted_sum": (lambda z: wz.weighted_sum_call(z, a),
                         wz.weighted_sum_plain(zb, a)),
        "coordinate_median": (rs.coordinate_median_call,
                              rs.coordinate_median_plain(zb)),
        "trimmed_mean": (lambda z: rs.trimmed_mean_call(z, trim),
                         rs.trimmed_mean_plain(zb, trim)),
        "partial_sqdist_segments": (
            lambda z: wz.partial_sqdist_segments_call(z, y, seg, 3),
            wz.partial_sqdist_segments_plain(zb, y, seg, 3)),
    }
    ops.reset_launch_counts()
    for name, (call, plain) in pairs.items():
        got = call(zb)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32, name
        assert torch.equal(_raw(got), _raw(call(zf))), name
        _close(got, plain)
    assert ops.bf16_launch_counts() == {
        "partial_sqdist": 1, "partial_sqdist unmasked": 1, "weighted_sum": 1,
        "coordinate_median": 1, "trimmed_mean": 1, "partial_sqdist_segments": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("w", [129, 455])
def test_bf16_order_stat_rank_routes(w):
    """K4 and K5 past the network (the shared-memory rank count at 129, the
    global one at 455): the float32 kernel's bits on the upcast."""
    _need_card()
    zb, *_ = _bf16_inputs(w, 300, seed=w)
    for call in (rs.coordinate_median_call, lambda z: rs.trimmed_mean_call(z, 7)):
        assert torch.equal(_raw(call(zb)), _raw(call(zb.float())))
    _close(rs.trimmed_mean_call(zb, 7), rs.trimmed_mean_plain(zb, 7))


@pytest.mark.gpu
def test_bf16_weighted_sum_and_sqdist_read_column_slices():
    """A column slice of a bf16 buffer (rows 1,000 + 2 elements apart: the
    scalar-load path) and a misaligned base: the float32 kernel's bits."""
    _need_card()
    zb, y, a = _bf16_inputs(7, 1002)
    zf = zb.float()
    for lo, hi in ((2, 302), (1, 1001), (0, 1002), (4, 304)):
        sl, slf, ys = zb[:, lo:hi], zf[:, lo:hi], y[lo:hi].contiguous()
        assert torch.equal(_raw(wz.weighted_sum_call(sl, a)),
                           _raw(wz.weighted_sum_call(slf, a)))
        assert torch.equal(_raw(wz.partial_sqdist_call(sl, ys)),
                           _raw(wz.partial_sqdist_call(slf, ys)))
        _close(wz.weighted_sum_call(sl, a), wz.weighted_sum_plain(sl, a))


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", BF16_SHAPES)
def test_bf16_saga_kernel_bitwise_plain(w, p):
    """K1's bf16 route on both routes: msg, avg and table bitwise the plain
    version's bf16 ops; an out-of-range index gives a NaN message and
    leaves the state alone."""
    _need_card()
    *_, grad, table, avg, idx = _inputs(w, p, seed=w)
    grad, table, avg = grad.bfloat16(), table.bfloat16(), avg.bfloat16()
    tab_k, avg_k = table.clone(), avg.clone()
    msg_k = sc.saga_correct_call(grad, tab_k, avg_k, idx)
    msg_p = sc.saga_correct_plain(grad, table, avg, idx)
    torch.cuda.synchronize()
    assert msg_k.dtype == torch.bfloat16
    for got, want in ((msg_k, msg_p), (avg_k, avg), (tab_k, table)):
        assert torch.equal(_raw(got), _raw(want))
    idx[0] = J
    tab0, avg0 = tab_k.clone(), avg_k.clone()
    msg = sc.saga_correct_call(grad, tab_k, avg_k, idx)
    torch.cuda.synchronize()
    assert bool(torch.isnan(msg[0].float()).all())
    assert torch.equal(tab_k[0], tab0[0]) and torch.equal(avg_k[0], avg0[0])


@pytest.mark.gpu
@pytest.mark.parametrize("c,j,p,w", [(13, 3, 300, 7), (40, 4, 39_760, 11)])
def test_bf16_saga_kernel_client_rows_bitwise_plain(c, j, p, w):
    _need_card()
    grad, table, avg, idx, rows = _client_inputs(c, j, p, w)
    grad, table, avg = grad.bfloat16(), table.bfloat16(), avg.bfloat16()
    tab_k, avg_k = table.clone(), avg.clone()
    ops.reset_launch_counts()
    msg_k = sc.saga_correct_call(grad, tab_k, avg_k, idx, rows)
    msg_p = sc.saga_correct_plain(grad, table, avg, idx, rows)
    torch.cuda.synchronize()
    for got, want in ((msg_k, msg_p), (avg_k, avg), (tab_k, table)):
        assert torch.equal(_raw(got), _raw(want))
    assert ops.bf16_launch_counts() == {"saga_correct": 1,
                                        "saga_correct clients": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,d,trim", [(7, 7, 300, t) for t in (0, 1, 2)]
                         + [(3, 40, 129, t) for t in (0, 1, 2, 17)])
def test_bf16_masked_routes_equal_float32_kernel_on_upcast(r, s, d, trim):
    """K7 (sum, select, rank), the masked and batched K2 and the batched
    K3 on a bf16 exchange: the float32 kernel's bits on the upcast, and
    the plain version at rtol 1e-5; also read as a column slice and as one
    matrix broadcast to every receiver."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(r * s + trim)
    ex = torch.randn((r, s, d + 6), generator=g, device="cuda").bfloat16()
    mask = (torch.rand((r, s), generator=g, device="cuda") < 0.7).float()
    mask[:, :2 * trim + 1] = 1.0
    y = torch.randn((r, d), generator=g, device="cuda")
    exf, one = ex.float(), ex[0, :, :d].contiguous()
    for x, xf in ((ex[..., :d].contiguous(), exf[..., :d].contiguous()),
                  (ex[..., 3:3 + d], exf[..., 3:3 + d]),
                  (one[None].expand(r, s, d), one.float()[None].expand(r, s, d))):
        got = tp.masked_neighbor_reduce_call(x, mask, trim)
        assert torch.equal(_raw(got), _raw(tp.masked_neighbor_reduce_call(xf, mask, trim)))
        _close(got, tp.masked_neighbor_reduce_plain(x, mask, trim))
        for m in (mask, None):
            got = wz.partial_sqdist_call(x, y, m)
            assert torch.equal(_raw(got), _raw(wz.partial_sqdist_call(xf, y, m)))
            _close(got, wz.partial_sqdist_plain(x, y, m))
        got = wz.weighted_sum_call(x, mask)
        assert torch.equal(_raw(got), _raw(wz.weighted_sum_call(xf, mask)))
        _close(got, wz.weighted_sum_plain(x, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["bfloat16", "int8", "sign1"])
@pytest.mark.parametrize("topology", ["star", "ring"])
def test_wire_steps_on_card_match_cpu(wire, topology):
    """Five steps of each wire on the card, master and decentralized, track
    the plain CPU path from the same data, state and draws (atol 2e-2 on the
    bf16 wire, where one last-bit difference moves a bf16 rounding; rtol 1e-4
    otherwise), and the bf16 wire runs the kernels' bf16 routes."""
    _need_card()
    data = ijcnn1_like(0, n=240, device="cpu")
    wd = partition({"a": data.x, "b": data.y}, 12, seed=1, device="cpu")
    cfg = RobustConfig(aggregator="geomed", vr="saga", attack="sign_flip",
                       num_byzantine=3, topology=topology, message_dtype=wire)
    draws = np.random.default_rng(3).integers(0, 20, (5, 12))
    out = {}
    for dev in ("cuda", "cpu"):
        init_fn, step_fn = make_federated_step(
            logreg_loss(0.01), wd, cfg, get_optimizer("sgd", 0.02), device=dev)
        st = init_fn({"w": torch.zeros(22)}, 0)
        ops.reset_launch_counts()
        for idx in draws:
            st, _ = step_fn(st, sample_idx=idx)
        out[dev] = (st.params["w"].cpu(), ops.bf16_launch_counts())
    tol = dict(rtol=0, atol=2e-2) if wire == "bfloat16" else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], **tol)
    bf16 = out["cuda"][1]
    if wire == "bfloat16":
        assert bf16["saga_correct"] == 5 and bf16["weighted_sum"] >= 5, bf16
        assert bf16["partial_sqdist"] == bf16["weighted_sum"], bf16
    else:
        assert bf16 == {}, bf16
    assert out["cpu"][1] == {}


# The bf16 routes that stream member rows (K3 and K7 "sum": 8 coordinates a
# lane in 16-byte loads where the base is 16-byte aligned and the strides are
# multiples of 8 elements, else the 8-byte or the scalar path; the masked K2:
# 4 rows in flight on its 8-byte path).  Each case reads x = buf[..., lo:lo +
# d] of an (r, s, width) bf16 buffer, and the float32 kernels read the same
# slice of the upcast buffer.  (r, s, d, lo, width, mask density):
BF16_STREAM_CASES = {
    "16-byte": (5, 40, 1024, 0, 1024, 0.6),
    "d%8==4": (5, 40, 300, 0, 300, 0.6),           # rows 600 bytes apart: 8-byte loads
    "ragged": (5, 40, 1002, 0, 1002, 0.6),         # D % 4 == 2: scalar loads
    "base-8-byte": (5, 40, 512, 4, 520, 0.6),      # strides fit, the base is 8 bytes off
    "tail-d%8==4": (5, 40, 300, 0, 304, 0.6),      # 16-byte rows, a lane's last 8 cut at D
    "tail-odd": (5, 40, 301, 0, 304, 0.6),         # the same, D odd (scalar stores)
    "members-2500": (2, 2500, 264, 0, 264, 0.9),   # compacted 2,048 at a time
    "receivers-70000": (70_000, 5, 16, 0, 16, 1.0),  # past the grid's y limit
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BF16_STREAM_CASES))
def test_bf16_streaming_routes_equal_float32_kernel_on_upcast(case):
    """The masked K2, the batched and unbatched K3 and K7 "sum" on a bf16
    exchange at every load path of their bf16 routes: the float32 kernel's
    bits on the upcast laid out alike, and the plain version at rtol 1e-5."""
    _need_card()
    r, s, d, lo, width, density = BF16_STREAM_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(r + s + d + lo)
    buf = torch.randn((r, s, width), generator=g, device="cuda").bfloat16()
    buff = buf.float()
    x, xf = buf[..., lo:lo + d], buff[..., lo:lo + d]
    mask = (torch.rand((r, s), generator=g, device="cuda") < density).float()
    wts = mask * torch.rand((r, s), generator=g, device="cuda")
    y = torch.randn((r, d), generator=g, device="cuda")
    pairs = {
        "K7 sum": (lambda z: tp.masked_neighbor_reduce_call(z, mask, 0),
                   tp.masked_neighbor_reduce_plain(x, mask, 0)),
        "masked K2": (lambda z: wz.partial_sqdist_call(z, y, mask),
                      wz.partial_sqdist_plain(x, y, mask)),
        "batched K3": (lambda z: wz.weighted_sum_call(z, wts),
                       wz.weighted_sum_plain(x, wts)),
        "K3": (lambda z: wz.weighted_sum_call(z[0], wts[0]),
               wz.weighted_sum_plain(x[0], wts[0])),
    }
    ops.reset_launch_counts()
    for name, (call, plain) in pairs.items():
        got = call(x)
        torch.cuda.synchronize()
        assert torch.equal(_raw(got), _raw(call(xf))), name
        _close(got, plain)
    assert ops.bf16_launch_counts() == {
        "masked_neighbor_reduce": 1, "masked_neighbor_reduce sum": 1,
        "partial_sqdist": 1, "partial_sqdist masked": 1, "weighted_sum": 2}


# K7 "select" on a bf16 exchange takes the pairs layout (two coordinates a
# thread, 16-bit keys ordered two at a time) where the base is 4-byte aligned
# and the strides are even, else one coordinate a thread; both give the
# float32 kernel's bits on the upcast laid out alike.  The exchange is x =
# buf[..., :1001] of a (5, 70, 1002) bf16 buffer: even strides and an odd D,
# so the last pair has a dead half.  Receiver 0 has 2 * trim - 1 members,
# receiver 1 exactly 2 * trim, receiver 2 all 70, the rest p = 0.5 (with
# senders 3 and 4); senders 0 and 1 are copies (ties), senders 5-9 hold +0
# and -0 at coordinates 40-59, sender 3 a NaN at 0-9, +inf at 10-19 and -inf
# at 20-29, and sender 4 is 1e30 times larger than the rest from coordinate
# 30 on: at most one extreme on each side of a coordinate, so trim 1 drops
# them all.


def _select_pairs_exchange(trim: int, s: int = 70, d: int = 1001, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed + trim)
    buf = torch.randn((5, s, d + 1), generator=g, device="cuda")
    buf[:, 1] = buf[:, 0]
    buf[:, 5:10, 40:60] = 0.0
    buf[:, 5:10:2, 40:60] = -0.0
    buf[:, 3, :10] = float("nan")
    buf[:, 3, 10:20] = float("inf")
    buf[:, 3, 20:30] = -float("inf")
    buf[:, 4, 30:] = 1e30 * (1.0 + buf[:, 4, 30:].abs())
    mask = (torch.rand((5, s), generator=g, device="cuda") < 0.5).float()
    mask[:, 3:5] = 1.0
    mask[0] = 0.0
    mask[0, :2 * trim - 1] = 1.0
    mask[1] = 0.0
    mask[1, :2 * trim] = 1.0
    mask[2] = 1.0
    return buf.bfloat16(), mask


def _select_layout_case(x, xf, mask, trim, layout):
    """K7 at trim on bf16 x: the float32 kernel's bits on xf, the plain
    version at rtol 1e-5, and one launch of `layout`."""
    ops.reset_launch_counts()
    got = tp.masked_neighbor_reduce_call(x, mask, trim)
    torch.cuda.synchronize()
    assert tp.SELECT_LAYOUT_LAUNCHES == {k: int(k == layout) for k in tp.SELECT_LAYOUTS}
    assert torch.equal(_raw(got), _raw(tp.masked_neighbor_reduce_call(xf, mask, trim)))
    assert tp.SELECT_LAYOUT_LAUNCHES == {"one": 1 + int(layout == "one"),
                                         "pairs": int(layout == "pairs")}
    _close(got, tp.masked_neighbor_reduce_plain(x, mask, trim))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("trim", range(1, 17))
def test_bf16_select_pairs_layout_equals_float32_kernel_on_upcast(trim):
    """The pairs layout at every trim it serves: receivers with fewer than
    2 * trim, exactly 2 * trim and more members (0 for the first two), ties,
    +-0, +-inf, a NaN member and a huge row, all dropped or kept as the
    float32 kernel drops or keeps them."""
    _need_card()
    buf, mask = _select_pairs_exchange(trim)
    got = _select_layout_case(buf[..., :1001], buf.float()[..., :1001], mask, trim,
                              "pairs")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[:2], torch.zeros((2, 1001), device="cuda"))
    assert float(got[2:].abs().max()) < 10.0


@pytest.mark.gpu
@pytest.mark.parametrize("trim", [1, 12, 16])
def test_bf16_select_pairs_layout_past_one_compaction(trim):
    """2,100 senders: the members are compacted 2,048 senders at a time, and
    receiver 0's first chunk holds fewer than 2 * trim of them."""
    _need_card()
    buf, mask = _select_pairs_exchange(trim, s=2_100, d=257, seed=7)
    mask[0] = 0.0
    mask[0, [5, 700, 1500]] = 1.0
    mask[0, 2_048:] = 1.0
    _select_layout_case(buf[..., :257], buf.float()[..., :257], mask, trim, "pairs")


@pytest.mark.gpu
@pytest.mark.parametrize("trim", [1, 12])
def test_bf16_select_unaligned_views_take_one_coordinate_a_thread(trim):
    """A column slice at an odd offset (a base 2 bytes off a 4-byte
    boundary) and a contiguous exchange of odd width (odd strides) take one
    coordinate a thread, with the same bits; a broadcast of one aligned
    matrix (rs = 0) takes the pairs."""
    _need_card()
    buf, mask = _select_pairs_exchange(trim, d=1005)
    bf = buf.float()
    _select_layout_case(buf[..., 3:3 + 1001], bf[..., 3:3 + 1001], mask, trim, "one")
    odd = buf[..., :1001].contiguous()
    _select_layout_case(odd, odd.float(), mask, trim, "one")
    one = buf[0, :, :1000].contiguous()
    _select_layout_case(one[None].expand(5, 70, 1000),
                        one.float()[None].expand(5, 70, 1000), mask, trim, "pairs")


# K2's unbatched bf16 route in one launch ("cluster": a 16-byte aligned z
# whose strides are multiples of 8 elements, so a contiguous z needs D % 8 ==
# 0) and K4's bf16 pairs layout (two columns a thread on 16-bit keys, D even
# and a 4-byte aligned base).  Both give the float32 kernel's bits on the
# upcast laid out alike; every other view takes the other layout, with the
# same bits.  D = 65,537 and 65,544 pass 32 chunks of 2,048 (the second on
# the cluster route), 600,000 passes 256.

SQDIST_CLUSTER_D = [1, 300, 2_047, 2_048, 2_049, 39_760, 65_537, 65_544, 600_000]


def _sqdist_layout_case(x, xf, y, layout):
    """K2 on bf16 x: one launch of `layout`, the float32 kernel's bits on
    xf, the plain version at rtol 1e-5."""
    ops.reset_launch_counts()
    got = wz.partial_sqdist_call(x, y)
    torch.cuda.synchronize()
    assert wz.SQDIST_LAYOUT_LAUNCHES == {k: int(k == layout) for k in wz.SQDIST_LAYOUTS}
    assert ops.bf16_launch_counts() == {"partial_sqdist": 1, "partial_sqdist unmasked": 1}
    assert torch.equal(_raw(got), _raw(wz.partial_sqdist_call(xf, y)))
    _close(got, wz.partial_sqdist_plain(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("d", SQDIST_CLUSTER_D)
@pytest.mark.parametrize("w", [1, 7, 70, 300])
def test_bf16_sqdist_layouts_equal_float32_kernel_on_upcast(w, d):
    """Every W and D of the sweep, with ties: the cluster layout where
    D % 8 == 0, the two passes otherwise."""
    _need_card()
    zb, y, _ = _bf16_inputs(w, d, seed=w + d)
    _sqdist_layout_case(zb, zb.float(), y, "cluster" if d % 8 == 0 else "two-pass")


@pytest.mark.gpu
def test_bf16_sqdist_cluster_batched_broadcast_and_many_rows():
    """A batched (5, 70, 39,760) exchange, one matrix broadcast to every
    receiver (rs = 0), and 70,000 rows (past one grid dimension): the
    cluster layout and the float32 kernel's bits."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(23)
    ex = torch.randn((5, 70, 39_760), generator=g, device="cuda").bfloat16()
    y = torch.randn((5, 39_760), generator=g, device="cuda")
    _sqdist_layout_case(ex, ex.float(), y, "cluster")
    one = ex[0]
    _sqdist_layout_case(one[None].expand(5, 70, 39_760),
                        one.float()[None].expand(5, 70, 39_760), y, "cluster")
    many = torch.randn((70_000, 16), generator=g, device="cuda").bfloat16()
    _sqdist_layout_case(many, many.float(), torch.randn(16, device="cuda"), "cluster")
    bad = ex[0].clone()   # rows holding +-inf and NaN: the float32 kernel's bits
    bad[3, :100] = float("inf")
    bad[4, 7] = -float("inf")
    bad[5, 39_000] = float("nan")
    ops.reset_launch_counts()
    got = wz.partial_sqdist_call(bad, y[0])
    assert wz.SQDIST_LAYOUT_LAUNCHES["cluster"] == 1
    assert torch.equal(_raw(got), _raw(wz.partial_sqdist_call(bad.float(), y[0])))
    assert bool(torch.isinf(got[3:5]).all()) and bool(torch.isnan(got[5]))


@pytest.mark.gpu
def test_bf16_sqdist_column_slices_take_their_layout():
    """The column slices of test_bf16_weighted_sum_and_sqdist_read_column_slices
    (rows 1,002 elements apart) take the two passes; slices of a 1,024-wide
    buffer at a 16-byte aligned offset take the cluster, one 8 bytes off the
    two passes; all with the float32 kernel's bits on the upcast slice."""
    _need_card()
    zb, y, _ = _bf16_inputs(7, 1002)
    zf = zb.float()
    for lo, hi in ((2, 302), (1, 1001), (0, 1002), (4, 304)):
        _sqdist_layout_case(zb[:, lo:hi], zf[:, lo:hi], y[lo:hi].contiguous(), "two-pass")
    wide, yw, _ = _bf16_inputs(7, 1024, seed=3)
    for lo, hi, layout in ((0, 512, "cluster"), (8, 520, "cluster"), (4, 516, "two-pass")):
        _sqdist_layout_case(wide[:, lo:hi], wide.float()[:, lo:hi], yw[lo:hi].contiguous(),
                            layout)


@pytest.mark.gpu
def test_bf16_sqdist_cluster_is_one_kernel_launch():
    """A call of the cluster layout launches exactly one kernel (one
    runtime launch a call, no memset or copy: the profiler's runtime
    records), and the card runs nothing but that kernel (its device
    records, which for this cudaLaunchKernelEx launch now and then miss
    one: they are not counted)."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    zb, y, _ = _bf16_inputs(70, 39_760, seed=5)
    wz.partial_sqdist_call(zb, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            wz.partial_sqdist_call(zb, y)
        torch.cuda.synchronize()
    events = prof.events()
    runtime = [e.name for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith("cuda") and ("Launch" in e.name or "Mem" in e.name)]
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert len(runtime) == 5 and all("LaunchKernel" in n for n in runtime), runtime
    assert kernels and all("sqdist_cluster_kernel" in n for n in kernels), kernels


def _median_layout_case(zb, layout):
    """K4 on bf16 zb: one launch of `layout`, the float32 kernel's bits on
    the upcast (zeros' signs included) and the plain version's values."""
    ops.reset_launch_counts()
    got = rs.coordinate_median_call(zb)
    torch.cuda.synchronize()
    assert rs.MEDIAN_LAYOUT_LAUNCHES == {k: int(k == layout) for k in rs.MEDIAN_LAYOUTS}
    assert torch.equal(_raw(got), _raw(rs.coordinate_median_call(zb.float())))
    torch.testing.assert_close(got, rs.coordinate_median_plain(zb), rtol=0, atol=0,
                               equal_nan=True)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [300, 301])
def test_bf16_median_layouts_at_every_network_width(d):
    """Every W from 1 to 128 at an even D (pairs) and an odd one (one a
    thread): columns with trim and trim + 1 NaN, NaN at the median ranks,
    +-inf, ties and both zeros."""
    _need_card()
    for w in range(1, rs.NETWORK_CAP + 1):
        zb, *_ = _bf16_inputs(w, d, seed=w)
        zb[:, :40] = torch.round(2 * zb[:, :40].float()).bfloat16()
        zb[: w // 3 + 1, 40:50] = float("inf")
        zb[w // 3 + 1: w // 2 + 1, 45:60] = float("-inf")
        trim = (w - 1) // 4
        zb[:trim, 60:70] = float("nan")
        zb[:trim + 1, 70:80] = -float("nan")
        zb[: (w + 1) // 2, 80:90] = float("nan")
        zb[:, 90:110] = 0.0
        zb[::2, 90:110] = -0.0
        got = _median_layout_case(zb, "pairs" if d % 2 == 0 else "one")
        assert bool(torch.isnan(got[80:90]).all()), w


@pytest.mark.gpu
def test_bf16_median_pairs_zero_signs_are_the_float32_kernels():
    """Every column of +0 and -0 at W = 1..9 (all 2^W of them): the pairs
    layout's result is the float32 kernel's bit for bit, and both order -0
    below +0 (Hopper's FMNMX does as the 16-bit keys do): the median is -0
    exactly when both middle ranks hold -0."""
    _need_card()
    for w in range(1, 10):
        cols = torch.arange(1 << w, device="cuda")
        neg = ((cols[None, :] >> torch.arange(w, device="cuda")[:, None]) & 1).bool()
        zb = torch.where(neg, -0.0, 0.0).bfloat16()
        got = _median_layout_case(zb, "pairs")
        lo, hi = (w - 1) // 2, w // 2
        n_neg = neg.sum(0)
        assert torch.equal(torch.signbit(got), (lo < n_neg) & (hi < n_neg)), w


@pytest.mark.gpu
def test_bf16_median_odd_offset_takes_one_column_a_thread():
    """A contiguous z at an odd storage offset (a base 2 bytes off a 4-byte
    boundary) takes one column a thread, with the same bits; the same
    values at an aligned base take the pairs."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    buf = torch.randn((70 * 300 + 1,), generator=g, device="cuda").bfloat16()
    _median_layout_case(buf[1:].view(70, 300), "one")
    _median_layout_case(buf[1:].view(70, 300).clone(), "pairs")


def _trimmed_layout_case(zb, trim, layout):
    """K5 on bf16 zb: one launch of `layout`, the float32 kernel's bits on
    the upcast (NaN words included: both write NAN where a column holds
    more than trim NaN) and the plain
    version at rtol 1e-5."""
    ops.reset_launch_counts()
    got = rs.trimmed_mean_call(zb, trim)
    torch.cuda.synchronize()
    assert rs.TRIMMED_LAYOUT_LAUNCHES == {k: int(k == layout) for k in rs.MEDIAN_LAYOUTS}
    assert torch.equal(_raw(got), _raw(rs.trimmed_mean_call(zb.float(), trim)))
    want = rs.trimmed_mean_plain(zb, trim)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    _close(got[fin], want[fin])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [300, 301])
def test_bf16_trimmed_layouts_at_every_network_width(d):
    """Every W from 1 to 128, trims 0, 1, (W - 1) // 2 and 20 where valid,
    at an even D (pairs) and an odd one (one a thread): columns with trim
    and trim + 1 NaN of both signs, +-inf, ties and both zeros."""
    _need_card()
    for w in range(1, rs.NETWORK_CAP + 1):
        for trim in sorted({t for t in (0, 1, (w - 1) // 2, 20) if 2 * t < w}):
            zb, *_ = _bf16_inputs(w, d, seed=w)
            zb[:, :40] = torch.round(2 * zb[:, :40].float()).bfloat16()
            zb[: w // 3 + 1, 40:50] = float("inf")
            zb[w // 3 + 1: w // 2 + 1, 45:60] = float("-inf")
            zb[:trim, 60:70] = float("nan")
            zb[:trim + 1, 70:80] = -float("nan")
            zb[:, 90:110] = 0.0
            zb[::2, 90:110] = -0.0
            got = _trimmed_layout_case(zb, trim, "pairs" if d % 2 == 0 else "one")
            assert bool(torch.isnan(got[70:80]).all()), (w, trim)


@pytest.mark.gpu
def test_bf16_trimmed_odd_offset_takes_one_column_a_thread():
    """A contiguous z at an odd storage offset takes one column a thread,
    the same values at an aligned base the pairs; both with the float32
    kernel's bits.  Past 128 workers the rank count runs ("one")."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(10)
    buf = torch.randn((70 * 300 + 1,), generator=g, device="cuda").bfloat16()
    _trimmed_layout_case(buf[1:].view(70, 300), 20, "one")
    _trimmed_layout_case(buf[1:].view(70, 300).clone(), 20, "pairs")
    ops.reset_launch_counts()
    rs.trimmed_mean_call(torch.randn((129, 300), generator=g, device="cuda").bfloat16(), 3)
    assert rs.TRIMMED_LAYOUT_LAUNCHES == {"one": 1, "pairs": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("dtype,hd,route", [(torch.float32, 64, "simt"),
                                            (torch.bfloat16, 128, "wgmma")],
                         ids=["f32-simt", "bf16-wgmma"])
def test_flash_attention_function_gradients(dtype, hd, route, causal):
    """K8 for training (``FlashAttention``: the kernel's forward, the plain
    backward) against autograd of the plain version on the same inputs, at
    a ragged S with GQA 2:1: the forward ran on ``route``, and every
    gradient agrees within the route's forward tolerance scaled to the
    gradient's largest entry."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (x.requires_grad_(True)
               for x in _flash_inputs(2, 300, 4, 2, hd, dtype, seed=hd))
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn((2, 300, 4, hd), generator=g, device="cuda").to(dtype)
    before = dict(fa.VARIANT_LAUNCHES)
    got = torch.autograd.grad(fa.FlashAttention.apply(q, k, v, causal, None),
                              (q, k, v), dout)
    assert fa.VARIANT_LAUNCHES[route] == before[route] + 1
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, causal),
                               (q, k, v), dout)
    tol = FLASH_TOL[dtype]["rtol"]
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "wgmma")],
                         ids=["f32-simt", "bf16-wgmma"])
def test_flash_attention_vmap_grad_folds_workers(dtype, route):
    """``torch.func.vmap(torch.func.grad(...))`` over 4 workers through
    ``FlashAttention`` (hd 64, GQA 2:1, a ragged S): one launch of ``route``
    on the folded (W * B, ...) batch, and every gradient within the route's
    forward tolerance (scaled to its largest entry) of a loop of per-worker
    ``grad`` s, which launch once a worker."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    w, b, s, h, kv, hd, d = 4, 2, 130, 4, 2, 64, 96
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((w, b, s, d), generator=g, device="cuda").to(dtype)
    params = {n: (torch.randn((d, m * hd), generator=g, device="cuda")
                  * d ** -0.5).to(dtype)
              for n, m in (("wq", h), ("wk", kv), ("wv", kv))}

    def loss(p, xb):
        q = (xb @ p["wq"]).reshape(b, s, h, hd)
        k = (xb @ p["wk"]).reshape(b, s, kv, hd)
        v = (xb @ p["wv"]).reshape(b, s, kv, hd)
        return torch.sum(fa.FlashAttention.apply(q, k, v, True, None).float() ** 2)

    before = dict(fa.VARIANT_LAUNCHES)
    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, x)
    assert fa.VARIANT_LAUNCHES[route] == before[route] + 1
    assert sum(fa.VARIANT_LAUNCHES.values()) == sum(before.values()) + 1
    tol = FLASH_TOL[dtype]["rtol"]
    for i in range(w):
        one = torch.func.grad(loss)(params, x[i])
        for n, want in one.items():
            err = float((batched[n][i].float() - want.float()).abs().max())
            assert err <= tol * float(want.float().abs().max()), (i, n, err)
    assert fa.VARIANT_LAUNCHES[route] == before[route] + 1 + w


# -- the sliding window through K8 (mixtral) -----------------------------------

# (route, dtype): the two kernels a window runs through.
WINDOW_ROUTES = [("wgmma", torch.bfloat16), ("simt", torch.bfloat16),
                 ("simt", torch.float32)]
WINDOW_SIZES = [1, 63, 128, 300]          # 300 >= every S below
WINDOW_SEQ = [65, 129, 300]


def _windowed(fa, q, k, v, window, route):
    before = dict(fa.VARIANT_LAUNCHES)
    out = fa.flash_attention_call(q, k, v, True, window=window,
                                  route="simt" if route == "simt" else None)
    torch.cuda.synchronize()
    ran = [r for r in fa.VARIANTS if fa.VARIANT_LAUNCHES[r] > before[r]]
    assert ran == [route], ran
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("s", WINDOW_SEQ)
@pytest.mark.parametrize("window", WINDOW_SIZES)
@pytest.mark.parametrize("route,dtype", WINDOW_ROUTES,
                         ids=["wgmma-bf16", "simt-bf16", "simt-f32"])
def test_flash_attention_window_vs_plain(route, dtype, window, s):
    """Windows of 1 key, below one tile, one tile and past S at ragged S
    (hd 128, GQA 2:1) on both kernels against the plain version's band
    mask; a window >= S gives causal attention's bits."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(2, s, 4, 2, 128, dtype, seed=window + s)
    got = _windowed(fa, q, k, v, window, route)
    want = fa.flash_attention_plain(q, k, v, True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if window >= s:
        causal = fa.flash_attention_call(q, k, v, True,
                                         route="simt" if route == "simt" else None)
        assert torch.equal(got, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 63, 200])
def test_flash_attention_window_wgmma_head_dim_64(window):
    """The wgmma route at hd 64 with a window, a ragged S of 257."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(1, 257, 4, 1, 64, torch.bfloat16, seed=window)
    got = _windowed(fa, q, k, v, window, "wgmma")
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, True, window=window).float(),
        **FLASH_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "wgmma")],
                         ids=["f32-simt", "bf16-wgmma"])
def test_flash_attention_window_gradients_and_vmap(dtype, route):
    """``FlashAttention`` with a window: autograd (K8 forward, the plain
    backward) against autograd of the plain version, and ``vmap(grad)``
    over 3 workers with one launch on the folded batch against a loop of
    per-worker gradients; each gradient within the route's forward
    tolerance of its largest entry."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    window, s = 37, 150
    q, k, v = (x.requires_grad_(True)
               for x in _flash_inputs(2, s, 4, 2, 64, dtype, seed=5))
    g = torch.Generator(device="cuda").manual_seed(2)
    dout = torch.randn((2, s, 4, 64), generator=g, device="cuda").to(dtype)
    before = dict(fa.VARIANT_LAUNCHES)
    got = torch.autograd.grad(fa.FlashAttention.apply(q, k, v, True, window),
                              (q, k, v), dout)
    assert fa.VARIANT_LAUNCHES[route] == before[route] + 1
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, True, window=window),
                               (q, k, v), dout)
    tol = FLASH_TOL[dtype]["rtol"]
    for name, a, b in zip("qkv", got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)

    w, d = 3, 96
    x = torch.randn((w, 2, s, d), generator=g, device="cuda").to(dtype)
    params = {n: (torch.randn((d, m * 64), generator=g, device="cuda")
                  * d ** -0.5).to(dtype) for n, m in (("wq", 4), ("wk", 2), ("wv", 2))}

    def loss(p, xb):
        qq = (xb @ p["wq"]).reshape(2, s, 4, 64)
        kk = (xb @ p["wk"]).reshape(2, s, 2, 64)
        vv = (xb @ p["wv"]).reshape(2, s, 2, 64)
        return torch.sum(fa.FlashAttention.apply(qq, kk, vv, True, window).float() ** 2)

    before = dict(fa.VARIANT_LAUNCHES)
    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, x)
    assert sum(fa.VARIANT_LAUNCHES.values()) == sum(before.values()) + 1
    for i in range(w):
        for n, one in torch.func.grad(loss)(params, x[i]).items():
            err = float((batched[n][i].float() - one.float()).abs().max())
            assert err <= tol * float(one.float().abs().max()), (i, n, err)


@pytest.mark.gpu
def test_flash_attention_window_refuses_bidirectional():
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(1, 8, 2, 1, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_call(q, k, v, False, window=4)
