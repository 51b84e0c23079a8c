"""The decentralized slice of the PyTorch port against the JAX reference.

Graphs and schedules are numpy in both packages and must agree exactly.
The masked rules, the per-edge exchange and whole decentralized steps get
the same numpy inputs in both packages, on the CPU, where kernels K2, K3
and K7 run as their plain PyTorch versions (held against the reference's
``ref.py`` and its Pallas K7 in interpret mode here, and against the CUDA
kernels by ``tests/test_torch_gpu.py``).  Each test states its tolerance:
1e-6 for the mean and order rules (float32, sums in another order), 1e-5
for the Weiszfeld rules (a float32 iteration whose stop may fall one
iteration apart), 1e-4 relative for ten training steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RobustConfig as JConfig
from repro.core import aggregators as jagg
from repro.core import attacks as jattacks
from repro.core import make_federated_step as j_make_step
from repro.core import packing as jpacking
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import mnist_like as j_mnist_like
from repro.data import partition as j_partition
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import get_optimizer as j_get_optimizer
from repro import topology as jtopo
from repro.topology import masked as jmasked
from repro_torch import convert
from repro_torch import topology as topo
from repro_torch.core import RobustConfig, make_federated_step, packing
from repro_torch.core import aggregators
from repro_torch.data import logreg_loss
from repro_torch.kernels import ops, ref
from repro_torch.kernels import topology as tp
from repro_torch.kernels import weiszfeld as wz
from repro_torch.models import paper_nn
from repro_torch.optim import get_optimizer
from repro_torch.topology import masked

RULE_TOL = {"geomed": 1e-5, "geomed_groups": 1e-5, "geomed_blockwise": 1e-5}
OPTS = dict(max_iters=200, tol=1e-7, num_groups=3, trim=1, num_byzantine=1,
            clip_radius=2.0)
# Two leaves for geomed_blockwise: a (4, 5) matrix and a (10,) vector.
LEAVES = {"a": (4, 5), "b": (10,)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _graph(name, n=9):
    return (jtopo.get_topology(name, n, seed=3, p=0.5),
            topo.get_topology(name, n, seed=3, p=0.5))


def _exchange(n=9, d=30, seed=0, ties=True):
    """(N, N, D) exchange: an honest cloud per receiver, two far senders,
    and (with ``ties``) values on a 0.5 grid so that equal values occur."""
    rng = np.random.default_rng(seed)
    ex = 0.6 * rng.standard_normal((n, n, d)).astype(np.float32) + 1.0
    ex[:, -2:] = -3.0 + rng.standard_normal((n, 2, d)).astype(np.float32)
    if ties:
        ex = np.round(ex * 2.0) / 2.0
    return ex


# -- graphs and schedules -------------------------------------------------------

@pytest.mark.parametrize("name,n", [(name, n) for name in jtopo.TOPOLOGY_NAMES
                                    for n in (8, 12)])
def test_graphs_match_reference(name, n):
    """Exact: adjacency, mask, mixing, degrees, min_neighborhood and the
    report (the spectral gap to 1e-12, both from numpy's eigvalsh)."""
    j = jtopo.get_topology(name, n, seed=5, p=0.4)
    t = topo.get_topology(name, n, seed=5, p=0.4)
    np.testing.assert_array_equal(t.adjacency, j.adjacency)
    np.testing.assert_array_equal(t.neighbor_mask, j.neighbor_mask)
    np.testing.assert_array_equal(t.mixing, j.mixing)
    np.testing.assert_array_equal(t.degrees, j.degrees)
    assert t.min_neighborhood == j.min_neighborhood
    jd, td = j.describe(), t.describe()
    assert td.pop("spectral_gap") == pytest.approx(jd.pop("spectral_gap"),
                                                   abs=1e-12)
    assert td == jd


@pytest.mark.parametrize("seed", [0, 1, 7, 23490])
def test_erdos_renyi_adjacency_matches_reference(seed):
    """The same SeedSequence([N, seed]) stream: the same graph, also with
    the redraws of a sparse p."""
    for n, p in ((11, 0.5), (20, 0.2), (70, 0.5)):
        j = jtopo.erdos_renyi(n, p=p, seed=seed)
        t = topo.erdos_renyi(n, p=p, seed=seed)
        np.testing.assert_array_equal(t.adjacency, j.adjacency)


def _schedules(n=9):
    return {
        "static": lambda m: m.get_schedule("static", n, topology="torus2d"),
        "cyclic": lambda m: m.get_schedule("cyclic", n,
                                           topology="ring,complete,erdos_renyi",
                                           seed=2, p=0.4),
        "erdos_renyi": lambda m: m.get_schedule("erdos_renyi", n, p=0.4,
                                                seed=4, period=5),
    }


@pytest.mark.parametrize("kind", ["static", "cyclic", "erdos_renyi"])
def test_schedules_match_reference(kind):
    """Exact stacks, names, periods, neighbourhoods and window
    connectivity; the joint gap to 1e-12; the device stacks index by the
    step modulo the period, as views of the stack moved once."""
    build = _schedules()[kind]
    j, t = build(jtopo), build(topo)
    assert (t.name, t.period, t.min_neighborhood) == (j.name, j.period,
                                                      j.min_neighborhood)
    np.testing.assert_array_equal(t.stacked_masks, j.stacked_masks)
    np.testing.assert_array_equal(t.stacked_mixing, j.stacked_mixing)
    assert t.is_connected_over_window() == j.is_connected_over_window()
    assert t.joint_spectral_gap() == pytest.approx(j.joint_spectral_gap(),
                                                   abs=1e-12)
    stacks = t.on("cpu")
    for step in range(2 * t.period + 1):
        np.testing.assert_array_equal(stacks.mask_at(step).numpy(),
                                      np.asarray(j.mask_at(step)))
        np.testing.assert_array_equal(stacks.mixing_at(step).numpy(),
                                      np.asarray(j.mixing_at(step)))
        assert stacks.mask_at(step).data_ptr() == \
            stacks.masks[step % t.period].data_ptr()


def test_spectral_gap_fault_of_the_reference_is_not_copied():
    """ROADMAP Queue C: this schedule has a disconnected round whose
    reference gap is -2.2e-16 (eigvalsh overshoot).  The port clamps every
    per-round gap to [0, 1] and otherwise agrees to 1e-12."""
    args = dict(p=0.5, seed=23490, period=5)
    j = jtopo.get_schedule("erdos_renyi", 11, **args)
    t = topo.get_schedule("erdos_renyi", 11, **args)
    gaps = [r.spectral_gap() for r in t.topologies]
    assert all(0.0 <= g <= 1.0 for g in gaps), gaps
    assert min(r.spectral_gap() for r in j.topologies) < 0.0
    np.testing.assert_allclose(
        gaps, np.clip([r.spectral_gap() for r in j.topologies], 0.0, 1.0),
        rtol=0, atol=1e-12)
    assert 0.0 <= t.joint_spectral_gap() <= 1.0


@pytest.mark.parametrize("case", ["nodes", "window", "trim"])
def test_validate_schedule_errors_match_reference(case):
    """The same ValueError text for a node-count mismatch, a schedule
    disconnected over its window, and an infeasible trim."""
    def run(m, cfg_cls):
        if case == "nodes":
            return m.validate_schedule(cfg_cls(), m.get_schedule(
                "static", 6, topology="ring"), 7)
        if case == "window":
            return m.validate_schedule(cfg_cls(), m.get_schedule(
                "erdos_renyi", 12, p=0.02, seed=1, period=2), 12)
        return m.validate_schedule(
            cfg_cls(aggregator="trimmed_mean", trim=2),
            m.get_schedule("static", 8, topology="ring"), 8)

    msgs = []
    for m, cfg_cls in ((jtopo, JConfig), (topo, RobustConfig)):
        with pytest.raises(ValueError) as err:
            run(m, cfg_cls)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- kernels K7 and the receiver-batched K2/K3 ------------------------------------

@pytest.mark.parametrize("graph,trim", [("ring", 0), ("ring", 1),
                                        ("erdos_renyi", 0), ("erdos_renyi", 1),
                                        ("erdos_renyi", 2), ("complete", 2)])
def test_masked_neighbor_reduce_plain_matches_reference(graph, trim):
    """K7's plain version against the reference's sort-based oracle and its
    Pallas kernel in interpret mode, 7 x 7 x 300 with ties (1e-6), and
    against the port's own oracle (a ring neighbourhood of 3 takes trim
    <= 1)."""
    mask = _graph(graph, 7)[1].neighbor_mask
    ex = _exchange(7, 300, seed=trim)
    got = tp.masked_neighbor_reduce_plain(_t(ex), _t(mask), trim).numpy()
    want = np.asarray(jref.masked_neighbor_reduce(jnp.asarray(ex),
                                                  jnp.asarray(mask), trim))
    pallas = np.asarray(jops.masked_neighbor_reduce(
        jnp.asarray(ex), jnp.asarray(mask), trim=trim, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ref.masked_neighbor_reduce(_t(ex), _t(mask), trim).numpy(), want,
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ops.masked_neighbor_reduce(_t(ex), _t(mask), trim=trim).numpy(), want,
        rtol=1e-6, atol=1e-6)


def test_masked_neighbor_reduce_checks_its_inputs():
    ex, mask = torch.zeros(3, 4, 5), torch.ones(3, 4)
    with pytest.raises(TypeError, match="float32"):
        ops.masked_neighbor_reduce(ex.double(), mask)
    with pytest.raises(ValueError, match="do not agree"):
        ops.masked_neighbor_reduce(ex, torch.ones(3, 3))
    with pytest.raises(ValueError, match="trim"):
        ops.masked_neighbor_reduce(ex, mask, trim=-1)
    with pytest.raises(ValueError, match="CUDA"):
        tp.masked_neighbor_reduce_call(ex, mask, 0)


def test_batched_weiszfeld_plain_sweeps_match_reference_per_receiver():
    """The receiver-batched K2/K3 plain versions give, row by row, the
    reference oracles' unbatched results (1e-6), also on a column slice
    and on a broadcast exchange (receiver stride 0)."""
    rng = np.random.default_rng(2)
    ex = rng.standard_normal((5, 6, 40)).astype(np.float32)
    y = rng.standard_normal((5, 40)).astype(np.float32)
    a = rng.random((5, 6)).astype(np.float32)
    sq = ops.partial_sqdist(_t(ex), _t(y)).numpy()
    ws = ops.weighted_sum(_t(ex), _t(a)).numpy()
    for r in range(5):
        np.testing.assert_allclose(
            sq[r], np.asarray(jref.partial_sqdist(ex[r], y[r])), rtol=1e-6)
        np.testing.assert_allclose(
            ws[r], np.asarray(jref.weighted_sum(ex[r], a[r])) * a[r].sum(),
            rtol=1e-5, atol=1e-6)
    cols = _t(ex)[:, :, 10:25]
    np.testing.assert_allclose(
        ops.partial_sqdist(cols, _t(y[:, 10:25])).numpy(),
        ops.partial_sqdist(cols.contiguous(), _t(y[:, 10:25])).numpy())
    shared = _t(ex[0])[None].expand(5, 6, 40)
    assert wz.batch_strides(shared) == (5, 40, 0)
    assert wz.batch_strides(cols) == (5, 40, 240)
    np.testing.assert_allclose(ops.weighted_sum(shared, _t(a)).numpy(),
                               (a @ ex[0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r", [1, 5])
def test_partial_sqdist_plain_with_mask_matches_reference(r):
    """K2's masked form: exactly 0 where mask <= 0 (a receiver with no
    member too), the reference's per-(receiver, sender) distances
    (``masked._sqdist_partials``) on the mask; the same through ``ops`` on
    a column slice, and as an unbatched (W,) mask."""
    rng = np.random.default_rng(r)
    ex = rng.standard_normal((r, 9, 40)).astype(np.float32)
    y = rng.standard_normal((r, 40)).astype(np.float32)
    mask = (rng.random((r, 9)) < 0.5).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1, 3] = -1.0                  # not > 0: no member
    if r > 1:
        mask[0] = 0.0
    got = ops.partial_sqdist(_t(ex), _t(y), _t(mask)).numpy()
    want = np.asarray(jmasked._sqdist_partials(jnp.asarray(ex), jnp.asarray(y)))
    np.testing.assert_array_equal(got[mask <= 0], 0.0)
    np.testing.assert_allclose(got[mask > 0], want[mask > 0], rtol=1e-6)
    cols = _t(ex)[:, :, 5:30]
    np.testing.assert_array_equal(
        ops.partial_sqdist(cols, _t(y[:, 5:30]), _t(mask)).numpy(),
        wz.partial_sqdist_plain(cols.contiguous(), _t(y[:, 5:30]), _t(mask)).numpy())
    np.testing.assert_array_equal(
        ops.partial_sqdist(_t(ex[-1]), _t(y[-1]), _t(mask[-1])).numpy(), got[-1])
    with pytest.raises(TypeError, match="float32"):
        ops.partial_sqdist(_t(ex), _t(y), _t(mask).double())
    with pytest.raises(ValueError, match="does not match"):
        ops.partial_sqdist(_t(ex), _t(y), _t(mask[:, :5]))


def test_masked_kernel_wrappers_refuse_cpu_tensors():
    """K7 and K2's masked route launch on the card or raise: a CPU tensor
    never reaches a plain version through them, and counts nothing."""
    ex = torch.randn(3, 5, 8)
    mask = torch.ones(3, 5)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tp.masked_neighbor_reduce_call(ex, mask, 1)
    with pytest.raises(ValueError, match="CUDA"):
        wz.partial_sqdist_call(ex, ex.mean(1), mask)
    assert tp.ROUTE_LAUNCHES == {"sum": 0, "select": 0, "rank": 0}
    assert wz.SQDIST_ROUTE_LAUNCHES == {"unmasked": 0, "masked": 0}


def test_unbatched_sweeps_keep_their_shapes():
    z, y, a = torch.randn(7, 30), torch.randn(30), torch.rand(7)
    assert ops.partial_sqdist(z, y).shape == (7,)
    assert ops.weighted_sum(z, a).shape == (30,)
    with pytest.raises(ValueError, match="do not agree"):
        ops.partial_sqdist(z[None], y)


# -- the masked engine --------------------------------------------------------------

def _engine_inputs(graph, ties):
    j_t, t_t = _graph(graph)
    mask = t_t.neighbor_mask
    mixing = (t_t.mixing * mask).astype(np.float32)
    ex = _exchange(ties=ties)
    shapes = {k: jnp.zeros(v) for k, v in LEAVES.items()}
    jspec = jpacking.pack_spec(shapes, batch_ndim=0)
    tspec = packing.pack_spec({k: torch.zeros(v) for k, v in LEAVES.items()},
                              batch_ndim=0)
    return ex, mask, mixing, jspec, tspec


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("graph", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("rule", aggregators.AGGREGATOR_NAMES)
def test_masked_rules_match_reference(rule, graph, ties):
    """Every rule of the flat masked engine on the same (9, 9, 30)
    exchange and mask: 1e-6 for mean (with mixing) and the order rules,
    1e-5 for the Weiszfeld rules."""
    ex, mask, mixing, jspec, tspec = _engine_inputs(graph, ties)
    want = np.asarray(jmasked.masked_aggregate_flat(
        rule, jnp.asarray(ex), jnp.asarray(mask), spec=jspec,
        mixing=jnp.asarray(mixing), **OPTS))
    got = masked.masked_aggregate_flat(rule, _t(ex), _t(mask), spec=tspec,
                                       mixing=_t(mixing), **OPTS).numpy()
    tol = RULE_TOL.get(rule, 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_masked_weiszfeld_runs_the_reference_iterations():
    """One stop for all receivers: the same iteration count as the
    reference's lockstep loop, and the same residual to 1e-5."""
    ex, mask, *_ = _engine_inputs("erdos_renyi", False)
    _, jinfo = jmasked.masked_weiszfeld(jnp.asarray(ex), jnp.asarray(mask),
                                        max_iters=100, tol=1e-5,
                                        return_info=True)
    _, info = masked.masked_weiszfeld(_t(ex), _t(mask), max_iters=100,
                                      tol=1e-5, return_info=True)
    assert info.iters == int(jinfo.iters)
    assert info.residual == pytest.approx(float(jinfo.residual), abs=1e-5)


@pytest.mark.parametrize("rule,trim", [("trimmed_mean", 1), ("trimmed_mean", 12),
                                       ("trimmed_mean", 20), ("geomed", 0)])
def test_masked_rules_match_reference_past_450_senders(rule, trim):
    """455 senders (past the 450 whose (S, 128) slab fits one block's
    shared memory), 4 receivers, narrow D, with ties: the masked trimmed
    mean and geometric median agree with the reference's jnp engine (1e-6;
    1e-5 for the Weiszfeld rule)."""
    rng = np.random.default_rng(trim)
    ex = np.round(2.0 * rng.standard_normal((4, 455, 6))).astype(np.float32) / 2
    ex[:, :30] -= 40.0
    mask = (rng.random((4, 455)) < 0.6).astype(np.float32)
    mask[:, :50] = 1.0
    opts = dict(trim=trim, max_iters=200, tol=1e-7)
    want = np.asarray(jmasked.masked_aggregate_flat(
        rule, jnp.asarray(ex), jnp.asarray(mask), **opts))
    got = masked.masked_aggregate_flat(rule, _t(ex), _t(mask), **opts).numpy()
    tol = RULE_TOL.get(rule, 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_masked_weiszfeld_sends_its_mask_to_the_distance_sweep(monkeypatch):
    """Every K2 call of the masked solve carries the neighbour mask, so on
    the card it takes the masked route and reads only the neighbours' rows;
    the answer is the reference's."""
    seen = []
    real = ops.partial_sqdist

    def spy(z, y, mask=None):
        seen.append(mask)
        return real(z, y, mask)

    monkeypatch.setattr(ops, "partial_sqdist", spy)
    ex, mask, *_ = _engine_inputs("erdos_renyi", False)
    got = masked.masked_weiszfeld(_t(ex), _t(mask), max_iters=30, tol=0.0)
    want = jmasked.masked_weiszfeld(jnp.asarray(ex), jnp.asarray(mask),
                                    max_iters=30, tol=0.0)
    assert len(seen) == 30
    assert all(m is not None and torch.equal(m, _t(mask)) for m in seen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _poisoned_exchange():
    """The (9, 9, 30) erdos_renyi exchange and mask, and a copy in which
    a mask-0 sender's row of every receiver that has one holds inf (and
    NaN further along)."""
    ex, mask, *_ = _engine_inputs("erdos_renyi", False)
    bad = ex.copy()
    off = mask == 0
    assert off.any()
    bad[off, :4] = np.inf
    bad[off, 4:6] = -np.inf
    bad[off, 6:8] = np.nan
    return ex, bad, mask, off.any(axis=1)


@pytest.mark.parametrize("rule", ["mean", "geomed"])
def test_mask_zero_non_finite_row_fault_of_the_reference_is_not_copied(rule):
    """ROADMAP Queue C: the reference's masked engine promises that mask-0
    senders do not influence a receiver's result (repro/topology/masked.py),
    but its ``_weighted_mean`` computes ``0 * inf``, so a non-member's row
    holding inf gives NaN.  The port keeps the promise on its plain path as
    its kernels do on the card: the result is finite and equal to the
    result without those rows (the clean exchange), which is the
    reference's clean result (1e-6; 1e-5 for the Weiszfeld rule)."""
    ex, bad, mask, hit = _poisoned_exchange()
    opts = dict(max_iters=200, tol=1e-7)
    ref_bad = np.asarray(jmasked.masked_aggregate_flat(
        rule, jnp.asarray(bad), jnp.asarray(mask), **opts))
    ref_clean = np.asarray(jmasked.masked_aggregate_flat(
        rule, jnp.asarray(ex), jnp.asarray(mask), **opts))
    assert np.isnan(ref_bad[hit][:, :8]).all()
    got = masked.masked_aggregate_flat(rule, _t(bad), _t(mask), **opts)
    clean = masked.masked_aggregate_flat(rule, _t(ex), _t(mask), **opts)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    tol = RULE_TOL.get(rule, 1e-6)
    np.testing.assert_allclose(got.numpy(), ref_clean, rtol=tol, atol=tol)


def test_plain_sweeps_leave_out_non_finite_zero_weight_rows():
    """The plain versions as the kernels: K3's zero-weight rows and the
    masked K2's mask-0 rows contribute nothing even when they hold inf or
    NaN (equal to the result without those rows), and K7 never keeps a
    non-member's value; a member's NaN sorts above +inf, so it is dropped
    among the trim largest and kept (NaN out) with trim 0."""
    ex, bad, mask, hit = _poisoned_exchange()
    y = ex.mean(axis=1)
    np.testing.assert_array_equal(
        ops.weighted_sum(_t(bad), _t(mask)).numpy(),
        ops.weighted_sum(_t(ex), _t(mask)).numpy())
    assert bool(torch.isnan(torch.bmm(_t(mask)[:, None], _t(bad))).any())
    keep = mask[0] > 0
    np.testing.assert_allclose(
        ops.weighted_sum(_t(bad[0]), _t(mask[0])).numpy(),
        ops.weighted_sum(_t(bad[0][keep]), _t(mask[0][keep])).numpy(),
        rtol=1e-6, atol=1e-6)
    sq = ops.partial_sqdist(_t(bad), _t(y), _t(mask)).numpy()
    np.testing.assert_array_equal(sq, ops.partial_sqdist(
        _t(ex), _t(y), _t(mask)).numpy())
    for trim in (0, 1):
        np.testing.assert_array_equal(
            ops.masked_neighbor_reduce(_t(bad), _t(mask), trim=trim).numpy(),
            ops.masked_neighbor_reduce(_t(ex), _t(mask), trim=trim).numpy())
    member = int(np.argmax(mask[0]))
    nan_member = bad.copy()
    nan_member[0, member, 10:12] = np.nan
    for trim, want_nan in ((0, True), (1, False)):
        got = ops.masked_neighbor_reduce(_t(nan_member), _t(mask), trim=trim)
        assert bool(torch.isnan(got[0, 10:12]).all()) == want_nan
        assert bool(torch.isfinite(got[0, 12:]).all())


def test_masked_registry_pins_the_reference_names():
    assert set(masked.MASKED_AGGREGATOR_NAMES) == set(
        jmasked.MASKED_AGGREGATOR_NAMES)
    assert set(masked.MASKED_AGGREGATOR_NAMES) == set(
        aggregators._FLAT_REGISTRY) == set(jagg._FLAT_REGISTRY)
    assert topo.TOPOLOGY_NAMES == jtopo.TOPOLOGY_NAMES
    assert topo.SCHEDULE_NAMES == jtopo.SCHEDULE_NAMES
    assert topo.GOSSIP_MODES == jtopo.GOSSIP_MODES
    ex, mask = torch.zeros(3, 3, 4), torch.ones(3, 3)
    out, diag = masked.masked_aggregate_flat("geomed", ex, mask,
                                             diagnostics=True)
    assert out.shape == (3, 4) and diag.dist.shape == (3, 3)
    with pytest.raises(ValueError, match="unknown masked aggregator"):
        masked.masked_aggregate_flat("nope", ex, mask)
    with pytest.raises(ValueError, match="spec="):
        masked.masked_aggregate_flat("geomed_blockwise", ex, mask)


# -- the per-edge exchange ----------------------------------------------------------

@pytest.mark.parametrize("attack", ["none", "gaussian", "sign_flip",
                                    "zero_gradient", "alie", "ipm"])
def test_build_exchange_matches_reference(attack):
    """Per-edge attacks from each receiver's masked honest statistics
    (1e-5: the reference sums the neighbourhood in another order); the
    gaussian case takes the reference's per-edge draws."""
    n, wh, d = 9, 7, 30
    mask = _graph("erdos_renyi")[1].neighbor_mask
    rng = np.random.default_rng(4)
    msgs = rng.standard_normal((n, d)).astype(np.float32)
    msgs[wh:] = 0.0
    is_byz = np.arange(n) >= wh
    kw = dict(attack=attack, num_byzantine=n - wh if attack != "none" else 0)
    key = jax.random.PRNGKey(8)
    spec = jpacking.pack_spec({"w": jnp.zeros(d)}, batch_ndim=0)
    want = np.asarray(jtopo.build_exchange(
        jnp.asarray(msgs), JConfig(**kw).attack_config(), jnp.asarray(mask),
        jnp.asarray(is_byz), key, spec=spec))
    noise = None
    if attack == "gaussian":
        noise = _t(jattacks.packed_gaussian_noise(spec, key, (n, n), 1.0))
    got = topo.build_exchange(_t(msgs), RobustConfig(**kw).attack_config(),
                              _t(mask), _t(is_byz), noise=noise)
    assert got.shape == (n, n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attack", ["straggler", "dropout", "nan",
                                    "inf_overflow", "bitflip"])
def test_build_exchange_unported_attacks_raise(attack):
    """The five per-edge attacks that raised before participation and the
    guards were ported now build the reference's exchange (NaN where it has
    NaN; bitflip's corrupted coordinates bit for bit)."""
    n, wh, d = 9, 7, 30
    mask = _graph("erdos_renyi")[1].neighbor_mask
    rng = np.random.default_rng(4)
    msgs = rng.standard_normal((n, d)).astype(np.float32)
    msgs[wh:] = 0.0
    is_byz = np.arange(n) >= wh
    kw = dict(attack=attack, num_byzantine=n - wh, bitflip_prob=0.3)
    spec = jpacking.pack_spec({"w": jnp.zeros(d - 5), "b": jnp.zeros(5)},
                              batch_ndim=0)
    want = np.asarray(jtopo.build_exchange(
        jnp.asarray(msgs), JConfig(**kw).attack_config(), jnp.asarray(mask),
        jnp.asarray(is_byz), None, spec=spec))
    tspec = packing.pack_spec({"w": torch.zeros(d - 5), "b": torch.zeros(5)},
                              batch_ndim=0)
    got = topo.build_exchange(_t(msgs), RobustConfig(**kw).attack_config(),
                              _t(mask), _t(is_byz), spec=tspec).numpy()
    assert got.shape == (n, n, d)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


# -- whole decentralized steps ------------------------------------------------------

def _j_nn_loss(params, batch):
    """benchmarks/table1_nn.py:nn_loss (benchmarks/ is no package)."""
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    tgt = jnp.take_along_axis(logits, batch["y"][:, None].astype(jnp.int32),
                              1)[:, 0]
    return jnp.mean(lse - tgt)


@functools.lru_cache(maxsize=None)
def _problem(name):
    """(jax loss, torch loss, worker data as numpy, params as numpy, W_h, B, lr)."""
    if name == "logreg":
        data = j_ijcnn1_like(jax.random.PRNGKey(0), n=600)
        wd = j_partition({"a": data.x, "b": data.y}, 8, seed=1)
        return (j_logreg_loss(0.01), logreg_loss(0.01), wd,
                {"w": np.zeros(22, np.float32)}, 8, 2, 0.05)
    data = j_mnist_like(jax.random.PRNGKey(0), n=80)
    wd = j_partition({"x": data.x, "y": data.y}, 4, seed=2)
    rng = np.random.default_rng(7)
    params = {"w1": 0.05 * rng.standard_normal((784, 8)).astype(np.float32),
              "b1": np.zeros(8, np.float32),
              "w2": 0.05 * rng.standard_normal((8, 10)).astype(np.float32),
              "b2": np.zeros(10, np.float32)}
    return _j_nn_loss, paper_nn.nn_loss, wd, params, 4, 2, 0.1


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


# (problem, cfg, steps): five jitted reference runs in all.
STEP_CASES = {
    "ring-geomed-gradient": ("logreg", dict(
        aggregator="geomed", attack="sign_flip", topology="ring")),
    "ring-geomed-params": ("logreg", dict(
        aggregator="geomed", attack="sign_flip", topology="ring",
        gossip="params")),
    "ring-trimmed_mean": ("logreg", dict(
        aggregator="trimmed_mean", attack="alie", topology="ring", trim=1)),
    "erdos_renyi-schedule-mean": ("logreg", dict(
        aggregator="mean", attack="ipm", schedule="erdos_renyi",
        topology_p=0.4, schedule_period=3)),
    "nn-complete-blockwise-gaussian": ("nn", dict(
        aggregator="geomed_blockwise", attack="gaussian", topology="complete",
        gossip="params")),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_decentralized_step_parity_with_reference(case):
    """Ten decentralized steps from the reference's init state (carried over
    by ``convert.state_from_jax``) with the reference's sample draws (and
    per-edge gaussian draws) handed in: per-node params and both metrics
    agree to rtol 1e-4 / atol 1e-5."""
    problem, extra = STEP_CASES[case]
    j_loss, t_loss, wd, params, wh, b, lr = _problem(problem)
    cfg = dict(vr="saga", num_byzantine=b, weiszfeld_iters=32, **extra)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", lr))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", lr), device="cpu")
    j_state = j_init({k: jnp.asarray(v) for k, v in params.items()},
                     jax.random.PRNGKey(5))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    n = wh + b
    assert t_state.vr.table.shape[0] == wh
    assert all(v.shape[0] == n for v in t_state.params.values())
    spec = jpacking.pack_spec({k: jnp.asarray(v) for k, v in params.items()},
                              batch_ndim=0)
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    edge_noise = jax.jit(
        lambda k: jattacks.packed_gaussian_noise(spec, k, (n, n), 1.0))
    for _ in range(10):
        _, k_idx, k_attack = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (wh,), 0, j))
        noise = None
        if cfg["attack"] == "gaussian":
            noise = _t(edge_noise(k_attack))
        j_state, j_metrics = j_step(j_state)
        t_state, t_metrics = t_step(t_state, sample_idx=idx, attack_noise=noise)
    for k in params:
        np.testing.assert_allclose(t_state.params[k].numpy(),
                                   np.asarray(j_state.params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("honest_variance", "consensus_dist"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    assert t_state.step == 10


def _logreg_step(**cfg):
    """The port's step builder on the logistic regression, on the CPU."""
    _, t_loss, wd, _, _, _, _ = _problem("logreg")
    return make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                               get_optimizer("sgd", 0.05), device="cpu")


@pytest.mark.parametrize("route", ["name", "graph", "schedule", "params"])
def test_star_static_stays_the_master_path(route):
    """Star + static -- by name, as a built graph, as a built static
    schedule, or in params-gossip mode -- is the master path: no node axis,
    and bitwise the default step's params."""
    _, t_loss, wd, _, _, _, _ = _problem("logreg")
    cfg = dict(aggregator="geomed", vr="saga", attack="sign_flip",
               num_byzantine=2)
    routes = {"name": (dict(topology="star"), {}),
              "graph": ({}, dict(topology=topo.star(10))),
              "schedule": ({}, dict(schedule=topo.static_schedule(topo.star(10)))),
              "params": (dict(gossip="params"), {})}
    outs = []
    for extra_cfg, kwargs in (({}, {}), routes[route]):
        init, step = make_federated_step(
            t_loss, _numpy(wd), RobustConfig(**cfg, **extra_cfg),
            get_optimizer("sgd", 0.05), device="cpu", **kwargs)
        st = init({"w": torch.zeros(22)}, 0)
        for i in range(3):
            st, _ = step(st, sample_idx=np.full(8, i))
        outs.append(st.params["w"])
    assert outs[0].shape == (22,)
    assert torch.equal(outs[0], outs[1])


def test_decentralized_errors_raise():
    """Infeasible trim, a node-count mismatch, a window-disconnected
    schedule, an unknown gossip mode, and the features of later slices."""
    with pytest.raises(ValueError, match="trimmed_mean"):
        _logreg_step(aggregator="trimmed_mean", trim=2, attack="ipm",
                     num_byzantine=2, topology="ring")
    _, t_loss, wd, _, _, _, _ = _problem("logreg")
    with pytest.raises(ValueError, match="nodes"):
        make_federated_step(t_loss, _numpy(wd), RobustConfig(vr="sgd"),
                            get_optimizer("sgd", 0.05), device="cpu",
                            topology=topo.get_topology("ring", 5))
    with pytest.raises(ValueError, match="disconnected over its window"):
        _logreg_step(schedule="erdos_renyi", topology_p=0.02,
                     schedule_period=2)
    with pytest.raises(ValueError, match="gossip"):
        _logreg_step(topology="ring", gossip="both")
    # comm names the distributed path; the simulated decentralized step
    # ignores it, as the reference's does.
    assert RobustConfig(topology="ring", comm="sharded").comm == "sharded"
    with pytest.raises(ValueError, match="needs the packed path"):
        _logreg_step(topology="ring", packed=False, message_dtype="int8")


def test_decentralized_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    _, t_loss, wd, _, _, _, _ = _problem("logreg")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_federated_step(t_loss, _numpy(wd), RobustConfig(topology="ring"),
                            get_optimizer("sgd", 0.05))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topo.make_decentralized_step(t_loss, _numpy(wd), RobustConfig(),
                                     get_optimizer("sgd", 0.05),
                                     topo.ring(8))


def test_decentralized_step_draws_its_own_samples_and_noise():
    """Without injected draws the step uses its generator; two runs from
    the same seed agree bitwise, per-node params differ across nodes."""
    outs = []
    for _ in range(2):
        init, step = _logreg_step(aggregator="trimmed_mean", attack="gaussian",
                                  num_byzantine=2, topology="torus2d", trim=1)
        st = init({"w": torch.zeros(22)}, 4)
        for _ in range(4):
            st, metrics = step(st)
        outs.append(st.params["w"])
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == (10, 22)
    assert float(metrics["consensus_dist"]) > 0.0
