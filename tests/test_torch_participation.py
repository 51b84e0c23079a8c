"""The port's partial participation, bounded staleness, K1's client-row
route and loopless SVRG against the JAX reference.

Cohorts, staleness counters and staleness weights match exactly (the cohort
stack is numpy-seeded; the weights use the float32 ``powf`` the reference's
``pow`` calls).  The reducers and whole steps are handed the reference's
sample draws and lsvrg coins and agree to rtol 1e-4 / atol 1e-5 after five
steps (the tolerance of ``tests/test_torch_step.py``); a single lsvrg
correction agrees to rtol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RobustConfig as JConfig
from repro.core import make_federated_step as j_make_step
from repro.core import participation as jpart
from repro.core import saga as jsaga
from repro.core import variance as jvariance
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import partition as j_partition
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch import convert
from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.core import participation, saga, variance
from repro_torch.data import logreg_loss
from repro_torch.kernels import ops
from repro_torch.kernels import saga_correct as sc
from repro_torch.optim import get_optimizer

STEPS = 5


def _t(x):
    return torch.as_tensor(np.array(x))


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


# -- the plan and the counters -------------------------------------------------

@pytest.mark.parametrize("c,w,seed", [(12, 4, 0), (10, 3, 1), (500, 50, 0),
                                      (7, 7, 2), (9, 1, 3)])
def test_stacked_cohorts_match_reference(c, w, seed):
    """The (T, W) cohort stack is the reference's exactly; each cohort has
    W distinct clients and every client takes part in every epoch."""
    got = participation.ParticipationPlan(c, w, seed=seed)
    want = jpart.ParticipationPlan(c, w, seed=seed)
    np.testing.assert_array_equal(got.stacked_cohorts, want.stacked_cohorts)
    assert got.num_rounds == want.num_rounds
    for row in got.stacked_cohorts:
        assert len(set(row.tolist())) == w
    per_epoch = got.rounds_per_epoch
    for e in range(got.epochs):
        rows = got.stacked_cohorts[e * per_epoch:(e + 1) * per_epoch]
        assert set(rows.ravel().tolist()) == set(range(c))
    for t in (0, 1, got.num_rounds + 2):
        np.testing.assert_array_equal(got.cohort_at(t).numpy(),
                                      np.asarray(want.cohort_at(t)))


def test_resolve_participation_rules():
    assert participation.resolve_participation(RobustConfig(), 8) is None
    assert participation.resolve_participation(
        RobustConfig(num_clients=8), 8) is None
    plan = participation.resolve_participation(
        RobustConfig(num_clients=12, cohort_size=4, participation_seed=3), 4)
    assert (plan.num_clients, plan.cohort_size, plan.seed) == (12, 4, 3)
    with pytest.raises(ValueError, match="smaller"):
        participation.resolve_participation(RobustConfig(num_clients=3), 4)
    with pytest.raises(ValueError, match="does not match"):
        participation.resolve_participation(
            RobustConfig(num_clients=12, cohort_size=5), 4)
    assert participation.uses_staleness(RobustConfig(attack="dropout"), None)
    assert not participation.uses_staleness(RobustConfig(attack="nan"), None)


def test_staleness_counters_and_weights_match_reference():
    """tick_staleness, staleness_weights (over decays whose float32 powers
    torch's own pow rounds differently) and slot_staleness: exact."""
    rng = np.random.default_rng(0)
    stal = rng.integers(0, 80, size=30).astype(np.int32)
    cohort = rng.permutation(30)[:7].astype(np.int32)
    np.testing.assert_array_equal(
        participation.tick_staleness(_t(stal), _t(cohort).long()).numpy(),
        np.asarray(jpart.tick_staleness(jnp.asarray(stal), jnp.asarray(cohort))))
    for decay in (1.0, 0.9, 0.75, 0.99, 0.5):
        for max_s in (64, 5, 0):
            want = jpart.staleness_weights(jnp.asarray(stal), decay=decay,
                                           max_staleness=max_s)
            got = participation.staleness_weights(_t(stal), decay=decay,
                                                  max_staleness=max_s)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for attack in ("straggler", "dropout", "sign_flip", "none"):
        want = jpart.slot_staleness(jnp.asarray(stal[:5]), attack, 3,
                                    straggler_k=4, max_staleness=64)
        got = participation.slot_staleness(_t(stal[:5]), attack, 3,
                                           straggler_k=4, max_staleness=64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_scatter_rows_round_trip():
    tab = torch.arange(24.0).reshape(6, 4)
    cohort = torch.tensor([4, 1])
    rows = participation.gather_rows(tab, cohort)
    np.testing.assert_array_equal(rows.numpy(), tab.numpy()[[4, 1]])
    participation.scatter_rows(tab, cohort, -rows)
    assert float(tab[4].sum()) < 0 and float(tab[0].sum()) >= 0
    state = variance.LsvrgState(tab.clone(), tab.clone() * 2)
    held = participation.gather_rows(state, cohort)
    assert isinstance(held, variance.LsvrgState)
    participation.scatter_rows(state, cohort, variance.LsvrgState(
        held.snapshot + 1, held.anchor + 1))
    np.testing.assert_array_equal(state.anchor[cohort].numpy(),
                                  (held.anchor + 1).numpy())
    np.testing.assert_array_equal(state.snapshot[[0, 2, 3, 5]].numpy(),
                                  tab.numpy()[[0, 2, 3, 5]])


# -- K1's client-row route -----------------------------------------------------

@pytest.mark.parametrize("c,j,d,w", [(13, 3, 300, 7), (12, 80, 22, 4)])
def test_k1_client_rows_match_reference_gather_scatter(c, j, d, w):
    """The plain K1 on a (C, J, D) resident table through (W,) distinct
    client rows gives the reference's gather -> saga_correct_scatter ->
    scatter (1e-6), bitwise the worker route on gathered copies, and
    changes only the drawn (row, idx) entries and avg rows."""
    rng = np.random.default_rng(c)
    table = rng.standard_normal((c, j, d)).astype(np.float32)
    avg = table.mean(1)
    g = rng.standard_normal((w, d)).astype(np.float32)
    rows = rng.permutation(c)[:w]
    idx = rng.integers(0, j, size=w)
    t_tab, t_avg = _t(table), _t(avg)
    msg = ops.saga_correct(_t(g), t_tab, t_avg, _t(idx), _t(rows))
    st = jsaga.SagaState(table=jnp.asarray(table[rows]),
                         avg=jnp.asarray(avg[rows]))
    j_msg, j_st = jsaga.saga_correct_scatter(st, jnp.asarray(g),
                                             jnp.asarray(idx))
    np.testing.assert_allclose(msg.numpy(), np.asarray(j_msg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t_tab.numpy()[rows], np.asarray(j_st.table),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_avg.numpy()[rows], np.asarray(j_st.avg),
                               rtol=1e-6, atol=1e-6)
    # Bitwise the worker route on copies of the cohort's rows.
    w_tab, w_avg = _t(table[rows]), _t(avg[rows])
    w_msg = sc.saga_correct_plain(_t(g), w_tab, w_avg, _t(idx))
    assert torch.equal(msg, w_msg)
    assert torch.equal(t_tab[_t(rows)], w_tab)
    assert torch.equal(t_avg[_t(rows)], w_avg)
    # Nothing else moved.
    touched = np.zeros((c, j), bool)
    touched[rows, idx] = True
    np.testing.assert_array_equal(t_tab.numpy()[~touched], table[~touched])
    other = np.setdiff1d(np.arange(c), rows)
    np.testing.assert_array_equal(t_avg.numpy()[other], avg[other])


def test_k1_client_rows_check_shapes_and_refuse_cpu_launch():
    tab, avg = torch.zeros(5, 3, 8), torch.zeros(5, 8)
    g, idx = torch.zeros(2, 8), torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="rows="):
        ops.saga_correct(g, tab, avg, idx)
    with pytest.raises(TypeError, match="int64"):
        ops.saga_correct(g, tab, avg, idx, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not agree"):
        ops.saga_correct(g, tab, avg, idx, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        sc.saga_correct_call(g, tab, avg, idx, torch.tensor([0, 3]))


def test_saga_hold_and_restore_put_back_the_drawn_rows():
    rng = np.random.default_rng(1)
    st = saga.SagaState(table=_t(rng.standard_normal((6, 4, 5)).astype(np.float32)),
                        avg=_t(rng.standard_normal((6, 5)).astype(np.float32)))
    before = (st.table.clone(), st.avg.clone())
    rows, idx = torch.tensor([5, 0, 2]), torch.tensor([1, 3, 3])
    held = saga.held_rows(st, idx, rows)
    saga.saga_correct_scatter(st, torch.ones(3, 5), idx, rows)
    assert not torch.equal(st.table, before[0])
    saga.restore_rows(st, held, idx, rows)
    assert torch.equal(st.table, before[0]) and torch.equal(st.avg, before[1])


# -- loopless SVRG ---------------------------------------------------------------

def test_lsvrg_correct_matches_reference():
    """One correction with the reference's coin: messages, snapshot and
    anchor at rtol 1e-5; only the refreshed workers' rows change."""
    rng = np.random.default_rng(2)
    w, d = 6, 11
    snap = rng.standard_normal((w, d)).astype(np.float32)
    anchor = rng.standard_normal((w, d)).astype(np.float32)
    grads = rng.standard_normal((w, d)).astype(np.float32)
    params = rng.standard_normal((w, d)).astype(np.float32)
    fresh = rng.standard_normal((w, d)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jred = JConfig(vr="lsvrg", lsvrg_p=0.5).reducer()
    j_msgs, j_st, j_m = jred.correct(
        jvariance.LsvrgState(jnp.asarray(snap), jnp.asarray(anchor)),
        jnp.asarray(grads), None, key, params=jnp.asarray(params),
        grads_at=lambda s: jnp.sin(s), full_grads_at=lambda p: jnp.asarray(fresh))
    coin = np.asarray(jax.random.bernoulli(key, 0.5, (w,)))
    assert 0 < coin.sum() < w
    tred = RobustConfig(vr="lsvrg", lsvrg_p=0.5).reducer()
    st = variance.LsvrgState(_t(snap), _t(anchor))
    msgs, st, m = tred.correct(
        st, _t(grads), None, params=_t(params), grads_at=torch.sin,
        full_grads_at=lambda sel: _t(fresh)[sel], coin=_t(coin))
    for got, want in ((msgs, j_msgs), (st.snapshot, j_st.snapshot),
                      (st.anchor, j_st.anchor)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert float(m["vr_snapshot_rate"]) == float(j_m["vr_snapshot_rate"])
    np.testing.assert_array_equal(st.snapshot.numpy()[~coin], snap[~coin])


def test_lsvrg_client_rows_and_hold():
    """With client rows the correction reads and refreshes only the
    cohort's rows of the (C, D) state; hold/restore undo it."""
    rng = np.random.default_rng(3)
    c, w, d = 7, 3, 5
    st = variance.LsvrgState(_t(rng.standard_normal((c, d)).astype(np.float32)),
                             _t(rng.standard_normal((c, d)).astype(np.float32)))
    before = (st.snapshot.clone(), st.anchor.clone())
    rows = torch.tensor([6, 1, 3])
    red = RobustConfig(vr="lsvrg").reducer()
    held = red.hold(st, None, rows)
    msgs, st, _ = red.correct(st, torch.zeros(w, d), None, rows=rows,
                              params=torch.ones(w, d),
                              grads_at=lambda s: s,
                              full_grads_at=lambda sel: 2 * torch.ones(len(sel), d),
                              coin=torch.tensor([True, False, True]))
    torch.testing.assert_close(msgs, before[1][rows] - before[0][rows])
    assert torch.equal(st.snapshot[6], torch.ones(d))
    assert torch.equal(st.anchor[3], 2 * torch.ones(d))
    assert torch.equal(st.snapshot[1], before[0][1])
    red.restore(st, held, None, rows)
    assert torch.equal(st.snapshot, before[0]) and torch.equal(st.anchor, before[1])


# -- whole steps ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _logreg(num_rows):
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=960)
    wd = j_partition({"a": data.x, "b": data.y}, num_rows, seed=1)
    return j_logreg_loss(0.01), logreg_loss(0.01), wd


def _run_pair(cfg, num_rows, wh, *, steps=STEPS, lr=0.05):
    """``steps`` steps of the reference (jitted) and the port (CPU) from
    the reference's init state, the port handed the reference's sample
    draws and lsvrg coins; returns both final states and metrics."""
    j_loss, t_loss, wd = _logreg(num_rows)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", lr))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", lr), device="cpu")
    j_state = j_init({"w": jnp.zeros(22, jnp.float32)}, jax.random.PRNGKey(5))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    for _ in range(steps):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (wh,), 0, j))
        coin = None
        if cfg.get("vr") == "lsvrg":
            coin = np.array(jax.random.bernoulli(
                jax.random.fold_in(k_idx, 1), cfg["lsvrg_p"], (wh,)))
        j_state, j_metrics = j_step(j_state)
        t_state, t_metrics = t_step(t_state, sample_idx=idx, coin=coin)
    return j_state, j_metrics, t_state, t_metrics


def _assert_close(t_state, j_state, t_metrics, j_metrics, keys):
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)
    for leaf_t, leaf_j in zip(t_state.vr, j_state.vr):
        np.testing.assert_allclose(leaf_t.numpy(), np.asarray(leaf_j),
                                   rtol=1e-4, atol=1e-5)
    for k in keys:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("attack", ["straggler", "dropout"])
def test_master_participation_parity_with_reference(attack):
    """C = 12 clients, cohorts of 4 + 2 Byzantine slots, staleness decay
    0.9: the resident (12, 80, D) table through the plain client-row K1,
    staleness counters exact, params, table and metrics at rtol 1e-4."""
    cfg = dict(aggregator="geomed", vr="saga", attack=attack,
               num_byzantine=2, num_clients=12, cohort_size=4,
               staleness_decay=0.9, straggler_k=2, weiszfeld_iters=32)
    j_state, j_m, t_state, t_m = _run_pair(cfg, 12, 4)
    assert t_state.vr.table.shape[0] == 12
    np.testing.assert_array_equal(t_state.staleness.numpy(),
                                  np.asarray(j_state.staleness))
    _assert_close(t_state, j_state, t_m, j_m,
                  ("honest_variance", "mean_staleness"))


@pytest.mark.parametrize("attack", ["straggler", "dropout"])
def test_master_staleness_attack_full_participation_parity(attack):
    """A staleness attack alone turns the weights on: mean with a
    fractional straggler weight and a dropout slot of weight 0."""
    cfg = dict(aggregator="mean", vr="saga", attack=attack, num_byzantine=3,
               staleness_decay=0.8)
    j_state, j_m, t_state, t_m = _run_pair(cfg, 12, 12)
    assert t_state.staleness is None
    _assert_close(t_state, j_state, t_m, j_m, ("mean_staleness",))


@pytest.mark.parametrize("participate", [False, True])
def test_master_lsvrg_parity_with_reference(participate):
    """Five lsvrg steps (p = 0.5, so coins come up) with the reference's
    coins handed in: params, snapshots and anchors at rtol 1e-4."""
    cfg = dict(aggregator="geomed", vr="lsvrg", lsvrg_p=0.5,
               attack="sign_flip", num_byzantine=2, weiszfeld_iters=32)
    rows, wh = 12, 12
    if participate:
        cfg.update(num_clients=12, cohort_size=4)
        wh = 4
    j_state, j_m, t_state, t_m = _run_pair(cfg, rows, wh)
    assert t_state.vr.snapshot.shape == (12, 22)
    _assert_close(t_state, j_state, t_m, j_m,
                  ("honest_variance", "vr_snapshot_rate"))


@pytest.mark.parametrize("case", ["lsvrg", "participation-dropout",
                                  "participation-straggler-trimmed"])
def test_decentralized_parity_with_reference(case):
    """Decentralized steps on a ring of W_h + B nodes: lsvrg against each
    node's own params; participation with staleness weights on the mask's
    sender columns (geomed with fractional weights starts from the
    weighted mean; the trimmed mean takes the reference's weighted form)."""
    cfg = dict(vr="saga", attack="sign_flip", num_byzantine=2,
               topology="ring", weiszfeld_iters=32, aggregator="geomed")
    rows, wh = 8, 8
    if case == "lsvrg":
        cfg.update(vr="lsvrg", lsvrg_p=0.5)
    else:
        cfg.update(num_clients=12, cohort_size=6, staleness_decay=0.9)
        rows, wh = 12, 6
        if case == "participation-dropout":
            cfg.update(attack="dropout")
        else:
            cfg.update(attack="straggler", aggregator="trimmed_mean", trim=1,
                       topology="complete")
    j_state, j_m, t_state, t_m = _run_pair(cfg, rows, wh)
    assert t_state.params["w"].shape == (wh + 2, 22)
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)
    for leaf_t, leaf_j in zip(t_state.vr, j_state.vr):
        np.testing.assert_allclose(leaf_t.numpy(), np.asarray(leaf_j),
                                   rtol=1e-4, atol=1e-5)
    for k in ("honest_variance", "consensus_dist"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)


def test_participation_draws_its_own_cohorts_and_coins():
    """Without injected draws the step runs on its generator: two runs
    from one seed agree bitwise, and the counters follow the plan."""
    _, t_loss, wd = _logreg(12)
    outs = []
    for _ in range(2):
        cfg = RobustConfig(aggregator="geomed", vr="lsvrg", lsvrg_p=0.3,
                           attack="straggler", num_byzantine=2,
                           num_clients=12, cohort_size=4)
        init, step = make_federated_step(t_loss, _numpy(wd), cfg,
                                         get_optimizer("sgd", 0.05),
                                         device="cpu")
        st = init({"w": torch.zeros(22)}, 3)
        for _ in range(4):
            st, m = step(st)
        outs.append((st.params["w"], st.staleness))
    assert torch.equal(outs[0][0], outs[1][0])
    plan = participation.ParticipationPlan(12, 4)
    want = np.full(12, 4, np.int32)
    for t in range(4):
        want[plan.stacked_cohorts[t]] = 3 - t
    np.testing.assert_array_equal(outs[0][1].numpy(), want)
    assert "vr_snapshot_rate" in m and "mean_staleness" in m
