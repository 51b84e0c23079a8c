"""The per-leaf baseline (``RobustConfig(packed=False)``) of the PyTorch port
against the JAX reference's pre-packing path, on the CPU.

The same numpy inputs go to both packages: every rule's
``get_aggregator(name, perleaf=True)`` (and the packed shim) on a
three-leaf payload, every masked rule's ``masked_aggregate(perleaf=True)``
on a ring, every attack of the registry on a dict of leaves (the gaussian
draws handed in as the reference's packed draws, which are its per-leaf
draws), and whole master and decentralized steps on a three-leaf logistic
model, the reference's sample draws handed in.  Tolerances: rtol 1e-5 /
atol 3e-5 for the flat rules, atol 5e-5 for the masked ones, 1e-5 for the
attacks, and rtol 1e-4 / atol 1e-5 for three training steps (a Weiszfeld
stop may fall one iteration apart).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import topology as jtopo
from repro.core import RobustConfig as JConfig
from repro.core import aggregators as jagg
from repro.core import attacks as jattacks
from repro.core import make_federated_step as j_make_step
from repro.core import packing as jpacking
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import partition as j_partition
from repro.optim import get_optimizer as j_get_optimizer
from repro.topology import masked as jmasked
from repro_torch import topology as topo
from repro_torch.core import (RobustConfig, aggregators, attacks,
                              make_federated_step, packing)
from repro_torch.optim import get_optimizer
from repro_torch.topology import masked

LEAVES = {"a": (4, 5), "b": (10,), "c": (3,)}
OPTS = dict(max_iters=200, tol=1e-7, num_groups=3, trim=1, num_byzantine=2,
            clip_radius=2.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(lead, seed, ties=False):
    """Three leaves with leading axes ``lead``, as numpy float32."""
    rng = np.random.default_rng(seed)
    tree = {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, s in LEAVES.items()}
    if ties:
        tree["b"] = np.round(2 * tree["b"]) / 2
    return tree


# -- the flat rules ------------------------------------------------------------------

@pytest.mark.parametrize("perleaf", [True, False])
@pytest.mark.parametrize("rule", aggregators.AGGREGATOR_NAMES)
def test_aggregators_on_leaves_match_reference(rule, perleaf):
    """Every rule on a (9, ...) three-leaf payload with two outlying rows:
    the per-leaf baseline and the packed shim, rtol 1e-5 / atol 3e-5."""
    tree = _tree((9,), seed=1, ties=True)
    for v in tree.values():
        v[-2:] = 5.0 + 3.0 * v[-2:]
    want = jagg.get_aggregator(rule, perleaf=perleaf, **OPTS)(
        {k: jnp.asarray(v) for k, v in tree.items()})
    got = aggregators.get_aggregator(rule, perleaf=perleaf, **OPTS)(
        {k: _t(v) for k, v in tree.items()})
    assert set(got) == set(LEAVES)
    for k in LEAVES:
        assert tuple(got[k].shape) == LEAVES[k]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=3e-5, err_msg=k)


def test_perleaf_trimmed_mean_checks_its_trim():
    with pytest.raises(ValueError, match="too large"):
        aggregators.get_aggregator("trimmed_mean", perleaf=True, trim=5)(
            {k: _t(v) for k, v in _tree((9,), seed=2).items()})


# -- the masked rules ----------------------------------------------------------------

@pytest.mark.parametrize("rule", masked.MASKED_AGGREGATOR_NAMES)
def test_masked_rules_on_leaves_match_reference(rule):
    """Every masked rule, per leaf, on a ring of 9 (mixing for mean): a
    (9, 9, ...) three-leaf exchange, atol 5e-5; the flat shim too."""
    graph = topo.get_topology("ring", 9)
    mask = graph.neighbor_mask.astype(np.float32)
    mixing = (graph.mixing * mask).astype(np.float32)
    ex = _tree((9, 9), seed=3, ties=True)
    opts = dict(OPTS, num_byzantine=0)
    for perleaf in (True, False):
        want = jmasked.masked_aggregate(
            rule, {k: jnp.asarray(v) for k, v in ex.items()}, jnp.asarray(mask),
            perleaf=perleaf, mixing=jnp.asarray(mixing), **opts)
        got = masked.masked_aggregate(
            rule, {k: _t(v) for k, v in ex.items()}, _t(mask), perleaf=perleaf,
            mixing=_t(mixing), **opts)
        for k in LEAVES:
            assert tuple(got[k].shape) == (9,) + LEAVES[k]
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=5e-5, atol=5e-5, err_msg=(k, perleaf))


def test_masked_perleaf_diagnostics_route_through_the_flat_engine():
    """diagnostics=True on a per-leaf call returns the flat engine's
    aggregate (unpacked) and its struct, as the reference does (iterations
    within one: the float32 stop at tol 1e-7)."""
    graph = topo.get_topology("ring", 9)
    mask = graph.neighbor_mask.astype(np.float32)
    ex = _tree((9, 9), seed=4)
    want, jdiag = jmasked.masked_aggregate(
        "geomed", {k: jnp.asarray(v) for k, v in ex.items()}, jnp.asarray(mask),
        perleaf=True, diagnostics=True, max_iters=200, tol=1e-7)
    got, diag = masked.masked_aggregate(
        "geomed", {k: _t(v) for k, v in ex.items()}, _t(mask), perleaf=True,
        diagnostics=True, max_iters=200, tol=1e-7)
    for k in LEAVES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(diag.dist.numpy(), np.asarray(jdiag.dist),
                               rtol=1e-4, atol=5e-5)
    # The float32 stop may fall one iteration apart across the frameworks.
    assert abs(int(diag.iters) - int(jdiag.iters)) <= 1


# -- attacks on leaves ---------------------------------------------------------------

@pytest.mark.parametrize("name", attacks.ATTACK_NAMES)
def test_attacks_on_leaves_match_reference(name):
    """Every attack of the registry on a dict of (6, ...) leaves: the
    port's pack -> attack -> unpack is the reference's per-leaf attack
    (NaN where it has NaN), with its per-leaf gaussian draws handed in."""
    b = 3
    tree = _tree((6,), seed=5)
    key = jax.random.PRNGKey(13)
    cfg = dict(name=name, num_byzantine=b, straggler_k=2, bitflip_prob=0.3)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    want = jattacks.apply_attack(jattacks.AttackConfig(**cfg), jtree, key)
    noise = None
    if name == "gaussian":
        noise = _t(jattacks.packed_gaussian_noise(jpacking.pack_spec(jtree),
                                                  key, (b,), 1.0))
    got = attacks.apply_attack(attacks.AttackConfig(**cfg),
                               {k: _t(v) for k, v in tree.items()}, noise=noise)
    for k in LEAVES:
        w = np.asarray(want[k])
        rows = 6 if name == "none" else 6 + b
        assert tuple(got[k].shape) == w.shape == (rows,) + LEAVES[k]
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", attacks.ATTACK_NAMES)
def test_exchange_on_leaves_matches_reference(name):
    """The per-edge exchange built leaf by leaf on a ring of 6 + 2 nodes:
    each leaf its own (R, S, *shape) tensor, bit for bit the port's packed
    exchange cut at the leaf boundaries, and equal to the reference's
    per-leaf exchange.  ``gaussian`` (numpy draws handed in) is held to the
    packed exchange only: that one meets the reference's draws in
    tests/test_torch_topology.py, and the reference's per-leaf draws
    compile one sampler a leaf shape."""
    n, b = 8, 2
    tree = _tree((n,), seed=9)
    for v in tree.values():
        v[n - b:] = 0.0
    mask = topo.get_topology("ring", n).neighbor_mask.astype(np.float32)
    is_byz = np.arange(n) >= n - b
    cfg = dict(name=name, num_byzantine=b, straggler_k=2, bitflip_prob=0.3)
    ttree = {k: _t(v) for k, v in tree.items()}
    spec = packing.pack_spec(ttree)
    noise = None
    if name == "gaussian":
        noise = _t(np.random.default_rng(3).standard_normal(
            (n, n, spec.padded_dim)).astype(np.float32))
    tcfg = attacks.AttackConfig(**cfg)
    got = topo.build_exchange(ttree, tcfg, _t(mask), _t(is_byz), noise=noise,
                              spec=spec)
    packed = topo.build_exchange(spec.pack(ttree), tcfg, _t(mask), _t(is_byz),
                                 noise=noise, spec=spec)
    assert torch.equal(spec.pack(got, batch_ndim=2).nan_to_num(7.0),
                       packed.nan_to_num(7.0))
    for k in LEAVES:
        assert tuple(got[k].shape) == (n, n) + LEAVES[k]
        assert got[k].is_contiguous() or name == "none"
    if name == "gaussian":
        return
    want = jtopo.build_exchange({k: jnp.asarray(v) for k, v in tree.items()},
                                jattacks.AttackConfig(**cfg), jnp.asarray(mask),
                                jnp.asarray(is_byz), jax.random.PRNGKey(17))
    for k in LEAVES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# -- whole steps ---------------------------------------------------------------------

def _j_loss(params, batch):
    """A logistic loss on a three-leaf model: x[:, :10] . a + x[:, 10:] . b + c."""
    a, x = batch["b"], batch["a"]
    z = x[:, :10] @ params["u"] + x[:, 10:] @ params["v"] + params["c"][0]
    return jnp.mean(jnp.logaddexp(0.0, -a * z))


def _t_loss(params, batch):
    a, x = batch["b"], batch["a"]
    z = x[:, :10] @ params["u"] + x[:, 10:] @ params["v"] + params["c"][0]
    return torch.mean(torch.logaddexp(torch.zeros_like(z), -a * z))


PARAMS = {"u": np.zeros(10, np.float32), "v": np.zeros(12, np.float32),
          "c": np.zeros(1, np.float32)}


@functools.lru_cache(maxsize=None)
def _data(rows):
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=480)
    return j_partition({"a": data.x, "b": data.y}, rows, seed=1)


def _run_pair(cfg, *, rows=8, steps=3, lr=0.05, opt="sgd"):
    """``steps`` steps of the reference's per-leaf step (jitted) and the
    port's, each from its own init state (the same table), the port handed
    the reference's sample draws."""
    cfg = dict(cfg, packed=False)
    wd = _data(rows)
    j_init, j_step = j_make_step(_j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer(opt, lr))
    t_init, t_step = make_federated_step(
        _t_loss, jax.tree_util.tree_map(np.array, wd), RobustConfig(**cfg),
        get_optimizer(opt, lr), device="cpu")
    j_state = j_init({k: jnp.asarray(v) for k, v in PARAMS.items()},
                     jax.random.PRNGKey(5))
    t_state = t_init({k: _t(v) for k, v in PARAMS.items()}, 0)
    wh = rows if not cfg.get("num_clients") else cfg["cohort_size"]
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    shape = (wh, cfg["minibatch_size"]) if cfg.get("vr") == "minibatch" else (wh,)
    for _ in range(steps):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, shape, 0, j))
        coin = None
        if cfg.get("vr") == "lsvrg":
            coin = np.array(jax.random.bernoulli(
                jax.random.fold_in(k_idx, 1), cfg["lsvrg_p"], (wh,)))
        j_state, j_m = j_step(j_state)
        t_state, t_m = t_step(t_state, sample_idx=idx, coin=coin)
    for k in PARAMS:
        np.testing.assert_allclose(t_state.params[k].numpy(),
                                   np.asarray(j_state.params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(t_m["honest_variance"]),
                               float(j_m["honest_variance"]), rtol=1e-4)
    return j_state, j_m, t_state, t_m


@pytest.mark.parametrize("rule", ["geomed", "trimmed_mean", "krum",
                                  "centered_clip"])
def test_master_perleaf_steps_match_reference(rule):
    """Three per-leaf master steps under sign_flip; the per-leaf SAGA
    tables (one (W, J, d_l) table a leaf) agree too."""
    j_state, _, t_state, _ = _run_pair(dict(
        aggregator=rule, vr="saga", attack="sign_flip", num_byzantine=3,
        trim=3, weiszfeld_iters=32))
    for k in PARAMS:
        np.testing.assert_allclose(
            t_state.vr[k].table.numpy(),
            np.asarray(j_state.vr.table[k]).reshape(t_state.vr[k].table.shape),
            rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("vr", ["sgd", "minibatch", "lsvrg"])
def test_master_perleaf_reducers_match_reference(vr):
    """The other reducers per leaf: robust SGD, BSGD with the reference's
    (W_h, B) draws, and lsvrg (p = 0.5) with its coins handed in, whose
    per-leaf snapshots and anchors agree too."""
    j_state, _, t_state, _ = _run_pair(dict(
        aggregator="geomed", vr=vr, attack="sign_flip", num_byzantine=3,
        weiszfeld_iters=32, minibatch_size=5, lsvrg_p=0.5))
    if vr == "lsvrg":
        for k in PARAMS:
            for got, want in zip(t_state.vr[k], (j_state.vr.snapshot[k],
                                                 j_state.vr.anchor[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
                    got.shape), rtol=1e-4, atol=1e-6, err_msg=k)


def test_master_perleaf_staleness_weights_match_reference():
    """A staleness attack turns row weights on: the per-leaf messages take
    one pack -> weighted flat rule -> unpack detour."""
    _, j_m, _, t_m = _run_pair(dict(
        aggregator="geomed", vr="saga", attack="straggler", num_byzantine=3,
        staleness_decay=0.8, weiszfeld_iters=32))
    np.testing.assert_allclose(float(t_m["mean_staleness"]),
                               float(j_m["mean_staleness"]))


def test_master_perleaf_guards_under_nan_match_reference():
    """NaN rows quarantined on the packed view: the weighted flat rule's
    aggregate, the rows counted, the round accepted."""
    _, j_m, _, t_m = _run_pair(dict(
        aggregator="trimmed_mean", vr="saga", attack="nan", num_byzantine=3,
        trim=3, guards=True))
    assert float(t_m["quarantined_rows"]) == float(j_m["quarantined_rows"]) == 3.0
    assert float(t_m["round_accepted"]) == float(j_m["round_accepted"])


def test_master_perleaf_diagnostics_match_reference():
    _, j_m, _, t_m = _run_pair(dict(
        aggregator="geomed", vr="saga", attack="sign_flip", num_byzantine=3,
        diagnostics=True, weiszfeld_iters=32))
    assert int(t_m["diag_iters"]) == int(j_m["diag_iters"])
    np.testing.assert_allclose(t_m["diag_dist"].numpy(),
                               np.asarray(j_m["diag_dist"]), rtol=1e-4, atol=1e-6)


def test_master_perleaf_adam_matches_reference():
    _run_pair(dict(aggregator="geomed", vr="sgd", attack="sign_flip",
                   num_byzantine=3, weiszfeld_iters=32), opt="adam", lr=0.01)


def test_perleaf_bf16_wire_is_the_float32_path():
    """The reference packs nothing on the per-leaf path, so a bfloat16 wire
    changes nothing there: the port's params are float32's bit for bit."""
    wd = jax.tree_util.tree_map(np.array, _data(8))
    outs = []
    for wire in ("float32", "bfloat16"):
        init, step = make_federated_step(
            _t_loss, wd, RobustConfig(aggregator="median", packed=False,
                                      message_dtype=wire, attack="sign_flip",
                                      num_byzantine=2),
            get_optimizer("sgd", 0.05), device="cpu")
        st = init({k: _t(v) for k, v in PARAMS.items()}, 1)
        for _ in range(2):
            st, _ = step(st)
        outs.append(st)
    for k in PARAMS:
        assert torch.equal(outs[0].params[k], outs[1].params[k])
    assert outs[1].vr["u"].table.dtype == torch.float32


@pytest.mark.parametrize("case", ["geomed-gradient", "geomed-params",
                                  "trimmed_mean"])
def test_decentralized_perleaf_steps_match_reference(case):
    """Three per-leaf decentralized steps on a ring of 8 + 2 nodes:
    per-node params and both metrics."""
    rule, _, gossip = case.partition("-")
    cfg = dict(aggregator=rule, vr="saga", attack="sign_flip",
               num_byzantine=2, topology="ring", gossip=gossip or "gradient",
               trim=1, weiszfeld_iters=32)
    _, j_m, t_state, t_m = _run_pair(cfg)
    assert t_state.params["u"].shape == (10, 10)
    np.testing.assert_allclose(float(t_m["consensus_dist"]),
                               float(j_m["consensus_dist"]), rtol=1e-4,
                               atol=1e-9)


@pytest.mark.parametrize("topology", ["star", "ring"])
def test_quantized_wire_raises_on_the_perleaf_path(topology):
    wd = jax.tree_util.tree_map(np.array, _data(8))
    for wire in ("int8", "sign1"):
        cfg = dict(message_dtype=wire, packed=False, topology=topology)
        with pytest.raises(ValueError, match="needs the packed path"):
            j_make_step(_j_loss, _data(8), JConfig(**cfg),
                        j_get_optimizer("sgd", 0.1))
        with pytest.raises(ValueError, match="needs the packed path"):
            make_federated_step(_t_loss, wd, RobustConfig(**cfg),
                                get_optimizer("sgd", 0.1), device="cpu")
