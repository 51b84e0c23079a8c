"""The port's fault attacks, staleness attacks and guards against the JAX
reference.

The bitflip hash and its corrupted coordinates match bit for bit; the guard
masks match exactly; the clean-round guarded call is bitwise the unguarded
one within torch for every rule, at the rule level and over whole steps; a
rejected round holds params and the SAGA table bitwise; guarded steps
under the three fault attacks agree with the reference at rtol 1e-4 /
atol 1e-5 (the tolerance of ``tests/test_torch_step.py``).
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
from repro.core import guards as jguards
from repro.core import make_federated_step as j_make_step
from repro.core import packing as jpacking
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import partition as j_partition
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch import convert
from repro_torch.core import RobustConfig, attacks, guards, make_federated_step
from repro_torch.core import packing
from repro_torch.data import logreg_loss
from repro_torch.optim import get_optimizer

RULES = tuple(jagg._FLAT_REGISTRY)


def _t(x):
    return torch.as_tensor(np.array(x))


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _specs(sizes=(("a", 17), ("b", 6)), pad_to=1):
    """The same two-leaf PackSpec in both packages."""
    j = jpacking.pack_spec({k: jnp.zeros(n) for k, n in sizes}, batch_ndim=0,
                           pad_to=pad_to)
    t = packing.pack_spec({k: torch.zeros(n) for k, n in sizes}, batch_ndim=0,
                          pad_to=pad_to)
    assert j.boundaries == t.boundaries and j.padded_dim == t.padded_dim
    return j, t


# -- the fault attacks ------------------------------------------------------------

def test_hash01_bit_equal_to_reference():
    """A (5, 70,000) grid with row ids and coordinates above 2^24 (where a
    float32 id would round) and salts above 2^32."""
    ids = np.array([0, 3, 2**24 + 1, 2**31 - 1, 2**32 - 5], np.int64)
    for salt in (0, 7 * 1000003 + 2, 2**40 + 9):
        want = np.asarray(jattacks._hash01(jnp.asarray(ids.astype(np.uint32)),
                                           70_000, salt))
        got = attacks._hash01(_t(ids), 70_000, salt).numpy()
        np.testing.assert_array_equal(got, want)


def test_bitflip_rows_and_edges_bit_equal():
    rng = np.random.default_rng(0)
    jspec, tspec = _specs(pad_to=8)
    d = tspec.padded_dim
    mean = rng.standard_normal(d).astype(np.float32) * 2
    mean[tspec.dim:] = 0.0
    ids = np.arange(5)
    want = np.asarray(jattacks.bitflip_rows(
        jnp.asarray(mean), jnp.asarray(ids, jnp.int32), prob=0.3, seed=4,
        spec=jspec))
    got = attacks.bitflip_rows(_t(mean), _t(ids), prob=0.3, seed=4,
                               spec=tspec).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got != mean).any() and (got[:, tspec.dim:] == 0).all()
    means = rng.standard_normal((4, d)).astype(np.float32)
    want = np.asarray(jattacks.bitflip_edges(
        jnp.asarray(means), jnp.arange(6, dtype=jnp.int32), prob=0.3, seed=1,
        spec=jspec))
    got = attacks.bitflip_edges(_t(means), torch.arange(6), prob=0.3, seed=1,
                                spec=tspec).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["nan", "inf_overflow", "bitflip",
                                  "straggler", "dropout"])
def test_new_attacks_match_reference(name):
    """The packed master-path attacks; padding stays 0 in the fault
    payloads."""
    rng = np.random.default_rng(1)
    jspec, tspec = _specs(pad_to=8)
    honest = rng.standard_normal((5, tspec.padded_dim)).astype(np.float32)
    honest[:, tspec.dim:] = 0.0
    kw = dict(name=name, num_byzantine=3, straggler_k=2, bitflip_prob=0.25,
              bitflip_seed=3)
    want = np.asarray(jattacks.apply_attack(
        jattacks.AttackConfig(**kw), jnp.asarray(honest), None, spec=jspec))
    got = attacks.apply_attack(attacks.AttackConfig(**kw), _t(honest),
                               spec=tspec).numpy()
    assert got.shape == (8, tspec.padded_dim)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, tspec.dim:], 0.0)


def test_attack_registry_equals_the_reference():
    assert set(attacks.ATTACK_NAMES) == set(jattacks.ATTACK_NAMES)
    assert attacks.STALENESS_ATTACKS == jattacks.STALENESS_ATTACKS
    assert attacks.FAULT_ATTACKS == jattacks.FAULT_ATTACKS
    assert attacks.OVERFLOW_MAGNITUDE == jattacks.OVERFLOW_MAGNITUDE


# -- the guard functions ----------------------------------------------------------

def _faulty_buf(kind, w=9, d=30, seed=2):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((w, d)).astype(np.float32)
    if kind in ("nan", "mixed"):
        buf[1, 3] = np.nan
    if kind in ("inf", "mixed"):
        buf[4, 0] = np.inf
    if kind in ("huge", "mixed"):
        buf[6] *= 1e3
    if kind == "overflow":
        buf[2] = 1e30
    return buf


@pytest.mark.parametrize("kind", ["clean", "nan", "inf", "huge", "overflow",
                                  "mixed"])
def test_guard_mask_matches_reference(kind):
    buf = _faulty_buf(kind)
    rw = np.ones(buf.shape[0], np.float32)
    rw[0] = 0.0
    for mult in (10.0, 0.0, 2.0):
        for base in (None, rw):
            want = jguards.guard_mask(
                jnp.asarray(buf), multiplier=mult,
                base_weights=None if base is None else jnp.asarray(base))
            got = guards.guard_mask(
                _t(buf), multiplier=mult,
                base_weights=None if base is None else _t(base))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(guards.all_valid(guards.guard_mask(_t(buf)))) == (kind == "clean")


def test_pairwise_guard_mask_and_sanitize_match_reference():
    rng = np.random.default_rng(3)
    ex = rng.standard_normal((5, 6, 12)).astype(np.float32)
    ex[0, 2, 1] = np.nan
    ex[3, 4] *= 1e4
    ex[1, 5] = 1e30
    mask = (rng.random((5, 6)) > 0.3).astype(np.float32)
    want = jguards.pairwise_guard_mask(jnp.asarray(ex), jnp.asarray(mask))
    got = guards.pairwise_guard_mask(_t(ex), _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        guards.sanitize_rows(_t(ex), got).numpy(),
        np.asarray(jguards.sanitize_rows(jnp.asarray(ex), want)))


def test_round_verdict_and_tree_norm_match_reference():
    """A run of norms through warm-up, a spike, NaN and inf, with and
    without the z gate: verdicts exact, health at 1e-6."""
    norms = [1.0, 1.1, 0.9, 1.05, 1.0, 50.0, float("nan"), 1.0, float("inf"),
             0.95, 40.0]
    for zmax, warmup in ((6.0, 3), (0.0, 2), (6.0, 8)):
        jh, th = jguards.init_health(), guards.init_health()
        for x in norms:
            ja, jh = jguards.round_verdict(jnp.float32(x), jh, zmax=zmax,
                                           warmup=warmup)
            ta, th = guards.round_verdict(torch.tensor(x), th, zmax=zmax,
                                          warmup=warmup)
            assert bool(ta) == bool(ja), (zmax, x)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
    tree = {"a": np.arange(6.0, dtype=np.float32), "b": -np.ones(3, np.float32)}
    np.testing.assert_allclose(
        float(guards.tree_norm({k: _t(v) for k, v in tree.items()})),
        float(jguards.tree_norm({k: jnp.asarray(v) for k, v in tree.items()})),
        rtol=1e-6)
    t_tree = {k: _t(v) for k, v in tree.items()}
    zeros = {k: torch.zeros_like(v) for k, v in t_tree.items()}
    for pred in (True, False):
        got = guards.select_tree(torch.tensor(pred), (t_tree, t_tree["a"]),
                                 (zeros, zeros["a"]))
        want = jguards.select_tree(jnp.bool_(pred), (tree, tree["a"]),
                                   ({k: np.zeros_like(v) for k, v in tree.items()},
                                    np.zeros(6, np.float32)))
        np.testing.assert_array_equal(got[0]["b"].numpy(), np.asarray(want[0]["b"]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _rule(name, spec, **kw):
    return RobustConfig(aggregator=name, num_byzantine=2, num_groups=3,
                        weiszfeld_iters=16, **kw).flat_aggregator_fn(spec)


@pytest.mark.parametrize("name", RULES)
def test_guarded_call_clean_round_is_the_unguarded_call(name):
    """Every rule: on a clean round the guarded call returns the unguarded
    call's bits, with and without base row weights."""
    _, tspec = _specs()
    buf = _t(np.random.default_rng(5).standard_normal((8, tspec.padded_dim))
             .astype(np.float32))
    fn = _rule(name, tspec)
    mask = guards.guard_mask(buf)
    assert torch.equal(guards.guarded_flat_call(fn, buf, mask), fn(buf))
    rw = torch.tensor([1.0, 0.5, 2.0, 1.0, 0.0, 1.0, 1.5, 1.0])
    mask = guards.guard_mask(buf, base_weights=rw)
    assert torch.equal(guards.guarded_flat_call(fn, buf, mask, row_weights=rw),
                       fn(buf, row_weights=rw))


@pytest.mark.parametrize("name", RULES)
def test_guarded_call_contains_faults_like_the_reference(name):
    """Every rule: a NaN row and an overflowing row are quarantined and the
    guarded aggregate matches the reference's at rtol 1e-4."""
    jspec, tspec = _specs()
    buf = np.random.default_rng(6).standard_normal(
        (9, tspec.padded_dim)).astype(np.float32)
    buf[2, 5] = np.nan
    buf[7] = 1e30
    jfn = JConfig(aggregator=name, num_byzantine=2, num_groups=3,
                  weiszfeld_iters=16).flat_aggregator_fn(jspec)
    want = jguards.guarded_flat_call(jfn, jnp.asarray(buf),
                                     jguards.guard_mask(jnp.asarray(buf)))
    mask = guards.guard_mask(_t(buf))
    assert mask.tolist() == [1, 1, 0, 1, 1, 1, 1, 0, 1]
    got = guards.guarded_flat_call(_rule(name, tspec), _t(buf), mask)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# -- whole steps ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _logreg():
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=600)
    wd = j_partition({"a": data.x, "b": data.y}, 8, seed=1)
    return j_logreg_loss(0.01), logreg_loss(0.01), wd


def _port_step(**cfg):
    _, t_loss, wd = _logreg()
    return make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                               get_optimizer("sgd", 0.05), device="cpu")


@pytest.mark.parametrize("name", RULES)
def test_step_guards_on_off_bitwise_on_clean_rounds(name):
    """Every rule, three steps with no attack from the same seed: guards on
    gives guards off's params and SAGA table bitwise (every round is clean
    and accepted)."""
    outs = []
    for on in (False, True):
        init, step = _port_step(aggregator=name, num_groups=3, trim=1,
                                weiszfeld_iters=16, guards=on)
        st = init({"w": torch.zeros(22)}, 3)
        for _ in range(3):
            st, m = step(st)
        outs.append((st.params["w"], st.vr.table))
    assert float(m["quarantined_rows"]) == 0.0 and float(m["round_accepted"]) == 1.0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("vr,topology,trigger", [
    ("saga", "star", "ema"), ("lsvrg", "star", "ema"), ("saga", "ring", "ema"),
    ("saga", "star", "nonfinite")])
def test_step_level_reject_holds_train_state(vr, topology, trigger):
    """The twin of the reference's test: with the health EMA re-seeded to a
    microscopic norm ("ema"), or with an aggregate whose norm overflows
    ("nonfinite": inf_overflow rows, the magnitude gate off, the mean),
    the round is rejected; step and health move on, params and the
    variance-reduction state (the SAGA table, or lsvrg's snapshots) are
    held bitwise."""
    extra = dict(aggregator="geomed")
    if trigger == "nonfinite":
        extra = dict(aggregator="mean", attack="inf_overflow",
                     num_byzantine=3, guard_multiplier=0.0)
    init, step = _port_step(vr=vr, lsvrg_p=0.5, guards=True, reject_warmup=2,
                            topology=topology, **extra)
    st = init({"w": torch.zeros(22)}, 3)
    if trigger == "nonfinite":
        # Away from the initial params, so the drawn gradients differ from
        # the table rows K1 overwrites.
        st = st._replace(params={"w": torch.full((22,), 0.1)})
        table = st.vr.table.clone()
        nxt, m = step(st)
        assert float(m["round_accepted"]) == 0.0
        assert float(m["quarantined_rows"]) == 0.0
        assert torch.equal(nxt.params["w"], st.params["w"])
        assert torch.equal(nxt.vr.table, table)
        return
    for _ in range(3):
        st, _ = step(st)
    poisoned = st._replace(health=torch.tensor([1e-8, 1e-16, 0.0, 10.0]))
    before = [t.clone() for t in poisoned.vr]
    params = poisoned.params["w"].clone()
    nxt, m = step(poisoned, coin=torch.ones(8, dtype=torch.bool))
    assert float(m["round_accepted"]) == 0.0
    assert float(m["rejected_rounds"]) == 1.0
    assert nxt.step == poisoned.step + 1
    assert torch.equal(nxt.params["w"], params)
    for a, b in zip(nxt.vr, before):
        assert torch.equal(a, b)
    nxt2, m2 = step(nxt._replace(health=torch.tensor([1.0, 1.0, 1.0, 10.0])))
    assert float(m2["round_accepted"]) == 1.0
    assert not torch.equal(nxt2.params["w"], params)


@pytest.mark.parametrize("attack", ["nan", "inf_overflow", "bitflip"])
def test_guarded_fault_steps_parity_with_reference(attack):
    """Five guarded geomed steps under each fault attack (3 of 11 rows):
    finite, every Byzantine row quarantined every step, and params, table
    and metrics at rtol 1e-4 against the reference with its draws."""
    j_loss, t_loss, wd = _logreg()
    cfg = dict(aggregator="geomed", vr="saga", attack=attack, num_byzantine=3,
               guards=True, bitflip_prob=0.5, weiszfeld_iters=32)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", 0.05))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", 0.05), device="cpu")
    j_state = j_init({"w": jnp.zeros(22, jnp.float32)}, jax.random.PRNGKey(3))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    j_step = jax.jit(j_step)
    for _ in range(5):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (8,), 0, 75))
        j_state, j_m = j_step(j_state)
        t_state, t_m = t_step(t_state, sample_idx=idx)
        assert float(t_m["quarantined_rows"]) >= 3.0
        assert float(t_m["quarantined_rows"]) == float(j_m["quarantined_rows"])
    assert bool(torch.isfinite(t_state.params["w"]).all())
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_state.vr.table.numpy(),
                               np.asarray(j_state.vr.table), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_state.health.numpy(),
                               np.asarray(j_state.health), rtol=1e-4)


@pytest.mark.parametrize("attack", ["nan", "bitflip"])
def test_guarded_decentralized_fault_steps_parity_with_reference(attack):
    """Per-edge faults on a complete graph of 8 + 3 nodes with guards on:
    every Byzantine in-edge quarantined, params at rtol 1e-4."""
    j_loss, t_loss, wd = _logreg()
    cfg = dict(aggregator="geomed", vr="saga", attack=attack, num_byzantine=3,
               guards=True, bitflip_prob=0.5, topology="complete",
               weiszfeld_iters=32)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", 0.05))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", 0.05), device="cpu")
    j_state = j_init({"w": jnp.zeros(22, jnp.float32)}, jax.random.PRNGKey(3))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    j_step = jax.jit(j_step)
    for _ in range(3):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (8,), 0, 75))
        j_state, j_m = j_step(j_state)
        t_state, t_m = t_step(t_state, sample_idx=idx)
        assert float(t_m["quarantined_edges"]) == float(j_m["quarantined_edges"])
        assert float(t_m["quarantined_edges"]) >= 3 * 11
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)
