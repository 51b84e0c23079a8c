"""Core modules of the PyTorch port against the JAX reference.

The same numpy inputs go through each reference function and its port on
the CPU.  Data layout and deterministic ops (partition, packing, the SAGA
table) must match exactly; float32 arithmetic that may sum in another order
is held at 1e-6 (rtol and atol).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtelemetry
from repro.core import aggregators as jagg
from repro.core import attacks as jattacks
from repro.core import geomed as jgeomed
from repro.core import packing as jpacking
from repro.core import robust_step as jstep
from repro.core import variance as jvariance
from repro.data import federated as jfederated
from repro.data import synthetic as jsynthetic
from repro.optim import optimizers as joptim
from repro_torch import convert
from repro_torch.core import aggregators, attacks, geomed, packing, robust_step
from repro_torch.core import saga, variance
from repro_torch.data import federated, synthetic
from repro_torch.models import paper_nn
from repro_torch.optim import optimizers
from repro_torch.telemetry import metrics

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _buf(w=9, d=40, b=3, seed=0):
    """(W, D) messages: a tight honest cloud plus b far-away rows."""
    rng = np.random.default_rng(seed)
    buf = 0.1 * rng.standard_normal((w, d)).astype(np.float32) + 1.0
    buf[w - b:] = -3.0 + rng.standard_normal((b, d)).astype(np.float32)
    return buf


# -- data and optimizer ------------------------------------------------------

@pytest.mark.parametrize("mode,spw", [("iid", None), ("iid", 7),
                                      ("replicated", 11)])
def test_partition_matches_reference(mode, spw):
    rng = np.random.default_rng(3)
    data = {"a": rng.standard_normal((60, 5)).astype(np.float32),
            "b": rng.integers(0, 9, 60).astype(np.int64)}
    want = jfederated.partition(data, 4, mode=mode, seed=5,
                                samples_per_worker=spw)
    got = federated.partition(data, 4, mode=mode, seed=5,
                              samples_per_worker=spw, device="cpu")
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_partition_unported_mode_raises():
    """Every mode of the reference is ported; an unknown one raises as the
    reference's does."""
    with pytest.raises(ValueError, match="unknown partition mode"):
        federated.partition({"a": np.zeros((8, 2))}, 2, mode="dirichlet",
                            device="cpu")


def test_logreg_loss_and_grad_match_reference():
    data = jsynthetic.ijcnn1_like(jax.random.PRNGKey(1), n=64)
    batch = {"a": np.asarray(data.x), "b": np.asarray(data.y)}
    w = np.random.default_rng(0).standard_normal(22).astype(np.float32)
    jl = jsynthetic.logreg_loss(0.01)
    tl = synthetic.logreg_loss(0.01)
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(tl({"w": _t(w)}, tb)),
                               float(jl({"w": jnp.asarray(w)}, batch)), **TOL)
    g_t = torch.func.grad(tl)({"w": _t(w)}, tb)["w"].numpy()
    g_j = np.asarray(jax.grad(jl)({"w": jnp.asarray(w)}, batch)["w"])
    np.testing.assert_allclose(g_t, g_j, **TOL)


def test_logreg_full_optimum_matches_reference():
    data = jsynthetic.ijcnn1_like(jax.random.PRNGKey(2), n=120)
    _, f_j = jsynthetic.logreg_full_loss_and_opt(data, iters=300, lr=0.5)
    _, f_t = synthetic.logreg_full_loss_and_opt(
        synthetic.Dataset(_t(data.x), _t(data.y)), iters=300, lr=0.5)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5)


def test_synthetic_generators_shapes_and_labels():
    d = synthetic.ijcnn1_like(0, n=50, device="cpu")
    assert d.x.shape == (50, 22) and set(d.y.unique().tolist()) <= {-1.0, 1.0}
    m = synthetic.mnist_like(0, n=30, device="cpu")
    assert m.x.shape == (30, 784) and float(m.x.min()) >= 0.0
    assert float(m.x.max()) <= 1.0 and m.y.tolist() == [i % 10 for i in range(30)]
    d2 = synthetic.ijcnn1_like(0, n=50, device="cpu")
    assert torch.equal(d.x, d2.x)


def test_covtype_like_shape_dtype_and_labels():
    """covtype_like: p = 54 float32 features and +-1 float32 labels, as the
    reference's; the same seed gives the same set."""
    d = synthetic.covtype_like(0, n=40, device="cpu")
    want = jsynthetic.covtype_like(jax.random.PRNGKey(0), n=40)
    assert d.x.shape == want.x.shape == (40, 54)
    assert d.y.shape == want.y.shape == (40,)
    assert d.x.dtype == d.y.dtype == torch.float32
    assert str(want.x.dtype) == str(want.y.dtype) == "float32"
    assert set(d.y.unique().tolist()) <= {-1.0, 1.0}
    assert torch.equal(d.x, synthetic.covtype_like(0, n=40, device="cpu").x)
    from repro_torch import data
    assert data.covtype_like is synthetic.covtype_like


def test_nn_loss_and_grad_match_reference():
    rng = np.random.default_rng(4)
    params = {"w1": 0.05 * rng.standard_normal((784, 16)).astype(np.float32),
              "b1": np.zeros(16, np.float32),
              "w2": 0.05 * rng.standard_normal((16, 10)).astype(np.float32),
              "b2": np.zeros(10, np.float32)}
    batch = {"x": rng.uniform(0, 1, (8, 784)).astype(np.float32),
             "y": (np.arange(8) % 10).astype(np.int32)}

    def jloss(p, b):  # benchmarks/table1_nn.py:nn_loss
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        tgt = jnp.take_along_axis(logits, b["y"][:, None], 1)[:, 0]
        return jnp.mean(lse - tgt)

    tp = {k: _t(v) for k, v in params.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(paper_nn.nn_loss(tp, tb)),
                               float(jloss(params, batch)), **TOL)
    g_t = torch.func.grad(paper_nn.nn_loss)(tp, tb)
    g_j = jax.grad(jloss)(params, batch)
    for k in params:
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]), **TOL)
    assert 0.0 <= paper_nn.accuracy(tp, tb) <= 1.0


def test_sgd_update_matches_reference():
    g = {"w": np.linspace(-1, 1, 7).astype(np.float32)}
    p = {"w": np.ones(7, np.float32)}
    jo, to = joptim.get_optimizer("sgd", 0.02), optimizers.get_optimizer("sgd", 0.02)
    ju, _ = jo.update(g, jo.init(p), p, 3)
    tu, state = to.update({"w": _t(g["w"])}, to.init(p), p, 3)
    assert state == ()
    np.testing.assert_array_equal(
        optimizers.apply_updates({"w": _t(p["w"])}, tu)["w"].numpy(),
        np.asarray(joptim.apply_updates(p, ju)["w"]))
    with pytest.raises(ValueError, match="unknown optimizer 'nope'"):
        optimizers.get_optimizer("nope", 0.1)


# -- packing -----------------------------------------------------------------

@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 4)])
def test_packing_round_trip_matches_reference(batch_shape):
    rng = np.random.default_rng(5)
    shapes = {"w1": (3, 4), "b": (5,), "s": (), "a": (2, 1, 3)}
    tree = {k: rng.standard_normal(batch_shape + s).astype(np.float32)
            for k, s in shapes.items()}
    nb = len(batch_shape)
    jspec = jpacking.pack_spec(tree, batch_ndim=nb)
    tspec = packing.pack_spec({k: _t(v) for k, v in tree.items()},
                              batch_ndim=nb)
    assert (tspec.sizes, tspec.offsets, tspec.dim, tspec.padded_dim) == (
        jspec.sizes, jspec.offsets, jspec.dim, jspec.padded_dim)
    buf = tspec.pack({k: _t(v) for k, v in tree.items()}, batch_ndim=nb)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jspec.pack(tree, batch_ndim=nb)))
    back = tspec.unpack(buf, batch_ndim=nb)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_packing_pad_and_unported_wire():
    """Padding is zero-filled; every wire of the reference builds a spec
    whose buffer has the format's cast dtype; an unknown name raises."""
    spec = packing.pack_spec({"w": torch.zeros(2, 5)}, pad_to=4)
    buf = spec.pack({"w": torch.ones(2, 5)})
    assert buf.shape == (2, 8) and float(buf[:, 5:].abs().sum()) == 0.0
    for name, dtype in (("bfloat16", torch.bfloat16), ("int8", torch.float32),
                        ("sign1", torch.float32)):
        wspec = packing.pack_spec({"w": torch.zeros(2)}, wire=name)
        assert wspec.wire == name and wspec.message_dtype == dtype
    with pytest.raises(ValueError, match="message_dtype must be one of"):
        packing.pack_spec({"w": torch.zeros(2)}, wire="fp8")


# -- aggregation ---------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, "fractional", "zero_row"])
def test_weiszfeld_flat_matches_reference(weights):
    buf = _buf()
    rw = None
    if weights == "fractional":
        rw = np.linspace(0.2, 1.0, buf.shape[0]).astype(np.float32)
    elif weights == "zero_row":
        rw = np.ones(buf.shape[0], np.float32)
        rw[-1] = 0.0
    y_j, info_j = jgeomed.weiszfeld_flat(
        jnp.asarray(buf), row_weights=None if rw is None else jnp.asarray(rw),
        return_info=True)
    y_t, info_t = geomed.weiszfeld_flat(
        _t(buf), row_weights=None if rw is None else _t(rw), return_info=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    assert info_t.iters == int(info_j.iters)
    assert info_t.converged == bool(info_j.converged)
    # The aggregate stays with the honest cloud.
    assert float(y_t.mean()) > 0.5


def test_weiszfeld_flat_iteration_cap_and_zero_iters():
    buf = _buf()
    y, info = geomed.weiszfeld_flat(_t(buf), max_iters=3, tol=0.0,
                                    return_info=True)
    y_j = jgeomed.weiszfeld_flat(jnp.asarray(buf), max_iters=3, tol=0.0)
    assert info.iters == 3 and not info.converged
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    y0, info0 = geomed.weiszfeld_flat(_t(buf), max_iters=0, return_info=True)
    assert info0.iters == 0 and info0.residual == float("inf")
    np.testing.assert_allclose(y0.numpy(), buf.mean(axis=0), **TOL)


@pytest.mark.parametrize("weights", [None, "zero_row"])
def test_mean_flat_matches_reference(weights):
    buf = _buf()
    rw = None
    if weights:
        rw = np.ones(buf.shape[0], np.float32)
        rw[0] = 0.0
    want = jagg.mean_flat(jnp.asarray(buf),
                          row_weights=None if rw is None else jnp.asarray(rw))
    got = aggregators.mean_flat(_t(buf),
                                row_weights=None if rw is None else _t(rw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_registries_pin_the_reference_names():
    """Every reference name is either ported or listed as still to port."""
    assert set(aggregators.AGGREGATOR_NAMES) | set(aggregators.UNPORTED) == \
        set(jagg._FLAT_REGISTRY)
    assert set(attacks.ATTACK_NAMES) | set(attacks.UNPORTED) == \
        set(jattacks.ATTACK_NAMES)
    assert set(variance.VR_NAMES) | set(variance.UNPORTED) == \
        set(jvariance.VR_NAMES)
    assert set(packing.WIRE_FORMAT_NAMES) == set(jpacking.WIRE_FORMAT_NAMES)
    # The pytree shims and the per-leaf baseline carry the same names.
    assert set(aggregators._REGISTRY) == set(jagg._REGISTRY)
    assert set(aggregators._PERLEAF_REGISTRY) == set(jagg._PERLEAF_REGISTRY)
    # The reference's get_optimizer takes exactly these names.
    for name in optimizers.OPTIMIZER_NAMES:
        joptim.get_optimizer(name, 0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        joptim.get_optimizer("lamb", 0.1)
    assert set(optimizers.OPTIMIZER_NAMES) == {"sgd", "momentum", "adam", "adamw"}
    with pytest.raises(ValueError, match="krum"):
        aggregators.get_flat_aggregator("nope", None)
    with pytest.raises(ValueError, match="krum"):
        aggregators.get_aggregator("nope", perleaf=True)
    assert attacks.UNPORTED == () and variance.UNPORTED == ()
    with pytest.raises(ValueError, match="bitflip"):
        attacks.check_attack_name("nope")


# -- attacks and metrics -------------------------------------------------------

@pytest.mark.parametrize("name", ["none", "gaussian", "sign_flip",
                                  "zero_gradient"])
def test_attacks_match_reference(name):
    b = 3
    honest = _buf(w=6, d=12, b=0, seed=7)
    tree = {"u": honest[:, :5].reshape(6, 5), "v": honest[:, 5:]}
    spec = jpacking.pack_spec(tree)
    key = jax.random.PRNGKey(11)
    cfg = jattacks.AttackConfig(name=name, num_byzantine=b)
    want = jattacks.apply_attack(cfg, jnp.asarray(honest), key, spec=spec)
    # The reference's standard-normal draws for the same key and layout.
    noise = jattacks.packed_gaussian_noise(spec, key, (b,), 1.0)
    got = attacks.apply_attack(
        attacks.AttackConfig(name=name, num_byzantine=b), _t(honest),
        noise=_t(noise) if name == "gaussian" else None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gaussian_attack_draws_from_generator():
    cfg = attacks.AttackConfig(name="gaussian", num_byzantine=4)
    honest = _t(_buf(w=5, d=8, b=0))
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a, b = attacks.apply_attack(cfg, honest, g1), attacks.apply_attack(cfg, honest, g2)
    assert a.shape == (9, 8) and torch.equal(a, b)
    assert 2.0 < float(a[5:].std()) < 9.0


def test_honest_variance_matches_reference():
    h = _buf(w=7, d=30, b=2)
    np.testing.assert_allclose(float(metrics.honest_variance(_t(h), 7)),
                               float(jtelemetry.honest_variance(jnp.asarray(h), 7)),
                               **TOL)


# -- variance reduction ----------------------------------------------------------

def test_saga_reducer_matches_reference():
    w, j, d = 5, 6, 17
    rng = np.random.default_rng(8)
    table = rng.standard_normal((w, j, d)).astype(np.float32)
    jcfg = jstep.RobustConfig(vr="saga")
    jred = jcfg.reducer()
    jstate = jred.init_sim(None, per_sample_grads_fn=lambda: jnp.asarray(table),
                           full_grads_fn=None, num_workers=w)
    tred = robust_step.RobustConfig(vr="saga").reducer()
    tstate = tred.init_sim(None, per_sample_grads_fn=lambda: _t(table),
                           num_workers=w)
    np.testing.assert_allclose(tstate.avg.numpy(), np.asarray(jstate.avg), **TOL)
    key = jax.random.PRNGKey(3)
    for _ in range(4):
        key, k = jax.random.split(key)
        idx = jred.draw_indices(k, w, j)
        grads = rng.standard_normal((w, d)).astype(np.float32)
        jm, jstate, _ = jred.correct(jstate, jnp.asarray(grads), idx, k)
        tm, tstate, _ = tred.correct(tstate, _t(grads),
                                     torch.from_numpy(np.asarray(idx, np.int64)))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tstate.avg.numpy(), np.asarray(jstate.avg), **TOL)
    np.testing.assert_array_equal(tstate.table.numpy(), np.asarray(jstate.table))
    # The Alg. 1 invariant avg == mean(table) survives the in-place updates.
    np.testing.assert_allclose(tstate.avg.numpy(), tstate.table.mean(1).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sgd_reducer_and_unported_reducers():
    red = robust_step.RobustConfig(vr="sgd").reducer()
    g = torch.ones(3, 4)
    out, state, m = red.correct(None, g, torch.zeros(3, dtype=torch.int64))
    assert out is g and state is None and m == {}
    idx = red.draw_indices(torch.Generator().manual_seed(0), 50, 7)
    assert idx.dtype == torch.int64 and int(idx.min()) >= 0 and int(idx.max()) < 7
    assert tuple(idx.shape) == (50,)
    assert variance.UNPORTED == ()
    assert robust_step.RobustConfig(vr="lsvrg").reducer().name == "lsvrg"
    with pytest.raises(ValueError, match="lsvrg"):
        robust_step.RobustConfig(vr="nope").reducer()


def test_minibatch_reducer_matches_reference():
    """BSGD: a (W, minibatch_size) draw in [0, J) like the reference's, no
    state, and the identity correction (the reduction is in the
    sampling)."""
    jred = jstep.RobustConfig(vr="minibatch", minibatch_size=9).reducer()
    tred = robust_step.RobustConfig(vr="minibatch", minibatch_size=9).reducer()
    assert tred.name == jred.name == "minibatch"
    want = jred.draw_indices(jax.random.PRNGKey(0), 5, 7)
    got = tred.draw_indices(torch.Generator().manual_seed(0), 5, 7)
    assert tuple(got.shape) == tuple(want.shape) == (5, 9)
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 7
    assert tred.init_sim(None, per_sample_grads_fn=None, num_workers=5) is None
    g = torch.ones(5, 4)
    jm, jstate, jmetrics = jred.correct(None, jnp.ones((5, 4)), want, None)
    out, state, m = tred.correct(None, g, got)
    assert out is g and state is None and m == {} == jmetrics
    np.testing.assert_array_equal(out.numpy(), np.asarray(jm))


def test_saga_init_zeros_is_packed():
    st = saga.saga_init_zeros({"w": torch.zeros(3, 2), "b": torch.zeros(2)}, 4, 5)
    assert st.table.shape == (4, 5, 8) and st.avg.shape == (4, 8)
    assert st.num_samples == 5


# -- config and conversion ---------------------------------------------------------

def test_robust_config_mirrors_reference_fields():
    ref_fields = {f.name: f.default for f in dataclasses.fields(jstep.RobustConfig)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(robust_step.RobustConfig)}
    assert port_fields == ref_fields
    robust_step.RobustConfig(num_clients=4, guards=True, diagnostics=True)
    robust_step.RobustConfig(packed=False)
    with pytest.raises(ValueError, match="outside the ported slice"):
        robust_step.RobustConfig(comm="sharded")


def test_state_from_jax_carries_ef_and_bf16_state():
    """The bf16 wire's table and avg stay bf16 (the same bits), and sign1's
    error-feedback residuals come across as float32."""
    import ml_dtypes
    from repro.core import saga as jsaga
    rng = np.random.default_rng(10)
    table = rng.standard_normal((3, 4, 5)).astype(ml_dtypes.bfloat16)
    avg = table.astype(np.float32).mean(1).astype(ml_dtypes.bfloat16)
    ef = rng.standard_normal((3, 5)).astype(np.float32)
    st = jstep.FederatedState(
        params={"w": rng.standard_normal(5).astype(np.float32)}, opt_state=(),
        vr=jsaga.SagaState(table=table, avg=avg), step=np.int32(2),
        key=np.zeros(2, np.uint32), ef=ef)
    out = convert.state_from_jax(st, device="cpu")
    assert out.vr.table.dtype == out.vr.avg.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.vr.table.view(torch.int16).numpy().view(np.uint16),
        table.view(np.uint16))
    np.testing.assert_array_equal(out.vr.avg.float().numpy(),
                                  avg.astype(np.float32))
    assert out.ef.dtype == torch.float32
    np.testing.assert_array_equal(out.ef.numpy(), ef)


def test_state_from_jax_carries_params_table_and_step():
    rng = np.random.default_rng(9)
    table = rng.standard_normal((3, 4, 5)).astype(np.float32)
    from repro.core import saga as jsaga
    st = jstep.FederatedState(
        params={"w": rng.standard_normal(5).astype(np.float32)}, opt_state=(),
        vr=jsaga.SagaState(table=table, avg=table.mean(1)), step=np.int32(7),
        key=np.zeros(2, np.uint32))
    out = convert.state_from_jax(st, device="cpu")
    np.testing.assert_array_equal(out.params["w"].numpy(), st.params["w"])
    np.testing.assert_array_equal(out.vr.table.numpy(), table)
    np.testing.assert_array_equal(out.vr.avg.numpy(), table.mean(1))
    assert out.step == 7 and out.opt_state == ()
    with pytest.raises(ValueError, match="sgd"):
        convert.state_from_jax(st._replace(opt_state=({"m": table},)),
                               device="cpu")
