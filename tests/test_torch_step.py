"""The PyTorch port's training step against the JAX reference, end to end.

Two problems at small size: ``test_convergence.py``'s logistic regression
(W_h = 12, B = 5, n = 960) and a narrow Table I network (784 -> 16 -> 10).
Both packages start from the same state -- the reference's ``init_fn``
state carried over with ``convert.state_from_jax`` -- and the port is
handed each step's sample draws, recomputed from the reference's key the
way ``step_fn_packed`` draws them.  After 20 steps the parameters agree to
rtol 1e-4 / atol 1e-5: the Weiszfeld tol early stop may end one iteration
apart across the frameworks, and 20 steps carry that difference along.
BSGD (``vr="minibatch"``) is held the same way for 3 steps, with the
reference's (W_h, B) draws handed in, on the master and the decentralized
steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RobustConfig as JConfig
from repro.core import make_federated_step as j_make_step
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import mnist_like as j_mnist_like
from repro.data import partition as j_partition
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch import convert
from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.data import logreg_loss
from repro_torch.models import paper_nn
from repro_torch.optim import get_optimizer

STEPS = 20
# (attack, aggregator, problem): the main path's rules under three attacks
# on both problems, every Fig. 6 rule under sign_flip on the logistic
# regression, and two of them on the narrow Table I network.
CASES = ([(attack, agg, problem) for problem in ("logreg", "nn")
          for attack in ("none", "sign_flip", "zero_gradient")
          for agg in ("geomed", "mean")]
         + [("sign_flip", agg, "logreg")
            for agg in ("median", "trimmed_mean", "krum", "geomed_groups",
                        "centered_clip", "geomed_blockwise")]
         + [("sign_flip", agg, "nn") for agg in ("median", "geomed_blockwise")])


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
        data = j_ijcnn1_like(jax.random.PRNGKey(0), n=960)
        wd = j_partition({"a": data.x, "b": data.y}, 12, seed=1)
        params = {"w": np.zeros(22, np.float32)}
        return j_logreg_loss(0.01), logreg_loss(0.01), wd, params, 12, 5, 0.02
    data = j_mnist_like(jax.random.PRNGKey(0), n=120)
    wd = j_partition({"x": data.x, "y": data.y}, 6, seed=2)
    rng = np.random.default_rng(7)
    params = {"w1": 0.05 * rng.standard_normal((784, 16)).astype(np.float32),
              "b1": np.zeros(16, np.float32),
              "w2": 0.05 * rng.standard_normal((16, 10)).astype(np.float32),
              "b2": np.zeros(10, np.float32)}
    return _j_nn_loss, paper_nn.nn_loss, wd, params, 6, 3, 0.1


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("attack,agg,problem", CASES)
def test_step_parity_with_reference(problem, attack, agg):
    j_loss, t_loss, wd, params, wh, b, lr = _problem(problem)
    nb = b if attack != "none" else 0
    cfg = dict(aggregator=agg, vr="saga", attack=attack, num_byzantine=nb,
               trim=max(nb, 1))
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", lr))
    _, t_step = make_federated_step(
        t_loss, _numpy(wd), RobustConfig(**cfg),
        get_optimizer("sgd", lr), device="cpu")
    j_state = j_init({k: jnp.asarray(v) for k, v in params.items()},
                     jax.random.PRNGKey(5))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    for _ in range(STEPS):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (wh,), 0, j))
        j_state, j_metrics = j_step(j_state)
        t_state, t_metrics = t_step(t_state, sample_idx=idx)
    for k in params:
        np.testing.assert_allclose(t_state.params[k].numpy(),
                                   np.asarray(j_state.params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(t_metrics["honest_variance"]),
                               float(j_metrics["honest_variance"]), rtol=1e-4)
    assert t_state.step == STEPS


@pytest.mark.parametrize("problem", ["logreg", "nn"])
def test_init_table_matches_reference(problem):
    """The port's Alg. 1 init (filled worker by worker) gives the
    reference's packed table and average."""
    j_loss, t_loss, wd, params, _, _, lr = _problem(problem)
    j_init, _ = j_make_step(j_loss, wd, JConfig(), j_get_optimizer("sgd", lr))
    t_init, _ = make_federated_step(t_loss, _numpy(wd), RobustConfig(),
                                    get_optimizer("sgd", lr), device="cpu")
    j_vr = j_init({k: jnp.asarray(v) for k, v in params.items()},
                  jax.random.PRNGKey(5)).vr
    t_vr = t_init({k: torch.from_numpy(v) for k, v in params.items()}, 0).vr
    np.testing.assert_allclose(t_vr.table.numpy(), np.asarray(j_vr.table),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_vr.avg.numpy(), np.asarray(j_vr.avg),
                               rtol=1e-5, atol=1e-6)


def test_gaussian_step_with_reference_noise():
    """The gaussian attack's step, with the reference's index and noise
    draws handed in, tracks the reference for a few steps."""
    from repro.core import attacks as jattacks
    from repro.core import packing as jpacking
    j_loss, t_loss, wd, params, wh, b, lr = _problem("logreg")
    cfg = dict(aggregator="geomed", vr="saga", attack="gaussian", num_byzantine=b)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", lr))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", lr), device="cpu")
    j_state = j_init({"w": jnp.zeros(22)}, jax.random.PRNGKey(5))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    spec = jpacking.pack_spec(j_state.params, batch_ndim=0)
    j_step = jax.jit(j_step)
    for _ in range(5):
        _, k_idx, k_attack = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (wh,), 0, 80))
        noise = np.array(jattacks.packed_gaussian_noise(spec, k_attack, (b,), 1.0))
        j_state, _ = j_step(j_state)
        t_state, _ = t_step(t_state, sample_idx=idx,
                            attack_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)


BSGD_CASES = [(agg, attack) for agg in ("mean", "geomed")
              for attack in ("none", "sign_flip")]
MINIBATCH = 7


def _bsgd_parity(j_loss, t_loss, wd, params, wh, lr, steps, **cfg):
    """``steps`` BSGD steps of the reference and of the port from the
    reference's init state, the port handed the reference's (W_h, B)
    draws; returns both final states."""
    cfg = dict(vr="minibatch", minibatch_size=MINIBATCH, **cfg)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", lr))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", lr), device="cpu")
    j_state = j_init({k: jnp.asarray(v) for k, v in params.items()},
                     jax.random.PRNGKey(5))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    assert t_state.vr is None
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    for _ in range(steps):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (wh, MINIBATCH), 0, j))
        j_state, j_metrics = j_step(j_state)
        t_state, t_metrics = t_step(t_state, sample_idx=idx)
    np.testing.assert_allclose(float(t_metrics["honest_variance"]),
                               float(j_metrics["honest_variance"]), rtol=1e-4)
    return t_state, j_state


@pytest.mark.parametrize("agg,attack", BSGD_CASES)
def test_minibatch_step_parity_with_reference(agg, attack):
    """BSGD on the master path: each worker's gradient of the mean loss
    over its B = 7 drawn rows, 3 steps against the reference's
    ``make_federated_step`` (rtol 1e-4 / atol 1e-5, the tolerance of the
    SAGA runs above)."""
    j_loss, t_loss, wd, params, wh, b, lr = _problem("logreg")
    nb = b if attack != "none" else 0
    t_state, j_state = _bsgd_parity(j_loss, t_loss, wd, params, wh, lr, 3,
                                    aggregator=agg, attack=attack,
                                    num_byzantine=nb)
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)
    assert t_state.step == 3


def test_minibatch_decentralized_step_parity_with_reference():
    """BSGD on the decentralized step (a ring of 12 honest + 5 Byzantine
    nodes, geomed, sign_flip per edge): every node's params after 3 steps
    agree with the reference's."""
    j_loss, t_loss, wd, params, wh, b, lr = _problem("logreg")
    t_state, j_state = _bsgd_parity(j_loss, t_loss, wd, params, wh, lr, 3,
                                    aggregator="geomed", attack="sign_flip",
                                    num_byzantine=b, topology="ring",
                                    weiszfeld_iters=32)
    assert t_state.params["w"].shape == (wh + b, 22)
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]),
                               rtol=1e-4, atol=1e-5)


def test_minibatch_sample_idx_is_validated():
    """BSGD takes (W_h, B) draws and refuses the one-sample (W_h,) layout,
    a wrong B and rows out of range; its own draws are (W_h, B)."""
    _, t_loss, wd, _, wh, _, lr = _problem("logreg")
    init, step = make_federated_step(
        t_loss, _numpy(wd), RobustConfig(vr="minibatch", minibatch_size=4),
        get_optimizer("sgd", lr), device="cpu")
    st = init({"w": torch.zeros(22)}, 0)
    with pytest.raises(ValueError, match=r"\(12, 4\)"):
        step(st, sample_idx=np.zeros(wh, np.int64))
    with pytest.raises(ValueError, match=r"\(12, 4\)"):
        step(st, sample_idx=np.zeros((wh, 5), np.int64))
    with pytest.raises(ValueError, match="out of range"):
        step(st, sample_idx=np.full((wh, 4), 80))
    st, _ = step(st, sample_idx=np.zeros((wh, 4), np.int64))
    st, metrics = step(st)
    assert st.step == 2 and bool(torch.isfinite(st.params["w"]).all())
    assert float(metrics["honest_variance"]) > 0.0


def test_sample_idx_is_validated():
    j_loss, t_loss, wd, params, wh, b, lr = _problem("logreg")
    init, step = make_federated_step(t_loss, _numpy(wd), RobustConfig(vr="sgd"),
                                     get_optimizer("sgd", lr), device="cpu")
    st = init({"w": torch.zeros(22)}, 0)
    with pytest.raises(ValueError, match="out of range"):
        step(st, sample_idx=np.full(wh, 80))
    with pytest.raises(ValueError, match=r"\(12,\)"):
        step(st, sample_idx=np.zeros(3, np.int64))
