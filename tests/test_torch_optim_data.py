"""The rest of the port's data and optimizers against the JAX reference, on
the CPU: ``momentum`` (and Nesterov), ``adam``, ``adamw`` and
``cosine_schedule`` over five updates on a two-leaf dict at rtol 1e-6,
``partition(mode="sorted")`` exactly (numpy-seeded in both), the shapes,
range and shift of ``token_stream``, and a master step trained with adam
against the reference's at rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RobustConfig as JConfig
from repro.core import make_federated_step as j_make_step
from repro.data import federated as jfederated
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import partition as j_partition
from repro.optim import optimizers as joptim
from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.data import federated, logreg_loss, token_stream
from repro_torch.optim import optimizers

CASES = {
    "momentum": ("momentum", {}),
    "nesterov": ("momentum", dict(beta=0.8, nesterov=True)),
    "adam": ("adam", {}),
    "adam-b2": ("adam", dict(b1=0.8, b2=0.99, eps=1e-6)),
    "adamw": ("adamw", {}),
    "adamw-decay": ("adamw", dict(weight_decay=0.1)),
}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_updates_match_reference(case, schedule):
    """Five updates on a two-leaf dict, new gradients each time, at a
    constant rate or on a cosine schedule (warm-up 2, total 4): params and
    the state's leaves at rtol 1e-6."""
    name, kw = CASES[case]
    lr = 0.05
    j_lr = joptim.cosine_schedule(lr, 2, 4) if schedule else lr
    t_lr = optimizers.cosine_schedule(lr, 2, 4) if schedule else lr
    jo, to = joptim.get_optimizer(name, j_lr, **kw), optimizers.get_optimizer(name, t_lr, **kw)
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, step)
        tu, ts = to.update({k: _t(v) for k, v in g.items()}, ts, tp, step)
        jp, tp = joptim.apply_updates(jp, ju), optimizers.apply_updates(tp, tu)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    j_leaves, t_leaves = jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(ts)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_reference():
    j, t = joptim.cosine_schedule(0.1, 3, 10, 0.2), optimizers.cosine_schedule(0.1, 3, 10, 0.2)
    for step in range(13):
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=1e-6)


def test_optimizer_state_is_not_written_in_place():
    """A rejected round keeps the old state: update makes new tensors."""
    to = optimizers.get_optimizer("adam", 0.1)
    p = {"w": torch.ones(4)}
    s0 = to.init(p)
    _, s1 = to.update({"w": torch.ones(4)}, s0, p, 0)
    assert torch.equal(s0.mu["w"], torch.zeros(4)) and not torch.equal(s1.mu["w"], s0.mu["w"])


@pytest.mark.parametrize("spw", [None, 9])
def test_partition_sorted_matches_reference(spw):
    """Sorted by the last name's values (the labels), stably: the
    reference's shards exactly."""
    rng = np.random.default_rng(4)
    data = {"a": rng.standard_normal((60, 5)).astype(np.float32),
            "b": rng.integers(0, 6, 60).astype(np.int64)}
    want = jfederated.partition(data, 4, mode="sorted", seed=5,
                                samples_per_worker=spw)
    got = federated.partition(data, 4, mode="sorted", seed=5,
                              samples_per_worker=spw, device="cpu")
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert bool(torch.all(got["b"][:, 1:] >= got["b"][:, :-1]))


def test_token_stream_shapes_range_and_shift():
    out = token_stream(3, 16, 50, generator=7, device="cpu")
    assert set(out) == {"tokens", "labels"}
    assert out["tokens"].shape == out["labels"].shape == (3, 16)
    assert out["tokens"].dtype == torch.int64
    both = torch.cat([out["tokens"], out["labels"]])
    assert int(both.min()) >= 0 and int(both.max()) < 50
    assert torch.equal(out["tokens"][:, 1:], out["labels"][:, :-1])
    again = token_stream(3, 16, 50, generator=7, device="cpu")
    assert torch.equal(again["tokens"], out["tokens"])


def test_master_step_with_adam_matches_reference():
    """Three packed master steps (geomed under sign_flip) with adam, the
    reference's sample draws handed in."""
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=480)
    wd = j_partition({"a": data.x, "b": data.y}, 8, seed=1)
    cfg = dict(aggregator="geomed", vr="saga", attack="sign_flip",
               num_byzantine=3, weiszfeld_iters=32)
    j_init, j_step = j_make_step(j_logreg_loss(0.01), wd, JConfig(**cfg),
                                 joptim.get_optimizer("adam", 0.01))
    t_init, t_step = make_federated_step(
        logreg_loss(0.01), jax.tree_util.tree_map(np.array, wd), RobustConfig(**cfg),
        optimizers.get_optimizer("adam", 0.01), device="cpu")
    j_state = j_init({"w": jnp.zeros(22, jnp.float32)}, jax.random.PRNGKey(5))
    t_state = t_init({"w": torch.zeros(22)}, 0)
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    for _ in range(3):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (8,), 0, j))
        j_state, _ = j_step(j_state)
        t_state, _ = t_step(t_state, sample_idx=idx)
    np.testing.assert_allclose(t_state.params["w"].numpy(),
                               np.asarray(j_state.params["w"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_state.opt_state.nu["w"].numpy(),
                               np.asarray(j_state.opt_state.nu["w"]), rtol=1e-4,
                               atol=1e-9)
