"""The port's aggregation diagnostics, step metrics, RunLogger and
PhaseTimer against the JAX reference.

Diagnostics: ``dist`` and ``weight`` at rtol 1e-5, ``selected`` and the
iteration counts exact, for every flat rule (with and without row weights)
and every masked rule; ``diagnostics=False`` is bitwise the rule's plain
output, and so is the aggregate next to the diagnostics.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtelemetry
from repro.core import RobustConfig as JConfig
from repro.core import aggregators as jagg
from repro.core import make_federated_step as j_make_step
from repro.core import packing as jpacking
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import partition as j_partition
from repro.optim import get_optimizer as j_get_optimizer
from repro.topology import masked as jmasked
from repro_torch import convert, telemetry
from repro_torch.core import RobustConfig, make_federated_step, packing
from repro_torch.data import logreg_loss
from repro_torch.optim import get_optimizer
from repro_torch.topology import masked

RULES = tuple(jagg._FLAT_REGISTRY)
FIELDS = ("dist", "weight", "score", "clip_frac", "residual")


def _t(x):
    return torch.as_tensor(np.array(x))


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _specs():
    j = jpacking.pack_spec({"a": jnp.zeros(17), "b": jnp.zeros(6)},
                           batch_ndim=0)
    t = packing.pack_spec({"a": torch.zeros(17), "b": torch.zeros(6)},
                          batch_ndim=0)
    return j, t


def _buf(w=10, b=3, seed=0):
    """Honest rows around 1, the last ``b`` rows far away."""
    rng = np.random.default_rng(seed)
    buf = 1.0 + 0.3 * rng.standard_normal((w, 23)).astype(np.float32)
    buf[w - b:] = -4.0 + rng.standard_normal((b, 23)).astype(np.float32)
    return buf


def _cfg(name):
    return dict(aggregator=name, num_byzantine=3, num_groups=3, trim=2,
                weiszfeld_iters=32, clip_radius=1.0)


def _compare(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(want.selected))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", RULES)
def test_flat_diagnostics_match_reference(name, weighted):
    jspec, tspec = _specs()
    buf = _buf()
    rw = None
    if weighted:
        rw = np.linspace(0.4, 1.0, buf.shape[0]).astype(np.float32)
        rw[2] = 0.0
    jfn = JConfig(diagnostics=True, **_cfg(name)).flat_aggregator_fn(jspec)
    tfn = RobustConfig(diagnostics=True, **_cfg(name)).flat_aggregator_fn(tspec)
    kw_j = {} if rw is None else dict(row_weights=jnp.asarray(rw))
    kw_t = {} if rw is None else dict(row_weights=_t(rw))
    j_out, j_diag = jfn(jnp.asarray(buf), **kw_j)
    t_out, t_diag = tfn(_t(buf), **kw_t)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-6)
    _compare(t_diag, j_diag)
    # Off, the rule is the program it was; on, the aggregate is the same.
    plain = RobustConfig(**_cfg(name)).flat_aggregator_fn(tspec)(_t(buf), **kw_t)
    assert torch.equal(plain, t_out)


def test_diagnostics_rank_attackers_low():
    _, tspec = _specs()
    fn = RobustConfig(diagnostics=True, **_cfg("geomed")).flat_aggregator_fn(tspec)
    _, diag = fn(_t(_buf()))
    assert float(diag.weight[:7].min()) > float(diag.weight[7:].max())
    metrics = telemetry.diagnostics_metrics(diag)
    assert set(metrics) == {"diag_" + f for f in diag._fields}


def _exchange(r=6, s=8, d=23, seed=1):
    rng = np.random.default_rng(seed)
    ex = 1.0 + 0.3 * rng.standard_normal((r, s, d)).astype(np.float32)
    ex[:, -2:] = -4.0
    mask = (rng.random((r, s)) > 0.25).astype(np.float32)
    mask[np.arange(r), np.arange(r)] = 1.0
    return ex, mask


@pytest.mark.parametrize("name", RULES)
def test_masked_diagnostics_match_reference(name):
    jspec, tspec = _specs()
    ex, mask = _exchange()
    opts = dict(max_iters=32, tol=1e-6, num_groups=3, trim=1,
                num_byzantine=2, clip_radius=1.0)
    j_out, j_diag = jmasked.masked_aggregate_flat(
        name, jnp.asarray(ex), jnp.asarray(mask), spec=jspec,
        diagnostics=True, mixing=jnp.asarray(mask) / 8, **opts)
    t_out, t_diag = masked.masked_aggregate_flat(
        name, _t(ex), _t(mask), spec=tspec, diagnostics=True,
        mixing=_t(mask) / 8, **opts)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-6)
    _compare(t_diag, j_diag)
    plain = masked.masked_aggregate_flat(name, _t(ex), _t(mask), spec=tspec,
                                         mixing=_t(mask) / 8, **opts)
    assert torch.equal(plain, t_out)
    j_red = jtelemetry.reduce_masked_diagnostics(j_diag, jnp.asarray(mask))
    t_red = telemetry.reduce_masked_diagnostics(t_diag, _t(mask))
    _compare(t_red, j_red)


def test_masked_diagnostics_with_fractional_weights():
    """A staleness-weighted mask (geomed takes the weighted-mean start)."""
    ex, mask = _exchange(seed=4)
    rw = np.linspace(0.5, 1.0, mask.shape[1]).astype(np.float32)
    j_out, j_diag = jmasked.masked_aggregate_flat(
        "geomed", jnp.asarray(ex), jnp.asarray(mask * rw), diagnostics=True,
        max_iters=32)
    t_out, t_diag = masked.masked_aggregate_flat(
        "geomed", _t(ex), _t(mask), diagnostics=True, max_iters=32,
        row_weights=_t(rw))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-6)
    _compare(t_diag, j_diag)


# -- steps --------------------------------------------------------------------------

def _logreg():
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=600)
    wd = j_partition({"a": data.x, "b": data.y}, 8, seed=1)
    return j_logreg_loss(0.01), logreg_loss(0.01), wd


@pytest.mark.parametrize("topology", ["star", "ring"])
def test_step_diagnostics_metrics_match_reference(topology):
    """Three diagnosed geomed steps under sign_flip: the ``diag_*`` metrics
    against the reference's (per worker on the master path, per sender on
    the ring), with the same params as without diagnostics."""
    j_loss, t_loss, wd = _logreg()
    cfg = dict(aggregator="geomed", vr="saga", attack="sign_flip",
               num_byzantine=3, diagnostics=True, topology=topology,
               weiszfeld_iters=32)
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", 0.05))
    runs = {}
    for diag in (True, False):
        _, runs[diag] = make_federated_step(
            t_loss, _numpy(wd), RobustConfig(**{**cfg, "diagnostics": diag}),
            get_optimizer("sgd", 0.05), device="cpu")
    j_state = j_init({"w": jnp.zeros(22, jnp.float32)}, jax.random.PRNGKey(3))
    states = {d: convert.state_from_jax(_numpy(j_state), device="cpu")
              for d in runs}
    j_step = jax.jit(j_step)
    for _ in range(3):
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (8,), 0, 75))
        j_state, j_m = j_step(j_state)
        for d, step in runs.items():
            states[d], m = step(states[d], sample_idx=idx)
            if d:
                t_m = m
    assert torch.equal(states[True].params["w"], states[False].params["w"])
    for k in ("diag_dist", "diag_weight"):
        np.testing.assert_allclose(t_m[k].numpy(), np.asarray(j_m[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(t_m["diag_selected"]) == int(j_m["diag_selected"])
    if topology == "star":
        w = t_m["diag_weight"].numpy()
        assert w[:8].min() > w[8:].max()


def test_health_and_staleness_metrics():
    assert telemetry.health_metrics(None, None) == {}
    assert telemetry.staleness_metrics(None) == {}
    h = torch.tensor([2.0, 5.0, 1.0, 7.0])
    got = telemetry.health_metrics(h, torch.tensor(True))
    want = jtelemetry.health_metrics(jnp.asarray(h.numpy()), jnp.bool_(True))
    assert set(got) == set(want)
    for k in got:
        assert float(got[k]) == float(want[k])
    s = np.array([0, 3, 64, 1], np.int32)
    assert float(telemetry.staleness_metrics(_t(s))["mean_staleness"]) == \
        float(jtelemetry.staleness_metrics(jnp.asarray(s))["mean_staleness"])


def test_runlogger_records_match_the_reference(tmp_path):
    """The same rows through both loggers: identical JSONL records and
    meta; device tensors are read only at flush."""
    rows = [(t, {"loss": np.float32(1.0 / (t + 1)), "diag_dist":
                 np.arange(3, dtype=np.float32) * t}, {"time_step_s": 0.5})
            for t in range(5)]
    seen = []
    with telemetry.RunLogger(str(tmp_path / "t"), log_every=2, flush_every=2,
                             on_row=seen.append) as tl:
        tl.write_meta(cfg={"vr": "saga"})
        for step, m, host in rows:
            tl.log_step(step, {k: torch.as_tensor(v) for k, v in m.items()},
                        host)
    with jtelemetry.RunLogger(str(tmp_path / "j"), log_every=2,
                              flush_every=2) as jl:
        jl.write_meta(cfg={"vr": "saga"})
        for step, m, host in rows:
            jl.log_step(step, {k: jnp.asarray(v) for k, v in m.items()}, host)
    for name in ("metrics.jsonl", "meta.json"):
        got = (tmp_path / "t" / name).read_text()
        want = (tmp_path / "j" / name).read_text()
        assert got == want, name
    lines = (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 2, 4]
    assert [r["step"] for r in seen] == [0, 2, 4]


def test_phase_timer_accumulates_and_drains():
    timer = telemetry.PhaseTimer(device=None)
    for _ in range(2):
        with timer.phase("step"):
            sum(range(1000))
    with timer.phase("data"):
        pass
    snap = timer.snapshot()
    assert set(snap) == {"time_step_s", "time_data_s"}
    assert snap["time_step_s"] >= 0.0
    assert timer.snapshot() == {}
    assert telemetry.PhaseTimer().device == (
        torch.device("cuda") if torch.cuda.is_available() else None)
