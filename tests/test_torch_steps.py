"""The training drivers (``repro_torch.launch.steps``, ``launch/train.py``)
and what they stand on (``Model.param_specs``, ``launch/sharding.py``, K8
under ``torch.func``) against the JAX reference, on the CPU.

One (4, 2) ("data", "model") gloo world, started once by a module-scoped
fixture and shared by every case of this file (``tests/torch_dist_cases.py``
``step_cases`` holds what the ranks compute), runs one step of the tiny
dense decoder of ``C.step_config`` (2 layers of width 64, GQA, qkv bias)
on every rank:

* ``make_train_step``: gather and sharded x sgd and saga (a SAGA table
  handed in, so the correction is not the identity) with geomed, and the
  int8 wire; the per-leaf baseline (``packed=False``) with trimmed_mean on
  gather; a sampled cohort of 4 of 8 clients with staleness weights under
  straggler; guards under a NaN worker.  Worker 0 attacks.
* ``make_decentralized_train_step`` on a ring of 4 nodes, each node its
  own parameters, gradient and params gossip, both comm paths, node 0
  attacking every edge by sign_flip.
* The rollback twin of the reference's
  ``tests/test_rollback.py::test_distributed_driver_rollback_is_deterministic``
  through ``launch/train.py``'s rank loop (``train.run``), twice, each in a
  fresh directory of the fixture's.

Each step is held against the reference composed in one process from the
same numpy parameters and batch: ``jax.vmap(jax.value_and_grad(loss))``,
``saga_correct_scatter`` with the same rows, the wire, ``apply_attack_stacked``,
the flat or per-leaf rule (or ``repro.topology``'s dense masked rule for
every node at once) and the SGD update: the loss at rtol 1e-5, the updated
parameters at rtol 1e-4 with an absolute floor of 1e-5 x the leaf's
largest entry, the other metrics at rtol 1e-4.  Every rank's parameters
(of its node, when decentralized) are checked.

Without a world: ``Model.param_specs`` against the reference's spec tree
for every dense config, the sharding specs, the ``FlashAttention`` vmap rule
(the kernel call replaced by its plain version) against a loop of
per-worker gradients, the robust-LM twin for two steps, and the serving
steps' refusal.
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as C
from repro import configs as jcfgs
from repro import topology as jtopo
from repro.configs import SHAPES as JSHAPES
from repro.core import aggregators as jagg
from repro.core import attacks as jattacks
from repro.core import guards as jguards
from repro.core import participation as jpart
from repro.core import saga as jsaga
from repro.core.robust_step import RobustConfig as JConfig
from repro.launch import sharding as jsharding
from repro.models import api as japi
from repro import optim as joptim
from repro.telemetry import metrics as jtel
from repro_torch import configs as tcfgs
from repro_torch.configs.shapes import SHAPES as TSHAPES
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm

WORLD_TIMEOUT = 240.0
STEP_CASES = C.step_cases()
NUM_WORKERS, MODEL_SIZE = C.GRID[0]
DENSE_ARCHS = [a for a in jcfgs.ARCH_NAMES
               if jcfgs.get_config(a).family == "dense"]


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """(each rank's results, each case's reference or the exception that
    computing it raised): the world runs in a thread while this one
    composes the references."""
    cases = dict(STEP_CASES, demo=dict(kind="demo", steps=1), rollback=dict(
        kind="rollback", dir=str(tmp_path_factory.mktemp("rollback"))))
    box = {}

    def world():
        try:
            box["world"] = C.run_world(*C.GRID, cases, timeout=WORLD_TIMEOUT,
                                       fn=C.run_step_cases)
        except BaseException as e:  # re-raised below, in the test's thread
            box["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    refs = {}
    try:
        for cid, case in STEP_CASES.items():
            try:
                refs[cid] = (_dec_reference if case["kind"] == "dec"
                             else _master_reference)(case)
            except Exception as e:  # raised by the case's test
                refs[cid] = e
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["world"], refs


@pytest.fixture(scope="module")
def step_world(step_run):
    return step_run[0]


def _reference_of(step_run, cid):
    ref = step_run[1][cid]
    if isinstance(ref, Exception):
        raise ref
    return ref


# -- the reference composed in one process ----------------------------------

def _tcfg():
    return C.step_config(tcfgs)


def _ref_tree(flat: dict, cfg, lead: int = 0) -> dict:
    """Port-named leaves (each with ``lead`` leading axes) -> the
    reference's tree, each pattern position's layers stacked over the
    periods after the leading axes."""
    pat, periods = cfg.resolve_pattern()
    tree: dict = {"blocks": {}}
    for name, v in flat.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
            continue
        layer = int(parts[1])
        if layer >= len(pat):
            continue
        node = tree["blocks"].setdefault(f"pos{layer}", {})
        for p in parts[2:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(np.stack(
            [flat[".".join(["blocks", str(q * len(pat) + layer), *parts[2:]])]
             for q in range(periods)], axis=lead))
    return tree


def _port_names(tree: dict, cfg, lead: int = 0) -> dict:
    """The reference's tree -> numpy leaves by the port's names."""
    pat, periods = cfg.resolve_pattern()
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            name = path + [k]
            if name[0] != "blocks":
                out[".".join(name)] = np.asarray(v)
                continue
            i = int(name[1].removeprefix("pos"))
            for q in range(periods):
                out[".".join(["blocks", str(q * len(pat) + i), *name[2:]])] = \
                    np.take(np.asarray(v), q, axis=lead)
    walk(tree, [])
    return out


def _jmodel():
    return japi.build_model(C.step_config(jcfgs), remat=False,
                            loss_chunk=C.STEP_CHUNK, q_chunk=8, kv_chunk=8)


def _robust(case) -> JConfig:
    return JConfig(comm=case["comm"], **{**C.STEP_KW, **case["cfg"]})


# Each piece jitted once for every case (eager JAX compiles every op of
# every leaf shape on its own).
@jax.jit
def _sgd(tree, agg):
    opt = joptim.get_optimizer("sgd", C.STEP_LR)
    updates, _ = opt.update(agg, opt.init(tree), tree, 0)
    return joptim.apply_updates(tree, updates)


@jax.jit
def _sq_jit(tree):
    return sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
               for x in jax.tree_util.tree_leaves(tree))


def _sq(tree) -> float:
    return float(_sq_jit(tree))


_CONSENSUS = jax.jit(jtel.consensus_dist, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _grads(nodes: bool):
    """(parameter tree, the workers' losses and gradients) of the step's
    batch: one parameter vector for the master, one a node (``nodes``)."""
    tcfg, w = _tcfg(), NUM_WORKERS
    tree = _ref_tree(C.step_params(ttfm.param_structs(tcfg),
                                   w if nodes else 0), tcfg, lead=int(nodes))
    batch = {k: jnp.asarray(v) for k, v in C.step_batch(w).items()}
    fn = jax.vmap(jax.value_and_grad(_jmodel().loss),
                  in_axes=(0 if nodes else None, 0))
    return (tree,) + jax.jit(fn)(tree, batch)


def _rule_config(robust: JConfig) -> JConfig:
    """What of a config decides its rule (the cache key of the jitted
    rules): the rule's own fields."""
    return JConfig(aggregator=robust.aggregator, vr="sgd", packed=robust.packed,
                   **{k: getattr(robust, k) for k in (
                       "weiszfeld_iters", "weiszfeld_tol", "trim",
                       "num_byzantine", "num_groups", "clip_radius")})


@functools.lru_cache(maxsize=None)
def _flat_rule(robust: JConfig, spec, weighted: bool):
    fn = robust.flat_aggregator_fn(spec)
    if weighted:
        return jax.jit(lambda buf, rw: fn(buf, row_weights=rw))
    return jax.jit(fn)


_SAGA = jax.jit(jsaga.saga_correct_scatter)


@functools.lru_cache(maxsize=None)
def _leaf_rule(robust: JConfig):
    return jax.jit(jagg.get_aggregator(
        robust.aggregator, perleaf=True, max_iters=robust.weiszfeld_iters,
        tol=robust.weiszfeld_tol, num_groups=robust.num_groups,
        trim=robust.trim, num_byzantine=robust.num_byzantine,
        clip_radius=robust.clip_radius))


def _master_reference(case) -> dict:
    tcfg, w = _tcfg(), NUM_WORKERS
    structs = ttfm.param_structs(tcfg)
    robust = _robust(case)
    tree, losses, msgs = _grads(False)
    b = robust.num_byzantine
    rw = slot_stal = None
    if case.get("table"):
        rows = C.STEP_CLIENTS if robust.num_clients else w
        table, avg = C.step_table(structs, rows)
        state = jsaga.SagaState(_ref_tree(table, tcfg, lead=2),
                                _ref_tree(avg, tcfg, lead=1))
        if robust.num_clients:
            cohort = jpart.resolve_participation(robust, w).cohort_at(
                jnp.int32(0))
            state = jax.jit(jpart.gather_rows)(state, cohort)
            slot_stal = jpart.slot_staleness(
                jnp.take(jnp.asarray(C.step_staleness()), cohort),
                robust.attack, b, straggler_k=robust.straggler_k,
                max_staleness=robust.max_staleness, byz_first=True)
            rw = jpart.staleness_weights(slot_stal,
                                         decay=robust.staleness_decay,
                                         max_staleness=robust.max_staleness)
        msgs, _ = _SAGA(state, msgs, jnp.asarray(C.step_sample_idx(w)))
    wire = robust.wire_format()
    near = None
    if wire.quantized:
        wspec = robust.message_spec(msgs, batch_ndim=1)
        near = _near_boundary(wspec, wspec.pack(msgs))
        msgs = jax.jit(lambda m: wspec.unpack(
            wspec.transmit(wspec.pack(m), None)[0]))(msgs)
    hmask = (jnp.arange(w) >= b).astype(jnp.float32)
    out = {"loss": float(jnp.mean(losses)),
           "honest_variance": float(_CONSENSUS(msgs, hmask, w - b))}
    key = jax.random.PRNGKey(0)
    if robust.packed:
        spec = robust.message_spec(msgs, batch_ndim=1)
        buf = jax.jit(lambda m: jattacks.apply_attack_stacked(
            robust.attack_config(), spec.pack(m), key, spec=spec))(msgs)
        if wire.quantized:
            near = np.maximum(near, _near_boundary(spec, buf))
            buf = spec.wire_roundtrip(buf)
        rule_spec = JConfig().message_spec(msgs, batch_ndim=1)
        if robust.guards:
            fn = robust.flat_aggregator_fn(rule_spec)

            @jax.jit
            def guarded(buf):
                gmask = jguards.guard_mask(
                    buf, multiplier=robust.guard_multiplier, base_weights=rw)
                return (jguards.guarded_flat_call(fn, buf, gmask,
                                                  row_weights=rw),
                        jnp.sum(1.0 - gmask))

            vec, quarantined = guarded(buf)
            out["quarantined_rows"] = float(quarantined)
        elif rw is None:
            vec = _flat_rule(_rule_config(robust), rule_spec, False)(buf)
        else:
            vec = _flat_rule(_rule_config(robust), rule_spec, True)(buf, rw)
        agg = spec.unpack(vec, batch_ndim=0)
    else:
        agg = _leaf_rule(_rule_config(robust))(jax.jit(
            lambda m: jattacks.apply_attack_stacked(robust.attack_config(), m,
                                                    key))(msgs))
    out["agg_norm"] = _sq(agg) ** 0.5
    if slot_stal is not None:
        out["mean_staleness"] = float(jnp.mean(slot_stal))
    out["params"] = _port_names(_sgd(tree, agg), tcfg)
    if near is not None:
        # Where a message coordinate lies within 1e-3 of a code step of a
        # rounding boundary, the two frameworks' gradients (1e-6 apart)
        # may quantize it to neighbouring codes: the aggregate may move by
        # one code step of the leaf there.
        out["slack"] = _port_names(spec.unpack(jnp.asarray(
            C.STEP_LR * near), batch_ndim=0), tcfg)
    return out


def _near_boundary(spec, buf) -> np.ndarray:
    """(D,) one int8 code step of each coordinate's leaf (its largest
    amax / 127 over the rows) where some row's value is within 1e-3 of a
    code step of a rounding boundary, else 0."""
    buf = np.asarray(buf, np.float64)
    per = np.zeros(buf.shape)
    for a, b in spec.boundaries:
        per[:, a:b] = np.abs(buf[:, a:b]).max(axis=1, keepdims=True) / 127.0
    ratio = np.abs(buf) / np.where(per > 0, per, 1.0)
    close = (np.abs(ratio - np.floor(ratio) - 0.5) < 1e-3) & (per > 0)
    return np.where(close.any(0), per.max(0), 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _masked_rule(robust: JConfig, spec):
    return jax.jit(lambda ex, mask, mixing: jtopo.masked_aggregate_flat(
        robust.aggregator, ex, mask, spec=spec, mixing=mixing,
        max_iters=robust.weiszfeld_iters, tol=robust.weiszfeld_tol,
        num_groups=robust.num_groups, trim=robust.trim,
        num_byzantine=robust.num_byzantine, clip_radius=robust.clip_radius))


def _dec_reference(case) -> dict:
    tcfg, n = _tcfg(), NUM_WORKERS
    robust = _robust(case)
    tree, losses, msgs = _grads(True)
    b = robust.num_byzantine
    honest = (jnp.arange(n) >= b).astype(jnp.float32)
    sched = jtopo.as_schedule(jtopo.get_topology(robust.topology, n))
    mask = jnp.asarray(sched.stacked_masks[0])
    mixing = jnp.asarray(sched.stacked_mixing[0], jnp.float32)

    def gossip(x):
        spec = robust.message_spec(x, batch_ndim=1)
        ex = jax.jit(lambda m: jtopo.build_exchange(
            spec.pack(m), robust.attack_config(), mask, jnp.arange(n) < b,
            spec=spec))(x)
        rule = _masked_rule(_rule_config(robust), spec)
        return spec.unpack(rule(ex, mask, mixing * mask), batch_ndim=1)

    out = {"loss": float(jnp.sum(honest * losses)) / (n - b),
           "honest_variance": float(_CONSENSUS(msgs, honest, n - b))}
    if robust.gossip == "params":
        new = gossip(_sgd(tree, msgs))
        move = jax.jit(lambda a, p: jax.tree_util.tree_map(
            lambda x, y: x - y, a, p))(new, tree)
    else:
        move = gossip(msgs)
        new = _sgd(tree, move)
    out["agg_norm"] = (_sq(move) / n) ** 0.5
    out["consensus_dist"] = float(_CONSENSUS(new, honest, n - b))
    out["params"] = _port_names(new, tcfg, lead=1)
    return out


def _check_params(got: dict, want: dict, what: str, node=None, slack=None):
    assert set(got) == set(want), what
    for k, v in want.items():
        ref = v if node is None else v[node]
        tol = 1e-4 * np.abs(ref) + 1e-5 * float(np.abs(ref).max())
        if slack is not None:
            tol = tol + slack[k]
        bad = np.abs(got[k] - ref) > tol
        assert not bad.any(), (f"{what} {k}: {int(bad.sum())} of {bad.size} "
                               f"off, largest {np.abs(got[k] - ref).max():.3g}")


def _check_step(world, cid, want):
    for rank, res in enumerate(world):
        got = res[cid]
        assert got["step"] == 1, cid
        metrics = got["metrics"]
        np.testing.assert_allclose(metrics["loss"], want["loss"], rtol=1e-5,
                                   err_msg=f"{cid} loss")
        for k, v in want.items():
            if k in ("loss", "params", "slack"):
                continue
            np.testing.assert_allclose(metrics[k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{cid} {k}")
        if "params" in got:
            node = rank // MODEL_SIZE
            _check_params(got["params"], want["params"], f"{cid} rank {rank}",
                          node if STEP_CASES[cid]["kind"] == "dec" else None,
                          want.get("slack"))


MASTER_IDS = [c for c, case in STEP_CASES.items() if case["kind"] == "master"]
DEC_IDS = [c for c, case in STEP_CASES.items() if case["kind"] == "dec"]


@pytest.mark.parametrize("cid", MASTER_IDS)
def test_train_step_matches_reference(step_run, cid):
    _check_step(step_run[0], cid, _reference_of(step_run, cid))


@pytest.mark.parametrize("cid", DEC_IDS)
def test_decentralized_train_step_matches_reference(step_run, cid):
    _check_step(step_run[0], cid, _reference_of(step_run, cid))


def test_driver_rollback_is_deterministic(step_world):
    """The twin of the reference's rollback test through ``train.run`` on
    the reduced qwen2-7b: ``--loss-blowup 0.5`` marks every round after the
    first as bad (its loss exceeds half the best so far), so with patience
    2 RunHealth arms on any data and the loop restores the last good
    checkpoint; two runs give equal ``resilience`` dicts on every rank."""
    r1 = step_world[0]["rollback"]["a"]
    assert r1["rollbacks"] >= 1, r1
    assert np.isfinite(r1["final_loss"]), r1
    for res in step_world:
        assert res["rollback"]["a"] == res["rollback"]["b"] == r1


def test_mesh_demo_twin_gather_and_sharded_agree(step_world):
    """``repro_torch.federated_mesh_demo.run`` for one step of each comm
    path: finite losses, and the same parameters within the reference
    test's own tolerance for gather against sharded (its
    tests/test_distributed.py:618, rtol 2e-3, atol 2e-4)."""
    demo = step_world[0]["demo"]
    for comm in ("gather", "sharded"):
        assert len(demo[comm]["losses"]) == 1
        assert np.all(np.isfinite(demo[comm]["losses"])), comm
    for k, v in demo["gather"]["params"].items():
        np.testing.assert_allclose(demo["sharded"]["params"][k], v,
                                   rtol=2e-3, atol=2e-4, err_msg=k)


# -- without a world ---------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_specs_match_reference(arch):
    """Every parameter's spec for a (4, 16) mesh (one sharding that does not
    divide its dimension becomes None, as in the reference) and its shape,
    by the port's names (the reference's stacked period axis dropped)."""
    sizes = {"data": 4, "model": 16}
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jmodel = japi.build_model(jcfg)
    tmodel = tapi.build_model(tcfg, device="cpu")
    jspecs = jax.tree_util.tree_map(lambda s: tuple(s), jmodel.param_specs(sizes),
                                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want, got = {}, tmodel.param_specs(sizes)
    pat, periods = tcfg.resolve_pattern()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif path and path[0] == "blocks":
                i = int(path[1].removeprefix("pos"))
                for q in range(periods):
                    want[".".join(["blocks", str(q * len(pat) + i), *path[2:], k])] = \
                        tuple(v)[1:]
            else:
                want[".".join(path + [k])] = tuple(v)
    walk(jspecs, [])
    pad = {k: s + (None,) * (len(got[k]) - len(s)) for k, s in want.items()}
    assert got == pad
    structs = jax.tree_util.tree_leaves(jmodel.param_structs())
    assert sum(int(np.prod(s.shape)) for s in structs) == sum(
        t.numel() for t in tmodel.param_structs().values())


def test_sharding_specs_match_reference():
    """fsdp_param_specs, batch_specs, cache_batch_axis and cache_specs_for
    against the reference's on a (2, 4, 2) and a (4, 2) mesh, for a dense,
    an SSM and the audio config, every assigned shape."""
    for sizes in ({"pod": 2, "data": 4, "model": 2}, {"data": 4, "model": 2}):
        fake = _FakeMesh(sizes)
        for arch in ("qwen2-7b", "mamba2-130m", "whisper-tiny", "paligemma-3b"):
            jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
            for name, jshape in JSHAPES.items():
                tshape = TSHAPES[name]
                assert tsharding.batch_specs(tcfg, tshape, sizes) == _tuples(
                    jsharding.batch_specs(jcfg, jshape, fake))
                assert tsharding.cache_batch_axis(tshape, sizes) == \
                    jsharding.cache_batch_axis(jshape, fake)
                assert tsharding.cache_specs_for(tcfg, tshape, sizes) == _tuples(
                    jsharding.cache_specs_for(jcfg, jshape, fake))
        specs = tapi.build_model(tcfgs.get_config("qwen2-7b"),
                                 device="cpu").param_specs(sizes)
        structs = ttfm.param_structs(tcfgs.get_config("qwen2-7b"))
        got = tsharding.fsdp_param_specs(specs, sizes, structs)
        jspecs = {k: jax.sharding.PartitionSpec(*v) for k, v in specs.items()}
        jstructs = {k: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
                    for k, t in structs.items()}
        want = jsharding.fsdp_param_specs(jspecs, fake, jstructs)
        assert got == _tuples(want)


class _FakeMesh:
    """What the reference's spec functions read of a mesh: its axis names
    and sizes (``repro.launch.mesh.axis_sizes`` / ``worker_axes``)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_flash_attention_vmap_rule_folds_workers_into_the_batch(monkeypatch):
    """``vmap(grad)`` through ``FlashAttention`` with the kernel call
    replaced by its plain version: one call on the folded (W * B, ...)
    batch, and the gradients of a loop of per-worker ``grad`` s (each one
    call on (B, ...)), bitwise."""
    calls = []

    def plain(q, k, v, causal, out_dtype=None, *, route=None, window=None):
        calls.append(tuple(q.shape))
        return fa.flash_attention_plain(q, k, v, causal, out_dtype, window)

    monkeypatch.setattr(fa, "flash_attention_call", plain)
    w, b, s, h, kv, hd = 3, 2, 9, 4, 2, 8
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((w, b, s, 16)).astype(np.float32))
    params = {n: torch.from_numpy(rng.standard_normal((16, m * hd))
                                  .astype(np.float32))
              for n, m in (("wq", h), ("wk", kv), ("wv", kv))}

    def loss(p, xb):
        q = (xb @ p["wq"]).reshape(b, s, h, hd)
        k = (xb @ p["wk"]).reshape(b, s, kv, hd)
        v = (xb @ p["wv"]).reshape(b, s, kv, hd)
        return torch.sum(fa.FlashAttention.apply(q, k, v, True, None) ** 2)

    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, x)
    assert calls == [(w * b, s, h, hd)]
    for i in range(w):
        one = torch.func.grad(loss)(params, x[i])
        for n in params:
            assert torch.equal(batched[n][i], one[n]), (i, n)
    assert calls[1:] == [(b, s, h, hd)] * w


def test_robust_lm_twin_trains_two_steps(monkeypatch):
    """The robust-LM twin's whole step (vmap(grad), SAGA, the attack,
    geomed, AdamW) on a 2-layer preset of width 64 for two steps."""
    from repro_torch import train_robust_lm
    monkeypatch.setitem(train_robust_lm.PRESETS, "tiny", dataclasses.replace(
        train_robust_lm.PRESETS["small"], num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128))
    out = train_robust_lm.main(["--preset", "tiny", "--steps", "2",
                                "--workers", "4", "--byzantine", "1",
                                "--seq", "16", "--per-worker-batch", "1",
                                "--saga-samples", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_serving_steps_raise_naming_their_queue_item():
    model = tapi.build_model(_tcfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="11.7"):
        tsteps.make_prefill_step(model, None)
    with pytest.raises(NotImplementedError, match="11.7"):
        tsteps.make_serve_step(model, TSHAPES["long_500k"], None)
