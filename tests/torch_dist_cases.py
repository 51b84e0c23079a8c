"""The cases of ``tests/test_torch_distributed.py``, computed on every rank
of a local ``gloo`` world (:func:`repro_torch.launch.mesh.spawn_mesh`):
the master's aggregation and attack, and the decentralized aggregation
(``decentralized_aggregate``, one node a worker index).

Each rank makes the same messages from a seed with numpy, takes its worker's
message and its model shard of it, runs every case and returns its local
results as numpy arrays; the test file holds them against the JAX
reference's single-process rule on the same arrays.  Imports torch and the
port only (no JAX), so the ranks start quickly.
"""
import numpy as np
import torch

from repro_torch.core import attacks as attack_lib
from repro_torch.core.aggregators import AGGREGATOR_NAMES
from repro_torch.core.robust_step import (RobustConfig, distributed_aggregate,
                                          distributed_attack,
                                          sharded_aggregate)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.topology import (cyclic_schedule, decentralized_aggregate,
                                  get_topology, ring, torus2d)

AGGREGATORS = AGGREGATOR_NAMES
ATTACKS = tuple(attack_lib.ATTACK_NAMES)
COMMS = ("gather", "sharded")
# The rules' settings, as the reference's tests/test_distributed.py.
RULE_KW = dict(weiszfeld_iters=100, weiszfeld_tol=1e-9, num_byzantine=1,
               clip_radius=2.5)
ROW_WEIGHTS = (1.0, 0.0, 1.0, 0.5)
GRID = ((4, 2), ("data", "model"))
POD = ((2, 4, 1), ("pod", "data", "model"))
# sharded geomed_blockwise's edge cases (the reference's :399): leaves that
# a worker's slice starts inside or misses, and padding.
BLOCKWISE_EDGE = {"single_leaf": {"only": (10,)},
                  "three_leaves": {"a": (6,), "b": (3, 3), "c": (7,)}}
# The decentralized cases' settings: node 0 attacks every edge by
# sign_flip (the reference's tests/test_distributed.py:228).  Every path
# stops its Weiszfeld loops together with the dense reference's (the
# largest move over the receivers), so tol 1e-7 leaves the two within
# about 1e-6 of each other.
DEC_KW = dict(RULE_KW, attack="sign_flip", trim=1, weiszfeld_tol=1e-7)
DEC_GRAPHS = ("ring", "torus2d", "erdos_renyi")
# Weighted: K7's rule in torch, the Weiszfeld start by K3, Krum's live
# count, the mixing mean, the segments' weights.  Diagnostics: the
# Weiszfeld facts, Krum's scores, the clip fraction, the segments'.
DEC_WEIGHTED = ("geomed", "trimmed_mean", "krum", "mean", "geomed_blockwise")
DEC_DIAGNOSTICS = ("geomed", "trimmed_mean", "krum", "centered_clip",
                   "geomed_blockwise")
# Messages whose local shard (7 + 3 coordinates) the sharded paths pad to
# a multiple of 4 workers, with slices that end inside a leaf.
PADDED_SHAPES = {"a": (14,), "b": (3, 2)}


def messages(num_workers: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The W messages of the sweep: leaves a (W, 16) and b (W, 6, 4)."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((num_workers, 16)).astype(np.float32),
            "b": rng.standard_normal((num_workers, 6, 4)).astype(np.float32)}


def padded_messages(num_workers: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(3)
    return {k: rng.standard_normal((num_workers,) + s).astype(np.float32)
            for k, s in PADDED_SHAPES.items()}


def params_messages(num_workers: int) -> dict[str, np.ndarray]:
    """Half-stepped models: :func:`messages` moved by a small step."""
    rng = np.random.default_rng(4)
    return {k: (v - 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in messages(num_workers).items()}


MESSAGES = {"base": messages, "padded": padded_messages,
            "params": params_messages}


def dec_graph(label: str, num_nodes: int):
    """A decentralized case's graph: a topology by name, or "cyclic" (ring
    then torus2d, the reference's time-varying case)."""
    if label == "cyclic":
        return cyclic_schedule([ring(num_nodes), torus2d(num_nodes)])
    return get_topology(label, num_nodes, seed=1, p=0.7)


def dec_noise(num_workers: int) -> np.ndarray:
    """gaussian's per-edge standard-normal draws (N, N, 40) over the
    packed coordinates of :func:`messages` (leaf a, then b)."""
    rng = np.random.default_rng(11)
    return rng.standard_normal((num_workers, num_workers, 40)
                               ).astype(np.float32)


def krum_messages() -> dict[str, np.ndarray]:
    """5 honest rows and 3 far Byzantine rows (the honest mean plus
    N(0, 100) noise), for krum on the pod mesh."""
    rng = np.random.default_rng(41)
    honest = rng.standard_normal((5, 16)).astype(np.float32)
    byz = honest.mean(0) + 10.0 * rng.standard_normal((3, 16))
    return {"g": np.concatenate([honest, byz.astype(np.float32)])}


def edge_messages(label: str) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    return {k: rng.standard_normal((4,) + s).astype(np.float32)
            for k, s in BLOCKWISE_EDGE[label].items()}


def shard(leaf: np.ndarray, model: int, model_size: int) -> np.ndarray:
    """A message leaf's shard of model rank ``model``: its last axis split
    ``model_size`` ways."""
    n = leaf.shape[-1] // model_size
    return leaf[..., model * n:(model + 1) * n]


def nan_rows(msgs: dict, rows=(2,)) -> dict:
    """``msgs`` with the given workers' messages all NaN."""
    out = {k: v.copy() for k, v in msgs.items()}
    for v in out.values():
        v[list(rows)] = np.nan
    return out


def attack_noise(num_byzantine: int) -> dict[str, np.ndarray]:
    """gaussian's standard-normal draws handed in, per Byzantine row."""
    rng = np.random.default_rng(5)
    return {"a": rng.standard_normal((num_byzantine, 16)).astype(np.float32),
            "b": rng.standard_normal((num_byzantine, 6, 4)).astype(np.float32)}


def grid_cases() -> dict[str, dict]:
    """The (4, 2) ("data", "model") world's cases, by id."""
    cases = {}
    for name in AGGREGATORS:
        for comm in COMMS:
            cases[f"rule-{comm}-{name}"] = dict(kind="rule", comm=comm,
                                                 name=name)
            cases[f"weighted-{comm}-{name}"] = dict(
                kind="rule", comm=comm, name=name, row_weights=ROW_WEIGHTS)
            cases[f"diagnostics-{comm}-{name}"] = dict(
                kind="rule", comm=comm, name=name, cfg=dict(diagnostics=True))
        cases[f"perleaf-{name}"] = dict(kind="rule", comm="gather", name=name,
                                        cfg=dict(packed=False))
    for comm in COMMS:
        for name in ("geomed", "median", "krum"):
            cases[f"guards-{comm}-{name}"] = dict(
                kind="rule", comm=comm, name=name, cfg=dict(guards=True),
                nan=True)
            cases[f"guards-clean-{comm}-{name}"] = dict(
                kind="rule", comm=comm, name=name, cfg=dict(guards=True))
            cases[f"guards-weighted-{comm}-{name}"] = dict(
                kind="rule", comm=comm, name=name, cfg=dict(guards=True),
                nan=True, row_weights=ROW_WEIGHTS)
        for wire in ("int8", "sign1", "bfloat16"):
            for name in ("geomed", "trimmed_mean"):
                cases[f"wire-{comm}-{wire}-{name}"] = dict(
                    kind="rule", comm=comm, name=name,
                    cfg=dict(message_dtype=wire))
    for label in BLOCKWISE_EDGE:
        cases[f"blockwise-edge-{label}"] = dict(kind="edge", label=label)
    for attack in ATTACKS:
        cases[f"attack-{attack}"] = dict(kind="attack", attack=attack)
    cases["perleaf-refusals"] = dict(kind="refusals")
    for comm in COMMS:
        # The sharded path pads these messages (the master's rules).
        for name in ("geomed", "trimmed_mean", "median", "krum",
                     "centered_clip", "geomed_blockwise"):
            cases[f"padded-{comm}-{name}"] = dict(
                kind="rule", comm=comm, name=name, msgs="padded")
        cases[f"padded-{comm}-int8-geomed"] = dict(
            kind="rule", comm=comm, name="geomed", msgs="padded",
            cfg=dict(message_dtype="int8"))
    cases.update(dec_grid_cases())
    return cases


def dec_grid_cases() -> dict[str, dict]:
    """The decentralized cases of the (4, 2) world: 4 nodes, each message
    split over 2 model ranks."""
    cases = {}

    def dec(cid, comm, name, graph="ring", **kw):
        cases[f"dec-{cid}"] = dict(kind="dec", comm=comm, name=name,
                                   graph=graph, **kw)

    for name in AGGREGATORS:
        dec(f"perleaf-{name}", "gather", name, cfg=dict(packed=False))
    for comm in COMMS:
        # The rules whose weighted forms or diagnostics differ in kind.
        for name in DEC_WEIGHTED:
            dec(f"weighted-{comm}-{name}", comm, name, graph="complete",
                row_weights=ROW_WEIGHTS)
        for name in DEC_DIAGNOSTICS:
            dec(f"diagnostics-{comm}-{name}", comm, name,
                cfg=dict(diagnostics=True))
    for comm in COMMS:
        for name in ("geomed", "median", "krum"):
            dec(f"guards-{comm}-{name}", comm, name, cfg=dict(guards=True),
                nan=True)
        for wire in ("int8", "sign1", "bfloat16"):
            for name in ("geomed", "trimmed_mean"):
                dec(f"wire-{comm}-{wire}-{name}", comm, name,
                    cfg=dict(message_dtype=wire))
        dec(f"padded-{comm}-geomed_blockwise", comm, "geomed_blockwise",
            msgs="padded")
        for name in ("geomed", "trimmed_mean", "krum", "mean"):
            dec(f"schedule-{comm}-{name}", comm, name, graph="cyclic",
                msgs="params", round_index=1, cfg=dict(gossip="params"))
        dec(f"gaussian-{comm}", comm, "median", noise=True,
            cfg=dict(attack="gaussian", gaussian_variance=9.0))
    # The sharded trimmed mean's route: K7 (its plain version here) once a
    # call, whatever the flag; the weighted form in torch.
    for flag in (True, False):
        dec(f"route-{flag}", "sharded", "trimmed_mean", graph="complete",
            count_k7=True, kernel_flag=flag)
    dec("route-weighted", "sharded", "trimmed_mean", graph="complete",
        count_k7=True, row_weights=ROW_WEIGHTS)
    return cases


def pod_cases() -> dict[str, dict]:
    """The (2, 4, 1) ("pod", "data", "model") world's cases, by id."""
    cases = {f"rule-{comm}-{name}": dict(kind="rule", comm=comm, name=name)
             for name in AGGREGATORS for comm in COMMS}
    for comm in COMMS:
        cases[f"krum-{comm}"] = dict(kind="krum", comm=comm)
    for graph in DEC_GRAPHS:
        for name in AGGREGATORS:
            for comm in COMMS:
                cases[f"dec-{graph}-{comm}-{name}"] = dict(
                    kind="dec", comm=comm, name=name, graph=graph)
    return cases


def _aggregate(mesh, local, cfg, comm, **kw):
    wa = mesh_lib.worker_axes(mesh)
    if comm == "gather":
        return distributed_aggregate(local, cfg, mesh=mesh, worker_axes=wa,
                                     **kw)
    return sharded_aggregate(local, cfg, mesh=mesh, worker_axes=wa,
                             num_workers=mesh_lib.num_workers(mesh), **kw)


def _numpy(out):
    if isinstance(out, tuple):   # (aggregate, AggDiagnostics)
        agg, diag = out
        return {"agg": _numpy(agg),
                "diag": {k: v.cpu().numpy() for k, v in diag._asdict().items()}}
    return {k: v.cpu().numpy() for k, v in out.items()}


def _local(mesh, msgs: dict, model_size: int) -> dict:
    wid = mesh.axes(*mesh_lib.worker_axes(mesh)).index
    mid = mesh.axes("model").index
    return {k: torch.from_numpy(shard(v[wid], mid, model_size).copy())
            for k, v in msgs.items()}


def local_noise(num_workers: int, model: int, model_size: int) -> torch.Tensor:
    """:func:`dec_noise` on a model rank's packed local coordinates."""
    full = dec_noise(num_workers)
    n = num_workers
    a = shard(full[..., :16], model, model_size)
    b = shard(full[..., 16:].reshape(n, n, 6, 4), model, model_size)
    return torch.from_numpy(np.concatenate([a, b.reshape(n, n, -1)], -1))


def _decentralized(mesh, case: dict, model_size: int):
    n = mesh_lib.num_workers(mesh)
    msgs = MESSAGES[case.get("msgs", "base")](n)
    if case.get("nan"):
        msgs = nan_rows(msgs)
    cfg = RobustConfig(aggregator=case["name"],
                       **{**DEC_KW, **case.get("cfg", {})})
    kw = dict(round_index=case.get("round_index"),
              use_topology_kernel=case.get("kernel_flag"))
    if case.get("row_weights") is not None:
        kw["row_weights"] = torch.tensor(case["row_weights"])
    if case.get("noise"):
        kw["noise"] = local_noise(n, mesh.axes("model").index, model_size)

    def run():
        return decentralized_aggregate(
            _local(mesh, msgs, model_size), cfg, dec_graph(case["graph"], n),
            mesh=mesh, comm=case["comm"],
            worker_axes=mesh_lib.worker_axes(mesh), num_workers=n, **kw)

    if not case.get("count_k7"):
        return _numpy(run())
    trims, k7 = [], ops.masked_neighbor_reduce

    def counted(*args, **kwargs):
        trims.append(kwargs.get("trim"))
        return k7(*args, **kwargs)

    ops.masked_neighbor_reduce = counted
    try:
        return {"agg": _numpy(run()), "k7_trims": trims}
    finally:
        ops.masked_neighbor_reduce = k7


def _refusals(mesh, local) -> list[str]:
    errors = []
    for kw, cfg in ((dict(row_weights=torch.ones(4)), {}),
                    ({}, dict(guards=True)), ({}, dict(diagnostics=True)),
                    ({}, dict(message_dtype="int8"))):
        try:
            _aggregate(mesh, local, RobustConfig(packed=False, **RULE_KW,
                                                 **cfg), "gather", **kw)
        except ValueError as e:
            errors.append(str(e))
    return errors


def run_cases(mesh, cases: dict[str, dict]) -> dict:
    """Every case on this rank -> {case id: its local result}."""
    model_size = mesh.axes("model").size
    msgs = messages(mesh_lib.num_workers(mesh))
    out = {}
    for cid, case in cases.items():
        kind = case["kind"]
        if kind == "dec":
            out[cid] = _decentralized(mesh, case, model_size)
        elif kind == "rule":
            data = MESSAGES[case.get("msgs", "base")](
                mesh_lib.num_workers(mesh))
            data = nan_rows(data) if case.get("nan") else data
            cfg = RobustConfig(aggregator=case["name"], **RULE_KW,
                               **case.get("cfg", {}))
            kw = {}
            if case.get("row_weights") is not None:
                kw["row_weights"] = torch.tensor(case["row_weights"])
            out[cid] = _numpy(_aggregate(mesh, _local(mesh, data, model_size),
                                         cfg, case["comm"], **kw))
        elif kind == "krum":
            cfg = RobustConfig(aggregator="krum", num_byzantine=3)
            out[cid] = _numpy(_aggregate(
                mesh, _local(mesh, krum_messages(), model_size), cfg,
                case["comm"]))
        elif kind == "edge":
            cfg = RobustConfig(aggregator="geomed_blockwise",
                               weiszfeld_iters=150, weiszfeld_tol=1e-10)
            local = {k: torch.from_numpy(v[mesh.axes("data").index].copy())
                     for k, v in edge_messages(case["label"]).items()}
            out[cid] = _numpy(sharded_aggregate(
                local, cfg, mesh=mesh, worker_axes=("data",), model_axes=(),
                num_workers=4))
        elif kind == "attack":
            cfg = RobustConfig(attack=case["attack"], num_byzantine=1,
                               gaussian_variance=9.0)
            noise = {k: torch.from_numpy(shard(v[0], mesh.axes(
                "model").index, model_size).copy())
                for k, v in attack_noise(1).items()}
            out[cid] = _numpy(distributed_attack(
                _local(mesh, msgs, model_size), cfg, mesh=mesh,
                worker_axes=("data",), noise=noise))
        else:
            out[cid] = _refusals(mesh, _local(mesh, msgs, model_size))
    return out


def run_world(shape, axes, cases, timeout: float = 120.0,
              fn=None) -> list[dict]:
    """Every case on every rank of a local world of ``shape`` -> each
    rank's result of ``fn`` (default :func:`run_cases`), in rank order."""
    return mesh_lib.spawn_mesh(fn or run_cases, shape, axes, args=(cases,),
                               timeout=timeout)


# ---------------------------------------------------------------------------
# The training drivers (tests/test_torch_steps.py): one step of
# make_train_step / make_decentralized_train_step on a tiny dense decoder,
# and the driver's rollback run, in one (4, 2) world.
# ---------------------------------------------------------------------------

# The reduced qwen2-7b cut to 2 layers of width 64 (GQA: 4 query heads on 2
# KV heads of 16, qkv bias, an unembedding).
STEP_SHAPES = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=128)
STEP_BATCH, STEP_SEQ, STEP_J, STEP_LR, STEP_CHUNK = 2, 8, 3, 0.5, 8
STEP_CLIENTS = 8
# Worker / node 0 attacks (sign_flip); the Weiszfeld loop runs to a tight
# tol so that the ranks' sums in another order stop where one process does.
STEP_KW = dict(attack="sign_flip", num_byzantine=1, weiszfeld_iters=100,
               weiszfeld_tol=1e-9, trim=1)


def step_config(cfgs):
    """The tiny config in either package's configs module."""
    import dataclasses
    return dataclasses.replace(cfgs.get_config("qwen2-7b").reduced(),
                               **STEP_SHAPES)


def step_cases() -> dict[str, dict]:
    """The step world's cases, by id: ``cfg`` the RobustConfig fields
    beyond STEP_KW; ``node_params`` a distinct parameter vector a node;
    ``table`` a SAGA table handed in (its rows drawn from the seed, so the
    first step's correction is not the identity); ``staleness`` counters
    handed in."""
    cases = {}
    for comm in COMMS:
        cases[f"master-{comm}-sgd-geomed"] = dict(
            kind="master", comm=comm, cfg=dict(vr="sgd", aggregator="geomed"))
        cases[f"master-{comm}-saga-geomed"] = dict(
            kind="master", comm=comm, table=True,
            cfg=dict(vr="saga", aggregator="geomed"))
        cases[f"master-{comm}-int8-geomed"] = dict(
            kind="master", comm=comm,
            cfg=dict(vr="sgd", aggregator="geomed", message_dtype="int8"))
        for gossip in ("gradient", "params"):
            cases[f"dec-{comm}-{gossip}-geomed"] = dict(
                kind="dec", comm=comm, node_params=True,
                cfg=dict(vr="sgd", aggregator="geomed", topology="ring",
                         gossip=gossip))
    cases["master-gather-perleaf-trimmed_mean"] = dict(
        kind="master", comm="gather", table=True,
        cfg=dict(vr="saga", aggregator="trimmed_mean", packed=False))
    cases["master-gather-cohort-geomed"] = dict(
        kind="master", comm="gather", table=True, staleness=True,
        cfg=dict(vr="saga", aggregator="geomed", attack="straggler",
                 num_clients=STEP_CLIENTS, staleness_decay=0.9))
    cases["master-gather-guards-geomed"] = dict(
        kind="master", comm="gather",
        cfg=dict(vr="sgd", aggregator="geomed", attack="nan", guards=True))
    return cases


def step_params(structs: dict, num_nodes: int = 0) -> dict[str, np.ndarray]:
    """Parameters by the port's names from the seed, norm scales near 1 and
    every other leaf N(0, 0.1); with ``num_nodes`` a (N, ...) stack of the
    same vector each moved by N(0, 0.01) noise."""
    rng = np.random.default_rng(21)
    out = {}
    for name in sorted(structs):
        shape = tuple(structs[name].shape)
        base = 0.1 * rng.standard_normal(shape)
        if name.endswith("scale"):
            base = base + 1.0
        if num_nodes:
            base = base + 0.01 * rng.standard_normal((num_nodes,) + shape)
        out[name] = base.astype(np.float32)
    return out


def step_batch(num_workers: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(22)
    toks = rng.integers(0, STEP_SHAPES["vocab_size"],
                        (num_workers, STEP_BATCH, STEP_SEQ + 1), dtype=np.int64)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def step_sample_idx(num_workers: int) -> np.ndarray:
    return np.random.default_rng(23).integers(0, STEP_J, (num_workers,))


def step_table(structs: dict, rows: int) -> tuple[dict, dict]:
    """A SAGA state handed in, per leaf by the port's names: table (rows, J,
    *shape) and mean (rows, *shape)."""
    rng = np.random.default_rng(24)
    table, avg = {}, {}
    for name in sorted(structs):
        shape = tuple(structs[name].shape)
        table[name] = (0.05 * rng.standard_normal((rows, STEP_J) + shape)
                       ).astype(np.float32)
        avg[name] = (0.05 * rng.standard_normal((rows,) + shape)
                     ).astype(np.float32)
    return table, avg


def step_staleness() -> np.ndarray:
    return (np.arange(STEP_CLIENTS) % 5).astype(np.int32)


def _shard_rows(arr: np.ndarray, lead: int, spec, axes) -> torch.Tensor:
    """The model shard of every (lead-dims) row of a whole-leaf array."""
    from repro_torch.launch.sharding import model_shard
    flat = torch.from_numpy(arr).reshape((-1,) + arr.shape[lead:])
    parts = [model_shard(x, spec, axes) for x in flat]
    return torch.stack(parts).reshape(arr.shape[:lead] + parts[0].shape)


def _hand_in_table(state, case, model, mesh, robust):
    from repro_torch.core import packing
    from repro_torch.core.saga import SagaState
    from repro_torch.launch.steps import stack_layers
    structs = model.param_structs()
    specs = model.param_specs(mesh_lib.axis_sizes(mesh))
    ma = mesh.axes("model")
    wid = mesh.axes(*mesh_lib.worker_axes(mesh)).index
    rows = STEP_CLIENTS if robust.num_clients else mesh_lib.num_workers(mesh)
    table, avg = step_table(structs, rows)
    sel = slice(None) if robust.num_clients else slice(wid, wid + 1)
    # The rank's message layout: each leaf's model shard, the layers
    # stacked as the reference's leaves.
    tab = stack_layers({k: _shard_rows(v[sel], 2, specs[k], ma)
                        for k, v in table.items()}, model.cfg, dim=2)
    mean = stack_layers({k: _shard_rows(v[sel], 1, specs[k], ma)
                         for k, v in avg.items()}, model.cfg, dim=1)
    if robust.packed:
        spec = packing.pack_spec({k: v[0, 0] for k, v in tab.items()},
                                 batch_ndim=0)
        state["vr"] = SagaState(spec.pack(tab, batch_ndim=2),
                                spec.pack(mean, batch_ndim=1))
    else:
        state["vr"] = {k: SagaState(tab[k].reshape(tab[k].shape[:2] + (-1,)),
                                    mean[k].reshape(mean[k].shape[0], -1))
                       for k in tab}


def _step_case(mesh, case: dict) -> dict:
    from repro_torch import configs as tcfgs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.api import build_model
    cfg = step_config(tcfgs)
    model = build_model(cfg, device="cpu", remat=False, loss_chunk=STEP_CHUNK)
    robust = RobustConfig(comm=case["comm"], **{**STEP_KW, **case["cfg"]})
    train = TrainConfig(optimizer="sgd", lr=STEP_LR)
    w = mesh_lib.num_workers(mesh)
    wid = mesh.axes(*mesh_lib.worker_axes(mesh)).index
    dec = case["kind"] == "dec"
    build = (steps_lib.make_decentralized_train_step if dec
             else steps_lib.make_train_step)
    step = build(model, robust, train, mesh,
                 saga_num_samples=STEP_J if case.get("table") else 0)
    params = step_params(model.param_structs(), w if dec else 0)
    params = {k: torch.from_numpy(v[wid] if dec else v).clone()
              for k, v in params.items()}
    state = step.init_state(params)
    if case.get("table"):
        _hand_in_table(state, case, model, mesh, robust)
    if case.get("staleness"):
        state["staleness"] = torch.from_numpy(step_staleness())
    batch = {k: torch.from_numpy(v) for k, v in step_batch(w).items()}
    new, metrics = step(state, batch, 7, sample_idx=step_sample_idx(w))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "step": new["step"]}
    if mesh.axes("model").index == 0:
        out["params"] = {k: v.numpy() for k, v in new["params"].items()}
    return out


def _rollback_case(mesh, case: dict) -> dict:
    """The driver's rollback run twice, each in a fresh directory."""
    import os
    from repro_torch.launch import train as train_lib
    out = {}
    for tag in ("a", "b"):
        argv = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                "--steps", "4", "--seq", "8", "--per-worker-batch", "1",
                "--mesh", "4x2", "--aggregator", "mean", "--guards",
                "--loss-blowup", "0.5", "--rollback-patience", "2",
                "--max-rollbacks", "1",
                "--checkpoint-dir", os.path.join(case["dir"], tag + "-ckpt"),
                "--checkpoint-every", "2",
                "--log-dir", os.path.join(case["dir"], tag + "-log")]
        res = train_lib.run(mesh, vars(train_lib.parser().parse_args(argv)))
        out[tag] = res["resilience"]
    return out


def _demo_case(mesh, case: dict) -> dict:
    """The mesh demo's twin for a few steps of each comm path."""
    from repro_torch import federated_mesh_demo
    return federated_mesh_demo.run(mesh, "cpu", case["steps"])


def run_step_cases(mesh, cases: dict[str, dict]) -> dict:
    """Every step case on this rank -> {case id: its result}."""
    run = {"rollback": _rollback_case, "demo": _demo_case}
    return {cid: run.get(case["kind"], _step_case)(mesh, case)
            for cid, case in cases.items()}
