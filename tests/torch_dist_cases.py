"""The cases of ``tests/test_torch_distributed.py``, computed on every rank
of a local ``gloo`` world (:func:`repro_torch.launch.mesh.spawn_mesh`).

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
from repro_torch.launch import mesh as mesh_lib

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


def messages(num_workers: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The W messages of the sweep: leaves a (W, 16) and b (W, 6, 4)."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((num_workers, 16)).astype(np.float32),
            "b": rng.standard_normal((num_workers, 6, 4)).astype(np.float32)}


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
    return cases


def pod_cases() -> dict[str, dict]:
    """The (2, 4, 1) ("pod", "data", "model") world's cases, by id."""
    cases = {f"rule-{comm}-{name}": dict(kind="rule", comm=comm, name=name)
             for name in AGGREGATORS for comm in COMMS}
    for comm in COMMS:
        cases[f"krum-{comm}"] = dict(kind="krum", comm=comm)
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
        if kind == "rule":
            data = nan_rows(msgs) if case.get("nan") else msgs
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


def run_world(shape, axes, cases, timeout: float = 120.0) -> list[dict]:
    """Every case on every rank of a local world of ``shape`` -> each
    rank's :func:`run_cases` result, in rank order."""
    return mesh_lib.spawn_mesh(run_cases, shape, axes, args=(cases,),
                               timeout=timeout)
