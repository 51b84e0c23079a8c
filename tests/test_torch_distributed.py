"""The master's aggregation across ranks (``distributed_aggregate``,
``sharded_aggregate``, ``distributed_attack``) on local ``gloo`` worlds,
against the JAX reference's single-process rules, on the CPU.

Two worlds of 8 ranks, one process a rank, each started once by a
module-scoped fixture with a time limit of its own
(``tests/torch_dist_cases.py`` holds what the ranks compute):

* mesh (4, 2) ("data", "model"): W = 4 workers whose messages (leaves a
  (16,) and b (6, 4)) are split over 2 model ranks.  Every rule of the
  registry on both comm paths, with ``row_weights``, with diagnostics, and
  on the per-leaf gather (``packed=False``) with its refusals; guards
  under a NaN row; the int8, sign1 and bfloat16 wires; sharded
  geomed_blockwise with leaves that a rank's slice starts inside or misses
  and padding (the reference's tests/test_distributed.py:399); every
  attack through ``distributed_attack`` against the port's
  ``apply_attack`` on the same rows (gaussian's noise handed in, bitflip
  against the port's hash on the rank's local coordinates).
* mesh (2, 4, 1) ("pod", "data", "model"): W = 8 workers pod-major.  Every
  rule on both paths, and krum on handed-in messages returning bitwise
  the row that the reference's single-process krum selects (the twin of
  tests/test_distributed.py:504 without a seed-pinned index).

Each rank's output (its model shard) is held against the same shard of the
reference's single-process rule on the same numpy stack at atol 1e-5
(rtol 1e-5 on the diagnostics' distances and scores), krum bitwise.  The
diagnostics' loop facts (residual, iterations, converged) are not
compared: at tol 1e-9 a float32 iterate settles on a fixed point or on a
cycle of two values depending on the order of its sums.  The
sharded path sends float32 on the bf16 wire, as the reference's does, so
its reference is the float32 rule.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as C
from repro.core import guards as jguards
from repro.core import packing as jpacking
from repro.core.aggregators import geomed_blockwise_agg
from repro.core.robust_step import RobustConfig as JConfig
from repro_torch.core import attacks as attack_lib
from repro_torch.core import packing

GRID_CASES = C.grid_cases()
POD_CASES = C.pod_cases()
WORLD_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def grid_world():
    return C.run_world(*C.GRID, GRID_CASES, timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def pod_world():
    return C.run_world(*C.POD, POD_CASES, timeout=WORLD_TIMEOUT)


def _rank_shards(world, shape):
    """(rank result, worker index, model index) of every rank."""
    for rank, res in enumerate(world):
        coord = np.unravel_index(rank, shape)
        yield res, int(np.ravel_multi_index(coord[:-1], shape[:-1])), int(coord[-1])


@functools.lru_cache(maxsize=None)
def _reference(num_workers: int, name: str, cfg_items: tuple, variant: str):
    """The reference's single-process result on :func:`C.messages`:
    (leaves, AggDiagnostics or None).  ``variant``: "plain", "weighted",
    "guards" (a clean round), "nan" and "nan-weighted" (guards with a NaN
    row, the latter on row weights), "roundtrip" (a quantized wire),
    "bf16" (the bf16 wire's buffer)."""
    msgs = C.nan_rows(C.messages(num_workers)) \
        if variant.startswith("nan") else C.messages(num_workers)
    msgs = {k: jnp.asarray(v) for k, v in msgs.items()}
    cfg = JConfig(aggregator=name, **C.RULE_KW, **dict(cfg_items))
    if not cfg.packed:
        return cfg.aggregator_fn()(msgs), None
    if variant == "roundtrip":
        spec = cfg.message_spec(msgs, batch_ndim=1)
        return cfg.aggregator_fn()(spec.unpack(
            spec.wire_roundtrip(spec.pack(msgs)))), None
    spec = (cfg.message_spec(msgs, batch_ndim=1) if variant == "bf16"
            else jpacking.pack_spec(msgs))
    buf = spec.pack(msgs)
    fn = cfg.flat_aggregator_fn(spec)
    if variant in ("guards", "nan", "nan-weighted"):
        rw = (jnp.asarray(C.ROW_WEIGHTS, jnp.float32)
              if variant == "nan-weighted" else None)
        out = jguards.guarded_flat_call(
            fn, buf, jguards.guard_mask(buf, multiplier=cfg.guard_multiplier,
                                        base_weights=rw), row_weights=rw)
    elif variant == "weighted":
        out = fn(buf, row_weights=jnp.asarray(C.ROW_WEIGHTS, jnp.float32))
    else:
        out = fn(buf)
    vec, diag = out if cfg.diagnostics else (out, None)
    return spec.unpack(vec, batch_ndim=0), diag


def _case_reference(case, num_workers):
    cfg = dict(case.get("cfg", {}))
    wire = cfg.get("message_dtype", "float32")
    if case.get("nan"):
        variant = "nan" if case.get("row_weights") is None else "nan-weighted"
    elif cfg.get("guards"):
        variant = "guards"
    elif case.get("row_weights") is not None:
        variant = "weighted"
    elif wire in ("int8", "sign1"):
        variant = "roundtrip"
    elif wire == "bfloat16":
        if case["comm"] == "sharded":
            # The reference's sharded path flattens to float32 on this wire.
            cfg.pop("message_dtype")
            variant = "plain"
        else:
            variant = "bf16"
    else:
        variant = "plain"
    return _reference(num_workers, case["name"], tuple(sorted(cfg.items())),
                      variant)


def _check_leaves(got: dict, want: dict, model: int, model_size: int,
                  exact: bool, what: str):
    for k, v in want.items():
        ref = C.shard(np.asarray(v, np.float32), model, model_size)
        if exact:
            np.testing.assert_array_equal(got[k], ref, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-5,
                                       err_msg=f"{what} {k}")


def _check_rule(world, shape, cid, case):
    num_workers, model_size = int(np.prod(shape[:-1])), shape[-1]
    want, want_diag = _case_reference(case, num_workers)
    krum = case["name"] == "krum"
    for res, _, model in _rank_shards(world, shape):
        got = res[cid]
        if want_diag is None:
            _check_leaves(got, want, model, model_size, krum, cid)
            continue
        _check_leaves(got["agg"], want, model, model_size, krum, cid)
        diag = got["diag"]
        for field in ("dist", "weight", "score", "clip_frac"):
            np.testing.assert_allclose(diag[field],
                                       np.asarray(getattr(want_diag, field)),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{cid} {field}")
        assert int(diag["selected"]) == int(want_diag.selected), cid


RULE_IDS = [c for c, case in GRID_CASES.items() if case["kind"] == "rule"]


@pytest.mark.parametrize("cid", RULE_IDS)
def test_grid_rule_matches_reference(grid_world, cid):
    _check_rule(grid_world, C.GRID[0], cid, GRID_CASES[cid])


@pytest.mark.parametrize("cid", [c for c, case in POD_CASES.items()
                                 if case["kind"] == "rule"])
def test_pod_rule_matches_reference(pod_world, cid):
    _check_rule(pod_world, C.POD[0], cid, POD_CASES[cid])


@pytest.mark.parametrize("comm", C.COMMS)
def test_pod_krum_returns_the_selected_row_bitwise(pod_world, comm):
    msgs = C.krum_messages()
    want = JConfig(aggregator="krum", num_byzantine=3).aggregator_fn()(
        {"g": jnp.asarray(msgs["g"])})["g"]
    want = np.asarray(want)
    assert any(np.array_equal(want, row) for row in msgs["g"][:5])
    for res in pod_world:
        np.testing.assert_array_equal(res[f"krum-{comm}"]["g"], want)


@pytest.mark.parametrize("label", list(C.BLOCKWISE_EDGE))
def test_sharded_blockwise_edges_match_reference(grid_world, label):
    msgs = C.edge_messages(label)
    want = geomed_blockwise_agg({k: jnp.asarray(v) for k, v in msgs.items()},
                                max_iters=150, tol=1e-10)
    for res in grid_world:
        got = res[f"blockwise-edge-{label}"]
        for k in msgs:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=1e-5, err_msg=f"{label} {k}")


def test_perleaf_gather_refuses_what_the_reference_refuses(grid_world):
    errors = grid_world[0]["perleaf-refusals"]
    assert len(errors) == 4
    for err, what in zip(errors, ("row_weights", "guards", "diagnostics",
                                  "quantized")):
        assert "packed" in err and what in err, (what, err)


def _attacked_row(attack: str, shape) -> dict[str, np.ndarray]:
    """The Byzantine worker 0's message under ``attack`` by the port's
    single-process ``apply_attack`` on the honest rows 1..W-1."""
    msgs = C.messages(shape[0])
    tree = {k: torch.from_numpy(v[1:]) for k, v in msgs.items()}
    spec = packing.pack_spec(tree)
    noise = spec.pack({k: torch.from_numpy(v) for k, v in
                       C.attack_noise(1).items()})
    cfg = attack_lib.AttackConfig(name=attack, num_byzantine=1,
                                  gaussian_variance=9.0)
    full = attack_lib.apply_attack(cfg, spec.pack(tree), noise=noise,
                                   spec=spec)
    return {k: v[-1].numpy() for k, v in spec.unpack(full).items()}


@pytest.mark.parametrize("attack", C.ATTACKS)
def test_distributed_attack_matches_apply_attack(grid_world, attack):
    shape = C.GRID[0]
    msgs = C.messages(shape[0])
    for res, worker, model in _rank_shards(grid_world, shape):
        got = res[f"attack-{attack}"]
        if worker > 0 or attack == "none":
            for k, v in msgs.items():   # honest ranks send what they had
                np.testing.assert_array_equal(
                    got[k], C.shard(v[worker], model, shape[1]))
            continue
        if attack == "bitflip":
            # The hash runs over the rank's local coordinates of each leaf.
            mean = {k: torch.from_numpy(C.shard(v[1:].mean(0), model,
                                                shape[1]).copy())
                    for k, v in msgs.items()}
            spec = packing.pack_spec(mean, batch_ndim=0)
            want = spec.unpack(attack_lib.bitflip_rows(
                spec.pack(mean, batch_ndim=0), torch.tensor([0]),
                prob=0.02, seed=0, spec=spec)[0], batch_ndim=0)
            want = {k: v.numpy() for k, v in want.items()}
        else:
            want = {k: C.shard(v, model, shape[1])
                    for k, v in _attacked_row(attack, shape).items()}
        for k in msgs:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{attack} {k}")
