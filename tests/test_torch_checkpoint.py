"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
reference, and resume and rollback on the master and decentralized steps,
on the CPU.

* Twins of tests/test_substrates.py's checkpoint tests (a nested tree with
  bf16 and int32 leaves, the keep window, a missing leaf) and of
  tests/test_rollback.py's manifest tests (truncated and unreadable files
  skipped, checksums and unrecorded ones, the last-good anchor surviving
  the GC, the fallback to the newest valid file).
* The layout is the reference's: each package's ``load`` restores the
  params and optimizer leaves the other saved, bf16 included, exactly.
* Resume: 5 straight steps against 3 steps, a checkpoint, a restore and 2
  more, on the master step (SAGA geomed under sign_flip) and the
  decentralized step (a ring), every leaf of the state equal with
  ``torch.equal``, the generator's state included.  The state is updated
  in place, so each run starts from its own ``init_fn``.
* Rollback (the twin of tests/test_rollback.py:225): guards on, a
  poisoned health vector makes every round reject, ``RunHealth(patience=2)``
  arms, ``restore_last_good``, and the descent after it equals the straight
  honest run bitwise, on both steps.
"""
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load as jload
from repro.checkpoint import save as jsave
from repro_torch.checkpoint import CheckpointManager, load, save
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.core.robust_step import (FederatedState, RobustConfig,
                                          make_federated_step)
from repro_torch.data import ijcnn1_like, logreg_loss, partition
from repro_torch.launch.health import RunHealth
from repro_torch.optim import get_optimizer

# -- twins of tests/test_substrates.py ------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16),
                       "c": torch.tensor(7, dtype=torch.int32)}}
    p = os.path.join(tmp_path, "ck.npz")
    save(p, tree)
    got = load(p, tree)
    for (ka, a), (kb, b) in zip(_leaves(tree), _leaves(got)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()   # a fresh tensor


def test_checkpoint_manager_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert torch.equal(mgr.restore(4, tree)["w"], torch.zeros(2))


def test_checkpoint_missing_leaf_raises(tmp_path):
    p = os.path.join(tmp_path, "ck.npz")
    save(p, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        load(p, {"a": torch.zeros(2), "b": torch.zeros(3)})


# -- twins of tests/test_rollback.py's checkpoint tests -------------------


def _tree(step):
    return {"w": torch.arange(6.0) + step, "b": torch.tensor(float(step))}


def test_restore_latest_skips_truncated_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree(1))
    p2 = ckpt.save(2, _tree(2))
    blob = open(p2, "rb").read()
    with open(p2, "wb") as f:              # truncated: checksum mismatch
        f.write(blob[: len(blob) // 2])
    with pytest.warns(UserWarning, match="checksum"):
        step, got = ckpt.restore_latest(_tree(0))
    assert step == 1
    assert torch.equal(got["w"], _tree(1)["w"])


def test_restore_latest_skips_unreadable_checkpoint(tmp_path):
    """A file whose content matches its manifest checksum but is no npz is
    skipped by the read failure, not by the checksum."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree(1))
    p2 = ckpt.save(2, _tree(2))
    with open(p2, "wb") as f:
        f.write(b"not an npz at all")
    m = json.load(open(os.path.join(tmp_path, "manifest.json")))
    m["checksums"][os.path.basename(p2)] = hashlib.sha256(
        b"not an npz at all").hexdigest()
    with open(os.path.join(tmp_path, "manifest.json"), "w") as f:
        json.dump(m, f)
    with pytest.warns(UserWarning, match="unreadable"):
        step, got = ckpt.restore_latest(_tree(0))
    assert step == 1
    assert torch.equal(got["w"], _tree(1)["w"])


def test_manifest_checksums_and_legacy_verify(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree(1))
    m = json.load(open(os.path.join(tmp_path, "manifest.json")))
    assert "step_00000001.npz" in m["checksums"]
    assert ckpt.verify(1)
    del m["checksums"]["step_00000001.npz"]   # no recorded checksum
    with open(os.path.join(tmp_path, "manifest.json"), "w") as f:
        json.dump(m, f)
    assert ckpt.verify(1)
    assert not ckpt.verify(99)


def test_mark_good_survives_gc_and_restores(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        ckpt.save(s, _tree(s))
        if s == 1:
            ckpt.mark_good(1)
    assert ckpt.all_steps() == [1, 4, 5]
    assert ckpt.last_good_step() == 1
    step, got = ckpt.restore_last_good(_tree(0))
    assert step == 1
    assert torch.equal(got["w"], _tree(1)["w"])
    m = json.load(open(os.path.join(tmp_path, "manifest.json")))
    assert set(m["checksums"]) == {"step_00000001.npz", "step_00000004.npz",
                                   "step_00000005.npz"}
    with pytest.raises(FileNotFoundError):
        ckpt.mark_good(42)


def test_restore_last_good_falls_back_to_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree(1))
    step, got = ckpt.restore_last_good(_tree(0))   # no marker yet
    assert step == 1
    assert torch.equal(got["b"], _tree(1)["b"])


# -- the layout on disk is the reference's --------------------------------


def test_each_package_restores_the_others_params_and_optimizer(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    m = rng.standard_normal((3, 4)).astype(np.float32)
    port_tree = {"params": {"w": torch.from_numpy(w),
                            "b": torch.from_numpy(b).to(torch.bfloat16)},
                 "opt_state": {"w": torch.from_numpy(m), "b": torch.zeros(4)},
                 "step": 3}
    jax_tree = {"params": {"w": jnp.asarray(w),
                           "b": jnp.asarray(b).astype(jnp.bfloat16)},
                "opt_state": {"w": jnp.asarray(m), "b": jnp.zeros(4)},
                "step": jnp.asarray(3, jnp.int32)}
    # The port's manager writes, the reference's reads.
    CheckpointManager(str(tmp_path / "port")).save_train_state(3, port_tree)
    step, got = JManager(str(tmp_path / "port")).restore_latest(jax_tree)
    assert step == 3
    for (k, a), (_, b_) in zip(_leaves(port_tree), _leaves(got)):
        want = a.float().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(np.asarray(b_, np.float32),
                                      np.asarray(want, np.float32), err_msg=k)
    # The reference writes, the port reads (into fresh tensors).
    jsave(str(tmp_path / "ref.npz"), jax_tree)
    got = load(str(tmp_path / "ref.npz"), port_tree)
    assert got["params"]["b"].dtype == torch.bfloat16 and got["step"] == 3
    for (k, a), (_, b_) in zip(_leaves(port_tree), _leaves(got)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b_), k
    # And the round trip through both: the reference's load of its own.
    back = jload(str(tmp_path / "ref.npz"), jax_tree)
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]), w)


# -- resume and rollback on both steps -------------------------------------

STEPS = ("master", "ring")


def _problem(topology: str, **cfg_kw):
    data = ijcnn1_like(0, n=600, device="cpu")
    wd = partition({"a": data.x, "b": data.y}, 8, seed=1, device="cpu")
    cfg = RobustConfig(aggregator="geomed", vr="saga", attack="sign_flip",
                       num_byzantine=2, **cfg_kw,
                       **({} if topology == "master" else {"topology": topology}))
    init_fn, step_fn = make_federated_step(
        logreg_loss(0.01), wd, cfg, get_optimizer("momentum", 0.02),
        device="cpu")
    return (lambda: init_fn({"w": torch.zeros(22)}, 3)), step_fn


def _run(step_fn, st, steps, monitor=None):
    for _ in range(steps):
        st, m = step_fn(st)
        if monitor is not None:
            monitor.observe({"round_accepted": float(m["round_accepted"])})
    return st


def _assert_same_state(a: FederatedState, b: FederatedState):
    la, lb = list(_leaves(a._asdict())), list(_leaves(b._asdict()))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), k
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("topology", STEPS)
def test_resume_is_bitwise_the_straight_run(tmp_path, topology):
    init, step_fn = _problem(topology)
    straight = _run(step_fn, init(), 5)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_train_state(3, _run(step_fn, init(), 3)._asdict())
    step, restored = ckpt.restore_latest(init()._asdict())
    assert step == 3
    resumed = _run(step_fn, FederatedState(**restored), 2)
    _assert_same_state(straight, resumed)


@pytest.mark.parametrize("topology", STEPS)
def test_rollback_recovers_bitwise(tmp_path, topology):
    """Honest guarded steps, a last-good checkpoint, two rejected rounds
    (a collapsed EMA in the health vector makes every aggregate an
    outlier), RunHealth arming, restore_last_good, and a descent equal to
    the straight honest run on every leaf."""
    init, step_fn = _problem(topology, guards=True)
    straight = _run(step_fn, init(), 5)
    monitor = RunHealth(patience=2)
    st3 = _run(step_fn, init(), 3, monitor)
    assert monitor.healthy
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_train_state(3, st3._asdict())
    ckpt.mark_good(3)
    w3 = st3.params["w"].clone()
    poisoned = st3._replace(health=torch.tensor([1e-8, 1e-16, 0.0, 10.0]))
    bad = _run(step_fn, poisoned, 2, monitor)
    assert torch.equal(bad.params["w"], w3)     # rejected rounds hold
    assert bad.step == 5
    assert monitor.rollback_pending
    gstep, restored = ckpt.restore_last_good(init()._asdict())
    assert gstep == 3
    monitor.on_rollback()
    resumed = _run(step_fn, FederatedState(**restored), 2, monitor)
    assert monitor.healthy and monitor.rollbacks == 1
    _assert_same_state(straight, resumed)


def test_save_after_rollback_replaces_the_abandoned_later_steps(tmp_path):
    """The descent after a rollback saves steps below the abandoned run's
    files: the keep window must keep the new file (the reference's deletes
    it at once, so its mark_good raises) and restore_latest must return
    the new trajectory."""
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in (2, 4, 6, 8):
        ckpt.save(s, _tree(s))
        if s == 4:
            ckpt.mark_good(4)
    ckpt.save(6, _tree(60))             # the re-descent from step 4
    ckpt.mark_good(6)
    assert ckpt.all_steps() == [4, 6]
    step, got = ckpt.restore_latest(_tree(0))
    assert step == 6 and torch.equal(got["w"], _tree(60)["w"])
