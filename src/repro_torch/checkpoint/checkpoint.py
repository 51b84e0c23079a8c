"""Checkpoints of nested train states: one ``.npz`` a step (port of
``repro/checkpoint/checkpoint.py``; the same layout on disk).

A tree is a nest of dicts, NamedTuples, tuples and lists whose leaves are
tensors, numpy arrays, Python numbers and :class:`torch.Generator` s;
``None`` holds no leaf.  Each leaf is stored under its path: dict keys
(sorted), NamedTuple field names and sequence indices joined by ``/`` --
the keys the reference writes for the same tree, so either package restores
the other's params and optimizer leaves.  bfloat16 is widened to float32 on
disk (exact) and narrowed back to the ``like`` leaf's dtype on load.  A
generator is stored as its ``get_state()`` bytes and restored into a new
generator on the ``like`` generator's device, which makes a resumed run
draw what the straight run draws.

:func:`save` copies every tensor to the host before it returns, so a step
that later updates the state in place cannot reach the file; :func:`load`
returns fresh tensors on the ``like`` leaves' devices, never views of the
arrays read or of the ``like``.

:class:`CheckpointManager` keeps ``step_%08d.npz`` files in a directory
with a ``manifest.json`` beside them: a sha256 per file and a ``last_good``
step.  Both are written atomically (a temporary file, then
``os.replace``).  ``restore_latest`` checks a file's checksum before it
reads it and walks from the newest file to the oldest past truncated or
unreadable ones, with a warning; ``mark_good``/``restore_last_good`` give
the rollback of :mod:`repro_torch.launch.health` an anchor that the
rolling ``keep`` window never deletes.  Unlike the reference's manager, a
save at a step below existing files (the descent after a rollback) first
deletes those later files: the reference's keep window keeps the highest
step numbers and so deletes the new file instead (ROADMAP.md Queue C).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import warnings
import zipfile
from typing import Any, Optional

import numpy as np
import torch

Tree = Any

_SEP = "/"

# What reading a damaged file raises: a truncated or corrupt zip, bytes that
# are no npz at all, a missing leaf or a leaf of another shape.
_UNREADABLE = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(key, child) pairs of an inner node in the reference's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaves(tree: Tree, prefix: str = ""):
    """(path, leaf) of every leaf of ``tree``, depth first."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _leaves(child, f"{prefix}{_SEP}{key}" if prefix else key)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host array: a generator's state bytes, a tensor copied
    off its device (bfloat16 widened to float32, exactly)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: Tree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def save(path: str, tree: Tree) -> None:
    """Atomically save ``tree`` to ``path`` (a ``.npz`` file)."""
    flat = _flatten_with_paths(tree)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    structure = json.dumps(sorted(flat)).encode()
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __treedef__=np.frombuffer(structure, np.uint8), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _restore_leaf(arr: np.ndarray, like):
    """``arr`` as a fresh leaf of ``like``'s kind, dtype and device."""
    if isinstance(like, torch.Generator):
        g = torch.Generator(device=like.device)
        g.set_state(torch.from_numpy(np.ascontiguousarray(arr, np.uint8)))
        return g
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.asarray(arr)).to(
            device=like.device, dtype=like.dtype, copy=True)
    if isinstance(like, (bool, np.bool_)):
        return bool(arr)
    if isinstance(like, (int, np.integer)):
        return int(arr)
    if isinstance(like, (float, np.floating)):
        return float(arr)
    return np.array(arr, dtype=np.asarray(like).dtype)


def _rebuild(like: Tree, restored: dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf taken from ``restored``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return restored[prefix]
    vals = [_rebuild(child, restored, f"{prefix}{_SEP}{key}" if prefix else key)
            for key, child in kids]
    if isinstance(like, dict):
        return dict(zip([k for k, _ in kids], vals))
    if _is_namedtuple(like):
        return type(like)(*vals)
    return type(like)(vals)


def load(path: str, like: Tree) -> Tree:
    """Restore the checkpoint at ``path`` into the structure of ``like``
    (leaf shapes must match what was saved; dtypes and devices are the
    ``like`` leaves')."""
    with np.load(path) as data:
        restored = {}
        for key, proto in _leaves(like):
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            arr = data[key]
            shape = (tuple(proto.shape) if isinstance(proto, torch.Tensor)
                     else None)
            if shape is not None and tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint {path} leaf {key!r} has shape "
                                 f"{tuple(arr.shape)}, expected {shape}")
            restored[key] = _restore_leaf(arr, proto)
    return _rebuild(like, restored)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointManager:
    """Rolling checkpoint directory: ``step_00000123.npz``, the last
    ``keep`` steps kept (plus the ``last_good`` anchor, which the GC never
    deletes)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    # -- manifest (checksums and the last-good marker) -------------------

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def _manifest(self) -> dict:
        try:
            with open(self._manifest_path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            m = {}
        m.setdefault("checksums", {})
        m.setdefault("last_good", None)
        return m

    def _write_manifest(self, m: dict) -> None:
        # Atomic like the checkpoints: a crash mid-write keeps the old one.
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(m, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self._manifest_path)

    def save(self, step: int, tree: Tree) -> str:
        """Checkpoint ``tree`` at ``step``.  Files of later steps (but the
        last-good one) belong to a trajectory the run left when it rolled
        back, and are deleted first: the keep window keeps the highest step
        numbers, so they would otherwise evict this file at once."""
        good = self._manifest()["last_good"]
        for later in self.all_steps():
            if later > step and later != good:
                os.unlink(self._path(later))
        p = self._path(step)
        save(p, tree)
        m = self._manifest()
        m["checksums"][os.path.basename(p)] = _sha256_file(p)
        self._write_manifest(m)
        self._gc()
        return p

    def verify(self, step: int) -> bool:
        """True when the step's file exists and matches its manifest
        checksum (a file with no recorded checksum passes)."""
        p = self._path(step)
        if not os.path.exists(p):
            return False
        expect = self._manifest()["checksums"].get(os.path.basename(p))
        return expect is None or _sha256_file(p) == expect

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, like: Tree) -> Tree:
        return load(self._path(step), like)

    # -- the whole train state -------------------------------------------
    #
    # A train state is saved whole: params, optimizer state, the variance
    # reducer's state (SAGA table and mean, lsvrg snapshots and anchors),
    # the step, the generator and the optional staleness, residual and
    # health tensors -- the FederatedState the step builders hand back, as
    # a dict (``state._asdict()``).  Anything less makes a resumed run
    # drift from the straight one.

    def save_train_state(self, step: int, state: Tree) -> str:
        """Checkpoint the complete train state at ``step``; every leaf
        (bf16 and the generator included) comes back bit for bit."""
        return self.save(step, state)

    def restore_latest(self, like: Tree) -> tuple[Optional[int], Tree]:
        """Restore the newest valid checkpoint into the structure of
        ``like``: a file failing its checksum, or unreadable, is skipped
        with a warning and the next older one tried.  ``(step, state)``,
        or ``(None, like)`` when nothing can be restored."""
        for step in reversed(self.all_steps()):
            if not self.verify(step):
                warnings.warn(
                    f"checkpoint {self._path(step)} fails its manifest "
                    f"checksum; skipping to the previous checkpoint")
                continue
            try:
                return step, self.restore(step, like)
            except _UNREADABLE as e:
                warnings.warn(
                    f"checkpoint {self._path(step)} is unreadable "
                    f"({type(e).__name__}: {e}); skipping to the previous "
                    f"checkpoint")
        return None, like

    # -- the last-good anchor (rollback, launch/health.py) ----------------

    def mark_good(self, step: int) -> None:
        """Record ``step`` as the last known-good checkpoint; the GC never
        deletes it."""
        if not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"cannot mark step {step} good: "
                                    f"{self._path(step)} does not exist")
        m = self._manifest()
        m["last_good"] = int(step)
        self._write_manifest(m)

    def last_good_step(self) -> Optional[int]:
        step = self._manifest()["last_good"]
        if step is None or not os.path.exists(self._path(step)):
            return None
        return int(step)

    def restore_last_good(self, like: Tree) -> tuple[Optional[int], Tree]:
        """Restore the checkpoint marked good (verified), or else the
        newest valid one (:meth:`restore_latest`)."""
        step = self.last_good_step()
        if step is not None and self.verify(step):
            try:
                return step, self.restore(step, like)
            except _UNREADABLE as e:
                warnings.warn(
                    f"last-good checkpoint {self._path(step)} is unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"newest valid checkpoint")
        return self.restore_latest(like)

    def _gc(self) -> None:
        steps = self.all_steps()
        good = self._manifest()["last_good"]
        doomed = [s for s in (steps[: -self.keep] if self.keep else [])
                  if s != good]
        for s in doomed:
            os.unlink(self._path(s))
        if doomed:
            m = self._manifest()
            live = {f"step_{s:08d}.npz" for s in self.all_steps()}
            m["checksums"] = {k: v for k, v in m["checksums"].items()
                              if k in live}
            self._write_manifest(m)
