"""Run health and the rollback state machine (port of
``repro/launch/health.py``).

The guards of :mod:`repro_torch.core.guards` contain faulty rows and
reject single rounds; :class:`RunHealth` watches the metric rows of the run
(``observe``) and decides when the run itself has gone bad:

- ``patience`` bad rounds in a row (the round's verdict rejected it, its
  loss is not finite, or its loss exceeds ``blowup`` times the best loss
  seen) set ``rollback_pending``;
- the train loop then restores the last good checkpoint
  (:meth:`repro_torch.checkpoint.CheckpointManager.restore_last_good`) and
  descends again with the restored generator, so the run repeats a straight
  run from that checkpoint bit for bit;
- every rollback climbs one rung of the degradation ladder: a list of
  :class:`~repro_torch.core.robust_step.RobustConfig` overrides applied
  with ``dataclasses.replace`` (:func:`apply_rung`), so repeated failures
  harden the defence instead of replaying the losing round.

Ladder syntax: rungs separated by ``;``, each a ``,``-separated group of
``key=value`` over RobustConfig fields::

    trim=3;aggregator=trimmed_mean,trim=4;aggregator=geomed

Values take the type of the field's current value.  Fields that change
the train state's structure (``vr``, ``message_dtype``, ``num_clients``,
``guards``, ...) would not fit the checkpoint being restored, and a rung
may not touch them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

# RobustConfig fields a rung may not touch: the restored checkpoint holds
# the state of the current structure.
_LADDER_FORBIDDEN = frozenset(
    {"vr", "message_dtype", "num_clients", "guards", "comm", "packed",
     "topology", "gossip", "schedule"})


def parse_ladder(spec: str) -> list[dict[str, str]]:
    """The ladder syntax as a list of override dicts (values still
    strings; :func:`apply_rung` converts them)."""
    rungs = []
    for group in (spec or "").split(";"):
        group = group.strip()
        if not group:
            continue
        rung = {}
        for kv in group.split(","):
            if "=" not in kv:
                raise ValueError(
                    f"degradation ladder rung {group!r}: expected "
                    f"key=value, got {kv!r}")
            k, v = kv.split("=", 1)
            rung[k.strip()] = v.strip()
        rungs.append(rung)
    return rungs


def _coerce(value: str, like):
    """``value`` in the type of the field's current value ``like``."""
    if isinstance(like, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    return value


def apply_rung(robust, rung: dict[str, str]):
    """One rung applied to a RobustConfig -> a new RobustConfig."""
    fields = {f.name for f in dataclasses.fields(robust)}
    overrides = {}
    for k, v in rung.items():
        if k not in fields:
            raise ValueError(f"degradation ladder: RobustConfig has no "
                             f"field {k!r}")
        if k in _LADDER_FORBIDDEN:
            raise ValueError(
                f"degradation ladder: field {k!r} changes the train-state "
                f"structure and cannot be escalated mid-run")
        overrides[k] = _coerce(v, getattr(robust, k))
    return dataclasses.replace(robust, **overrides)


class RunHealth:
    """Bad rounds in a row, and the rollback and escalation bookkeeping.

    Feed it metric rows with :meth:`observe`; poll ``rollback_pending`` in
    the train loop and call :meth:`on_rollback` after restoring a
    checkpoint (or :meth:`dismiss` when there is none)."""

    def __init__(self, *, patience: int = 5, blowup: float = 1e3,
                 ladder: str = ""):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.patience = patience
        self.blowup = blowup
        self.ladder = parse_ladder(ladder)
        self.rollbacks = 0
        self.rollback_pending = False
        self._consecutive_bad = 0
        self._best_loss: Optional[float] = None

    def observe(self, row: dict) -> None:
        """One metric row: the round is bad when its verdict rejected it
        (``round_accepted`` < 0.5), its loss is not finite, or its loss
        exceeds ``blowup`` times the best loss seen."""
        bad = False
        accepted = row.get("round_accepted")
        if accepted is not None and float(accepted) < 0.5:
            bad = True
        loss = row.get("loss")
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                bad = True
            elif self._best_loss is None:
                self._best_loss = loss
            elif loss > self.blowup * max(abs(self._best_loss), 1e-12):
                bad = True
            else:
                self._best_loss = min(self._best_loss, loss)
        self._consecutive_bad = self._consecutive_bad + 1 if bad else 0
        if self._consecutive_bad >= self.patience:
            self.rollback_pending = True

    @property
    def healthy(self) -> bool:
        """No bad round since the last good one: the gate for marking a
        checkpoint good."""
        return self._consecutive_bad == 0 and not self.rollback_pending

    def on_rollback(self) -> None:
        """The loop restored a checkpoint: count the rollback and start a
        fresh ``patience`` window."""
        self.rollbacks += 1
        self.rollback_pending = False
        self._consecutive_bad = 0
        self._best_loss = None

    def dismiss(self) -> None:
        """No rollback is possible: clear the pending flag and restart the
        window without counting a rollback or using a rung."""
        self.rollback_pending = False
        self._consecutive_bad = 0

    def escalate(self, robust):
        """The RobustConfig for the descent after a rollback: rung
        ``rollbacks - 1`` of the ladder (call after :meth:`on_rollback`),
        or ``robust`` itself when the ladder is empty or spent."""
        idx = self.rollbacks - 1
        if idx < 0 or idx >= len(self.ladder):
            return robust
        return apply_rung(robust, self.ladder[idx])

    def summary(self) -> dict:
        return {"rollbacks": self.rollbacks,
                "ladder_rungs_used": min(self.rollbacks, len(self.ladder))}
