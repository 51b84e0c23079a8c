"""Partial participation with bounded staleness (port of
``repro/core/participation.py``).

* :class:`ParticipationPlan` -- which clients fill the W honest message
  slots each round.  The cohorts are precomputed with numpy (so the port
  reproduces the reference's exactly) as one (T, W) stack, moved to the
  device once; round ``t`` takes row ``t % T``.  Each epoch is a seeded
  permutation of the C clients chopped into ceil(C / W) rounds, the short
  last round topped up from the head of the same permutation: every
  cohort has W distinct clients, and every client takes part at least once
  an epoch.
* Per-client bookkeeping: :func:`gather_rows` / :func:`scatter_rows` move
  a cohort's rows between (C, ...) resident state and the (W, ...) round
  view; :func:`tick_staleness` advances the (C,) rounds-since-last-report
  counters.  The SAGA table is not moved at all: kernel K1 reads and
  writes the cohort's rows of the resident table in place.
* Bounded-staleness weights: :func:`staleness_weights` maps counters to
  per-row aggregation weights ``decay**s``, exactly 0 at or past
  ``max_staleness`` (how ``dropout`` slots drop out of every rule), and
  :func:`slot_staleness` appends the Byzantine slots' counters.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.attacks import STALENESS_ATTACKS


@dataclasses.dataclass(frozen=True)
class ParticipationPlan:
    """Seeded plan of the cohorts: ``num_clients`` C logical clients,
    ``cohort_size`` W slots a round, ``epochs`` shuffled epochs before the
    plan wraps (period ``num_rounds``)."""

    num_clients: int
    cohort_size: int
    seed: int = 0
    epochs: int = 4

    def __post_init__(self):
        if not 0 < self.cohort_size <= self.num_clients:
            raise ValueError(
                f"cohort_size={self.cohort_size} must be in "
                f"[1, num_clients={self.num_clients}]")
        if self.epochs < 1:
            raise ValueError(f"epochs={self.epochs} must be >= 1")

    @property
    def rounds_per_epoch(self) -> int:
        return math.ceil(self.num_clients / self.cohort_size)

    @property
    def num_rounds(self) -> int:
        """T: the period of the cohort stack."""
        return self.epochs * self.rounds_per_epoch

    @functools.cached_property
    def stacked_cohorts(self) -> np.ndarray:
        """(T, W) int32 client ids, one row a round: round r of an epoch
        takes ``perm[r*W:(r+1)*W]``, the last one topped up from
        ``perm[:k]`` (head and tail never overlap)."""
        c, w = self.num_clients, self.cohort_size
        rounds = []
        for e in range(self.epochs):
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, e]))
            perm = rng.permutation(c)
            for r in range(self.rounds_per_epoch):
                chunk = perm[r * w:(r + 1) * w]
                if chunk.size < w:
                    chunk = np.concatenate([chunk, perm[: w - chunk.size]])
                rounds.append(chunk)
        return np.stack(rounds).astype(np.int32)

    def cohort_at(self, t: int, device: str | torch.device = "cpu"
                  ) -> torch.Tensor:
        """(W,) int64 client ids of round ``t``, on ``device`` (the stack is
        moved there once)."""
        return _stack_on(self, torch.device(device))[int(t) % self.num_rounds]


@functools.lru_cache(maxsize=16)
def _stack_on(plan: ParticipationPlan, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(plan.stacked_cohorts, dtype=torch.int64,
                           device=device)


def resolve_participation(cfg, cohort_size: int
                          ) -> Optional[ParticipationPlan]:
    """The plan of a RobustConfig for a path of ``cohort_size`` honest
    slots, or None for full participation (``num_clients`` 0 or equal to
    the slots), which keeps the step the program it was before."""
    if cfg.num_clients in (0, cohort_size):
        return None
    if cfg.num_clients < cohort_size:
        raise ValueError(
            f"num_clients={cfg.num_clients} is smaller than the "
            f"{cohort_size}-slot cohort; use num_clients=0 for full "
            "participation")
    if cfg.cohort_size not in (0, cohort_size):
        raise ValueError(
            f"cohort_size={cfg.cohort_size} does not match the execution "
            f"path's {cohort_size} message slots")
    return ParticipationPlan(num_clients=cfg.num_clients,
                             cohort_size=cohort_size,
                             seed=cfg.participation_seed)


def gather_rows(tree, cohort: torch.Tensor):
    """The cohort's rows of (C, ...)-leading state (a tensor, or a NamedTuple
    of them) -> (W, ...) copies."""
    if isinstance(tree, torch.Tensor):
        return tree[cohort]
    return type(tree)(*(v[cohort] for v in tree))


def scatter_rows(tree, cohort: torch.Tensor, rows):
    """Write the round's (W, ...) rows back into the (C, ...) state in place
    and return ``tree``.  The plan's cohorts are duplicate-free, so no two
    rows land on one client."""
    pairs = [(tree, rows)] if isinstance(tree, torch.Tensor) else zip(tree,
                                                                      rows)
    for v, r in pairs:
        v[cohort] = r.to(v.dtype)
    return tree


def init_staleness(num_clients: int, device: str | torch.device = "cpu"
                   ) -> torch.Tensor:
    """(C,) int32 rounds-since-last-participation counters, all 0."""
    return torch.zeros((num_clients,), dtype=torch.int32, device=device)


def tick_staleness(staleness: torch.Tensor,
                   cohort: torch.Tensor) -> torch.Tensor:
    """One round on: +1 for every client, 0 for the cohort (a new
    tensor)."""
    out = staleness + 1
    out[cohort] = 0
    return out


@functools.lru_cache(maxsize=1)
def _powf():
    """The C library's float32 ``powf``, which XLA's CPU ``pow`` calls (torch's
    vectorized pow and float64 rounding each differ from it by an ulp now and
    then)."""
    name = ctypes.util.find_library("m")
    if name is None:
        raise RuntimeError("the C math library (libm) was not found; the "
                           "staleness weights need its powf")
    fn = ctypes.CDLL(name).powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return fn


@functools.lru_cache(maxsize=32)
def _decay_table(decay: float, max_staleness: int,
                 device: torch.device) -> torch.Tensor:
    """(max(max_staleness, 1),) float32 ``decay**s`` for s = 0, 1, ...,
    computed once on the host and moved to ``device``."""
    powf = _powf()
    vals = [powf(decay, float(e)) for e in range(max(max_staleness, 1))]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def staleness_weights(staleness: torch.Tensor, *, decay: float,
                      max_staleness: int) -> torch.Tensor:
    """(W,) float32 weights ``decay**s`` (float32 ``powf``, as the reference
    computes them), exactly 0 at or past ``max_staleness``."""
    s = staleness.to(torch.int64)
    table = _decay_table(float(decay), int(max_staleness), s.device)
    w = table[torch.clamp(s, 0, table.numel() - 1)]
    return torch.where(s >= max_staleness, 0.0, w)


def slot_staleness(honest_staleness: torch.Tensor, attack: str,
                   num_byzantine: int, *, straggler_k: int,
                   max_staleness: int) -> torch.Tensor:
    """Per-slot staleness of the full message buffer: the cohort's
    counters, then the B Byzantine slots' (appended last): ``straggler_k``
    for ``straggler``, the ``max_staleness`` sentinel (weight 0) for
    ``dropout``, 0 for every other attack."""
    s = honest_staleness.to(torch.int32)
    if num_byzantine == 0 or attack == "none":
        return s
    byz_val = {"straggler": straggler_k,
               "dropout": max_staleness}.get(attack, 0)
    return torch.cat([s, torch.full((num_byzantine,), byz_val,
                                    dtype=torch.int32, device=s.device)])


def uses_staleness(cfg, plan: Optional[ParticipationPlan]) -> bool:
    """Whether the aggregation takes staleness weights: under partial
    participation or a staleness attack.  Otherwise the rules run without
    ``row_weights``, the program they were."""
    return plan is not None or cfg.attack in STALENESS_ATTACKS
