"""Time-varying communication graphs for decentralized training (port of
``repro/topology/schedule.py``).

A :class:`GraphSchedule` is a finite period of T graphs on one node set;
round ``t`` uses graph ``t % T``.  Its (T, N, N) neighbor masks and mixing
matrices are stacked once in numpy; :meth:`GraphSchedule.on` moves both
stacks to a device once, and :meth:`DeviceSchedule.mask_at` /
:meth:`DeviceSchedule.mixing_at` then index them by the step counter (a
Python int), so nothing is rebuilt per round.

Gossip only needs the union graph over a window of rounds to be connected
(:meth:`GraphSchedule.is_connected_over_window`); a single round may be
disconnected.  :meth:`GraphSchedule.joint_spectral_gap` is one minus the
second-largest singular value of the period product of mixing matrices.

Constructors: ``static(topology)`` (T = 1), ``cyclic([...])`` and
``erdos_renyi_schedule(n, p, seed, period)``; ``get_schedule(name, ...)``
builds by name ("static", "cyclic", "erdos_renyi").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.topology.graphs import (Topology, _connected, erdos_renyi,
                                         get_topology)


class DeviceSchedule(NamedTuple):
    """A schedule's stacked masks (T, N, N) and mixing matrices (T, N, N),
    float32 on one device."""

    masks: torch.Tensor
    mixing: torch.Tensor

    def mask_at(self, t: int) -> torch.Tensor:
        """(N, N) neighbor mask of round ``t``."""
        return self.masks[t % self.masks.shape[0]]

    def mixing_at(self, t: int) -> torch.Tensor:
        """(N, N) mixing matrix of round ``t``."""
        return self.mixing[t % self.mixing.shape[0]]


@dataclasses.dataclass(frozen=True)
class GraphSchedule:
    """A periodic sequence of topologies on one node set."""

    name: str
    topologies: tuple[Topology, ...]

    def __post_init__(self):
        if not self.topologies:
            raise ValueError("GraphSchedule needs at least one topology")
        ns = {t.num_nodes for t in self.topologies}
        if len(ns) != 1:
            raise ValueError(
                f"every topology in a schedule must share the node set; "
                f"got node counts {sorted(ns)}")
        object.__setattr__(self, "topologies", tuple(self.topologies))

    @property
    def num_nodes(self) -> int:
        return self.topologies[0].num_nodes

    @property
    def period(self) -> int:
        return len(self.topologies)

    @property
    def is_static(self) -> bool:
        return self.period == 1

    @property
    def min_neighborhood(self) -> int:
        """Smallest neighborhood (incl. self) over every round."""
        return min(t.min_neighborhood for t in self.topologies)

    @functools.cached_property
    def stacked_masks(self) -> np.ndarray:
        """(T, N, N) float32 neighbor masks (with self-loops)."""
        return np.stack([t.neighbor_mask for t in self.topologies])

    @functools.cached_property
    def stacked_mixing(self) -> np.ndarray:
        """(T, N, N) float64 Metropolis-Hastings mixing matrices."""
        return np.stack([t.mixing for t in self.topologies])

    def on(self, device: str | torch.device) -> DeviceSchedule:
        """Both stacks as float32 tensors on ``device``, moved once."""
        return DeviceSchedule(
            torch.as_tensor(self.stacked_masks, dtype=torch.float32,
                            device=device),
            torch.as_tensor(self.stacked_mixing, dtype=torch.float32,
                            device=device))

    def union_adjacency(self, start: int = 0,
                        window: Optional[int] = None) -> np.ndarray:
        """(N, N) bool union of the adjacencies of rounds ``start`` ..
        ``start + window - 1`` (mod the period; default window = period)."""
        w = self.period if window is None else window
        adj = np.zeros((self.num_nodes, self.num_nodes), bool)
        for k in range(w):
            adj |= self.topologies[(start + k) % self.period].adjacency
        return adj

    def is_connected_over_window(self, window: Optional[int] = None) -> bool:
        """True iff the union graph of every length-``window`` run of
        consecutive rounds is connected (default window = the period)."""
        w = self.period if window is None else window
        if not 1 <= w <= self.period:
            raise ValueError(
                f"window must be in [1, {self.period}], got {w}")
        if w == self.period:
            return _connected(self.union_adjacency(0, w))
        return all(_connected(self.union_adjacency(s, w))
                   for s in range(self.period))

    def joint_spectral_gap(self) -> float:
        """``1 - sigma_2(W_{T-1} ... W_0)``, clamped to [0, 1]; 0 for a
        window-disconnected schedule."""
        n = self.num_nodes
        if n == 1:
            return 1.0
        prod = np.eye(n)
        for t in self.topologies:
            prod = t.mixing @ prod
        disagree = prod - np.full((n, n), 1.0 / n)
        sig = np.linalg.svd(disagree, compute_uv=False)
        return float(max(0.0, 1.0 - sig[0]))

    def describe(self) -> dict:
        """The schedule-level report: the joint gap plus each round's."""
        return {
            "name": self.name,
            "num_nodes": self.num_nodes,
            "period": self.period,
            "window_connected": self.is_connected_over_window(),
            "joint_spectral_gap": self.joint_spectral_gap(),
            "min_neighborhood": self.min_neighborhood,
            "rounds": [t.describe() for t in self.topologies],
        }


def static(topology: Topology) -> GraphSchedule:
    """The fixed-graph schedule, T = 1."""
    return GraphSchedule(f"static:{topology.name}", (topology,))


def cyclic(topologies: Sequence[Topology], *,
           name: Optional[str] = None) -> GraphSchedule:
    """Round ``t`` uses ``topologies[t % len(topologies)]``."""
    topos = tuple(topologies)
    if name is None:
        name = "cyclic:" + ",".join(t.name for t in topos)
    return GraphSchedule(name, topos)


def erdos_renyi_schedule(num_nodes: int, *, p: float = 0.5, seed: int = 0,
                         period: int = 4) -> GraphSchedule:
    """``period`` independent seeded G(N, p) draws, cycled; rounds are not
    redrawn to connectivity (``validate_schedule`` checks the window)."""
    if period < 1:
        raise ValueError(f"erdos_renyi schedule needs period >= 1, got {period}")
    rng = np.random.default_rng(np.random.SeedSequence([num_nodes, seed, period]))
    round_seeds = rng.integers(0, 2**31 - 1, size=period)
    topos = tuple(
        erdos_renyi(num_nodes, p=p, seed=int(s), require_connected=False)
        for s in round_seeds)
    return GraphSchedule(f"erdos_renyi(p={p},seed={seed},T={period})", topos)


def _build_static(num_nodes, topology, period, seed, p):
    topo = (topology if isinstance(topology, Topology)
            else get_topology(topology, num_nodes, seed=seed, p=p))
    return static(topo)


def _build_cyclic(num_nodes, topology, period, seed, p):
    if isinstance(topology, Topology):
        names = [topology]
    elif isinstance(topology, str):
        names = [n.strip() for n in topology.split(",") if n.strip()]
    else:
        names = list(topology)
    topos = [t if isinstance(t, Topology)
             else get_topology(t, num_nodes, seed=seed, p=p) for t in names]
    return cyclic(topos)


def _build_er(num_nodes, topology, period, seed, p):
    return erdos_renyi_schedule(num_nodes, p=p, seed=seed, period=period)


# name -> builder(num_nodes, topology, period, seed, p); the reference's names.
_SCHEDULES: dict[str, Callable[..., GraphSchedule]] = {
    "static": _build_static,
    "cyclic": _build_cyclic,
    "erdos_renyi": _build_er,
}

SCHEDULE_NAMES = tuple(_SCHEDULES)


def get_schedule(name: str, num_nodes: int, *,
                 topology: Union[str, Topology, Sequence] = "ring",
                 period: int = 4, seed: int = 0,
                 p: float = 0.5) -> GraphSchedule:
    """Build a schedule by name.  ``topology`` feeds "static" and "cyclic"
    (comma-separated names, a list, or objects); ``period``/``seed``/``p``
    feed the "erdos_renyi" resampler."""
    try:
        build = _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; known: "
            f"{', '.join(sorted(_SCHEDULES))}") from None
    return build(num_nodes, topology, period, seed, p)


def as_schedule(obj: Union[Topology, GraphSchedule]) -> GraphSchedule:
    """A fixed :class:`Topology` -> its static schedule; schedules pass."""
    if isinstance(obj, GraphSchedule):
        return obj
    if isinstance(obj, Topology):
        return static(obj)
    raise TypeError(f"expected Topology or GraphSchedule, got {type(obj)!r}")


def validate_schedule(cfg: Any, sched: GraphSchedule, num_nodes: int) -> None:
    """Feasibility of a schedule against the federation: node count, window
    connectivity, and trimmed_mean's per-round neighborhood bound."""
    if sched.num_nodes != num_nodes:
        raise ValueError(
            f"schedule {sched.name!r} has {sched.num_nodes} nodes but the "
            f"federation has {num_nodes}")
    if not sched.is_connected_over_window():
        raise ValueError(
            f"schedule {sched.name!r} is disconnected over its window of "
            f"{sched.period} rounds -- gossip cannot reach consensus; raise "
            "p / the period, or add a connected round to the cycle")
    if cfg.aggregator == "trimmed_mean" and sched.min_neighborhood <= 2 * cfg.trim:
        raise ValueError(
            f"trimmed_mean(trim={cfg.trim}) needs every neighborhood in "
            f"every round to have > {2 * cfg.trim} members; schedule "
            f"{sched.name!r} has a round with a neighborhood of "
            f"{sched.min_neighborhood}")
