"""Network topologies for decentralized Byzantine-robust training (port of
``repro/topology/graphs.py``; plain numpy, a copy kept in the port).

A :class:`Topology` carries

* ``adjacency``     -- (N, N) bool, symmetric, zero diagonal;
* ``mixing``        -- (N, N) float64 Metropolis-Hastings weights
                       ``W_ij = 1 / (1 + max(deg_i, deg_j))`` on edges,
                       ``W_ii = 1 - sum_j W_ij``: symmetric and doubly
                       stochastic;
* ``neighbor_mask`` -- (N, N) float32 with self-loops,
                       ``mask[i, j] = 1  iff  j in N(i) or j == i``: the
                       restriction every masked rule of
                       :mod:`repro_torch.topology.masked` consumes.

Constructors: ``ring``, ``torus2d``, ``complete``, ``erdos_renyi(p, seed)``
(the reference's ``SeedSequence([N, seed])`` stream, so the same adjacency)
and ``star`` (node 0 the hub; the training entry point keeps a static star
on the master path).

:meth:`Topology.spectral_gap` is ``1 - |lambda_2(mixing)|`` clamped to
[0, 1]: a disconnected graph has an eigenvalue of magnitude 1, which
``eigvalsh`` may return O(eps) above 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected communication graph plus its gossip matrices."""

    name: str
    num_nodes: int
    adjacency: np.ndarray  # (N, N) bool, symmetric, zero diagonal

    def __post_init__(self):
        adj = np.asarray(self.adjacency, bool)
        n = self.num_nodes
        if adj.shape != (n, n):
            raise ValueError(f"adjacency must be ({n}, {n}), got {adj.shape}")
        if adj.diagonal().any():
            raise ValueError("adjacency must have a zero diagonal "
                             "(self-loops live in neighbor_mask)")
        if not (adj == adj.T).all():
            raise ValueError("adjacency must be symmetric (undirected graph)")
        object.__setattr__(self, "adjacency", adj)

    @property
    def degrees(self) -> np.ndarray:
        """(N,) neighbor counts, self excluded."""
        return self.adjacency.sum(axis=1).astype(np.int64)

    @property
    def neighbor_mask(self) -> np.ndarray:
        """(N, N) float32 mask with self-loops: row i selects N(i) + {i}."""
        return (self.adjacency | np.eye(self.num_nodes, dtype=bool)).astype(
            np.float32)

    @property
    def mixing(self) -> np.ndarray:
        """(N, N) float64 Metropolis-Hastings weights (symmetric, doubly
        stochastic)."""
        n = self.num_nodes
        deg = self.degrees
        w = np.where(self.adjacency,
                     1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])),
                     0.0)
        w[np.arange(n), np.arange(n)] = 1.0 - w.sum(axis=1)
        return w

    @property
    def min_neighborhood(self) -> int:
        """Smallest neighborhood size including self (min degree + 1)."""
        return int(self.degrees.min()) + 1

    def is_connected(self) -> bool:
        return _connected(self.adjacency)

    def spectral_gap(self) -> float:
        """``1 - |lambda_2|`` of the mixing matrix, in [0, 1]; a
        disconnected graph reports 0."""
        if self.num_nodes <= 1:
            return 1.0
        mags = np.sort(np.abs(np.linalg.eigvalsh(self.mixing)))
        return float(min(max(1.0 - mags[-2], 0.0), 1.0))

    def describe(self) -> dict:
        """The spectral-gap report (log line)."""
        deg = self.degrees
        return {
            "name": self.name,
            "num_nodes": self.num_nodes,
            "num_edges": int(self.adjacency.sum()) // 2,
            "degree_min": int(deg.min()),
            "degree_max": int(deg.max()),
            "degree_mean": float(deg.mean()),
            "connected": self.is_connected(),
            "spectral_gap": self.spectral_gap(),
        }


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    seen[0] = True
    frontier = adj[0].copy()
    while frontier.any():
        seen |= frontier
        frontier = (adj[frontier].any(axis=0)) & ~seen
    return bool(seen.all())


def _check_n(name: str, n: int, minimum: int = 2) -> None:
    if n < minimum:
        raise ValueError(f"{name} topology needs >= {minimum} nodes, got {n}")


def ring(num_nodes: int) -> Topology:
    """Cycle graph: node i talks to i +- 1 (mod N)."""
    _check_n("ring", num_nodes)
    adj = np.zeros((num_nodes, num_nodes), bool)
    idx = np.arange(num_nodes)
    adj[idx, (idx + 1) % num_nodes] = True
    adj[(idx + 1) % num_nodes, idx] = True
    np.fill_diagonal(adj, False)  # num_nodes == 2: the two edges coincide
    return Topology("ring", num_nodes, adj)


def torus2d(num_nodes: int, *, rows: Optional[int] = None) -> Topology:
    """2-D torus (wrap-around grid, degree <= 4).  ``rows`` defaults to the
    largest divisor of N at most sqrt(N); a prime N is rejected."""
    _check_n("torus2d", num_nodes, 4)
    if rows is None:
        rows = max(d for d in range(1, int(math.isqrt(num_nodes)) + 1)
                   if num_nodes % d == 0)
    if num_nodes % rows != 0:
        raise ValueError(f"torus2d: rows={rows} does not divide N={num_nodes}")
    cols = num_nodes // rows
    if rows == 1 or cols == 1:
        raise ValueError(
            f"torus2d: N={num_nodes} only factors as a 1-wide grid "
            "(prime N?); use the ring topology instead")
    adj = np.zeros((num_nodes, num_nodes), bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j in (((r + 1) % rows) * cols + c,
                      r * cols + (c + 1) % cols):
                if i != j:
                    adj[i, j] = adj[j, i] = True
    return Topology("torus2d", num_nodes, adj)


def complete(num_nodes: int) -> Topology:
    """Fully connected: every node sees every message."""
    _check_n("complete", num_nodes)
    return Topology("complete", num_nodes, ~np.eye(num_nodes, dtype=bool))


def erdos_renyi(num_nodes: int, *, p: float = 0.5, seed: int = 0,
                max_tries: int = 64, require_connected: bool = True) -> Topology:
    """G(N, p), each edge i.i.d. Bernoulli(p) from a numpy Generator on
    ``SeedSequence([N, seed])``.  A disconnected draw is redrawn up to
    ``max_tries`` times, then raises; ``require_connected=False`` returns
    the first draw (the schedules' rounds may be disconnected)."""
    _check_n("erdos_renyi", num_nodes)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"erdos_renyi: p must be in [0, 1], got {p}")
    rng = np.random.default_rng(np.random.SeedSequence([num_nodes, seed]))
    for _ in range(max_tries):
        upper = rng.random((num_nodes, num_nodes)) < p
        adj = np.triu(upper, k=1)
        adj = adj | adj.T
        if not require_connected or _connected(adj):
            return Topology("erdos_renyi", num_nodes, adj)
    raise ValueError(
        f"erdos_renyi(N={num_nodes}, p={p}, seed={seed}): no connected draw "
        f"in {max_tries} tries -- raise p (connectivity threshold ~ ln(N)/N) "
        "or pick another seed")


def star(num_nodes: int) -> Topology:
    """Hub-and-spokes, node 0 the hub: the master federation as a graph."""
    _check_n("star", num_nodes)
    adj = np.zeros((num_nodes, num_nodes), bool)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return Topology("star", num_nodes, adj)


# name -> builder(num_nodes, **opts); the reference's names.
_TOPOLOGIES: dict[str, Callable[..., Topology]] = {
    "ring": ring,
    "torus2d": torus2d,
    "complete": complete,
    "erdos_renyi": erdos_renyi,
    "star": star,
}

TOPOLOGY_NAMES = tuple(_TOPOLOGIES)


def get_topology(name: str, num_nodes: int, *, seed: int = 0,
                 p: float = 0.5) -> Topology:
    """Build a topology by name; ``seed``/``p`` reach ``erdos_renyi`` only."""
    try:
        build = _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; known: "
            f"{', '.join(sorted(_TOPOLOGIES))}") from None
    if name == "erdos_renyi":
        return build(num_nodes, p=p, seed=seed)
    return build(num_nodes)
