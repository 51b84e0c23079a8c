"""The Byzantine-robust federated training step, paper Alg. 1 (port of
``repro/core/robust_step.py``'s simulated federation).

:func:`make_federated_step` builds ``(init_fn, step_fn)`` for the
simulation: the packed step, or with ``packed=False`` the per-leaf
baseline (messages, VR state and aggregation as dicts of per-leaf tensors,
each kernel launched once per leaf); the two share one step body, and
:class:`PackedLayout` or :class:`LeafLayout` holds the messages.  With the default star
topology and static schedule it is the master path: W_h honest workers
each send a (variance-reduced) stochastic gradient, B Byzantine rows are
injected by an attack model, the master aggregates the packed (W, D)
buffer with a robust rule and applies the optimizer.  Any other graph or
schedule (:func:`resolve_schedule`) routes to the decentralized step of
:mod:`repro_torch.topology.decentralized_step`.

Per-sample gradients come from ``torch.func`` (``grad`` vmapped over the
sample axis).  On a CUDA device the SAGA correction runs kernel K1 and the
aggregation rules their kernels (K2-K6, see :mod:`repro_torch.core.aggregators`);
on the CPU their plain versions run.
The SAGA table, the step's generator and the state passed to ``step_fn``
are updated in place (see :mod:`repro_torch.core.saga`).

Besides the paper's path the step takes the reference's simulation
options:

* partial participation (``num_clients``, ``cohort_size``): each round a
  seeded cohort of clients fills the honest slots
  (:mod:`repro_torch.core.participation`); the variance-reduction state is
  resident per client and the cohort's SAGA rows are updated in place by
  K1's client-row route, never gathered into a copy;
* bounded staleness (``max_staleness``, ``staleness_decay``, the
  ``straggler`` and ``dropout`` attacks): per-row staleness weights of the
  flat rules;
* guards (``guards``): quarantined rows get weight 0
  (:mod:`repro_torch.core.guards`), and a rejected round keeps params,
  optimizer state and the variance-reduction state -- the drawn rows are
  copied before the correction and written back;
* diagnostics (``diagnostics``): the rule's AggDiagnostics as ``diag_*``
  metrics;
* the wires (``message_dtype``, :data:`repro_torch.core.packing.WIRE_FORMATS`):
  ``bfloat16`` packs the messages, the SAGA table and lsvrg's state in
  bf16, and the kernels read it as it is; ``int8`` and ``sign1`` send the
  corrected messages through :meth:`PackSpec.transmit` (sign1 with a
  float32 error-feedback residual per client, ``FederatedState.ef``, whose
  cohort rows are written back in place under partial participation), and
  the whole buffer, Byzantine rows included, crosses the wire again after
  the attack.

With all of them off (the defaults) the step is the program it was.

:func:`distributed_aggregate` (``comm="gather"``) and
:func:`sharded_aggregate` (``comm="sharded"``) are the master's
aggregation across ranks over a :class:`repro_torch.launch.mesh.Mesh`, one
worker per index of its worker axes, and :func:`distributed_attack` its
Byzantine workers; the simulation ignores ``comm``, as the reference's
does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as attack_lib
from repro_torch.core import geomed as geomed_lib
from repro_torch.core import guards as guards_lib
from repro_torch.core import packing
from repro_torch.core import participation as participation_lib
from repro_torch.core import variance as vr_lib
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch import collectives as coll
from repro_torch.optim import optimizers as optim_lib
from repro_torch.telemetry import diagnostics as diag_lib
from repro_torch.telemetry import metrics as telemetry

Params = dict[str, torch.Tensor]

@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Everything that defines the robust training loop of the paper: the
    reference's field names and defaults."""

    aggregator: str = "geomed"
    vr: str = "saga"
    attack: str = "none"
    num_byzantine: int = 0
    topology: str = "star"
    topology_seed: int = 0
    topology_p: float = 0.5
    gossip: str = "gradient"
    schedule: str = "static"
    schedule_period: int = 4
    minibatch_size: int = 50
    lsvrg_p: float = 0.1
    weiszfeld_iters: int = 64
    weiszfeld_tol: float = 1e-6
    num_groups: int = 4
    trim: int = 1
    clip_radius: float = 1.0
    comm: str = "gather"
    packed: bool = True
    message_dtype: str = "float32"
    gaussian_variance: float = 30.0
    sign_flip_magnitude: float = -3.0
    alie_z: float = 1.0
    ipm_eps: float = 0.5
    num_clients: int = 0
    cohort_size: int = 0
    participation_seed: int = 0
    max_staleness: int = 64
    staleness_decay: float = 1.0
    straggler_k: int = 4
    diagnostics: bool = False
    guards: bool = False
    guard_multiplier: float = 10.0
    reject_ema: float = 0.9
    reject_zmax: float = 6.0
    reject_warmup: int = 8
    bitflip_prob: float = 0.02
    bitflip_seed: int = 0

    def reducer(self):
        """The variance reducer named by ``self.vr``, on the per-leaf
        layout (:class:`~repro_torch.core.variance.PerLeafReducer`) when
        ``not self.packed``."""
        return vr_lib.get_reducer(self, perleaf=not self.packed)

    def aggregator_fn(self, *, perleaf: Optional[bool] = None,
                      axis_names=(), sync_axes=()) -> agg_lib.Aggregator:
        """Pytree aggregator for this config; ``perleaf`` defaults to ``not
        self.packed`` (the packed engine's shim against the per-leaf
        baseline)."""
        return agg_lib.get_aggregator(
            self.aggregator,
            perleaf=(not self.packed) if perleaf is None else perleaf,
            max_iters=self.weiszfeld_iters, tol=self.weiszfeld_tol,
            num_groups=self.num_groups, trim=self.trim,
            num_byzantine=self.num_byzantine, clip_radius=self.clip_radius,
            axis_names=axis_names, sync_axes=sync_axes)

    def check_wire(self) -> None:
        """A quantized wire needs the packed path, as in the reference."""
        if packing.resolve_wire_format(self.message_dtype).quantized \
                and not self.packed:
            raise ValueError(
                f"message_dtype={self.message_dtype!r} is a quantized wire "
                "format and needs the packed path (cfg.packed=True)")

    def attack_config(self) -> attack_lib.AttackConfig:
        attack_lib.check_attack_name(self.attack)
        return attack_lib.AttackConfig(
            name=self.attack, num_byzantine=self.num_byzantine,
            gaussian_variance=self.gaussian_variance,
            sign_flip_magnitude=self.sign_flip_magnitude,
            alie_z=self.alie_z, ipm_eps=self.ipm_eps,
            straggler_k=self.straggler_k, bitflip_prob=self.bitflip_prob,
            bitflip_seed=self.bitflip_seed)

    def message_spec(self, tree: Params, *, batch_ndim: int = 1
                     ) -> packing.PackSpec:
        """PackSpec of this config's wire messages for ``tree``."""
        return packing.pack_spec(tree, batch_ndim=batch_ndim,
                                 wire=self.message_dtype)

    def flat_aggregator_fn(self, spec: packing.PackSpec, *, axis_names=(),
                           sync_axes=(), diagnostics: Optional[bool] = None
                           ) -> agg_lib.FlatAggregator:
        """Flat aggregator ``(W, D) -> (D,) f32`` for this config's messages
        laid out by ``spec``; with diagnostics (default
        ``self.diagnostics``) it returns ``(aggregate, AggDiagnostics)``.
        ``axis_names``/``sync_axes``: the collective axes of rows that are
        coordinate shards across ranks."""
        return agg_lib.get_flat_aggregator(
            self.aggregator, spec,
            max_iters=self.weiszfeld_iters, tol=self.weiszfeld_tol,
            num_groups=self.num_groups, trim=self.trim,
            num_byzantine=self.num_byzantine, clip_radius=self.clip_radius,
            diagnostics=(self.diagnostics if diagnostics is None
                         else diagnostics),
            axis_names=axis_names, sync_axes=sync_axes)


class FederatedState(NamedTuple):
    # The model's leaf shapes on the master path; with a leading node axis
    # (N, ...) on the decentralized path.
    params: Params
    opt_state: Any
    # Variance-reduction state (SagaState for "saga", LsvrgState for
    # "lsvrg", None for "sgd" and "minibatch"); under partial participation
    # its rows are per client, (num_clients, ...).
    vr: Optional[Any]
    step: int
    # The run's random stream: sample draws, lsvrg's refresh coins, then
    # attack noise, each step.
    generator: torch.Generator
    # (num_clients,) int32 rounds since each client last took part, or
    # None under full participation.
    staleness: Optional[torch.Tensor] = None
    # (num_clients, D) float32 error-feedback residuals on an
    # error-feedback wire (sign1), else None.
    ef: Optional[torch.Tensor] = None
    # (4,) float32 round-health vector when cfg.guards, else None.
    health: Optional[torch.Tensor] = None


def as_batches(rows: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Rows (W, ...) -> batches of one sample (W, 1, ...)."""
    return {k: v[:, None] for k, v in rows.items()}


def per_sample_table(per_sample_grads, params: Params,
                     data: dict[str, torch.Tensor],
                     spec: packing.PackSpec) -> torch.Tensor:
    """Alg. 1 init: table[w, j] = f'_{w,j}(x^0), packed (W_h, J, D),
    written worker by worker so no second full-size table exists."""
    wh, j = next(iter(data.values())).shape[:2]
    dev = next(iter(data.values())).device
    table = torch.empty((wh, j, spec.padded_dim), dtype=spec.message_dtype,
                        device=dev)
    for w in range(wh):
        grads = per_sample_grads(params, as_batches(
            {k: v[w] for k, v in data.items()}))
        table[w] = spec.pack(grads, batch_ndim=1)
    return table


def perleaf_table(per_sample_grads, params: Params,
                  data: dict[str, torch.Tensor]) -> Params:
    """Alg. 1 init on the per-leaf layout: table[k][w, j] = f'_{w,j}(x^0),
    leaves (W_h, J, *shape), written worker by worker."""
    wh, j = next(iter(data.values())).shape[:2]
    dev = next(iter(data.values())).device
    table = {k: torch.empty((wh, j) + tuple(p.shape), dtype=torch.float32,
                            device=dev) for k, p in params.items()}
    for w in range(wh):
        grads = per_sample_grads(params, as_batches(
            {k: v[w] for k, v in data.items()}))
        for k, g in grads.items():
            table[k][w] = g
    return table


def init_vr(cfg: RobustConfig, reducer, per_sample_grads, params: Params,
            data: dict[str, torch.Tensor], spec: packing.PackSpec,
            num_workers: int):
    """The reducer's initial state at ``params``, packed by ``spec`` or, with
    ``cfg.packed`` False, on the per-leaf layout; ``data`` holds one shard a
    state row."""
    if cfg.packed:
        return reducer.init_sim(
            params, per_sample_grads_fn=lambda: per_sample_table(
                per_sample_grads, params, data, spec),
            full_grads_fn=lambda: spec.pack(per_sample_grads(params, data)),
            num_workers=num_workers, spec=spec)
    return reducer.init_sim(
        params, per_sample_grads_fn=lambda: perleaf_table(
            per_sample_grads, params, data),
        full_grads_fn=lambda: per_sample_grads(params, data),
        num_workers=num_workers)


def init_ef(spec: packing.PackSpec, num_clients: int,
            dev: torch.device) -> Optional[torch.Tensor]:
    """Zero (num_clients, D) float32 residuals on an error-feedback wire,
    else None: the first round sends plain quantized messages."""
    if not spec.wire_format.error_feedback:
        return None
    return torch.zeros((num_clients, spec.padded_dim), dtype=torch.float32,
                       device=dev)


def wire_transmit(spec: packing.PackSpec, buf: torch.Tensor,
                  ef: Optional[torch.Tensor], rows: Optional[torch.Tensor]):
    """The honest senders' wire step on ``buf`` (W_h, D) -> ``(wire, ef,
    held)``: the dequantized wire rows (``buf`` itself on a format that is
    not quantized), the residual state after the round and the residual
    rows it replaced (None without error feedback).  With ``rows`` (the
    cohort's client rows) the new residual rows are written into ``ef`` in
    place; otherwise the new (W_h, D) residual is returned and ``ef`` is
    left as it was.  :func:`restore_ef` undoes the round."""
    fmt = spec.wire_format
    if not fmt.error_feedback:
        return spec.wire_roundtrip(buf), ef, None
    held = ef if rows is None else ef[rows]
    wire, new = spec.transmit(buf, held)
    if rows is None:
        return wire, new, held
    ef[rows] = new
    return wire, ef, held


def restore_ef(ef: Optional[torch.Tensor], held: Optional[torch.Tensor],
               rows: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The residual state of a rejected round: :func:`wire_transmit`'s
    ``held`` rows back in place (or the old tensor itself)."""
    if held is None:
        return ef
    if rows is None:
        return held
    ef[rows] = held
    return ef


class PackedLayout(NamedTuple):
    """Messages on the packed path: one (W, D) buffer in the wire's dtype,
    laid out by ``spec``, which crosses the wire."""
    spec: packing.PackSpec

    def pack(self, tree: Params, batch_ndim: int = 1) -> torch.Tensor:
        return self.spec.pack(tree, batch_ndim=batch_ndim)

    def unpack(self, buf: torch.Tensor, batch_ndim: int = 1) -> Params:
        return self.spec.unpack(buf, batch_ndim=batch_ndim)

    def flat(self, buf: torch.Tensor) -> torch.Tensor:
        return buf

    def transmit(self, buf, ef, rows):
        return wire_transmit(self.spec, buf, ef, rows)


class LeafLayout(NamedTuple):
    """Messages on the per-leaf baseline (``cfg.packed=False``): dicts of
    per-leaf tensors, float32 on every wire that is not quantized (the
    reference packs nothing there, so a bf16 wire casts nothing).  ``spec``
    is their float32 packing, for the packed views that metrics, guards
    and the flat-engine detours read."""
    spec: packing.PackSpec

    def pack(self, tree: Params, batch_ndim: int = 1) -> Params:
        return tree

    def unpack(self, tree: Params, batch_ndim: int = 1) -> Params:
        return tree

    def flat(self, tree: Params) -> torch.Tensor:
        return self.spec.pack(tree)

    def transmit(self, tree, ef, rows):
        return tree, ef, None


def message_layout(cfg: RobustConfig, tree: Params):
    """The layout of this config's messages, whose per-worker gradients
    ``tree`` has leaves (W, ...)."""
    if cfg.packed:
        return PackedLayout(cfg.message_spec(tree, batch_ndim=1))
    return LeafLayout(packing.pack_spec(tree))


def expand_rows(x, n: int):
    """``x`` (a tensor, or a dict of them) repeated as ``n`` rows, a view."""
    if isinstance(x, dict):
        return {k: expand_rows(v, n) for k, v in x.items()}
    return x[None].expand((n,) + tuple(x.shape))


def sample_rows(reducer: vr_lib.VarianceReducer, generator: torch.Generator,
                sample_idx, wh: int, j: int,
                dev: torch.device) -> torch.Tensor:
    """The step's sample rows, shaped ``reducer.index_shape(wh)`` ((W_h,),
    or (W_h, B) for ``minibatch``): drawn from ``generator``, or the
    caller's ``sample_idx`` checked and moved to ``dev``."""
    if sample_idx is None:
        return reducer.draw_indices(generator, wh, j)
    idx = torch.as_tensor(sample_idx, dtype=torch.int64)
    shape = reducer.index_shape(wh)
    if tuple(idx.shape) != shape:
        raise ValueError(f"sample_idx must be {shape}, got {tuple(idx.shape)}")
    if idx.device.type == "cpu" and bool(((idx < 0) | (idx >= j)).any()):
        raise ValueError(f"sample_idx out of range [0, {j})")
    return idx.to(dev)


def worker_batches(data: dict[str, torch.Tensor], w_ids: torch.Tensor,
                   idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """Each worker's batch of the step, (W_h, 1, ...) for (W_h,) sample
    rows and (W_h, B, ...) for (W_h, B) rows: a gradient of the mean loss
    over it is the worker's one-sample or minibatch gradient."""
    if idx.dim() == 2:
        return {k: v[w_ids[:, None], idx] for k, v in data.items()}
    return as_batches({k: v[w_ids, idx] for k, v in data.items()})


def resolve_plan(cfg: RobustConfig, worker_data: dict[str, Any]):
    """The participation plan of ``cfg`` for ``worker_data`` (one shard a
    client under partial participation), or None; checks the two agree."""
    num_rows = next(iter(worker_data.values())).shape[0]
    if cfg.num_clients:
        if cfg.num_clients != num_rows:
            raise ValueError(f"num_clients={cfg.num_clients} but worker_data "
                             f"has {num_rows} client shards")
        if not cfg.cohort_size:
            raise ValueError("partial participation in the simulated "
                             "federation needs an explicit cohort_size")
    return participation_lib.resolve_participation(
        cfg, cfg.cohort_size if cfg.num_clients else num_rows)


def slot_weights(cfg: RobustConfig, honest_stal: Optional[torch.Tensor],
                 num_byzantine: int):
    """(W,) staleness weights of the full message buffer (honest slots,
    then the Byzantine ones) and the slots' staleness, or (None, None) on
    the unweighted path."""
    if honest_stal is None:
        return None, None
    slot_stal = participation_lib.slot_staleness(
        honest_stal, cfg.attack, num_byzantine, straggler_k=cfg.straggler_k,
        max_staleness=cfg.max_staleness)
    return participation_lib.staleness_weights(
        slot_stal, decay=cfg.staleness_decay,
        max_staleness=cfg.max_staleness), slot_stal


def round_slots(plan, weighted: bool, state: "FederatedState",
                w_ids: torch.Tensor):
    """The round's (slot data rows (W_h,), state rows or None, honest
    staleness or None): the cohort under partial participation, the
    workers ``w_ids`` themselves otherwise."""
    if plan is None:
        stal = torch.zeros_like(w_ids, dtype=torch.int32) if weighted else None
        return w_ids, None, stal
    cohort = plan.cohort_at(state.step, w_ids.device)
    return cohort, cohort, state.staleness[cohort]


def resolve_topology(cfg: RobustConfig, num_nodes: int, topology=None):
    """The ``topology=`` argument of the step builder: an explicit
    :class:`~repro_torch.topology.Topology` wins, else ``cfg.topology`` is
    built by name for ``num_nodes`` nodes.  None for ``"star"`` (the master
    path)."""
    from repro_torch import topology as topo_lib  # topology imports core
    if topology is None:
        topology = cfg.topology
    if isinstance(topology, str):
        if topology == "star":
            return None
        return topo_lib.get_topology(topology, num_nodes,
                                     seed=cfg.topology_seed, p=cfg.topology_p)
    if topology.name == "star":
        return None
    return topology


def resolve_schedule(cfg: RobustConfig, num_nodes: int, topology=None,
                     schedule=None):
    """The (topology, schedule) arguments as a
    :class:`~repro_torch.topology.GraphSchedule`, or None for the master
    path: exactly a static schedule whose one graph is the star (in either
    gossip mode).  An explicit ``GraphSchedule`` wins; else
    ``cfg.schedule`` is built by name around the resolved topology."""
    from repro_torch import topology as topo_lib  # topology imports core
    if isinstance(topology, topo_lib.GraphSchedule) and schedule is None:
        schedule, topology = topology, None
    if schedule is None:
        schedule = cfg.schedule
    if isinstance(schedule, topo_lib.GraphSchedule):
        sched = schedule
    elif schedule == "static":
        topo = resolve_topology(cfg, num_nodes, topology)
        if topo is None:
            return None
        sched = topo_lib.static_schedule(topo)
    else:
        if topology is None:
            topology = cfg.topology
        sched = topo_lib.get_schedule(
            schedule, num_nodes, topology=topology,
            period=cfg.schedule_period, seed=cfg.topology_seed,
            p=cfg.topology_p)
    if sched.is_static and sched.topologies[0].name == "star":
        return None
    return sched


def make_federated_step(
    loss_fn: Callable[[Params, dict], torch.Tensor],
    worker_data: dict[str, Any],
    cfg: RobustConfig,
    optimizer: optim_lib.Optimizer,
    *,
    topology=None,
    schedule=None,
    device: str | torch.device = DEFAULT_DEVICE,
):
    """Build ``(init_fn, step_fn)`` for the simulated federation.

    ``topology``: a name of ``repro_torch.topology.TOPOLOGY_NAMES`` or a
    built ``Topology`` (default ``cfg.topology``); ``schedule``: a name of
    ``SCHEDULE_NAMES`` or a built ``GraphSchedule`` (default
    ``cfg.schedule``).  The default star + static is this function's master
    path; anything else is :func:`repro_torch.topology.make_decentralized_step`
    (gossip mode ``cfg.gossip``), whose state has a leading node axis.

    ``loss_fn(params, batch)``: mean loss over a batch whose values have a
    leading sample axis, written with ``torch`` ops (``torch.func`` takes
    its gradient).  ``worker_data``: values shaped (W_h, J, ...), moved to
    ``device``.

    With ``cfg.num_clients > 0`` (partial participation) ``worker_data``
    holds one shard per client, (num_clients, J, ...), and each round's
    cohort of ``cfg.cohort_size`` clients fills the honest slots.

    ``init_fn(params, seed)`` -> :class:`FederatedState`; for ``saga`` it
    fills the packed (W_h, J, D) table of Alg. 1 one worker (client) at a
    time, for ``lsvrg`` the snapshots and their full local gradients.
    ``step_fn(state, *, sample_idx=None, attack_noise=None, coin=None)`` ->
    ``(new_state, metrics)``.  ``sample_idx`` ((W_h,) rows, or (W_h, B)
    for ``minibatch``), ``attack_noise`` ((B, D) standard-normal draws for
    ``gaussian``) and ``coin`` ((W_h,) bool snapshot refreshes for
    ``lsvrg``) replace the step's own draws, so a test can hand in the
    reference's.
    """
    dev = resolve_device(device)
    cfg.check_wire()
    plan = resolve_plan(cfg, worker_data)
    wh = (plan.cohort_size if plan is not None
          else next(iter(worker_data.values())).shape[0])
    b = cfg.num_byzantine if cfg.attack != "none" else 0
    sched = resolve_schedule(cfg, wh + b, topology, schedule)
    if sched is not None:
        from repro_torch.topology.decentralized_step import (
            make_decentralized_step)
        return make_decentralized_step(loss_fn, worker_data, cfg, optimizer,
                                       sched, device=dev)
    data = {k: torch.as_tensor(v, device=dev) for k, v in worker_data.items()}
    num_clients, j = next(iter(data.values())).shape[:2]
    weighted = participation_lib.uses_staleness(cfg, plan)
    attack_cfg = cfg.attack_config()
    reducer = cfg.reducer()
    # The rule is built from the messages' PackSpec, which the first step
    # reads from its gradients (a state may come from elsewhere than init_fn).
    flat_fns: dict[packing.PackSpec, agg_lib.FlatAggregator] = {}
    # The per-leaf baseline's rule (each kernel once per leaf).
    perleaf_fn = None if cfg.packed else cfg.aggregator_fn(perleaf=True)
    grad_fn = torch.func.grad(loss_fn)
    # One gradient per worker batch: a sample is a batch of one, as in the
    # reference's per-worker grad of sample_batch(data_w, idx[None]); a
    # minibatch is the worker's (B, ...) rows; a client's whole shard gives
    # its full local gradient.
    per_sample_grads = torch.func.vmap(grad_fn, in_dims=(None, 0))
    # Each slot's gradient at its own params (lsvrg's snapshots).
    per_worker_grads = torch.func.vmap(grad_fn, in_dims=(0, 0))
    w_ids = torch.arange(wh, device=dev)

    def init_fn(params: Params, seed: int | torch.Generator = 0
                ) -> FederatedState:
        params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
        spec = cfg.message_spec(params, batch_ndim=0)
        with torch.no_grad():
            vr_state = init_vr(cfg, reducer, per_sample_grads, params, data,
                               spec, num_clients)
        staleness = (participation_lib.init_staleness(num_clients, dev)
                     if plan is not None else None)
        health = guards_lib.init_health(dev) if cfg.guards else None
        return FederatedState(params, optimizer.init(params), vr_state, 0,
                              generator_for(seed, dev), staleness,
                              init_ef(spec, num_clients, dev), health)

    def oracles(params, lay, slots, batches) -> dict:
        """lsvrg's oracles in the messages' layout ``lay``: the slots'
        params, their gradients at those params on this step's batches, and
        the full local gradients of the slots ``sel`` (packed: at the packed
        params, on the bf16 wire rounded to bf16, as the reference unpacks
        them)."""
        if not reducer.uses_oracles:
            return {}
        flat = lay.pack(params, batch_ndim=0)
        at = lay.unpack(flat, batch_ndim=0)
        return dict(
            params=expand_rows(flat, wh),
            grads_at=lambda p: lay.pack(per_worker_grads(
                lay.unpack(p), batches)),
            full_grads_at=lambda sel: lay.pack(per_sample_grads(
                at, {k: v[slots[sel]] for k, v in data.items()})))

    def aggregate(lay, msgs, rw, metrics):
        """The rule on the round's messages -> (aggregate leaves, what the
        guards' verdict reads: the packed vector, or the per-leaf
        aggregate).  Guards build their mask on the packed view.  The
        per-leaf baseline runs its rule leaf by leaf on a clean round
        without staleness weights or diagnostics; those are flat-engine
        features, so otherwise its messages detour through pack -> flat
        rule -> unpack, as in the reference."""
        spec = lay.spec
        buf = msgs if cfg.packed else None
        gmask = None
        if cfg.guards:
            buf = lay.flat(msgs)
            gmask = guards_lib.guard_mask(
                buf, multiplier=cfg.guard_multiplier, base_weights=rw)
            metrics["quarantined_rows"] = torch.sum(1.0 - gmask)
        if (not cfg.packed and rw is None and not cfg.diagnostics
                and (gmask is None or bool(guards_lib.all_valid(gmask)))):
            agg = perleaf_fn(msgs)
            return agg, agg
        if buf is None:
            buf = lay.flat(msgs)
        if spec not in flat_fns:
            flat_fns[spec] = cfg.flat_aggregator_fn(spec)
        flat_fn = flat_fns[spec]
        if gmask is not None:
            out = guards_lib.guarded_flat_call(flat_fn, buf, gmask,
                                               row_weights=rw)
        else:
            out = flat_fn(buf) if rw is None else flat_fn(buf, row_weights=rw)
        if cfg.diagnostics:
            out, diag = out
            metrics.update(diag_lib.diagnostics_metrics(diag))
        agg = spec.unpack(out, batch_ndim=0)
        return agg, (out if cfg.packed else agg)

    @torch.no_grad()
    def step_fn(state: FederatedState, *, sample_idx=None,
                attack_noise: Optional[torch.Tensor] = None, coin=None):
        params = state.params
        slots, rows, honest_stal = round_slots(plan, weighted, state, w_ids)
        idx = sample_rows(reducer, state.generator, sample_idx, wh, j, dev)
        batches = worker_batches(data, slots, idx)
        honest_tree = per_sample_grads(params, batches)
        lay = message_layout(cfg, honest_tree)
        honest = lay.pack(honest_tree)             # (W_h, D), or leaves
        held = reducer.hold(state.vr, idx, rows) if cfg.guards else None
        honest, vr_state, vr_metrics = reducer.correct(
            state.vr, honest, idx, rows=rows, generator=state.generator,
            coin=coin, **oracles(params, lay, slots, batches))
        staleness = (state.staleness if plan is None else
                     participation_lib.tick_staleness(state.staleness, rows))
        # The honest senders transmit the corrected messages: what the
        # master, the variance metric and the attackers see is the
        # dequantized wire.
        honest, ef, ef_held = lay.transmit(honest, state.ef, rows)
        var = telemetry.honest_variance(lay.flat(honest), wh)
        # (W, D), or (W, ...) leaves; ``attack_noise`` is packed (B, D).
        msgs = attack_lib.apply_attack(attack_cfg, honest, state.generator,
                                       noise=attack_noise, spec=lay.spec)
        if cfg.packed:
            # The Byzantine rows cross the wire too (the honest rows are a
            # fixed point of the roundtrip).
            msgs = lay.spec.wire_roundtrip(msgs)
        rw, slot_stal = slot_weights(cfg, honest_stal, b)
        metrics = {"honest_variance": var, **vr_metrics,
                   **telemetry.staleness_metrics(slot_stal)}
        agg, watch = aggregate(lay, msgs, rw, metrics)
        updates, opt_state = optimizer.update(agg, state.opt_state, params,
                                              state.step)
        new_params = optim_lib.apply_updates(params, updates)
        health = state.health
        if cfg.guards:
            # A rejected round keeps params, optimizer, VR state and the
            # residuals (the drawn rows copied before the correction are
            # written back); step, generator, staleness and health move on.
            accept, health = guards_lib.round_verdict(
                guards_lib.tree_norm(watch), state.health,
                decay=cfg.reject_ema, zmax=cfg.reject_zmax,
                warmup=cfg.reject_warmup)
            if not bool(accept):
                new_params, opt_state = params, state.opt_state
                reducer.restore(vr_state, held, idx, rows)
                ef = restore_ef(ef, ef_held, rows)
            metrics.update(telemetry.health_metrics(health, accept))
        new_state = FederatedState(new_params, opt_state, vr_state,
                                   state.step + 1, state.generator, staleness,
                                   ef, health)
        return new_state, metrics
    return init_fn, step_fn


# ---------------------------------------------------------------------------
# The master's aggregation across ranks (torch.distributed).  One worker per
# index of the mesh's worker axes; each worker's message leaves are its local
# shards over the model axes.  ``mesh`` is a repro_torch.launch.mesh.Mesh.
# ---------------------------------------------------------------------------

# Both comm paths cover the whole registry, as in the reference.
GATHER_AGGREGATORS = agg_lib.AGGREGATOR_NAMES
SHARDED_AGGREGATORS = agg_lib.AGGREGATOR_NAMES


def _flatten_concat(tree: Params):
    """``tree`` as one float32 vector, its inverse (leaf dtypes restored)
    and the leaves' flat sizes (the blocks of sharded geomed_blockwise)."""
    spec = packing.pack_spec(tree, batch_ndim=0)
    return (spec.pack(tree, batch_ndim=0),
            lambda vec: spec.unpack(vec, batch_ndim=0), list(spec.sizes))


def _local_leaf_ids(leaf_sizes, pad: int, num_workers: int, worker: int,
                    device) -> torch.Tensor:
    """(chunk,) int32 leaf of each coordinate of worker ``worker``'s slice
    of the padded vector: the first leaf whose cumulative bound exceeds the
    coordinate; padding lies past every bound, in the dummy leaf
    ``len(leaf_sizes)``."""
    chunk = (sum(leaf_sizes) + pad) // num_workers
    coords = worker * chunk + torch.arange(chunk, dtype=torch.int64,
                                           device=device)
    bounds = torch.tensor(leaf_sizes, dtype=torch.int64,
                          device=device).cumsum(0)
    return torch.searchsorted(bounds, coords, right=True).to(torch.int32)


def distributed_aggregate(grads: Params, cfg: RobustConfig, *, mesh,
                          worker_axes=("data",), model_axes=("model",),
                          row_weights: Optional[torch.Tensor] = None,
                          diagnostics: Optional[bool] = None):
    """The paper's ``gather`` master across ranks: every worker's message
    (its model shard) is all-gathered over the worker axes and every rank
    runs the rule on the (W, D_shard) stack, the rows' distance partials
    summed over the model axes.

    ``cfg.packed`` (default): the shard is packed into one buffer, so the
    gather is one collective; an int8 or sign1 wire gathers the codes and
    the scales (whole-leaf scales: the block statistics are reduced over
    the model axes) and decodes them on the receiver; the bf16 wire's
    buffer is bf16 and the kernels read it as it is.  ``row_weights``: (W,)
    staleness weights, the same on every rank.  ``cfg.guards`` masks rows
    (the mask is the same on every rank) and ``diagnostics`` (default
    ``cfg.diagnostics``) returns ``(tree, AggDiagnostics)``.  The per-leaf
    baseline (``packed=False``) gathers each leaf and runs the per-leaf
    rule; it refuses the options above, as the reference does."""
    wa, ma = mesh.axes(*worker_axes), mesh.axes(*model_axes)
    diag_on = cfg.diagnostics if diagnostics is None else diagnostics
    if cfg.packed:
        spec = cfg.message_spec(grads, batch_ndim=0)
        buf = spec.pack(grads, batch_ndim=0)                  # (D_shard,)
        if spec.quantized:
            codes, scales = spec.encode(buf, axis_names=ma)
            stacked = spec.decode(coll.all_gather(codes, wa),
                                  coll.all_gather(scales, wa))
        else:
            stacked = coll.all_gather(buf, wa)
        flat_fn = cfg.flat_aggregator_fn(spec, axis_names=ma, sync_axes=wa,
                                         diagnostics=diag_on)
        if cfg.guards:
            # After the gather the worker axes hold the same rows, so the
            # row statistics are summed over the model axes only.
            gmask = guards_lib.guard_mask(
                stacked, multiplier=cfg.guard_multiplier,
                base_weights=row_weights, axis_names=ma)
            out = guards_lib.guarded_flat_call(flat_fn, stacked, gmask,
                                               row_weights=row_weights)
        elif row_weights is None:
            out = flat_fn(stacked)
        else:
            out = flat_fn(stacked, row_weights=row_weights)
        if diag_on:
            vec, diag = out
            return spec.unpack(vec, batch_ndim=0), diag
        return spec.unpack(out, batch_ndim=0)
    for what, on in (("staleness row_weights", row_weights is not None),
                     ("fault-containment guards", cfg.guards),
                     ("aggregation diagnostics", diag_on)):
        if on:
            raise ValueError(f"{what} need the packed gather path "
                             "(cfg.packed=True); the per-leaf baseline has "
                             "no flat buffer")
    cfg.check_wire()
    stacked = {k: coll.all_gather(g, wa) for k, g in grads.items()}
    return cfg.aggregator_fn(perleaf=True, axis_names=ma,
                             sync_axes=wa)(stacked)


def sharded_aggregate(grads: Params, cfg: RobustConfig, *, mesh,
                      worker_axes=("data",), model_axes=("model",),
                      num_workers: int,
                      row_weights: Optional[torch.Tensor] = None,
                      diagnostics: Optional[bool] = None):
    """The ``sharded`` master: the flat message is re-sharded by coordinate
    with an all_to_all over the worker axes, so each rank holds a distinct
    ceil(D / W) slice of all W messages; the rule runs on the slices with
    the rows' partials summed over the worker and model axes (Weiszfeld's
    and the clip's distances, Krum's (W, W) Gram product, geomed_blockwise's
    (W, L) block distances, the guards' and the diagnostics' row
    statistics); the slices of the aggregate are all-gathered back.

    An int8 or sign1 wire sends the codes through the all_to_all, gathers
    the (W, L) scales and decodes the slice per coordinate
    (:func:`~repro_torch.core.packing.dequantize_slice`); the flat vector
    is float32 on every other wire, the bf16 one included, as in the
    reference.  ``row_weights``, guards (through
    :func:`~repro_torch.core.guards.guarded_flat_call`) and ``diagnostics``
    as in :func:`distributed_aggregate`."""
    if cfg.aggregator not in SHARDED_AGGREGATORS:
        raise ValueError(f"unknown aggregator {cfg.aggregator!r} for "
                         f"comm='sharded'; supported: {SHARDED_AGGREGATORS}")
    wa = mesh.axes(*worker_axes)
    comm = mesh.axes(*worker_axes, *model_axes)
    diag_on = cfg.diagnostics if diagnostics is None else diagnostics
    w = num_workers
    flat, unflatten, leaf_sizes = _flatten_concat(grads)
    p = flat.shape[0]
    pad = (-p) % w
    wid = coll.axis_index(wa)

    def leaf_ids():
        return _local_leaf_ids(leaf_sizes, pad, w, wid, flat.device)

    wire_fmt = packing.resolve_wire_format(cfg.message_dtype)
    if wire_fmt.quantized:
        wspec = packing.pack_spec(grads, batch_ndim=0, wire=wire_fmt)
        codes, scales = wspec.encode(flat, axis_names=mesh.axes(*model_axes))
        codes = torch.nn.functional.pad(codes, (0, pad)).reshape(w, -1)
        z_local = packing.dequantize_slice(
            coll.all_to_all(codes, wa), coll.all_gather(scales, wa),
            leaf_ids())
    else:
        # Row r of ``chunks``: this worker's slice for worker r; after the
        # all_to_all, row r is worker r's slice of this rank's coordinates.
        chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(w, -1)
        z_local = coll.all_to_all(chunks, wa)
    rw = row_weights
    gmask = None
    if cfg.guards:
        gmask = guards_lib.guard_mask(
            z_local, multiplier=cfg.guard_multiplier, base_weights=rw,
            axis_names=comm)
    name = cfg.aggregator

    def blockwise(z, row_weights=None, info=False):
        # Every coordinate knows its leaf, so per-leaf norms survive the
        # re-sharding: one (W, L + 1) sum over the axes an iteration (the
        # extra block holds the padding).
        return geomed_lib.weiszfeld_blockwise_sharded(
            z, leaf_ids(), len(leaf_sizes) + 1, axis_names=comm,
            row_weights=row_weights, return_info=info,
            max_iters=cfg.weiszfeld_iters, tol=cfg.weiszfeld_tol)

    if diag_on:
        # Every rule through its flat engine with the struct; with guards
        # the mask folds into the weights.
        if gmask is not None:
            z_local = guards_lib.sanitize_rows(z_local, gmask)
            rw = gmask if rw is None else rw * gmask
        if name == "geomed_blockwise":
            slice_agg, info = blockwise(z_local, rw, info=True)
            diag = diag_lib.flat_diagnostics(
                z_local, slice_agg, row_weights=rw, axis_names=comm,
                residual=info.residual, iters=info.iters,
                converged=info.converged)
        else:
            fn = cfg.flat_aggregator_fn(None, axis_names=comm,
                                        diagnostics=True)
            slice_agg, diag = fn(z_local, row_weights=rw)
        full = coll.all_gather(slice_agg, wa).reshape(-1)
        return unflatten(full[:p]), diag

    fn = (blockwise if name == "geomed_blockwise" else
          cfg.flat_aggregator_fn(None, axis_names=comm, diagnostics=False))
    if gmask is not None:
        # The mask is the same on every rank, so all take the same branch.
        slice_agg = guards_lib.guarded_flat_call(fn, z_local, gmask,
                                                 row_weights=rw)
    elif rw is None:
        slice_agg = fn(z_local)
    else:
        slice_agg = fn(z_local, row_weights=rw)
    full = coll.all_gather(slice_agg, wa).reshape(-1)
    return unflatten(full[:p])


def distributed_attack(msg: Params, cfg: RobustConfig, *, mesh,
                       worker_axes=("data",),
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[Params] = None) -> Params:
    """Byzantine behaviour across ranks: the workers of index <
    ``num_byzantine`` over the worker axes replace their message (their
    model shards) by the attack's.  The honest statistics come from masked
    sums over the worker axes (the attackers are omniscient and collude,
    as in the paper).  ``gaussian`` draws its noise from ``generator`` (one
    per rank), or takes standard-normal draws ``noise`` shaped like
    ``msg``; ``bitflip`` hashes the rank's relative Byzantine index and the
    coordinates of its local shard of each leaf."""
    if cfg.attack == "none" or cfg.num_byzantine == 0:
        return msg
    attack_lib.check_attack_name(cfg.attack)
    wa = mesh.axes(*worker_axes)
    wid, w = coll.axis_index(wa), coll.axis_size(wa)
    b = cfg.num_byzantine
    wh = w - b
    honest_w = 0.0 if wid < b else 1.0

    def honest_mean_of(x):
        return coll.psum(honest_w * x.float(), wa) / wh

    # Every rank takes part in the sums; the honest ranks then keep their
    # messages.
    mean = {k: honest_mean_of(v) for k, v in msg.items()}
    name = cfg.attack
    if name == "alie":
        sq_mean = {k: honest_mean_of(v * v) for k, v in msg.items()}
    if wid >= b:
        return msg
    if name == "sign_flip":
        byz = {k: cfg.sign_flip_magnitude * m for k, m in mean.items()}
    elif name == "zero_gradient":
        byz = {k: -(wh / b) * m for k, m in mean.items()}
    elif name == "ipm":
        byz = {k: -cfg.ipm_eps * m for k, m in mean.items()}
    elif name == "straggler":
        byz = {k: (1.0 + 0.25 * cfg.straggler_k) * m for k, m in mean.items()}
    elif name == "dropout":
        byz = {k: torch.zeros_like(m) for k, m in mean.items()}
    elif name == "gaussian":
        std = math.sqrt(cfg.gaussian_variance)
        if noise is None:
            if generator is None:
                raise ValueError("gaussian attack needs a per-rank generator "
                                 "or the noise")
            noise = {k: torch.randn(m.shape, generator=generator,
                                    device=m.device)
                     for k, m in sorted(mean.items())}
        byz = {k: m + std * noise[k].to(m.device) for k, m in mean.items()}
    elif name == "alie":
        byz = {k: m + cfg.alie_z * torch.sqrt(torch.clamp(
            sq_mean[k] - m * m, min=0.0)) for k, m in mean.items()}
    elif name == "nan":
        byz = {k: torch.full_like(m, torch.nan) for k, m in mean.items()}
    elif name == "inf_overflow":
        byz = {k: torch.where(m < 0, -attack_lib.OVERFLOW_MAGNITUDE,
                              attack_lib.OVERFLOW_MAGNITUDE).to(m.dtype)
               for k, m in mean.items()}
    else:   # bitflip: the hash per leaf, over the leaf's local coordinates
        spec = packing.pack_spec(mean, batch_ndim=0)
        flipped = attack_lib.bitflip_rows(
            spec.pack(mean, batch_ndim=0),
            torch.tensor([wid], device=next(iter(mean.values())).device),
            prob=cfg.bitflip_prob, seed=cfg.bitflip_seed, spec=spec)
        byz = spec.unpack(flipped[0], batch_ndim=0)
    return {k: byz[k].to(v.dtype) for k, v in msg.items()}
