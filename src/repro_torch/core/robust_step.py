"""The Byzantine-robust federated training step, paper Alg. 1 (port of
``repro/core/robust_step.py``'s simulated federation).

:func:`make_federated_step` builds ``(init_fn, step_fn)`` for the packed,
full-participation, float32-wire simulation.  With the default star
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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as attack_lib
from repro_torch.core import packing
from repro_torch.core import variance as vr_lib
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch.optim import optimizers as optim_lib
from repro_torch.telemetry import metrics as telemetry

Params = dict[str, torch.Tensor]

# RobustConfig fields the ported slice reads; every other field must keep
# its default (the features behind them are still to port, ROADMAP.md
# Queue A items 7, 9 and 10).
_SLICE_FIELDS = ("aggregator", "vr", "attack", "num_byzantine",
                 "topology", "topology_seed", "topology_p", "gossip",
                 "schedule", "schedule_period", "minibatch_size",
                 "weiszfeld_iters", "weiszfeld_tol", "num_groups", "trim",
                 "clip_radius", "gaussian_variance", "sign_flip_magnitude",
                 "alie_z", "ipm_eps")


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

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name not in _SLICE_FIELDS and getattr(self, f.name) != f.default:
                raise ValueError(
                    f"RobustConfig.{f.name}={getattr(self, f.name)!r} is "
                    "outside the ported slice (packed simulated master and "
                    "decentralized steps, full participation, float32 wire); "
                    "see ROADMAP.md Queue A")

    def reducer(self) -> vr_lib.VarianceReducer:
        """The variance reducer named by ``self.vr``."""
        return vr_lib.get_reducer(self)

    def attack_config(self) -> attack_lib.AttackConfig:
        attack_lib.check_attack_name(self.attack)
        return attack_lib.AttackConfig(
            name=self.attack, num_byzantine=self.num_byzantine,
            gaussian_variance=self.gaussian_variance,
            sign_flip_magnitude=self.sign_flip_magnitude,
            alie_z=self.alie_z, ipm_eps=self.ipm_eps)

    def message_spec(self, tree: Params, *, batch_ndim: int = 1
                     ) -> packing.PackSpec:
        """PackSpec of this config's wire messages for ``tree``."""
        return packing.pack_spec(tree, batch_ndim=batch_ndim,
                                 wire=self.message_dtype)

    def flat_aggregator_fn(self, spec: packing.PackSpec
                           ) -> agg_lib.FlatAggregator:
        """Flat aggregator ``(W, D) -> (D,) f32`` for this config's messages
        laid out by ``spec``."""
        return agg_lib.get_flat_aggregator(
            self.aggregator, spec,
            max_iters=self.weiszfeld_iters, tol=self.weiszfeld_tol,
            num_groups=self.num_groups, trim=self.trim,
            num_byzantine=self.num_byzantine, clip_radius=self.clip_radius)


class FederatedState(NamedTuple):
    # The model's leaf shapes on the master path; with a leading node axis
    # (N, ...) on the decentralized path.
    params: Params
    opt_state: Any
    # Variance-reduction state (SagaState for "saga", None for "sgd" and
    # "minibatch").
    vr: Optional[Any]
    step: int
    # The run's random stream: sample draws, then attack noise, each step.
    generator: torch.Generator


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
    table = torch.empty((wh, j, spec.padded_dim), dtype=torch.float32,
                        device=dev)
    for w in range(wh):
        grads = per_sample_grads(params, as_batches(
            {k: v[w] for k, v in data.items()}))
        table[w] = spec.pack(grads, batch_ndim=1)
    return table


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

    ``init_fn(params, seed)`` -> :class:`FederatedState`; for ``saga`` it
    fills the packed (W_h, J, D) table of Alg. 1 one worker at a time.
    ``step_fn(state, *, sample_idx=None, attack_noise=None)`` ->
    ``(new_state, metrics)``.  ``sample_idx`` ((W_h,) rows, or (W_h, B)
    for ``minibatch``) and
    ``attack_noise`` ((B, D) standard-normal draws for ``gaussian``)
    replace the step's own draws, so a test can hand in the reference's.
    """
    dev = resolve_device(device)
    wh = next(iter(worker_data.values())).shape[0]
    b = cfg.num_byzantine if cfg.attack != "none" else 0
    sched = resolve_schedule(cfg, wh + b, topology, schedule)
    if sched is not None:
        from repro_torch.topology.decentralized_step import (
            make_decentralized_step)
        return make_decentralized_step(loss_fn, worker_data, cfg, optimizer,
                                       sched, device=dev)
    data = {k: torch.as_tensor(v, device=dev) for k, v in worker_data.items()}
    wh, j = next(iter(data.values())).shape[:2]
    attack_cfg = cfg.attack_config()
    reducer = cfg.reducer()
    # The rule is built from the messages' PackSpec, which the first step
    # reads from its gradients (a state may come from elsewhere than init_fn).
    flat_fns: dict[packing.PackSpec, agg_lib.FlatAggregator] = {}
    # One gradient per worker batch: a sample is a batch of one, as in the
    # reference's per-worker grad of sample_batch(data_w, idx[None]); a
    # minibatch is the worker's (B, ...) rows.
    per_sample_grads = torch.func.vmap(torch.func.grad(loss_fn),
                                       in_dims=(None, 0))
    w_ids = torch.arange(wh, device=dev)

    def init_fn(params: Params, seed: int | torch.Generator = 0
                ) -> FederatedState:
        params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
        spec = cfg.message_spec(params, batch_ndim=0)
        with torch.no_grad():
            vr_state = reducer.init_sim(
                params, per_sample_grads_fn=lambda: per_sample_table(
                    per_sample_grads, params, data, spec),
                num_workers=wh)
        return FederatedState(params, optimizer.init(params), vr_state, 0,
                              generator_for(seed, dev))

    @torch.no_grad()
    def step_fn(state: FederatedState, *, sample_idx=None,
                attack_noise: Optional[torch.Tensor] = None):
        params = state.params
        idx = sample_rows(reducer, state.generator, sample_idx, wh, j, dev)
        honest_tree = per_sample_grads(params, worker_batches(data, w_ids, idx))
        spec = cfg.message_spec(honest_tree, batch_ndim=1)
        honest = spec.pack(honest_tree)                       # (W_h, D)
        honest, vr_state, vr_metrics = reducer.correct(state.vr, honest, idx)
        var = telemetry.honest_variance(honest, wh)
        msgs = attack_lib.apply_attack(attack_cfg, honest, state.generator,
                                       noise=attack_noise)    # (W, D)
        if spec not in flat_fns:
            flat_fns[spec] = cfg.flat_aggregator_fn(spec)
        agg = spec.unpack(flat_fns[spec](msgs), batch_ndim=0)
        updates, opt_state = optimizer.update(agg, state.opt_state, params,
                                              state.step)
        new_params = optim_lib.apply_updates(params, updates)
        new_state = FederatedState(new_params, opt_state, vr_state,
                                   state.step + 1, state.generator)
        return new_state, {"honest_variance": var, **vr_metrics}

    return init_fn, step_fn
