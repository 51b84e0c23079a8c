"""Step builders of the distributed training runtime on ``torch.distributed``
(port of ``repro/launch/steps.py``).

:func:`make_train_step` composes the Byzantine-robust data-parallel step
of DESIGN.md Sec. 2 across the ranks of a
:class:`repro_torch.launch.mesh.Mesh`.  Each index of the worker axes
(``"data"``, or ``("pod", "data")``) is one worker, and the ``"model"``
ranks of a worker hold the same batch:

  1. the worker's gradient of ``Model.loss`` by ``torch.func.grad_and_value``
     (on the card K8 runs every attention forward, through
     :class:`repro_torch.kernels.flash_attention.FlashAttention`);
  2. the variance reduction of :mod:`repro_torch.core.variance` on the
     rank's state (SAGA's table through K1);
  3. the sender's wire step (int8 / sign1 with its error-feedback row);
  4. the attack: the first B workers replace their messages
     (:func:`~repro_torch.core.robust_step.distributed_attack`);
  5. the robust rule across ranks: ``comm="gather"``, the paper's master,
     :func:`~repro_torch.core.robust_step.distributed_aggregate`;
     ``comm="sharded"``, the coordinate re-sharding,
     :func:`~repro_torch.core.robust_step.sharded_aggregate`;
  6. the optimizer.

Layout.  Every rank holds the whole parameters and computes its worker's
whole gradient, then cuts its model shard of it
(:func:`repro_torch.launch.sharding.model_shard` by ``Model.param_specs``).
Steps 2-5 run on the shard, and the aggregate is all-gathered over the
model axis before the optimizer, whose state is whole on every rank.  The
reference instead shards the forward and the parameters over ``"model"``
(XLA inserting the collectives), which divides the model's memory; that
is not reproduced here: the model axis splits the robust aggregation and
the variance-reduction state, not the model.

The state is the reference's dict -- ``params`` (a flat dict of tensors by
``named_parameters`` name), ``opt``, ``step`` (an int) and, when on,
``vr``, ``ef``, ``health`` and ``staleness`` -- with ``vr`` and ``ef``
holding the rank's own rows over its model shard's packed coordinates:
its worker's row, or under partial participation (``num_clients``) every
client's row, kept equal on the worker ranks by an all-gather of the
cohort's rows each step.  SAGA's table is updated in place.  The metrics
carry the reference's names and are the same on every rank.

Draws.  The reference folds its key into 1 (the sample indices), 2 (the
attack) and 3 (lsvrg's coins).  Here ``key`` is an int folded the same
way (:func:`fold_in`; JAX's draws are not reproduced), and
``sample_idx``, ``attack_noise`` and ``coin`` take the draws from the
caller instead, as ``make_federated_step`` does, so a test can hand in
the reference's.

:func:`make_decentralized_train_step` is the server-free variant: every
worker index is a graph node with its own parameters and optimizer state,
and the aggregation is
:func:`repro_torch.topology.decentralized_aggregate` of its neighbourhood.

The reference's ``compile_train_step`` jits the step with the train state
donated to XLA; torch runs the step eagerly and updates the state's
largest buffer (SAGA's table) in place, so it has no counterpart.
``make_prefill_step`` and ``make_serve_step``, the sequence-sharded
decode, raise ``NotImplementedError`` (ROADMAP.md Queue A 11.7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import collectives as coll
from repro_torch.configs.base import TrainConfig
from repro_torch.core import guards as guards_lib
from repro_torch.core import packing
from repro_torch.core import participation as participation_lib
from repro_torch.core.robust_step import (RobustConfig, distributed_aggregate,
                                          distributed_attack,
                                          resolve_schedule, sharded_aggregate)
from repro_torch.core.saga import SagaState
from repro_torch.core.variance import LsvrgState
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.models.api import Model
from repro_torch.optim import optimizers as optim_lib
from repro_torch.telemetry import diagnostics as diag_lib
from repro_torch.telemetry import metrics as telemetry

Params = dict[str, torch.Tensor]

_SEED_MOD = 2 ** 63


def fold_in(key: int, data: int) -> int:
    """A new seed from ``key`` and ``data`` (numpy's ``SeedSequence``): the
    port's counterpart of ``jax.random.fold_in``."""
    seq = np.random.SeedSequence([int(key) % _SEED_MOD, int(data) % _SEED_MOD])
    return int(seq.generate_state(1, np.uint64)[0]) % _SEED_MOD


def _generator(seed: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def stack_layers(tree: Params, cfg, dim: int = 0) -> Params:
    """Per-layer leaves (the port's ``named_parameters`` names) -> the
    reference's leaves: the layers of pattern position ``i`` stacked over
    the periods on a new axis ``dim``, as ``blocks.pos{i}.<rest>``; the
    other leaves as they are.  The messages keep the reference's leaves,
    so a rule or a wire that works leaf by leaf (the per-leaf baseline,
    geomed_blockwise, the int8 and sign1 scales) sees the reference's."""
    pat, periods = cfg.resolve_pattern()
    out, layers = {}, {}
    for name, v in tree.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = v
            continue
        period, i = divmod(int(parts[1]), len(pat))
        key = ".".join(["blocks", f"pos{i}", *parts[2:]])
        layers.setdefault(key, [None] * periods)[period] = v
    out.update({k: torch.stack(v, dim=dim) for k, v in layers.items()})
    return out


def unstack_layers(tree: Params, cfg, dim: int = 0) -> Params:
    """The inverse of :func:`stack_layers`."""
    pat, _ = cfg.resolve_pattern()
    out = {}
    for name, v in tree.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = v
            continue
        i = int(parts[1].removeprefix("pos"))
        for period, layer in enumerate(torch.unbind(v, dim=dim)):
            out[".".join(["blocks", str(period * len(pat) + i),
                          *parts[2:]])] = layer
    return out


class _RankLayout:
    """What a rank of ``mesh`` holds of the model's leaves: its worker and
    model indices, the model-axis specs, and the packing of its messages
    (its model shard of each leaf, the layers stacked as the reference's
    leaves)."""

    def __init__(self, model: Model, robust: RobustConfig, mesh):
        self.cfg = model.cfg
        self.worker_names = mesh_lib.worker_axes(mesh)
        self.wa = mesh.axes(*self.worker_names)
        self.ma = mesh.axes("model")
        self.all = mesh.axes(*self.worker_names, "model")
        self.w = mesh_lib.num_workers(mesh)
        self.wid = coll.axis_index(self.wa)
        self.rank = coll.axis_index(mesh.axes(*mesh.axis_names))
        self.specs = model.param_specs(mesh_lib.axis_sizes(mesh))
        structs = model.param_structs()
        self.shapes = {k: tuple(t.shape) for k, t in structs.items()}
        self.spec = packing.pack_spec(self.messages(structs), batch_ndim=0,
                                      wire=robust.message_dtype)

    def messages(self, tree: Params) -> Params:
        """Whole per-layer leaves -> the rank's message leaves: each leaf's
        model shard, the layers stacked."""
        return stack_layers({k: shard_lib.model_shard(v, self.specs[k],
                                                      self.ma)
                             for k, v in tree.items()}, self.cfg)

    def whole(self, tree: Params) -> Params:
        """The inverse of :meth:`messages`: an all-gather over the model
        axis."""
        return {k: shard_lib.gather_model_shard(v, self.specs[k], self.ma,
                                                self.shapes[k])
                for k, v in unstack_layers(tree, self.cfg).items()}

    def pack(self, tree: Params) -> torch.Tensor:
        """Message leaves -> the rank's (1, D) float32 buffer."""
        return self.spec.pack(tree, batch_ndim=0, dtype=torch.float32)[None]

    def unpack(self, buf: torch.Tensor) -> Params:
        return self.spec.unpack(buf[0], batch_ndim=0)


def _draws(reducer, key: int, w: int, j: int, sample_idx, coin, p: float):
    """The round's (W,) sample indices (SAGA's table rows; zeros for the
    other reducers, which read none) and (W,) refresh coins (lsvrg, else
    None), on the CPU: the caller's, else drawn from ``key`` folded with 1
    and 3."""
    idx, coins = torch.zeros((w,), dtype=torch.int64), None
    if reducer.name == "saga":
        idx = (torch.as_tensor(sample_idx, dtype=torch.int64)
               if sample_idx is not None else
               torch.randint(0, j, (w,), generator=_generator(fold_in(key, 1))))
        if tuple(idx.shape) != (w,):
            raise ValueError(f"sample_idx must be ({w},), got {tuple(idx.shape)}")
    if reducer.name == "lsvrg":
        coins = (torch.as_tensor(coin, dtype=torch.bool) if coin is not None
                 else torch.rand((w,), generator=_generator(fold_in(key, 3)))
                 < p)
        if tuple(coins.shape) != (w,):
            raise ValueError(f"coin must be ({w},), got {tuple(coins.shape)}")
    return idx, coins


def _transmit(lay: _RankLayout, buf: torch.Tensor, residual):
    """The sender's wire step on the rank's packed (1, D_shard) message:
    a quantized format encodes it with whole-leaf scales (the block
    statistics reduced over the model axis) and returns what the receiver
    decodes, sign1 first adding its error-feedback residual and keeping
    the new one; every other format passes the message through."""
    if not lay.spec.quantized:
        return buf, residual
    t = buf.float() if residual is None else buf.float() + residual
    wire = lay.spec.decode(*lay.spec.encode(t, axis_names=lay.ma))
    if lay.spec.wire_format.error_feedback:
        return wire, t - wire
    return wire, residual


def _tree_sq(tree: Params) -> torch.Tensor:
    return sum(torch.sum(v.float() ** 2) for v in tree.values())


class _Round:
    """What one round of either driver does on a rank before and after its
    aggregation: the draws, the staleness weights, the worker's gradient,
    the variance reduction (K1 on the rank's rows), the wire with its
    error-feedback row, and at the end the guards' verdict (a rejected
    round holds params, optimizer, VR and EF state) and the participation
    bookkeeping.  It also builds the cold-start state."""

    def __init__(self, model: Model, robust: RobustConfig, train: TrainConfig,
                 mesh, saga_num_samples: int):
        if robust.comm not in ("gather", "sharded"):
            raise ValueError(f"RobustConfig.comm must be 'gather' or "
                             f"'sharded', got {robust.comm!r}")
        robust.check_wire()
        self.robust, self.model = robust, model
        self.lay = lay = _RankLayout(model, robust, mesh)
        self.w, self.wid = lay.w, lay.wid
        self.plan = participation_lib.resolve_participation(robust, lay.w)
        self.weighted = participation_lib.uses_staleness(robust, self.plan)
        self.optimizer = optim_lib.get_optimizer(train.optimizer, train.lr)
        self.reducer = robust.reducer()
        self.j = saga_num_samples
        self.use_vr = ((self.reducer.name == "saga" and self.j > 0)
                       or self.reducer.name == "lsvrg")
        self.use_ef = lay.spec.wire_format.error_feedback
        self.b = robust.num_byzantine if robust.attack != "none" else 0
        self.honest = self.wid >= self.b
        self.num_honest = max(self.w - self.b, 1)
        self.grad_fn = torch.func.grad_and_value(model.loss)

    # -- the state ------------------------------------------------------

    def init_state(self, params: Params) -> dict:
        """The cold-start state at the rank's whole ``params``: the
        optimizer's initial state, step 0, a zero SAGA table (it warms up
        over the first steps, as the reference's does) or lsvrg's snapshot
        at ``params`` with a zero anchor, zero residual rows, health and
        staleness; the VR and EF rows the worker's, or every client's
        under partial participation, over the rank's packed message."""
        lay, robust = self.lay, self.robust
        dev = next(iter(params.values())).device
        rows = self.plan.num_clients if self.plan is not None else 1
        state = {"params": params, "opt": self.optimizer.init(params),
                 "step": 0}

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def vr(d, snap):
            if self.reducer.name == "saga":
                return SagaState(zeros(rows, self.j, d), zeros(rows, d))
            return LsvrgState(snap.reshape(1, -1).float().repeat(rows, 1),
                              zeros(rows, d))

        if self.use_vr:
            local = lay.messages(params)
            state["vr"] = (vr(lay.spec.padded_dim, lay.pack(local))
                           if robust.packed else
                           {k: vr(v.numel(), v) for k, v in local.items()})
        if self.use_ef:
            state["ef"] = zeros(rows, lay.spec.padded_dim)
        if robust.guards:
            state["health"] = guards_lib.init_health(dev)
        if self.plan is not None:
            state["staleness"] = participation_lib.init_staleness(
                self.plan.num_clients, dev)
        return state

    # -- before the aggregation -------------------------------------------

    def begin(self, state: dict, batch: dict, key: int, sample_idx, coin):
        """The worker's side of the round -> its messages (the corrected
        gradient's message leaves), with the round's facts kept on
        ``self`` for :meth:`finish`: its loss, weights, cohort, draws and
        held rows.  ``batch`` leaves are (W, ...); the rank reads row
        ``wid``."""
        robust, lay, w = self.robust, self.lay, self.w
        params = state["params"]
        dev = next(iter(params.values())).device
        wbatch = {k: v[self.wid] for k, v in batch.items()}
        self.cohort = (None if self.plan is None
                       else self.plan.cohort_at(state["step"], dev))
        self.rw = self.slot_stal = None
        if self.weighted:
            stal = (torch.zeros((w,), dtype=torch.int32, device=dev)
                    if self.plan is None else state["staleness"][self.cohort])
            if self.b:
                # The first B slots are the Byzantine ones (the reference's
                # byz_first convention).
                byz = {"straggler": robust.straggler_k,
                       "dropout": robust.max_staleness}.get(robust.attack, 0)
                stal = torch.where(torch.arange(w, device=dev) < self.b,
                                   torch.tensor(byz, dtype=torch.int32,
                                                device=dev), stal)
            self.slot_stal = stal
            self.rw = participation_lib.staleness_weights(
                stal, decay=robust.staleness_decay,
                max_staleness=robust.max_staleness)
        grads, self.loss = self.grad_fn(params, wbatch)
        self.idx, coins = _draws(self.reducer, key, w, self.j, sample_idx,
                                 coin, robust.lsvrg_p)
        msgs = self.correct(state, lay.messages(grads), coins,
                            lambda p: self.grad_fn(p, wbatch)[0])
        self.ef = state.get("ef")
        self.ef_row = 0 if self.cohort is None else int(self.cohort[self.wid])
        self.ef_held = self.ef[self.ef_row].clone() if self.use_ef else None
        return msgs

    def _rows(self, dev):
        """(the worker's (1,) sample row, its (1,) client row or None)."""
        wid = self.wid
        rows = None if self.cohort is None else self.cohort[wid:wid + 1].to(dev)
        return self.idx[wid:wid + 1].to(dev), rows

    def correct(self, state, msgs: Params, coin, grad_of) -> Params:
        """The variance reduction on the rank's message leaves ``msgs``
        (packed, or leaf by leaf with ``packed=False``); ``grad_of(p)``:
        the worker's gradient at whole parameters ``p``, lsvrg's oracle."""
        lay, params = self.lay, state["params"]
        self.held, self.vr_metrics = None, {}
        if not self.use_vr:
            return msgs
        packed = self.robust.packed

        def whole(tree):
            return {k: v.to(params[k].dtype)
                    for k, v in lay.whole(tree).items()}

        def grads_at(snap):
            if packed:
                return lay.pack(lay.messages(grad_of(whole(lay.unpack(snap)))))
            g = lay.messages(grad_of(whole({k: v[0] for k, v in snap.items()})))
            return {k: v[None] for k, v in g.items()}

        local = lay.messages(params)
        buf = lay.pack(msgs) if packed else {k: v[None] for k, v in msgs.items()}
        p_local = lay.pack(local) if packed else {k: v[None]
                                                   for k, v in local.items()}
        my_idx, rows = self._rows(next(iter(params.values())).device)
        if self.robust.guards:
            self.held = self.reducer.hold(state["vr"], my_idx, rows)
        kw = {}
        if self.reducer.name == "lsvrg":
            kw = dict(params=p_local, grads_at=grads_at,
                      coin=coin[self.wid:self.wid + 1])
            self.vr_metrics = {"vr_snapshot_rate": torch.mean(coin.float())}
        out, _, _ = self.reducer.correct(state["vr"], buf, my_idx, rows=rows,
                                         **kw)
        return lay.unpack(out) if packed else {k: v[0] for k, v in out.items()}

    def wire(self, tree: Params) -> Params:
        """The sender's wire step on whichever message leaves go on the
        wire, the error-feedback row updated in place."""
        lay = self.lay
        if not lay.spec.quantized:
            return tree
        row = slice(self.ef_row, self.ef_row + 1)
        buf, res = _transmit(lay, lay.pack(tree),
                             self.ef[row] if self.use_ef else None)
        if self.use_ef:
            self.ef[row] = res
        return lay.unpack(buf)

    def consensus(self, tree: Params) -> torch.Tensor:
        """The reference's ``consensus_dist`` of the honest workers' trees
        across ranks, each rank holding its worker's message leaves."""
        x = self.lay.pack(tree)[0]
        h = 1.0 if self.honest else 0.0
        mean = coll.psum(h * x, self.lay.wa) / self.num_honest
        return coll.psum(h * torch.sum((x - mean) ** 2),
                         self.lay.all) / self.num_honest

    # -- after the aggregation -------------------------------------------

    def finish(self, state: dict, new_state: dict, agg_norm) -> dict:
        """The guards' verdict on ``agg_norm`` (a rejected round keeps the
        old params, optimizer, VR rows and EF row) and the participation
        bookkeeping (the cohort's rows sent to every worker rank, the
        staleness counters ticked) -> the round's health, staleness and
        VR metrics."""
        robust = self.robust
        metrics = dict(self.vr_metrics)
        metrics.update(telemetry.staleness_metrics(self.slot_stal))
        if robust.guards:
            accept, health = guards_lib.round_verdict(
                agg_norm, state["health"], decay=robust.reject_ema,
                zmax=robust.reject_zmax, warmup=robust.reject_warmup)
            if not bool(accept):
                new_state.update(params=state["params"], opt=state["opt"])
                if self.held is not None:
                    self.reducer.restore(state["vr"], self.held,
                                         *self._rows(agg_norm.device))
                if self.ef_held is not None:
                    self.ef[self.ef_row] = self.ef_held
            new_state["health"] = health
            metrics.update(telemetry.health_metrics(health, accept))
        if self.plan is not None:
            if self.use_vr or self.use_ef:
                self._sync_cohort_rows(state.get("vr") if self.use_vr else {})
            new_state["staleness"] = participation_lib.tick_staleness(
                state["staleness"], self.cohort)
        return metrics

    def _sync_cohort_rows(self, vr) -> None:
        """Under partial participation every worker rank keeps every
        client's rows: each rank sends the rows its slot's client wrote
        (SAGA's drawn table row and mean, lsvrg's snapshot and anchor, the
        error-feedback row) to the others, in place."""
        cohort, lay = self.cohort, self.lay
        me = cohort[lay.wid]

        def rows(t, sample=None):
            if sample is None:
                t[cohort] = coll.all_gather(t[me], lay.wa)
            else:
                t[cohort, sample] = coll.all_gather(t[me, sample[lay.wid]],
                                                    lay.wa)

        for s in (vr.values() if isinstance(vr, dict) else (vr,)):
            if isinstance(s, SagaState):
                rows(s.table, self.idx.to(s.table.device))
                rows(s.avg)
            elif isinstance(s, LsvrgState):
                rows(s.snapshot)
                rows(s.anchor)
        if self.ef is not None:
            rows(self.ef)


def make_train_step(model: Model, robust: RobustConfig, train: TrainConfig,
                    mesh, *, saga_num_samples: int = 0):
    """The master's distributed step on ``mesh``.

    ``train_step(state, batch, key, *, sample_idx=None, attack_noise=None,
    coin=None) -> (state, metrics)``, called on every rank of ``mesh``
    with the same arguments: ``batch`` leaves (W, per-worker batch, ...),
    of which the rank reads its worker's row; ``key`` an int (the step's
    seed).  Overrides: ``sample_idx`` (W,) SAGA rows, ``coin`` (W,) lsvrg
    refreshes, ``attack_noise`` gaussian's standard-normal draws, a dict
    of whole leaves (B, *shape).  Metrics: ``loss`` (the mean over all W
    workers), ``honest_variance``, ``agg_norm``, the reducer's, staleness
    and health metrics, ``quarantined_rows`` (guards on the gather path)
    and ``diag_*`` (diagnostics), 0-dim tensors, the same on every rank.
    ``train_step.init_state(params)`` builds the cold-start state at the
    rank's whole ``params``.

    With ``robust.num_clients`` > W (partial participation) each round's
    seeded cohort of W clients mans the worker slots: their rows of the
    per-client state are corrected (K1's client-row route) and their
    staleness counters give the per-slot weights.  The reference also
    returns the state's sharding specs and shapes, which place and lower
    its XLA program; torch places nothing, so they have no counterpart.
    """
    rnd = _Round(model, robust, train, mesh, saga_num_samples)
    lay, w, wid = rnd.lay, rnd.w, rnd.wid

    def train_step(state: dict, batch: dict, key: int, *, sample_idx=None,
                   attack_noise: Optional[Params] = None, coin=None):
        params = state["params"]
        dev = next(iter(params.values())).device
        message = rnd.wire(rnd.begin(state, batch, key, sample_idx, coin))
        var = rnd.consensus(message)
        noise = None
        if attack_noise is not None and wid < rnd.b:
            noise = lay.messages({k: torch.as_tensor(v)[wid].to(dev)
                                  for k, v in attack_noise.items()})
        message = distributed_attack(
            message, robust, mesh=mesh, worker_axes=lay.worker_names,
            generator=_generator(fold_in(fold_in(key, 2), lay.rank), dev),
            noise=noise)
        metrics: dict = {}
        if robust.comm == "gather":
            out, quarantined = _gather_agg(message, robust, mesh, rnd.rw)
            if quarantined is not None:
                metrics["quarantined_rows"] = quarantined
        else:
            out = _sharded_agg(message, robust, mesh, rnd.rw)
        if robust.diagnostics:
            out, diag = out
            metrics.update(diag_lib.diagnostics_metrics(diag))
        agg = lay.whole(out)
        updates, opt_state = rnd.optimizer.update(agg, state["opt"], params,
                                                  state["step"])
        agg_norm = torch.sqrt(_tree_sq(agg))
        new_state = dict(state, params=optim_lib.apply_updates(params, updates),
                         opt=opt_state, step=state["step"] + 1)
        return new_state, {
            "loss": coll.psum(rnd.loss.detach().float(), lay.wa) / w,
            "honest_variance": var,
            "agg_norm": agg_norm,
            **rnd.finish(state, new_state, agg_norm),
            **metrics,
        }

    train_step.init_state = rnd.init_state
    return train_step


def make_decentralized_train_step(model: Model, robust: RobustConfig,
                                  train: TrainConfig, mesh, topology=None, *,
                                  saga_num_samples: int = 0):
    """Server-free variant of :func:`make_train_step` (DESIGN.md Secs.
    6-7): every worker index is a graph node whose ranks hold its own
    parameters and optimizer state (the state's ``params`` are the node's),
    gradients are taken at each node's own parameters, and the aggregation
    is the node's masked neighbourhood rule through
    :func:`repro_torch.topology.decentralized_aggregate` (per-edge
    attacks by the first B nodes included; ``comm`` "gather" or
    "sharded").  ``topology``: a graph name, a ``Topology`` or a
    ``GraphSchedule`` (default ``robust.topology`` with ``robust.schedule``);
    round ``state["step"]`` picks a time-varying schedule's graph.
    ``robust.gossip``: ``"gradient"`` aggregates the neighbours' corrected
    gradients, then steps; ``"params"`` takes the local optimizer step
    first and aggregates the half-stepped models, the aggregate being the
    new iterate.

    ``train_step`` as :func:`make_train_step`'s, but ``attack_noise`` is
    gaussian's per-edge draws on the rank's packed local coordinates, as
    ``decentralized_aggregate`` takes them.  Metrics add
    ``consensus_dist``; ``loss`` is the honest nodes' mean and
    ``agg_norm`` the root mean square over the nodes of the per-step
    movement (the aggregate, or in params gossip the aggregate minus the
    previous iterate)."""
    from repro_torch.topology import GOSSIP_MODES, decentralized_aggregate
    if robust.gossip not in GOSSIP_MODES:
        raise ValueError(f"RobustConfig.gossip must be one of {GOSSIP_MODES}, "
                         f"got {robust.gossip!r}")
    rnd = _Round(model, robust, train, mesh, saga_num_samples)
    lay, w = rnd.lay, rnd.w
    sched = resolve_schedule(robust, w, topology)
    if sched is None:
        raise ValueError(
            "topology 'star' with a static schedule is the master "
            "federation -- use launch/steps.make_train_step")

    def train_step(state: dict, batch: dict, key: int, *, sample_idx=None,
                   attack_noise: Optional[torch.Tensor] = None, coin=None):
        params = state["params"]
        dev = next(iter(params.values())).device
        msgs = rnd.begin(state, batch, key, sample_idx, coin)
        if robust.gossip != "params":
            msgs = rnd.wire(msgs)
        var = rnd.consensus(msgs)

        def gossip(tree: Params) -> Params:
            out = decentralized_aggregate(
                tree, robust, sched, mesh=mesh, comm=robust.comm,
                worker_axes=lay.worker_names, num_workers=w,
                generator=_generator(fold_in(fold_in(key, 2), lay.rank), dev),
                noise=attack_noise, round_index=state["step"],
                row_weights=rnd.rw)
            if robust.diagnostics:
                out, diag = out
                metrics.update(diag_lib.diagnostics_metrics(diag))
            return lay.whole(out)

        metrics: dict = {}
        if robust.gossip == "params":
            updates, opt_state = rnd.optimizer.update(
                lay.whole(msgs), state["opt"], params, state["step"])
            half = optim_lib.apply_updates(params, updates)
            new_params = {k: v.to(params[k].dtype) for k, v in
                          gossip(rnd.wire(lay.messages(half))).items()}
            move = {k: v.float() - params[k].float()
                    for k, v in new_params.items()}
        else:
            move = gossip(msgs)
            updates, opt_state = rnd.optimizer.update(move, state["opt"],
                                                      params, state["step"])
            new_params = optim_lib.apply_updates(params, updates)
        # Every node's movement: the worker axes sum one rank a node.
        agg_norm = torch.sqrt(coll.psum(_tree_sq(move), lay.wa) / w)
        new_state = dict(state, params=new_params, opt=opt_state,
                         step=state["step"] + 1)
        health = rnd.finish(state, new_state, agg_norm)
        honest = 1.0 if rnd.honest else 0.0
        return new_state, {
            "loss": coll.psum(honest * rnd.loss.detach().float(), lay.wa)
            / rnd.num_honest,
            "honest_variance": var,
            "consensus_dist": rnd.consensus(lay.messages(new_state["params"])),
            "agg_norm": agg_norm,
            **health,
            **metrics,
        }

    train_step.init_state = rnd.init_state
    return train_step


def _gather_agg(message: Params, robust: RobustConfig, mesh, row_weights):
    """The paper's master across ranks (the reference's ``_gather_agg`` and
    the packed gather branch of its step):
    :func:`~repro_torch.core.robust_step.distributed_aggregate` of the
    workers' model shards -> (this rank's aggregate shard, or with
    diagnostics ``(shard, AggDiagnostics)``; the quarantined-row count
    under guards, else None).  With ``robust.packed`` every rule runs on
    the packed buffer; the reference packs only the rules that need whole
    rows (geomed, geomed_groups, krum, centered_clip) and runs the
    coordinate-wise ones leaf by leaf, which gives the same values on
    every wire but bf16 (where its leaves stay float32)."""
    out, gmask = distributed_aggregate(
        message, robust, mesh=mesh, worker_axes=mesh_lib.worker_axes(mesh),
        row_weights=row_weights, return_guard_mask=True)
    return out, (None if gmask is None else torch.sum(1.0 - gmask))


def _sharded_agg(message: Params, robust: RobustConfig, mesh, row_weights):
    """The beyond-paper master (the reference's ``_sharded_agg``, a
    shard_map over the worker and model axes):
    :func:`~repro_torch.core.robust_step.sharded_aggregate`, the workers'
    model shards re-sharded by coordinate with an all_to_all over the
    worker axes, the rows' partials summed over the worker and model
    axes -> this rank's aggregate shard (with diagnostics, ``(shard,
    AggDiagnostics)``)."""
    return sharded_aggregate(
        message, robust, mesh=mesh, worker_axes=mesh_lib.worker_axes(mesh),
        num_workers=mesh_lib.num_workers(mesh), row_weights=row_weights)


def make_prefill_step(model: Model, mesh):
    """The sequence-sharded serving paths are not ported yet."""
    raise NotImplementedError("make_prefill_step: the sharded serving steps "
                              "come with the sequence-sharded decode "
                              "(ROADMAP.md Queue A 11.7)")


def make_serve_step(model: Model, shape, mesh, *, window=None):
    """The sequence-sharded decode is not ported yet."""
    raise NotImplementedError("make_serve_step: the sequence-sharded decode "
                              "is not ported yet (ROADMAP.md Queue A 11.7)")
