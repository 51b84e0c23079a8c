"""Decentralized Byzantine-robust training over a graph, simulated on one
device (port of the simulation side of
``repro/topology/decentralized_step.py``).

There is no master: every node keeps its own parameters, computes its own
(variance-reduced) stochastic gradient at them, exchanges messages only with
its graph neighbours, and robustly aggregates its masked neighbourhood
with any rule of :mod:`repro_torch.topology.masked`.  ``cfg.gossip``
chooses the channel:

* ``"gradient"`` -- nodes exchange gradient messages, aggregate, then
  apply the optimizer to the aggregate;
* ``"params"``   -- each node first takes a local optimizer step with its
  own gradient, then the half-stepped parameters are exchanged and each
  node's new iterate is the robust aggregate of its neighbourhood's.

The graph may vary with the round (a :class:`GraphSchedule`): round ``t``
uses the schedule's ``t % period`` mask and mixing matrix, indexed from
stacks moved to the device once.  Nodes are ``N = W_h + B``: the first
W_h are the honest workers (rows of ``worker_data``), the last B are
Byzantine.  Byzantine nodes attack per edge (:func:`build_exchange`): the
message a Byzantine sender sends receiver r is built from r's own honest
neighbourhood, so two receivers see different poison.

The master step's options carry over: under partial participation
(``num_clients``) a seeded cohort of clients mans the W_h honest node slots
each round (their data and variance-reduction rows; node parameters stay
per slot), K1 updating the cohort's rows of the resident SAGA table in
place; staleness weights scale the sender columns of the mask; guards
quarantine edges per receiver (:func:`repro_torch.core.guards.pairwise_guard_mask`)
and a rejected round keeps every node's state; diagnostics report the
masked rules' per-sender summary.  On a quantized wire (``message_dtype``
``int8`` or ``sign1``) the honest senders transmit through
:func:`repro_torch.core.robust_step.wire_transmit`: the corrected gradients
in gradient gossip, the half-stepped models in params gossip (sign1's
residuals then track the param channel).  The per-edge Byzantine payloads
are not re-quantized, as in the reference: they replace the senders'
entries wholesale.  On the bf16 wire the exchange is bf16.  With
``packed=False`` the step is the per-leaf baseline: messages, VR state,
the per-edge exchange and the masked rule on dicts of per-leaf tensors
(:func:`build_exchange` on a dict,
:func:`repro_torch.topology.masked.masked_aggregate` with ``perleaf=True``),
each kernel once per leaf; one step body serves both layouts
(:func:`repro_torch.core.robust_step.message_layout`).

The ``torch.distributed`` form of the reference's
``decentralized_aggregate`` (each rank one node, K7 on the sharded path) is
ROADMAP.md Queue A item 10b; the master's is
:func:`repro_torch.core.robust_step.distributed_aggregate`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core import attacks as attack_lib
from repro_torch.core import guards as guards_lib
from repro_torch.core import participation as participation_lib
from repro_torch.core.robust_step import (FederatedState, init_ef,
                                          init_vr, message_layout,
                                          resolve_plan, restore_ef,
                                          round_slots, sample_rows,
                                          slot_weights, worker_batches)
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch.optim import optimizers as optim_lib
from repro_torch.telemetry import diagnostics as diag_lib
from repro_torch.telemetry import metrics as telemetry
from repro_torch.topology.masked import masked_aggregate
from repro_torch.topology.schedule import as_schedule, validate_schedule

Params = dict[str, torch.Tensor]

GOSSIP_MODES = ("gradient", "params")


def _check_gossip(cfg) -> str:
    gossip = getattr(cfg, "gossip", "gradient")
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"RobustConfig.gossip must be one of {GOSSIP_MODES}, "
                         f"got {gossip!r}")
    return gossip


def build_exchange(msgs, cfg: attack_lib.AttackConfig,
                   mask: torch.Tensor, is_byz: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   spec=None):
    """The per-edge message exchange (R, S, D), in ``msgs``' dtype (bf16 on
    the bf16 wire, float32 otherwise).

    ``msgs``: (S, D) honestly computed messages (Byzantine rows are
    ignored); ``mask``: (R, S) neighbour-mask rows of the receivers;
    ``is_byz``: (S,) bool marks Byzantine senders.  Row r is receiver r's
    view: every Byzantine sender's entry is an attack vector built from
    receiver r's masked honest statistics (mean, and for ``alie`` the
    second moment).  Without an attack the (S, D) rows are broadcast to
    every receiver (a view, no copy).  ``gaussian`` draws per-edge noise
    from ``generator``, or takes the standard-normal draws ready-made as
    ``noise`` (R, S, D) (only the Byzantine senders' entries are read).
    ``straggler`` scales r's mean by ``1 + 0.25 * straggler_k``,
    ``dropout`` sends zeros, ``nan`` and ``inf_overflow`` fill r's mean
    (padding of ``spec`` kept at 0), and ``bitflip`` corrupts it at
    coordinates hashed per sender id (:func:`attacks.bitflip_edges`).

    ``msgs`` may also be a dict of per-leaf (S, *shape) messages (the
    per-leaf baseline), whose float32 packing is ``spec``: each leaf's
    exchange (R, S, *shape) is a tensor of its own, its Byzantine entries
    cut at the leaf's boundaries from the payloads computed once on the
    packed rows (every per-edge attack is coordinate-separable), so
    ``gaussian``'s draws and ``bitflip``'s hash are the packed exchange's.
    """
    attack_lib.check_attack_name(cfg.name)
    r = mask.shape[0]
    attacked = cfg.name != "none" and cfg.num_byzantine > 0
    if isinstance(msgs, dict):
        byz = (_edge_payloads(spec.pack(msgs), cfg, mask, is_byz, generator,
                              noise, spec) if attacked else None)
        out = {}
        for k, (a, b), shape in zip(spec.names, spec.boundaries, spec.shapes):
            rows = msgs[k].reshape(msgs[k].shape[0], -1)
            ex = (_broadcast(rows, r) if byz is None
                  else _with_payloads(rows, byz[..., a:b], is_byz))
            out[k] = ex.reshape(tuple(ex.shape[:2]) + shape)
        return out
    if not attacked:
        return _broadcast(msgs, r)
    return _with_payloads(msgs, _edge_payloads(msgs, cfg, mask, is_byz,
                                               generator, noise, spec), is_byz)


def _broadcast(msgs: torch.Tensor, r: int) -> torch.Tensor:
    """The (S, d) rows as every one of ``r`` receivers' view, (R, S, d)."""
    return msgs[None].expand((r,) + tuple(msgs.shape))


def _with_payloads(msgs: torch.Tensor, byz: torch.Tensor,
                   is_byz: torch.Tensor) -> torch.Tensor:
    """The (R, S, d) exchange of the (S, d) rows with the Byzantine
    senders' entries replaced by ``byz`` ((R, d) per receiver, or (R, B, d)
    per edge), cast on store."""
    exchange = _broadcast(msgs, byz.shape[0]).clone()
    exchange[:, is_byz] = (byz[:, None] if byz.dim() == 2 else byz
                           ).to(msgs.dtype)
    return exchange


def _edge_payloads(msgs: torch.Tensor, cfg: attack_lib.AttackConfig,
                   mask: torch.Tensor, is_byz: torch.Tensor,
                   generator: Optional[torch.Generator],
                   noise: Optional[torch.Tensor], spec) -> torch.Tensor:
    """The Byzantine payloads of :func:`build_exchange` for the (S, D)
    rows: (R, D) float32 per receiver, or (R, B, D) per edge
    (``gaussian``).  The payloads are computed in float32."""
    r = mask.shape[0]
    s, d = msgs.shape
    m32 = msgs.float()
    byz_f = is_byz.float()
    hon_w = mask * (1.0 - byz_f)[None, :]                       # (R, S)
    h_cnt = torch.clamp(torch.sum(hon_w, dim=1), min=1.0)       # (R,)
    b_cnt = torch.clamp(torch.sum(mask * byz_f[None, :], dim=1), min=1.0)
    mean = (hon_w @ m32) / h_cnt[:, None]                       # (R, D)
    nb = int(is_byz.sum())
    if cfg.name == "sign_flip":
        return cfg.sign_flip_magnitude * mean
    if cfg.name == "zero_gradient":
        # Each receiver's masked neighbourhood mean becomes exactly zero.
        return -(h_cnt / b_cnt)[:, None] * mean
    if cfg.name == "ipm":
        return -cfg.ipm_eps * mean
    if cfg.name == "alie":
        sq = (hon_w @ (m32 * m32)) / h_cnt[:, None]
        return mean + cfg.alie_z * torch.sqrt(torch.clamp(sq - mean * mean,
                                                          min=0.0))
    if cfg.name == "straggler":
        return (1.0 + 0.25 * cfg.straggler_k) * mean
    if cfg.name == "dropout":
        return torch.zeros_like(mean)
    if cfg.name == "nan":
        return attack_lib._fault_fill(attack_lib._nan_fill, mean, spec)
    if cfg.name == "inf_overflow":
        return attack_lib._fault_fill(attack_lib._overflow_fill, mean, spec)
    if cfg.name == "bitflip":
        # Only the Byzantine senders' payloads: the hash is per sender id.
        return attack_lib.bitflip_edges(
            mean, torch.arange(s, device=msgs.device)[is_byz],
            prob=cfg.bitflip_prob, seed=cfg.bitflip_seed, spec=spec)
    # gaussian: per-edge draws around each receiver's mean
    if noise is None:
        draws = torch.randn((r, nb, d), generator=generator,
                            device=msgs.device)
    else:
        if tuple(noise.shape) != (r, s, d):
            raise ValueError(f"gaussian: noise must be {(r, s, d)}, got "
                             f"{tuple(noise.shape)}")
        draws = noise.to(msgs.device, torch.float32)[:, is_byz]
    return mean[:, None] + math.sqrt(cfg.gaussian_variance) * draws


def make_decentralized_step(
    loss_fn: Callable[[Params, dict], torch.Tensor],
    worker_data: dict[str, Any],
    cfg,
    optimizer: optim_lib.Optimizer,
    topology,
    *,
    device: str | torch.device = DEFAULT_DEVICE,
):
    """Build ``(init_fn, step_fn)`` for the simulated decentralized
    federation, shaped like :func:`repro_torch.core.make_federated_step`
    but with per-node parameters.

    ``topology``: a fixed :class:`Topology` or a :class:`GraphSchedule`.
    ``init_fn(params, seed)`` copies ``params`` to every node and builds the
    honest workers' (clients', under partial participation) variance-
    reduction state at those shared initial params.
    ``step_fn(state, *, sample_idx=None, attack_noise=None, coin=None)`` ->
    ``(new_state, metrics)`` with ``honest_variance`` and
    ``consensus_dist`` (the honest-variance formula on the honest nodes'
    parameter copies).  ``sample_idx`` ((W_h,) rows, (W_h, B) for
    ``minibatch``), ``attack_noise`` ((N, N, D) standard-normal per-edge
    draws for ``gaussian``) and ``coin`` ((W_h,) bool refreshes for
    ``lsvrg``) replace the step's own draws, so a test can hand in the
    reference's.
    """
    sched = as_schedule(topology)
    dev = resolve_device(device)
    cfg.check_wire()
    plan = resolve_plan(cfg, worker_data)
    data = {k: torch.as_tensor(v, device=dev) for k, v in worker_data.items()}
    num_clients, j = next(iter(data.values())).shape[:2]
    wh = plan.cohort_size if plan is not None else num_clients
    weighted = participation_lib.uses_staleness(cfg, plan)
    b = cfg.num_byzantine if cfg.attack != "none" else 0
    n = wh + b
    validate_schedule(cfg, sched, n)
    gossip = _check_gossip(cfg)
    stacks = sched.on(dev)
    attack_cfg = cfg.attack_config()
    reducer = cfg.reducer()
    grad_fn = torch.func.grad(loss_fn)
    # Alg. 1 init: every sample's gradient at the shared initial params (a
    # client's whole shard: its full local gradient).
    per_sample_grads = torch.func.vmap(grad_fn, in_dims=(None, 0))
    # Each honest node's gradient at its own params, on its drawn sample
    # (or minibatch, or whole shard).
    per_node_grads = torch.func.vmap(grad_fn, in_dims=(0, 0))
    is_byz = torch.arange(n, device=dev) >= wh
    w_ids = torch.arange(wh, device=dev)
    opts = dict(max_iters=cfg.weiszfeld_iters, tol=cfg.weiszfeld_tol,
                num_groups=cfg.num_groups, trim=cfg.trim,
                num_byzantine=cfg.num_byzantine, clip_radius=cfg.clip_radius)

    def init_fn(params: Params, seed: int | torch.Generator = 0
                ) -> FederatedState:
        params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
        nodes = {k: p[None].expand((n,) + tuple(p.shape)).clone()
                 for k, p in params.items()}
        spec = cfg.message_spec(params, batch_ndim=0)
        with torch.no_grad():
            vr_state = init_vr(cfg, reducer, per_sample_grads, params, data,
                               spec, num_clients)
        staleness = (participation_lib.init_staleness(num_clients, dev)
                     if plan is not None else None)
        health = guards_lib.init_health(dev) if cfg.guards else None
        return FederatedState(nodes, optimizer.init(nodes), vr_state, 0,
                              generator_for(seed, dev), staleness,
                              init_ef(spec, num_clients, dev), health)

    def oracles(honest_params, lay, slots, batches) -> dict:
        """lsvrg's oracles against each honest node's own params, in the
        messages' layout ``lay`` (packed: rounded to bf16 on the bf16 wire,
        as the reference unpacks them)."""
        if not reducer.uses_oracles:
            return {}
        flat = lay.pack(honest_params)
        at = lay.unpack(flat)
        return dict(
            params=flat,
            grads_at=lambda p: lay.pack(per_node_grads(lay.unpack(p),
                                                       batches)),
            full_grads_at=lambda sel: lay.pack(per_node_grads(
                {k: v[sel] for k, v in at.items()},
                {k: v[slots[sel]] for k, v in data.items()})))

    @torch.no_grad()
    def step_fn(state: FederatedState, *, sample_idx=None,
                attack_noise: Optional[torch.Tensor] = None, coin=None):
        mask = stacks.mask_at(state.step)
        mixing = stacks.mixing_at(state.step)
        slots, rows, honest_stal = round_slots(plan, weighted, state, w_ids)
        idx = sample_rows(reducer, state.generator, sample_idx, wh, j, dev)
        honest_params = {k: v[:wh] for k, v in state.params.items()}
        batches = worker_batches(data, slots, idx)
        honest_tree = per_node_grads(honest_params, batches)
        lay = message_layout(cfg, honest_tree)
        spec = lay.spec
        honest = lay.pack(honest_tree)               # (W_h, D), or leaves
        held = reducer.hold(state.vr, idx, rows) if cfg.guards else None
        honest, vr_state, vr_metrics = reducer.correct(
            state.vr, honest, idx, rows=rows, generator=state.generator,
            coin=coin, **oracles(honest_params, lay, slots, batches))
        staleness = (state.staleness if plan is None else
                     participation_lib.tick_staleness(state.staleness, rows))
        # Staleness weights scale the mask's sender columns.
        sw, slot_stal = slot_weights(cfg, honest_stal, b)
        wmask = mask if sw is None else mask * sw[None, :]
        # Gradient gossip sends the corrected gradients over the wire;
        # params gossip sends the half-stepped models instead (below), so
        # only one channel pays the wire.
        ef, ef_held = state.ef, None
        if gossip == "gradient":
            honest, ef, ef_held = lay.transmit(honest, state.ef, rows)
        var = telemetry.honest_variance(lay.flat(honest), wh)
        # Byzantine node rows carry zeros until the attack replaces them.
        msgs = _zero_rows_to(honest, n)
        guard_info = {}

        def gossip_agg(wire):
            # (R, S, D), or (R, S, *shape) leaves.
            exchange = build_exchange(wire, attack_cfg, wmask, is_byz,
                                      state.generator, noise=attack_noise,
                                      spec=spec)
            gm = mask
            if cfg.guards:
                # Each receiver quarantines its non-finite or oversized
                # in-edges (weight 0, payload zeroed); a clean round keeps
                # the exchange and the mask as they are.
                emask = guards_lib.pairwise_guard_mask(
                    exchange, wmask, multiplier=cfg.guard_multiplier)
                if not bool(guards_lib.all_valid(emask)):
                    exchange = guards_lib.sanitize_rows(exchange, emask)
                    gm = mask * emask
                guard_info["quarantined_edges"] = torch.sum(
                    (wmask > 0) * (1.0 - emask))
            # The rule scales gm's sender columns by the staleness weights;
            # the per-leaf baseline runs it leaf by leaf (diagnostics
            # through the flat engine).
            out = masked_aggregate(cfg.aggregator, exchange, gm,
                                   perleaf=not cfg.packed, spec=spec,
                                   mixing=mixing * gm, row_weights=sw,
                                   diagnostics=cfg.diagnostics, **opts)
            out, diag = out if cfg.diagnostics else (out, None)
            return lay.unpack(out), diag

        if gossip == "params":
            updates, opt_state = optimizer.update(
                lay.unpack(msgs), state.opt_state, state.params, state.step)
            half = optim_lib.apply_updates(state.params, updates)
            wire = lay.pack(half)                               # (N, D)
            if spec.quantized:
                sent, ef, ef_held = lay.transmit(wire[:wh], state.ef, rows)
                wire = torch.cat([sent, wire[wh:]])
            params, diag = gossip_agg(wire)
            watch = params
        else:
            agg, diag = gossip_agg(msgs)
            updates, opt_state = optimizer.update(agg, state.opt_state,
                                                  state.params, state.step)
            params = optim_lib.apply_updates(state.params, updates)
            watch = agg
        health = state.health
        if cfg.guards:
            # The verdict on the gossip output's norm; a rejected round
            # keeps every node's params, optimizer and VR state.
            accept, health = guards_lib.round_verdict(
                guards_lib.tree_norm(watch), state.health,
                decay=cfg.reject_ema, zmax=cfg.reject_zmax,
                warmup=cfg.reject_warmup)
            if not bool(accept):
                params, opt_state = state.params, state.opt_state
                reducer.restore(vr_state, held, idx, rows)
                ef = restore_ef(ef, ef_held, rows)
            guard_info.update(telemetry.health_metrics(health, accept))
        consensus = telemetry.honest_variance(
            spec.pack({k: v[:wh] for k, v in params.items()},
                      dtype=torch.float32), wh)
        new_state = FederatedState(params, opt_state, vr_state,
                                   state.step + 1, state.generator, staleness,
                                   ef, health)
        metrics = {"honest_variance": var, "consensus_dist": consensus,
                   **vr_metrics, **telemetry.staleness_metrics(slot_stal),
                   **guard_info}
        if diag is not None:
            metrics.update(diag_lib.diagnostics_metrics(
                diag_lib.reduce_masked_diagnostics(diag, wmask)))
        return new_state, metrics

    return init_fn, step_fn


def _zero_rows_to(x, n: int):
    """``x`` (W_h, ...) (a tensor, or a dict of them) with zero rows
    appended up to ``n``."""
    if isinstance(x, dict):
        return {k: _zero_rows_to(v, n) for k, v in x.items()}
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out
