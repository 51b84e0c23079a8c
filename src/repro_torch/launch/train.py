"""Runnable distributed training driver on ``torch.distributed`` (port of
``repro/launch/train.py``): random weights from the seed, Byzantine-robust
data-parallel training on synthetic LM data across the ranks of a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --reduced --device cpu --steps 20 --mesh 4x2 --aggregator geomed \\
        --attack sign_flip --byzantine 1

``--mesh AxB`` (data x model) or ``AxBxC`` (pod x data x model) starts one
``gloo`` process a rank (:func:`repro_torch.launch.mesh.spawn_mesh`); each
worker index is one worker (:mod:`repro_torch.launch.steps`).  On the card
(the default ``--device cuda``) every rank uses it, K8 runs the attention
of the loss and K1-K7 the variance reduction and the robust rule; gloo
stages each collective through the host.  Rank 0 prints, writes
``metrics.jsonl``/``meta.json`` (``--log-dir``) and the checkpoints
(``--checkpoint-dir``): the ranks' own state (the variance-reduction and
residual rows, and on a decentralized graph each node's parameters and
optimizer state) is gathered into it and each rank takes its part back on
a restore.  Every rank sees the same metrics, so the run-health verdicts,
the rollbacks (``--guards``, ``--rollback-patience``,
``--degradation-ladder``) and the step counter agree across ranks.

:func:`run` is one rank's whole loop, for callers that already hold a
world (``run(mesh, args)``); :func:`main` parses the flags and spawns it.
``meta.json`` leaves out the reference's XLA cost analysis and collective
bytes, which the HLO analysis gives (ROADMAP.md Queue A 11.8).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import collectives as coll
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import packing
from repro_torch.core import participation as participation_lib
from repro_torch.core.robust_step import RobustConfig, resolve_schedule
from repro_torch.core.variance import VR_NAMES
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import health as health_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.telemetry import PhaseTimer, RunLogger

KEY = 0   # the reference's jax.random.PRNGKey(0)


def make_batch(generator: torch.Generator, cfg: ModelConfig, num_workers: int,
               per_worker: int, seq: int,
               device: str | torch.device = "cpu") -> dict:
    """A batch of uniform random tokens, (W, per_worker, seq) ``tokens``
    and their next tokens as ``labels``, drawn on the CPU from
    ``generator`` and moved to ``device`` (plus the reference's random
    prefix or encoder embeddings for the vlm and audio families).  JAX's
    draws are not reproduced."""
    toks = torch.randint(0, cfg.vocab_size, (num_workers, per_worker, seq + 1),
                         generator=generator)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "vlm":
        batch["image_emb"] = 0.02 * torch.randn(
            (num_workers, per_worker, cfg.num_prefix_tokens, cfg.d_model),
            generator=generator)
    if cfg.family == "audio":
        batch["audio_emb"] = 0.02 * torch.randn(
            (num_workers, per_worker, cfg.encoder_seq, cfg.d_model),
            generator=generator)
    return {k: (v.to(device, cfg.dtype) if v.is_floating_point()
                else v.to(device)) for k, v in batch.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized variant (CPU friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--mesh", default="1x1",
                    help="e.g. 4x2 (data x model) or 2x2x2 (pod x data x "
                    "model, multi-pod worker axes); one gloo process a rank")
    ap.add_argument("--aggregator", default="geomed")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--byzantine", type=int, default=0)
    ap.add_argument("--comm", default="gather", choices=["gather", "sharded"])
    ap.add_argument("--topology", default="star",
                    help="communication graph: star keeps the master path; "
                    "ring/torus2d/complete/erdos_renyi train decentralized")
    ap.add_argument("--topology-seed", type=int, default=0)
    ap.add_argument("--topology-p", type=float, default=0.5)
    ap.add_argument("--gossip", default="gradient",
                    choices=["gradient", "params"])
    ap.add_argument("--schedule", default="static",
                    choices=["static", "cyclic", "erdos_renyi"])
    ap.add_argument("--schedule-period", type=int, default=4)
    ap.add_argument("--per-leaf", action="store_true",
                    help="the per-leaf baseline (RobustConfig(packed=False))")
    ap.add_argument("--message-dtype", default="float32",
                    choices=list(packing.WIRE_FORMAT_NAMES))
    ap.add_argument("--vr", default="sgd", choices=list(VR_NAMES))
    ap.add_argument("--saga-samples", type=int, default=4)
    ap.add_argument("--lsvrg-p", type=float, default=0.1)
    ap.add_argument("--num-clients", type=int, default=0)
    ap.add_argument("--participation-seed", type=int, default=0)
    ap.add_argument("--max-staleness", type=int, default=64)
    ap.add_argument("--staleness-decay", type=float, default=1.0)
    ap.add_argument("--straggler-k", type=int, default=4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--guards", action="store_true")
    ap.add_argument("--guard-multiplier", type=float, default=10.0)
    ap.add_argument("--reject-ema", type=float, default=0.9)
    ap.add_argument("--reject-zmax", type=float, default=6.0)
    ap.add_argument("--rollback-patience", type=int, default=5)
    ap.add_argument("--loss-blowup", type=float, default=1e3)
    ap.add_argument("--max-rollbacks", type=int, default=3)
    ap.add_argument("--degradation-ladder", default="")
    ap.add_argument("--diagnostics", action="store_true")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="torch.profiler trace of this many post-warmup "
                    "steps on rank 0 into <log-dir>/profile (needs --log-dir)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--world-timeout", type=float, default=3600.0,
                    help="seconds the whole world may take")
    return ap


def robust_config(args) -> RobustConfig:
    return RobustConfig(
        aggregator=args.aggregator, vr=args.vr, attack=args.attack,
        num_byzantine=args.byzantine, comm=args.comm, weiszfeld_iters=16,
        topology=args.topology, topology_seed=args.topology_seed,
        topology_p=args.topology_p, gossip=args.gossip,
        schedule=args.schedule, schedule_period=args.schedule_period,
        packed=not args.per_leaf, message_dtype=args.message_dtype,
        lsvrg_p=args.lsvrg_p, num_clients=args.num_clients,
        participation_seed=args.participation_seed,
        max_staleness=args.max_staleness,
        staleness_decay=args.staleness_decay, straggler_k=args.straggler_k,
        diagnostics=args.diagnostics, guards=args.guards,
        guard_multiplier=args.guard_multiplier, reject_ema=args.reject_ema,
        reject_zmax=args.reject_zmax)


def mesh_shape(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) not in (2, 3):
        raise SystemExit(f"--mesh must have 2 or 3 axes, got {spec!r}")
    return shape, (("pod", "data", "model") if len(shape) == 3
                   else ("data", "model"))


# -- the checkpoint of a world's state ----------------------------------------

# The state entries each rank holds for itself: its rows of the variance
# reduction and the residuals; on a decentralized graph also its node's
# parameters and optimizer state.
_OWN_KEYS = ("vr", "ef")
_OWN_KEYS_DECENTRALIZED = ("params", "opt", "vr", "ef")


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _checkpoint_tree(state: dict, own: tuple, world, stacked: bool) -> dict:
    """The state as one tree: the entries every rank holds alike as they
    are, each rank's own entries stacked over the world (an all-gather when
    ``stacked``; otherwise empty stacks of the shape, for a restore)."""
    tree = {k: v for k, v in state.items() if k not in own}
    fn = ((lambda t: coll.all_gather(t, world)) if stacked else
          (lambda t: torch.empty((world.size,) + tuple(t.shape),
                                 dtype=t.dtype, device=t.device)))
    tree["ranks"] = {k: _tree_map(fn, state[k]) for k in own if k in state}
    return tree


def _from_checkpoint(tree: dict, world) -> dict:
    state = {k: v for k, v in tree.items() if k != "ranks"}
    state.update({k: _tree_map(lambda t: t[world.index].clone(), v)
                  for k, v in tree["ranks"].items()})
    return state


def _device_for(args, mesh) -> torch.device:
    dev = resolve_device(args["device"])
    if dev.type == "cuda" and dev.index is None:
        rank = coll.axis_index(mesh.axes(*mesh.axis_names))
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def run(mesh, args: dict) -> dict:
    """One rank's training loop on ``mesh`` with the flags ``args`` (a dict
    of :func:`parser`'s destinations) -> ``{"row": the last metric row,
    "resilience": the guards' outcome or None, "start": the first step,
    "params": the final parameters as numpy arrays on rank 0, else None}``.
    """
    a = argparse.Namespace(**args)
    world = mesh.axes(*mesh.axis_names)
    rank0 = world.index == 0

    def say(msg: str) -> None:
        if rank0:
            print(msg, flush=True)

    if a.resume and not a.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    if a.profile_steps and not a.log_dir:
        raise SystemExit("--profile-steps needs --log-dir")
    cfg = get_config(a.arch)
    if a.reduced:
        cfg = cfg.reduced()
    dev = _device_for(args, mesh)
    w = mesh_lib.num_workers(mesh)
    model = build_model(cfg, device=dev, remat=False, loss_chunk=128)
    robust = robust_config(a)
    train = TrainConfig(optimizer=a.optimizer, lr=a.lr)
    sched = resolve_schedule(robust, w)
    decentralized = sched is not None
    plan = participation_lib.resolve_participation(robust, w)
    if plan is not None:
        say(f"participation: {plan.num_clients} clients, cohorts of "
            f"{plan.cohort_size}, {plan.num_rounds} rounds a period")
    saga_samples = a.saga_samples if robust.vr == "saga" else 0
    own = _OWN_KEYS_DECENTRALIZED if decentralized else _OWN_KEYS

    def build_step(rcfg):
        """The step for the (possibly escalated) config; the state's
        structure must not change across rebuilds (launch/health.py
        refuses the fields that would change it)."""
        if decentralized:
            return steps_lib.make_decentralized_train_step(
                model, rcfg, train, mesh, sched,
                saga_num_samples=saga_samples)
        return steps_lib.make_train_step(model, rcfg, train, mesh,
                                         saga_num_samples=saga_samples)

    if decentralized:
        say(f"schedule: {sched.describe()}")
    params0 = tfm.flat_params(model.init(KEY))
    step_fn = build_step(robust)
    state = step_fn.init_state(params0)
    ckpt = CheckpointManager(a.checkpoint_dir) if a.checkpoint_dir else None
    start = 0
    if a.resume:
        step0, tree = ckpt.restore_latest(_checkpoint_tree(state, own, world,
                                                           stacked=False))
        if step0 is not None:
            state, start = _from_checkpoint(tree, world), step0
            say(f"resumed full train state from step {step0}")
    t0 = time.time()

    def console(step_i, row):
        if not rank0:
            return
        extra = (f" consensus={row['consensus_dist']:.5f}"
                 if decentralized else "")
        wall = row.get("time_wall_s", time.time() - t0)
        print(f"step {step_i:4d} loss={row['loss']:.4f} "
              f"agg_norm={row['agg_norm']:.4f}{extra} "
              f"({wall / (step_i - start + 1):.2f}s/step)", flush=True)

    monitor = health_lib.RunHealth(
        patience=a.rollback_patience, blowup=a.loss_blowup,
        ladder=a.degradation_ladder) if a.guards else None
    last_row: dict = {}

    def on_row(row):
        last_row.update(row)
        if monitor is not None:
            monitor.observe(row)

    log_dir = a.log_dir or None
    logger = RunLogger(log_dir if rank0 else None, log_every=a.log_every,
                       flush_every=4 if a.guards else 32, on_row=on_row,
                       console=console, console_every=max(a.steps // 10, 1))
    wspec = robust.message_spec(params0, batch_ndim=0)
    logger.write_meta(
        config=args, torch_version=torch.__version__, device=str(dev),
        device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        mesh_shape=dict(zip(mesh.axis_names, mesh.shape)), num_workers=w,
        start_step=start,
        collective_bytes="not computed: the HLO analysis is ROADMAP.md "
                         "Queue A 11.8",
        wire={"message_dtype": a.message_dtype,
              "bits_per_coord": wspec.wire_format.bits_per_coord,
              "coords": wspec.padded_dim,
              "bytes_per_message": wspec.wire_bytes(),
              "bytes_per_round": wspec.wire_bytes() * w})
    timer = PhaseTimer(dev if dev.type == "cuda" else None)
    prof, profile_until = None, 0
    i = start
    while i < a.steps:
        if a.profile_steps and i == start + 1 and rank0:
            # Skip the first step, then trace N steady-state steps.
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            profile_until = i + a.profile_steps
        with timer.phase("data"):
            gen = torch.Generator().manual_seed(steps_lib.fold_in(KEY, 1000 + i))
            batch = make_batch(gen, cfg, w, a.per_worker_batch, a.seq, dev)
        with timer.phase("step"):
            state, metrics = step_fn(state, batch, steps_lib.fold_in(KEY, i))
        with timer.phase("host"):
            host = timer.snapshot()
            host["time_wall_s"] = round(time.time() - t0, 3)
            logger.log_step(i, metrics, host=host)
            if ckpt and a.checkpoint_every and (i + 1) % a.checkpoint_every == 0:
                tree = _checkpoint_tree(state, own, world, stacked=True)
                if rank0:
                    ckpt.save_train_state(i + 1, tree)
                    if monitor is None or monitor.healthy:
                        # Healthy as of the last flush: the rollback anchor.
                        ckpt.mark_good(i + 1)
                dist.barrier()
        if prof is not None and i + 1 >= profile_until:
            _close_profile(prof, log_dir, dev)
            prof = None
        i += 1
        if (monitor is not None and monitor.rollback_pending
                and ckpt is not None and monitor.rollbacks < a.max_rollbacks):
            # Drain the logger so the monitor has seen every verdict,
            # restore the last good checkpoint, climb one rung, and descend
            # again with the same seeded draws.
            logger.flush()
            gstep, tree = ckpt.restore_last_good(
                _checkpoint_tree(state, own, world, stacked=False))
            monitor.on_rollback()
            if gstep is None:
                say("run unhealthy but no restorable checkpoint; continuing "
                    "without rollback")
            else:
                state = _from_checkpoint(tree, world)
                escalated = monitor.escalate(robust)
                if escalated != robust:
                    robust = escalated
                    step_fn = build_step(robust)
                    say(f"rollback #{monitor.rollbacks}: restored step {gstep}, "
                        f"escalated to aggregator={robust.aggregator} "
                        f"trim={robust.trim} "
                        f"guard_multiplier={robust.guard_multiplier}")
                else:
                    say(f"rollback #{monitor.rollbacks}: restored step {gstep} "
                        "(ladder exhausted or empty)")
                i = gstep
        elif monitor is not None and monitor.rollback_pending:
            monitor.dismiss()
            say("run unhealthy; no rollback available "
                f"(checkpointing={'on' if ckpt else 'off'}, "
                f"rollbacks={monitor.rollbacks}/{a.max_rollbacks})")
    if prof is not None:
        _close_profile(prof, log_dir, dev)
    logger.close()
    resilience = None
    if monitor is not None:
        resilience = {"rejected_rounds": last_row.get("rejected_rounds", 0.0),
                      "final_loss": last_row.get("loss"), **monitor.summary()}
    if rank0 and log_dir is not None and a.guards:
        meta_path = os.path.join(log_dir, "meta.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            meta = {}
        meta["resilience"] = resilience
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
    say(f"done ({a.steps - start} steps, {time.time() - t0:.1f}s)")
    params = ({k: v.detach().float().cpu().numpy()
               for k, v in state["params"].items()} if rank0 else None)
    return {"row": dict(last_row), "resilience": resilience, "start": start,
            "params": params}


def _close_profile(prof, log_dir: str, dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def main(argv: Optional[list[str]] = None) -> list[dict]:
    """Parse the flags and run :func:`run` on every rank of ``--mesh``;
    returns the ranks' results in rank order."""
    args = parser().parse_args(argv)
    shape, axes = mesh_shape(args.mesh)
    resolve_device(args.device)   # fail here, before the world starts
    return mesh_lib.spawn_mesh(run, shape, axes, args=(vars(args),),
                               timeout=args.world_timeout)


if __name__ == "__main__":
    main()
