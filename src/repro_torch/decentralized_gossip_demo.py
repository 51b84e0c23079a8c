"""Decentralized Byzantine-robust training demo on the PyTorch port: ring
against complete graph, then the two gossip modes.  The counterpart of
``examples/decentralized_gossip_demo.py``: the same runs at the same sizes.

No master: every node owns its own parameter copy, exchanges SAGA-corrected
gradients only with its graph neighbours, and robustly aggregates its
masked neighbourhood (``repro_torch.topology``).  Two sign-flipping
Byzantine nodes attack per edge: each receiver gets poison crafted from its
own neighbourhood's statistics.

Per topology the run prints the spectral-gap report and the loss and
consensus-distance trajectory under geomed and the non-robust mean: on the
complete graph every honest node sees every message, so the copies stay in
consensus (distance 0); on the ring information diffuses hop by hop, the
distance stays positive, robust aggregation still learns and the mean lets
the per-edge attack poison every neighbourhood.  A second section compares
gradient gossip (aggregate the neighbours' gradients, then step) with
parameter gossip (step locally, then aggregate the neighbours' models) on a
per-round resampled ``erdos_renyi`` schedule, connected only over its
window.

    PYTHONPATH=src python -m repro_torch.decentralized_gossip_demo \\
        --log-dir runs/gossip-demo --diagnostics        # on the card
    PYTHONPATH=src python -m repro_torch.decentralized_gossip_demo --device cpu

With ``--log-dir`` every run section streams its per-step metrics (with
``--diagnostics`` the aggregation diagnostics too) to
``<dir>/<section>/metrics.jsonl`` through ``repro_torch.telemetry.RunLogger``.
The draws come from torch's generators, so the numbers are not the JAX
example's, only their order.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.core.robust_step import resolve_schedule
from repro_torch.data import ijcnn1_like, logreg_loss, partition
from repro_torch.optim import get_optimizer
from repro_torch.topology import get_topology

HONEST, BYZ, STEPS = 10, 2, 300


def mean_honest_loss(loss_fn, params, wd, wh) -> float:
    with torch.no_grad():
        return float(np.mean([
            float(loss_fn({"w": params["w"][i]},
                          {"a": wd["a"][i], "b": wd["b"][i]}))
            for i in range(wh)]))


def run_dir(base: str, name: str):
    return os.path.join(base, name) if base else None


def _run(cfg, loss_fn, wd, opt, args, section, meta, **where):
    """``args.steps`` steps of one configuration, logged; prints three
    progress lines and returns (final honest loss, final consensus)."""
    init_fn, step_fn = make_federated_step(loss_fn, wd, cfg, opt,
                                           device=args.device, **where)
    state = init_fn({"w": torch.zeros(22)}, 1)
    steps = args.steps
    with telemetry.RunLogger(run_dir(args.log_dir, section),
                             flush_every=64) as logger:
        logger.write_meta(honest=HONEST, byzantine=BYZ, steps=steps,
                          torch_version=torch.__version__, **meta)
        for i in range(steps):
            state, metrics = step_fn(state)
            logger.log_step(i, metrics)
            if i % max(steps // 3, 1) == 0 or i == steps - 1:
                ml = mean_honest_loss(loss_fn, state.params, wd, HONEST)
                print(f"  {section:20s} step {i:3d}: honest-loss={ml:.4f} "
                      f"consensus={float(metrics['consensus_dist']):.5f}")
    return ml, float(metrics["consensus_dist"])


def main(argv=None) -> dict[str, tuple[float, float]]:
    """Run every section; returns ``{section: (honest loss, consensus)}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--log-dir", default="", help="write metrics.jsonl per "
                    "run section under <dir>/<section>/")
    ap.add_argument("--diagnostics", action="store_true",
                    help="log the aggregation diagnostics per step")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    data = ijcnn1_like(0, n=2000, device=args.device)
    wd = partition({"a": data.x, "b": data.y}, HONEST, seed=1,
                   device=args.device)
    loss_fn = logreg_loss(0.01)
    opt = get_optimizer("sgd", 0.02)
    out = {}

    for topo_name in ("ring", "complete"):
        topo = get_topology(topo_name, HONEST + BYZ)
        print(f"\n=== {topo_name} === {topo.describe()}")
        for agg in ("geomed", "mean"):
            cfg = RobustConfig(aggregator=agg, vr="saga", attack="sign_flip",
                               num_byzantine=BYZ, weiszfeld_iters=32,
                               diagnostics=args.diagnostics)
            out[f"{topo_name}_{agg}"] = _run(
                cfg, loss_fn, wd, opt, args, f"{topo_name}_{agg}",
                dict(section="topology", topology=topo_name, aggregator=agg),
                topology=topo)

    print("\n=== gossip modes on a time-varying erdos_renyi schedule ===")
    for gossip in ("gradient", "params"):
        cfg = RobustConfig(aggregator="geomed", vr="saga",
                           attack="sign_flip", num_byzantine=BYZ,
                           weiszfeld_iters=32, gossip=gossip,
                           schedule="erdos_renyi", schedule_period=4,
                           topology_p=0.4, diagnostics=args.diagnostics)
        sched = resolve_schedule(cfg, HONEST + BYZ)
        if gossip == "gradient":
            d = sched.describe()
            print(f"  schedule: period={d['period']} "
                  f"window_connected={d['window_connected']} "
                  f"joint_spectral_gap={d['joint_spectral_gap']:.3f} "
                  f"(per-round gaps: "
                  f"{[round(r['spectral_gap'], 3) for r in d['rounds']]})")
        out[f"schedule_{gossip}"] = _run(
            cfg, loss_fn, wd, opt, args, f"schedule_{gossip}",
            dict(section="gossip_modes", gossip=gossip), schedule=sched)
    return out


if __name__ == "__main__":
    main()
