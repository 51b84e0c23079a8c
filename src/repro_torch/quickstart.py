"""Quickstart: Byrd-SAGA on l2-regularized logistic regression under a
sign-flipping Byzantine attack (the paper's core experiment, Sec. V-A), on
the PyTorch port.  The counterpart of ``examples/quickstart.py``: the same
three runs at the same sizes.

    PYTHONPATH=src python -m repro_torch.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

Expected: mean aggregation collapses under attack; Byrd-SAGA (geomed)
converges to a small optimality gap; robust SGD converges to a larger one
(Thm 1 vs Thm 2).  The draws come from torch's generators, so the numbers
are not the JAX example's, only their order.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                              logreg_loss, partition)
from repro_torch.optim import get_optimizer

RUNS = [
    ("Byrd-SAGA   (SAGA + geomed)", "saga", "geomed", 0.02),
    ("robust SGD  (SGD + geomed)", "sgd", "geomed", 0.02),
    ("plain SAGA  (SAGA + mean)", "saga", "mean", 0.02),
]


def main(argv=None) -> dict[str, float]:
    """Run the three solvers; returns each run's final optimality gap."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    data = ijcnn1_like(0, n=2000, device=args.device)
    loss = logreg_loss(0.01)
    _, f_star = logreg_full_loss_and_opt(data)
    batch = {"a": data.x, "b": data.y}
    honest, byzantine = 25, 10
    worker_data = partition(batch, honest, seed=1, device=args.device)
    print(f"{honest} honest + {byzantine} Byzantine workers, "
          f"J={worker_data['a'].shape[1]} samples each, sign-flip attack, "
          f"device {args.device}\n")
    gaps = {}
    for label, vr, agg, lr in RUNS:
        cfg = RobustConfig(aggregator=agg, vr=vr, attack="sign_flip",
                           num_byzantine=byzantine)
        init_fn, step_fn = make_federated_step(
            loss, worker_data, cfg, get_optimizer("sgd", lr), device=args.device)
        st = init_fn({"w": torch.zeros(22)}, 1)
        for k in range(1200):
            st, metrics = step_fn(st)
            if (k + 1) % 400 == 0:
                with torch.no_grad():
                    gap = float(loss(st.params, batch)) - f_star
                print(f"  {label}  step {k + 1:4d}  gap={gap:.5f}  "
                      f"honest-var={float(metrics['honest_variance']):.2e}")
        with torch.no_grad():
            gaps[label.split("(")[0].strip()] = float(loss(st.params, batch)) - f_star
        print()
    return gaps


if __name__ == "__main__":
    main()
