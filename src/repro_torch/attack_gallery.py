"""Attack x aggregator gallery: the robustness landscape in one table, on the
PyTorch port.  The counterpart of ``examples/attack_gallery.py``: the same
grid at the same sizes.

Runs the federated logistic regression under every (attack x aggregator)
pair (the beyond-paper ALIE and IPM attacks included) and prints the final
optimality gap.  Under the paper's attacks (gaussian, sign_flip,
zero_gradient) geomed, median and Krum end below mean.  ALIE and IPM hide
inside the honest spread: under them mean can end below a robust rule (in
the JAX example too: under IPM at 100 steps, under both at 500).

    PYTHONPATH=src python -m repro_torch.attack_gallery              # on the card
    PYTHONPATH=src python -m repro_torch.attack_gallery --device cpu --steps 100

The draws come from torch's generators, so the numbers are not the JAX
example's, only their order.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import RobustConfig, make_federated_step
from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                              logreg_loss, partition)
from repro_torch.optim import get_optimizer

ATTACKS = ["none", "gaussian", "sign_flip", "zero_gradient", "alie", "ipm"]
AGGS = ["mean", "geomed", "median", "trimmed_mean", "krum", "centered_clip"]
WH, B, STEPS = 15, 6, 500


def main(argv=None) -> dict[tuple[str, str], float]:
    """Print the grid; returns each (attack, aggregator) run's final gap."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    data = ijcnn1_like(0, n=1500, device=args.device)
    loss = logreg_loss(0.01)
    _, f_star = logreg_full_loss_and_opt(data)
    batch = {"a": data.x, "b": data.y}
    wd = partition(batch, WH, seed=1, device=args.device)

    print(f"Byrd-SAGA optimality gaps, {WH} honest + {B} Byzantine, "
          f"{args.steps} steps, device {args.device}")
    header = f"{'attack':>14s} | " + " | ".join(f"{a:>13s}" for a in AGGS)
    print(header)
    print("-" * len(header))
    gaps = {}
    for attack in ATTACKS:
        row = []
        for agg in AGGS:
            cfg = RobustConfig(aggregator=agg, vr="saga", attack=attack,
                               num_byzantine=0 if attack == "none" else B,
                               num_groups=3, trim=min(B, WH // 2))
            init_fn, step_fn = make_federated_step(
                loss, wd, cfg, get_optimizer("sgd", 0.02), device=args.device)
            st = init_fn({"w": torch.zeros(22)}, 2)
            for _ in range(args.steps):
                st, _ = step_fn(st)
            with torch.no_grad():
                gaps[attack, agg] = float(loss(st.params, batch)) - f_star
            row.append(gaps[attack, agg])
        print(f"{attack:>14s} | " + " | ".join(f"{g:>13.5f}" for g in row))
    return gaps


if __name__ == "__main__":
    main()
