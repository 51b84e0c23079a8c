#!/usr/bin/env python3
"""Step times of the PyTorch port's main path on one CUDA card, for
comparing two checkouts within one machine.

    python3 tools/torch_step_times.py [--src SRC_DIR] [--label NAME]
                                      [--cells CELL,CELL,...]

Imports ``repro_torch`` from ``SRC_DIR`` (default: this checkout's
``src``) and times, as ``chip_smoke.py`` drives them:

* workload A: logistic regression at IJCNN1 scale (n=49,990, D=22, 50
  honest workers x 999 samples + 20 Byzantine), sign_flip, 300 steps;
* workload B: the Table I network at MNIST size (D=39,760, 50 honest
  workers x 1,200 samples + 20 Byzantine, the 9.54 GB SAGA table),
  sign_flip, 60 steps;

each with geomed and with mean (B also with median, trimmed_mean with
trim 20 and geomed_blockwise, the rules that run K4, K5 and K6); and
workload D: workload B's data, model
and table on the erdos_renyi(70, p=0.5, seed=0) graph, trim 12, sign_flip,
60 steps, in cells D/gradient/geomed, D/gradient/trimmed_mean,
D/gradient/mean and D/params/geomed.  ``--cells`` picks some of the cells
(default: all); A's run first, the others in the order given.  Prints the card's name and power limit,
then one JSON line per cell with the median step time on the host clock
(ms, each step ending in ``torch.cuda.synchronize()``) and every step's
time.  Host times vary between machines by tens of percent: run two trees
in turns in one call (parent, change, change, parent) and compare within
it.  Imports nothing of JAX.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
CELLS = ("A/geomed", "A/mean", "B/geomed", "B/mean", "B/median",
         "B/trimmed_mean", "B/geomed_blockwise", "D/gradient/geomed", "D/gradient/trimmed_mean",
         "D/gradient/mean", "D/params/geomed")


def steps_ms(torch, step_fn, state, steps):
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, _ = step_fn(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells (default: all)")
    args = ap.parse_args()
    cells = args.cells.split(",")
    unknown = sorted(set(cells) - set(CELLS))
    if unknown:
        ap.error(f"unknown cells {unknown}; the cells are {list(CELLS)}")
    import torch
    if not torch.cuda.is_available():
        print("torch_step_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.data import ijcnn1_like, logreg_loss, mnist_like, partition
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    from repro_torch.topology import get_topology
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; repro_torch from {args.src}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(cell, times):
        print(json.dumps({"label": args.label, "cell": cell,
                          "median_step_ms": statistics.median(times),
                          "steps_ms": times}), flush=True)

    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=49_990, device="cuda")
    wd = partition({"a": data.x, "b": data.y}, 50, seed=1,
                   samples_per_worker=999, device="cuda")
    for agg in ("geomed", "mean"):
        if f"A/{agg}" not in cells:
            continue
        cfg = RobustConfig(aggregator=agg, vr="saga", attack="sign_flip",
                           num_byzantine=20)
        init_fn, step_fn = make_federated_step(
            loss, wd, cfg, get_optimizer("sgd", 0.02), device="cuda")
        st = init_fn({"w": torch.zeros(22, device="cuda")}, SEED)
        emit(f"A/{agg}", steps_ms(torch, step_fn, st, 300))
    del data, wd
    data = mnist_like(SEED, n=60_000, device="cuda")
    wd = partition({"x": data.x, "y": data.y}, 50, seed=2, device="cuda")
    trim = min(20, (get_topology("erdos_renyi", 70, seed=0, p=0.5)
                    .min_neighborhood - 1) // 2)
    for cell in cells:
        if cell[0] not in "BD":
            continue
        extra = {}
        if cell[0] == "D":
            _, gossip, agg = cell.split("/")
            extra = dict(trim=trim, topology="erdos_renyi", topology_p=0.5,
                         topology_seed=0, gossip=gossip)
        else:
            agg = cell[2:]
            extra = dict(trim=20, num_groups=5)   # as chip_smoke.py's workload B
        cfg = RobustConfig(aggregator=agg, vr="saga", attack="sign_flip",
                           num_byzantine=20, **extra)
        init_fn, step_fn = make_federated_step(
            paper_nn.nn_loss, wd, cfg, get_optimizer("sgd", 0.1), device="cuda")
        st = init_fn(paper_nn.init_params(SEED + 7, device="cuda"), 5)
        emit(cell, steps_ms(torch, step_fn, st, 60))
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
