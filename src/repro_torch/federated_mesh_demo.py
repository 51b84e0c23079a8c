"""Multi-rank federation demo on the PyTorch port: the distributed training
step on a (4, 2) mesh of gloo ranks -- one worker per "data" index, a
2-way "model" axis, geometric-median aggregation over the workers, one
Byzantine worker mounting a sign-flip attack.  The counterpart of
``examples/federated_mesh_demo.py``: the reduced qwen2-7b, both comm paths,
10 steps each.

    PYTHONPATH=src python -m repro_torch.federated_mesh_demo             # on the card
    PYTHONPATH=src python -m repro_torch.federated_mesh_demo --device cpu

Eight processes (:func:`repro_torch.launch.mesh.spawn_mesh`); on the card
all of them use it and gloo stages each collective through the host.  The
draws come from torch's generators, so the numbers are not the JAX
example's; the gather and sharded runs print near-identical losses.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.robust_step import RobustConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.train import make_batch
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model

MESH = ((4, 2), ("data", "model"))
SEQ, PER_WORKER = 32, 2


def run(mesh, device: str, steps: int) -> dict:
    """Both comm paths on this rank -> ``{comm: {"losses", "agg_norms",
    "params"}}`` (``params`` as numpy on rank 0, else None)."""
    rank0 = mesh.axes(*mesh.axis_names).index == 0
    dev = torch.device(device)
    cfg = get_config("qwen2-7b").reduced()
    model = build_model(cfg, device=dev, remat=False, loss_chunk=32)
    w = mesh_lib.num_workers(mesh)
    if rank0:
        print(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))} — {w} "
              f"workers, {mesh.shape[-1]}-way model axis", flush=True)
    out = {}
    for comm in ("gather", "sharded"):
        robust = RobustConfig(aggregator="geomed", vr="sgd",
                              attack="sign_flip", num_byzantine=1, comm=comm,
                              weiszfeld_iters=16)
        step = steps_lib.make_train_step(
            model, robust, TrainConfig(optimizer="adamw", lr=1e-3), mesh)
        state = step.init_state(tfm.flat_params(model.init(0)))
        if rank0:
            print(f"\ncomm={comm} (paper-faithful gather vs sharded "
                  "Weiszfeld):", flush=True)
        losses, norms = [], []
        for i in range(steps):
            gen = torch.Generator().manual_seed(steps_lib.fold_in(1, i))
            batch = make_batch(gen, cfg, w, PER_WORKER, SEQ, dev)
            state, m = step(state, batch, steps_lib.fold_in(1, 50 + i))
            losses.append(float(m["loss"]))
            norms.append(float(m["agg_norm"]))
            if rank0 and (i % 3 == 0 or i == steps - 1):
                print(f"  step {i}: honest-loss={losses[-1]:.4f} "
                      f"agg_norm={norms[-1]:.4f}", flush=True)
        params = ({k: v.float().cpu().numpy() for k, v in state["params"].items()}
                  if rank0 else None)
        out[comm] = {"losses": losses, "agg_norms": norms, "params": params}
    return out


def main(argv=None) -> list[dict]:
    """Run the demo on a local (4, 2) world; returns the ranks' results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("federated_mesh_demo: --device cuda needs a card; "
                           "pass --device cpu")
    return mesh_lib.spawn_mesh(run, *MESH, args=(args.device, args.steps),
                               timeout=args.timeout)


if __name__ == "__main__":
    main()
