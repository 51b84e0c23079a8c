"""End-to-end Byzantine-robust LM training on the PyTorch port: a decoder-only
transformer trained across W simulated workers with SAGA-corrected
gradients and geometric-median aggregation while B workers mount a
sign-flip attack.  The counterpart of ``examples/train_robust_lm.py``: the
same presets, flags and step.

    # the full ~100M model, on the card (the default)
    PYTHONPATH=src python -m repro_torch.train_robust_lm --preset 100m --steps 300

    # the ~8M variant on the CPU
    PYTHONPATH=src python -m repro_torch.train_robust_lm --preset small \\
        --steps 200 --device cpu

Each worker owns a fixed corpus of J batches (the finite-sum setting).  A
step draws one batch a worker, takes the per-worker gradients with
``torch.func.vmap(grad)`` of ``Model.loss`` (on the card K8 runs each
layer's attention once for all workers: its vmap rule folds the workers
into the batch), corrects them with SAGA (K1), lets the first B workers'
messages be replaced by the attack, aggregates with the rule (K2/K3 for
geomed) and applies AdamW.  The draws come from torch's generators, so the
numbers are not the JAX example's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import RobustConfig
from repro_torch.core.attacks import apply_attack
from repro_torch.core.packing import pack_spec
from repro_torch.core.saga import saga_correct_scatter, saga_init_zeros
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.optim import apply_updates, get_optimizer

PRESETS = {
    # ~103M params: 12L, d=768, tied 32k vocab.
    "100m": ModelConfig(name="robust-lm-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=12, d_ff=2048,
                        vocab_size=32000, param_dtype="float32",
                        tie_embeddings=True),
    # ~8M params for CPU-quick runs.
    "small": ModelConfig(name="robust-lm-small", family="dense", num_layers=4,
                         d_model=256, num_heads=4, num_kv_heads=4, d_ff=1024,
                         vocab_size=8000, param_dtype="float32",
                         tie_embeddings=True),
}


def main(argv=None) -> dict:
    """Train and print the loss; returns ``{"losses": each step's mean
    worker loss, "launches": each step's kernel launches (K1-K3 by name,
    K8 by route), "step_s": each step's seconds (host clock, the loss
    read back each step), "params": the parameter count}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--byzantine", type=int, default=2)
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--aggregator", default="geomed")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--saga-samples", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="stop after the step that passes this many seconds "
                    "and say how many steps ran (0: run every step)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    w, b, j = args.workers, args.byzantine, args.saga_samples
    model = build_model(cfg, device=dev, remat=False, loss_chunk=128)
    params = tfm.flat_params(model.init(0))
    n = sum(p.numel() for p in params.values())
    print(f"{cfg.name}: {n / 1e6:.1f}M params | {w} workers ({b} Byzantine, "
          f"{args.attack}) | agg={args.aggregator} | SAGA J={j}")

    robust = RobustConfig(aggregator=args.aggregator, vr="saga",
                          attack=args.attack, num_byzantine=b,
                          weiszfeld_iters=16)
    spec = pack_spec(params, batch_ndim=0)
    aggregate = robust.flat_aggregator_fn(spec)
    attack_cfg = robust.attack_config()
    opt = get_optimizer("adamw", args.lr)

    # Fixed per-worker corpora (the finite-sum setting: J batches a worker).
    gen = torch.Generator().manual_seed(1)
    corpus = torch.randint(0, cfg.vocab_size,
                           (w, j, args.per_worker_batch, args.seq + 1),
                           generator=gen).to(dev)

    def worker_loss(p, toks):
        return model.loss(p, {"tokens": toks[..., :-1],
                              "labels": toks[..., 1:]})

    grads_fn = torch.func.vmap(torch.func.grad_and_value(worker_loss),
                               in_dims=(None, 0))
    saga = saga_init_zeros(params, w, j)
    opt_state = opt.init(params)
    attack_gen = torch.Generator(device=dev).manual_seed(2)
    out = {"losses": [], "launches": [], "step_s": [], "params": n}
    t0 = time.time()
    def counts() -> dict:
        c = ops.launch_counts()
        return {**{k: c[k] for k in ("saga_correct", "partial_sqdist",
                                     "weighted_sum")},
                **{f"flash_attention {r}": n
                   for r, n in fa.VARIANT_LAUNCHES.items()}}

    for i in range(args.steps):
        before = counts()
        t = time.perf_counter()
        idx = torch.randint(0, j, (w,), generator=gen).to(dev)
        batches = corpus[torch.arange(w, device=dev), idx]
        grads, losses = grads_fn(params, batches)
        msgs, saga = saga_correct_scatter(saga, spec.pack(grads), idx)
        # The first B workers' messages are replaced by the attack on the
        # honest ones (the Byzantine rows go last; the rule is
        # permutation-invariant).
        msgs = apply_attack(attack_cfg, msgs[b:], attack_gen, spec=spec)
        agg = spec.unpack(aggregate(msgs), batch_ndim=0)
        updates, opt_state = opt.update(agg, opt_state, params, i)
        params = apply_updates(params, updates)
        loss = float(torch.mean(losses))
        out["step_s"].append(time.perf_counter() - t)
        out["losses"].append(loss)
        out["launches"].append({k: v - before[k]
                                for k, v in counts().items()})
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  honest-loss={loss:.4f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
        if args.max_seconds and time.time() - t0 > args.max_seconds:
            print(f"stopped after {i + 1} of {args.steps} steps "
                  f"(--max-seconds {args.max_seconds:g})")
            break
    print("done — loss should be dropping despite the Byzantine workers.")
    return out


if __name__ == "__main__":
    main()
