#!/usr/bin/env python3
"""Device times of the PyTorch port's sweep kernels on one CUDA card, for
comparing two checkouts within one machine.

    python3 tools/torch_kernel_times.py [--src SRC_DIR] [--label NAME]

Imports ``repro_torch`` from ``SRC_DIR`` (default: this checkout's
``src``) and times, on random inputs from a fixed seed:

* at workload B's shapes, messages (70, 39,760): K2 ``partial_sqdist``,
  K3 ``weighted_sum``, K4 ``coordinate_median``, K5 ``trimmed_mean``
  (trim 20) and K6 ``partial_sqdist_segments`` (the Table I network's four
  leaves, ``chip_smoke.table1_boundaries``), 200 launches a window; K5's
  bf16 line also names the layout it ran (``"layout"``, where the tree
  reports one);
* K2, K3, K4, K5 and K6 on a bfloat16 copy of the messages (the bf16
  wire's routes; lines ending in "bf16", each right after its float32
  line);
* at workload D's exchange (70, 70, 39,760) under its erdos_renyi(70,
  p=0.5, seed=0) mask: K3 batched with weights 0 off the mask, K2 batched
  unmasked and (where the tree has it) masked, and K7
  ``masked_neighbor_reduce`` at trim 0 and 12, 20 launches a window; then
  K3 batched, the masked K2 and K7 at trim 0 and 12 on a bfloat16 copy of
  the exchange (lines ending in "bf16").

Each kernel is timed in 5 windows with ``chip_smoke.event_ms`` (CUDA events
around launches queued behind a sleep kernel, so the card runs them back to
back); prints the card's name and power limit, then one JSON line per
kernel with the median and every window's time per launch (us).  The lines
at B's shapes also give each launched kernel's own device time per call
(``"kernels"``, torch.profiler over 200 calls: ``chip_smoke.kernel_split``),
so a route of two kernels shows both.  Run two
trees in turns in one call (parent, change, change, parent) and compare
within it.  Imports nothing of JAX.
"""
import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
WINDOWS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import event_ms, kernel_split, table1_boundaries
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.geomed import segment_ids
    from repro_torch.kernels import robust_stats as rs
    from repro_torch.kernels import topology as tp
    from repro_torch.kernels import weiszfeld as wz
    from repro_torch.topology import get_topology
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; repro_torch from {args.src}", flush=True)

    def emit(name, fn, reps, split=False, layouts=None):
        us = [event_ms(torch, fn, reps) * 1e3 for _ in range(WINDOWS)]
        line = {"label": args.label, "kernel": name,
                "median_us": statistics.median(us), "us": us}
        if split:
            line["kernels"] = {k: round(v, 3) for k, v in kernel_split(torch, fn, reps).items()}
        if layouts is not None:   # the layout one more call takes
            for k in layouts:
                layouts[k] = 0
            fn()
            line["layout"] = [k for k, v in layouts.items() if v]
        print(json.dumps(line), flush=True)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    z = torch.randn((70, 39_760), generator=g, device="cuda")
    y = z.mean(0)
    a = torch.rand(70, generator=g, device="cuda")
    zb = z.bfloat16()
    emit("K2 at B", lambda: wz.partial_sqdist_call(z, y), 200, split=True)
    emit("K2 at B bf16", lambda: wz.partial_sqdist_call(zb, y), 200, split=True)
    emit("K3 at B", lambda: wz.weighted_sum_call(z, a), 200)
    emit("K3 at B bf16", lambda: wz.weighted_sum_call(zb, a), 200)
    emit("K4 at B", lambda: rs.coordinate_median_call(z), 200, split=True)
    emit("K4 at B bf16", lambda: rs.coordinate_median_call(zb), 200, split=True)
    emit("K5 trim 20 at B", lambda: rs.trimmed_mean_call(z, 20), 200, split=True)
    emit("K5 trim 20 at B bf16", lambda: rs.trimmed_mean_call(zb, 20), 200, split=True,
         layouts=getattr(rs, "TRIMMED_LAYOUT_LAUNCHES", None))
    bounds, d = table1_boundaries(torch)
    seg = segment_ids(tuple(bounds), d, torch.device("cuda"))
    emit("K6 at B", lambda: wz.partial_sqdist_segments_call(z, y, seg, len(bounds)),
         200)
    emit("K6 at B bf16",
         lambda: wz.partial_sqdist_segments_call(zb, y, seg, len(bounds)), 200)
    del z, zb
    topo = get_topology("erdos_renyi", 70, seed=0, p=0.5)
    mask = torch.as_tensor(topo.neighbor_mask, device="cuda")
    ex = torch.randn((70, 70, 39_760), generator=g, device="cuda")
    wts = mask * torch.rand((70, 70), generator=g, device="cuda")
    yb = ex.mean(1)
    emit("K3 batched at D", lambda: wz.weighted_sum_call(ex, wts), 20)
    emit("K2 batched unmasked at D", lambda: wz.partial_sqdist_call(ex, yb), 20)
    if "mask" in inspect.signature(wz.partial_sqdist_call).parameters:
        emit("K2 batched masked at D",
             lambda: wz.partial_sqdist_call(ex, yb, mask), 20)
    for trim in (0, 12):
        emit(f"K7 trim {trim} at D",
             lambda: tp.masked_neighbor_reduce_call(ex, mask, trim), 20)
    ex = ex.bfloat16()
    emit("K3 batched at D bf16", lambda: wz.weighted_sum_call(ex, wts), 20)
    emit("K2 batched masked at D bf16",
         lambda: wz.partial_sqdist_call(ex, yb, mask), 20)
    for trim in (0, 12):
        emit(f"K7 trim {trim} at D bf16",
             lambda: tp.masked_neighbor_reduce_call(ex, mask, trim), 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
