#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. The card: name and power limit; TF32 off for matmuls and cuDNN (Krum's
   Gram product must run in full float32).
2. Build: the CUDA kernels K1-K8 from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a, one process per source, all started together
   (``-Xptxas -v`` summary printed).
3. Kernel checks: each kernel against its plain PyTorch version at ragged
   shapes (W=7 and 8, D=300, J=3, L=3 segments with some coordinates in
   none) and at workload B's shapes (W=70, D=39,760, table (50, 1,200,
   39,760), L=4 for the Table I network's four leaves).  K1 within 1 ulp
   with only the drawn table rows changed; K4 bitwise on its network route
   (W <= 128; also at 127, 128 and 129 workers with ties and +-inf) and
   for odd W past it, within 1 ulp for even W past it, and the same bits on
   a second launch; K5 on its network route (W <= 128) with columns of trim
   and trim + 1 NaN, NaN and +-inf exactly where the plain version has
   them, and the same bits on a second launch; K2, K3 (also on a column
   slice), K5 and K6 within
   rtol 1e-5 (atol 1e-5 x max|plain|: the sum runs in another order); K6
   the same bits on three back-to-back launches and one kernel on the card
   per call (torch.profiler).
   Then the decentralized kernels: K7 and the receiver-batched K2 (both
   routes: unmasked, and masked, which reads only the rows of mask > 0) and
   K3 at a ragged (R, S, D) = (7, 7, 300) with ties and trim 0-2, at
   workload D's (70, 70, 39,760) exchange under its erdos_renyi mask with
   trim 0 and 12, and past what one block's shared memory holds: K7 and
   K2 at S = 451, 1,000 and 2,048 senders (every K7 route: trim 0, 1, 12,
   16, 17 and (n - 1) // 2, with ties), K4/K5 at W = 455, 1,000 and 5,000,
   K2/K3 at W = 12,289; all within rtol 1e-5.
4. Workload A: logistic regression at IJCNN1 scale (n=49,990, D=22,
   50 honest + 20 Byzantine workers), sign_flip, 300 steps of SAGA and of
   BSGD (50 samples a worker), each with geomed and with mean, launch
   counts asserted per solver and rule; then the C1 claim of
   tests/test_convergence.py (W_h=12, B=5, n=960, 700 steps, three
   attacks); then 20 SAGA and 20 BSGD steps on the card against the plain
   CPU path from the same state and draws.
   Workload F: covtype_like at the real set's size (581,012 x 54), 50
   honest workers x 11,620 samples + 20 Byzantine, sign_flip; SGD, BSGD
   and SAGA at benchmarks/common.py's learning rates, each with mean and
   geomed, 300 steps: step time, device busy and idle share (20 traced
   steps), Weiszfeld iterations, peak memory and loss for each.
5. Workload B: the Table I network at MNIST size (60,000 x 784, D=39,760,
   50 honest workers x 1,200 samples + 20 Byzantine), sign_flip, geomed,
   20 steps, with the launch counters of K1-K3 reset just before and read
   just after; a torch.profiler trace of 3 more steps gives device time by
   kernel and the device's idle share.
6. Timing: each kernel's device time at workload B's shapes (torch.profiler
   kernel durations), beside its bound, its plain version and one library
   call where one computes the same function (K3: ``a @ z``; K4:
   ``torch.quantile``), and K4's and K5's network route beside its bytes
   bound and instruction floor (its float min/max a coordinate at the
   card's top SM clock); the
   Weiszfeld loop's time per iteration on the host
   clock; then workload B again with mean, the step without the Weiszfeld
   loop.
7. Workload B with every other rule of the reference's registry (median,
   trimmed_mean with trim 20, krum, geomed_groups with 5 groups,
   centered_clip, geomed_blockwise), 20 steps each, launch counts asserted
   (K4 once per step for median and centered_clip, K5 once per step for
   trimmed_mean, K6 at least once per step and K2 never for
   geomed_blockwise); the SAGA table is freed between runs.
8. Fig. 6 at workload A's scale: 300 steps for each of the four attacks of
   benchmarks/common.py and alie, times every rule; the optimality gaps as
   a table.  Then the grids of benchmarks/fig3_ijcnn1.py, fig4_covtype.py,
   fig5_zero_outer.py and table1_nn.py at their sizes, with GRID_STEPS'
   steps (cut from the benchmarks' own; logged), as tables, and the
   orderings of GRID_ORDERINGS asserted.
9. The claims C2-C4 and the krum/median/trimmed-mean claim of
   tests/test_convergence.py at their sizes and thresholds, and
   tests/test_system.py's BSGD claim (honest variance below SGD's), then
   ``repro_torch.quickstart`` on the card.
10. Workload D, the decentralized step at full width: workload B's data,
   model and table on an erdos_renyi(p=0.5, seed=0) graph of the 70 nodes
   (static schedule; trim = min(B, (min_neighborhood - 1) // 2) = 12),
   sign_flip per edge; 20 steps each of gradient gossip with geomed,
   trimmed_mean and mean, and parameter gossip with geomed, launch counts
   reset just before and read just after and asserted (K7 once per step
   for trimmed_mean, on its "select" kernel; batched K2 and K3 once per
   Weiszfeld iteration, every K2 launch on the masked route, K7 once per
   step on its "sum" kernel for geomed; workloads A and B launch no masked
   K2), and a 3-step profile; then K7 (trim 12 and 0, the latter beside
   ``torch.bmm`` of the masked mean) and the batched K2 (masked beside
   unmasked) and K3 timed at its shapes.
11. The decentralized claims of tests/test_topology.py on the card, at
   their sizes and thresholds: ring geomed learns and beats mean under
   sign_flip, the complete graph keeps exact consensus, the parameter
   gossip error floor lies within 2x of gradient gossip's (sign_flip and
   gaussian, 500 steps), and every rule in both gossip modes trains on a
   ring with finite values.
12. K8 flash attention against its plain version, float32 within rtol/atol
   2e-5 and bfloat16 within 2e-2 (the tolerances of tests/test_kernels.py),
   at the shapes of tests/test_kernels.py:120-125, a ragged MQA head of 128
   (2, 300, 7, 1, 128), two bidirectional heads of 64 and 128 and workload
   E's per-layer shape (4, 2,048, 28, 4, 128), causal; each call through the
   route ``flash_attention.variant`` picks (wgmma for bfloat16 at hd 64 and
   128, SIMT otherwise), the route that ran logged and asserted.
13. Workload E, serving qwen2-7b at full width and depth (28 layers, 7.6 B
   parameters, bf16, drawn on the card from the seed) through
   ``repro_torch.launch.serve``: batch 4 x 2,048 prompt tokens, 32 greedy
   tokens, the KV cache allocated once at 2,080 positions.  One warm-up,
   then three runs (prefill time and decode ms/step, medians), launch
   counts reset just before the first and read just after (K8 exactly 28
   times, once per layer of the prefill, all through the wgmma kernel, and
   never in a decode step),
   finite logits and the output shapes asserted; peak memory; a
   torch.profiler split of one prefill and one decode step (K8, matmuls,
   the rest) with the device's idle share.
14. The cache against prefill at full width (2 layers, float32): prefill
   over s tokens then one decode step at s agrees with a prefill over the
   s + 1 tokens, rtol 1e-4; the card against the CPU: the reduced
   qwen2-7b in float32, prefill + 4 decode steps, rtol 1e-4.
15. K8 timed at workload E's per-layer shape (CUDA events): the wgmma
   kernel the path runs and, for comparison, the SIMT kernel on the same
   bfloat16 inputs, beside the bound, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, timed here only;
   the port never calls it).
16. The simulation options.  K1's client-row route (a table resident per client,
   updated through (W,) distinct client rows) bitwise against its plain
   version at (C, J, D) = (13, 3, 300) with 7 rows and at workload G's
   (500, 120, 39,760) with a cohort of 50, only the drawn entries changed,
   an out-of-range row giving NaN and touching no state.  Workload G: the
   Table I network at MNIST size under partial participation (500 clients x
   120 samples, cohorts of 50 honest slots + 20 Byzantine), SAGA, geomed,
   sgd 0.1, 20 steps each of G1 straggler (straggler_k 4, staleness decay
   0.9) and G2 dropout: step time, device busy and idle share, Weiszfeld
   iterations, K1 launches by route, peak memory (asserted below workload
   B's plus 0.5 GB: no copy of the cohort's table rows), loss and accuracy;
   K1's two routes timed on G's table.  Workload B with the new options, 20
   steps each: lsvrg (p = 1/1,200, every coin up on step 10, so the
   refresh runs at full width) under sign_flip; guards under nan,
   inf_overflow and bitflip (prob 0.02), finite and every Byzantine row
   quarantined every step; guards under sign_flip and diagnostics, each
   with B geomed's loss to every printed digit, the diagnostics' mean weight
   of the honest and the Byzantine slots.  Workload D gradient geomed with
   guards under per-edge bitflip and diagnostics.  The twins of
   tests/test_convergence.py's lsvrg claim and tests/test_guards.py's
   fault containment on the simulated master.
17. The wires (``message_dtype`` bfloat16, int8, sign1).  Every bf16 route
   of K1-K7: K1 (both routes) bitwise its plain version's bf16 ops at
   (7, 3, 300), B's (50, 1,200, 39,760) and G's (500, 120, 39,760) with 50
   client rows, only the drawn rows changed; K2-K6 at (7, 300), (8, 300),
   B's (70, 39,760), (455, 39,760) (K4/K5's global rank count) and
   (129, 1,000), and K7, the batched K2 (both routes) and K3 at (7, 7, 300),
   D's exchange under its mask (every trim 0-16) and S = 451, each contiguous and as a
   misaligned column slice (the scalar loads; K7 "select" two coordinates a
   thread on the contiguous exchange, one on the slice, asserted): the
   float32 kernel's bits on the upcast laid out alike, and the plain version
   within rtol 1e-5.  Each bf16 route timed beside the float32 route on the
   same values in the same phase, its bound (messages at 2 B) and its plain
   version; K7 "select" at D in both layouts beside its instruction floor.
   Runs of 20 steps (D gradient trimmed_mean bfloat16: every K7 launch two
   coordinates a thread): workload B under bfloat16 with geomed, median, trimmed_mean
   and geomed_blockwise (the SAGA table 4.77 GB, peak below B's float32
   peak, every launch on a bf16 route), under int8 and sign1 with geomed;
   G1 under sign1 (the residual rows move with the cohort) and bfloat16
   (K1's client-row bf16 route); D gradient geomed and trimmed_mean under
   bfloat16 and D params geomed under sign1.  The twins of
   tests/test_convergence.py's quantized-wire floor (int8 < 2 x max(f32,
   0.03), sign1 < 4 x max(f32, 0.03) and < 0.2) and of
   tests/test_packing.py's bf16-tracks-f32 check (10 steps within 5e-2, a
   bf16 table).
18. The master's collectives across ranks (run right after the kernel
   checks): K2-K6 against their plain versions at the shapes the
   distributed paths give them (the gather path's (W, D_shard) stacks, the
   sharded path's (W, ceil(D / W)) slices, K6 on every worker's slice with
   its leaf ids, absent blocks exactly 0, a slice ending in padding); then
   8 ranks on the one card (``gloo``, CUDA tensors staged through the
   host), meshes (4, 2) ("data", "model") and (2, 4, 1) ("pod", "data",
   "model"), workers' messages of the Table I network's leaves (D =
   39,760) drawn from the seed, worker 0 Byzantine under sign_flip through
   ``distributed_attack``: every rule on both comm paths and, on (4, 2),
   geomed on the int8, sign1 and bfloat16 wires, each within rtol 1e-5 of
   the single-process flat rule on the stacked buffer (krum bitwise), each
   rule's kernels launched on every rank (counts printed).  Times here are
   gloo's staging on one card, not an interconnect's.
19. Resume and rollback at workload A's size: 5 straight steps against 3, a
   checkpoint, a restore and 2 more, equal on every leaf and the
   generator's state, for the master step (SAGA geomed, sign_flip) and the
   decentralized step on workload D's erdos_renyi(70, 0.5) graph; then the
   rollback sequence (guards, a poisoned health vector, RunHealth with
   patience 2, restore_last_good, the descent equal to the straight run).
   The checkpoint's size and the save and restore times are printed.
20. The per-leaf baseline (``RobustConfig(packed=False)``): the per-leaf
   rules against the packed ones on workload B's step-0 messages, then
   workload B and D gradient gossip per leaf with geomed and trimmed_mean,
   20 steps each, loss and accuracy within 1e-3 of the packed run's, one
   launch a leaf where the packed run launches one.
21. The port's twins of the two examples (attack_gallery,
   decentralized_gossip_demo; 100 steps each): the gallery's robust rules
   end below mean, the demo's complete graph keeps consensus and the ring
   does not.
22. One JSON line with the kernels (K1-K8, and K1's client-row route, the
   masked route of K2 and the trim-0 kernel of K7 as entries of their
   own, then each bf16 route: "<entry> bf16"), then the result line.

It imports nothing of JAX or of the JAX package ``repro``.
"""
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores
SEED = 0

# Kernel -> (its source in the port, the TPU kernel's pallas_call it replaces).
KERNEL_SOURCES = {
    "saga_correct": ("src/repro_torch/kernels/csrc/saga_correct.cu",
                     "src/repro/kernels/saga_correct.py:52"),
    "saga_correct clients": ("src/repro_torch/kernels/csrc/saga_correct.cu",
                             "src/repro/kernels/saga_correct.py:52"),
    "partial_sqdist": ("src/repro_torch/kernels/csrc/weiszfeld.cu",
                       "src/repro/kernels/weiszfeld.py:58"),
    "weighted_sum": ("src/repro_torch/kernels/csrc/weiszfeld.cu",
                     "src/repro/kernels/weiszfeld.py:126"),
    "coordinate_median": ("src/repro_torch/kernels/csrc/robust_stats.cu",
                          "src/repro/kernels/robust_stats.py:34"),
    "trimmed_mean": ("src/repro_torch/kernels/csrc/robust_stats.cu",
                     "src/repro/kernels/robust_stats.py:56"),
    "partial_sqdist_segments": ("src/repro_torch/kernels/csrc/weiszfeld.cu",
                                "src/repro/kernels/weiszfeld.py:98"),
    "masked_neighbor_reduce": ("src/repro_torch/kernels/csrc/topology.cu",
                               "src/repro/kernels/topology.py:78"),
    "partial_sqdist masked": ("src/repro_torch/kernels/csrc/weiszfeld.cu",
                              "src/repro/kernels/weiszfeld.py:58"),
    "masked_neighbor_reduce sum": ("src/repro_torch/kernels/csrc/topology.cu",
                                   "src/repro/kernels/topology.py:78"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:99"),
}
# Rule -> the kernels its step must launch on the card.
RULE_KERNELS = {
    "geomed": ("saga_correct", "partial_sqdist", "weighted_sum"),
    "mean": ("saga_correct",),
    "median": ("saga_correct", "coordinate_median"),
    "trimmed_mean": ("saga_correct", "trimmed_mean"),
    "krum": ("saga_correct",),
    "geomed_groups": ("saga_correct", "partial_sqdist", "weighted_sum"),
    "centered_clip": ("saga_correct", "coordinate_median"),
    "geomed_blockwise": ("saga_correct", "partial_sqdist_segments",
                         "weighted_sum"),
}
# The path whose run gives each kernel's launch count in the kernels line.
KERNEL_PATH = {"saga_correct": "geomed", "saga_correct clients": "G1",
               "partial_sqdist": "geomed",
               "weighted_sum": "geomed", "coordinate_median": "median",
               "trimmed_mean": "trimmed_mean",
               "partial_sqdist_segments": "geomed_blockwise",
               "masked_neighbor_reduce": "D gradient trimmed_mean",
               "partial_sqdist masked": "D gradient geomed",
               "masked_neighbor_reduce sum": "D gradient geomed",
               "flash_attention": "E serve"}
# Workload D's runs: (gossip, rule).
D_RUNS = (("gradient", "geomed"), ("gradient", "trimmed_mean"),
          ("gradient", "mean"), ("params", "geomed"))
FIG6_RULES = ("mean", "geomed", "median", "krum", "trimmed_mean",
              "geomed_groups", "centered_clip", "geomed_blockwise")
FIG6_ATTACKS = ("none", "gaussian", "sign_flip", "zero_gradient", "alie")
# Workload G: workload B's data and network under partial participation,
# 500 clients x 120 samples, cohorts of 50 honest slots + 20 Byzantine.
G_CLIENTS, G_COHORT, G_BYZ = 500, 50, 20
G_RUNS = (("G1", dict(attack="straggler", straggler_k=4, staleness_decay=0.9)),
          ("G2", dict(attack="dropout")))
# K8 checks: (B, S, H, KV, hd), causal.
FLASH_CHECKS = (((2, 64, 4, 2, 16), True), ((1, 100, 2, 2, 32), True),
                ((2, 37, 4, 4, 8), False), ((1, 192, 2, 1, 64), True),
                ((2, 300, 7, 1, 128), True), ((1, 129, 4, 2, 64), False),
                ((2, 65, 2, 1, 128), False), ((4, 2048, 28, 4, 128), True))
# Workload E: qwen2-7b served at full width and depth.
E_ARCH, E_BATCH, E_PROMPT, E_DECODE = "qwen2-7b", 4, 2048, 32
# The paper's three solvers (label, vr, sgd learning rate), as
# benchmarks/common.py ALGOS; BSGD draws 50 samples a worker.
ALGOS = (("SGD", "sgd", 0.02), ("BSGD", "minibatch", 0.01), ("SAGA", "saga", 0.02))
# Workload F: covtype at the real set's size, 50 honest workers x 11,620
# samples + 20 Byzantine, sign_flip, 300 steps of each solver x rule.
F_N, F_WORKERS, F_BYZ, F_STEPS = 581_012, 50, 20, 300
# The paper's grids at benchmarks/'s sizes: the attacks of
# benchmarks/common.py, and each grid's steps, cut from the benchmarks' 600
# (Figs. 3 and 4), 800 (Fig. 5) and 500 (Table I) to keep the phase near
# two minutes (at 400, 400, 500 and 300 it took 192 s on an H100).
GRID_ATTACKS = ("none", "gaussian", "sign_flip", "zero_gradient")
GRID_STEPS = {"fig3": 250, "fig4": 250, "fig5": 300, "table1": 200}
# (grid, attack, run, run): the first run's optimality gap lies below the
# second's.  Each holds in the reference's benchmarks run on the CPU at the
# same sizes and steps (PERF.md); Table I's accuracies at 300 steps sit near
# chance there, so none of its orderings is asserted.
GRID_ORDERINGS = tuple(
    [(fig, attack, lo, hi) for fig in ("fig3", "fig4")
     for attack in ("sign_flip", "zero_gradient")
     for lo, hi in (("SAGA-geomed", "BSGD-geomed"), ("BSGD-geomed", "SGD-geomed"),
                    ("SAGA-geomed", "SAGA-mean"))]
    + [(fig, "gaussian", f"{s}-geomed", f"{s}-mean") for fig in ("fig3", "fig4")
       for s in ("SGD", "SAGA")]
    + [("fig5", attack, lo, hi) for attack in ("sign_flip", "zero_gradient")
       for lo, hi in (("SAGA-geomed", "BSGD-geomed"), ("BSGD-geomed", "SGD-geomed"))]
    + [("fig5", attack, "SAGA-geomed", "SGD-geomed") for attack in ("none", "gaussian")])


def log(msg=""):
    print(msg, flush=True)


def ulps(a, b) -> int:
    """Largest distance in float32 ulps between two tensors."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def close(got, want, rtol=1e-5):
    """K2/K3 tolerance: |got - want| <= rtol * (|want| + max|want|)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = bool(((got - want).abs() <= rtol * (want.abs() + scale)).all())
    return ok, err


def launch_counts():
    """Launches per kernel since the last reset, with K1's per-route counts
    ("saga_correct workers" / "clients"), K2's ("partial_sqdist unmasked" /
    "masked", and the unmasked route's layouts "partial_sqdist cluster" /
    "two-pass"), K4's and K5's layouts ("coordinate_median one" / "pairs",
    "trimmed_mean one" / "pairs"), K7's
    ("masked_neighbor_reduce sum" / "select" / "rank", and "select"'s
    layouts "masked_neighbor_reduce select one" / "select pairs"), and the
    bf16 routes' ("saga_correct bf16", "saga_correct clients bf16", ...)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import robust_stats as rs
    from repro_torch.kernels import saga_correct as sc
    from repro_torch.kernels import topology as tp
    from repro_torch.kernels import weiszfeld as wz
    counts = ops.launch_counts()
    counts.update({f"saga_correct {k}": v for k, v in sc.ROUTE_LAUNCHES.items()})
    counts.update({f"partial_sqdist {k}": v
                   for k, v in wz.SQDIST_ROUTE_LAUNCHES.items()})
    counts.update({f"partial_sqdist {k}": v
                   for k, v in wz.SQDIST_LAYOUT_LAUNCHES.items()})
    counts.update({f"coordinate_median {k}": v
                   for k, v in rs.MEDIAN_LAYOUT_LAUNCHES.items()})
    counts.update({f"trimmed_mean {k}": v
                   for k, v in rs.TRIMMED_LAYOUT_LAUNCHES.items()})
    counts.update({f"masked_neighbor_reduce {k}": v
                   for k, v in tp.ROUTE_LAUNCHES.items()})
    counts.update({f"masked_neighbor_reduce select {k}": v
                   for k, v in tp.SELECT_LAYOUT_LAUNCHES.items()})
    # The bf16 routes' launches, under "<kernel>[ <route>] bf16" (absent when
    # none ran).
    counts.update({f"{k} bf16": v for k, v in ops.bf16_launch_counts().items()})
    return counts


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {', '.join(_build.SOURCES)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if line.strip():
                log(f"  [{name}] {line.strip()}")


def check_saga(torch, w, j, d, gen):
    """K1 vs its plain version on a fresh (w, j, d) table; returns the
    largest absolute difference."""
    from repro_torch.kernels import saga_correct as sc
    dev = torch.device("cuda")
    t_plain = torch.randn((w, j, d), generator=gen, device=dev)
    avg_plain = torch.randn((w, d), generator=gen, device=dev)
    g = torch.randn((w, d), generator=gen, device=dev)
    idx = torch.randint(0, j, (w,), generator=gen, device=dev)
    rows = torch.arange(w, device=dev)
    old_rows = t_plain[rows, idx].clone()
    t_kern, avg_kern = t_plain.clone(), avg_plain.clone()
    msg_k = sc.saga_correct_call(g, t_kern, avg_kern, idx)
    torch.cuda.synchronize()
    assert torch.equal(t_kern[rows, idx], g), "K1: drawn rows != gradient"
    t_kern[rows, idx] = old_rows
    assert torch.equal(t_kern, t_plain), "K1 changed rows other than idx[w]"
    t_kern[rows, idx] = g
    msg_p = sc.saga_correct_plain(g, t_plain, avg_plain, idx)
    torch.cuda.synchronize()
    assert torch.equal(t_kern, t_plain), "K1 table != plain table"
    assert ulps(msg_k, msg_p) <= 1, f"K1 msg off by {ulps(msg_k, msg_p)} ulp"
    assert ulps(avg_kern, avg_plain) <= 1, \
        f"K1 avg off by {ulps(avg_kern, avg_plain)} ulp"
    err = max(float((msg_k - msg_p).abs().max()),
              float((avg_kern - avg_plain).abs().max()))
    del t_plain, t_kern
    torch.cuda.empty_cache()
    return err


def check_weiszfeld(torch, w, d, gen):
    from repro_torch.kernels import weiszfeld as wz
    dev = torch.device("cuda")
    z = torch.randn((w, d), generator=gen, device=dev)
    y = z.mean(0) + 0.1 * torch.randn((d,), generator=gen, device=dev)
    a = torch.rand((w,), generator=gen, device=dev) + 0.5
    ok2, err2 = close(wz.partial_sqdist_call(z, y), wz.partial_sqdist_plain(z, y))
    ok3, err3 = close(wz.weighted_sum_call(z, a), wz.weighted_sum_plain(z, a))
    torch.cuda.synchronize()
    assert ok2, f"K2 partial_sqdist disagrees at {(w, d)}: max err {err2}"
    assert ok3, f"K3 weighted_sum disagrees at {(w, d)}: max err {err3}"
    return err2, err3


def k4_bitwise(w):
    """Whether K4 must give the plain version's bits at ``w`` workers: on
    its network route (W <= NETWORK_CAP) always, past it at odd W (within 1
    ulp at even W)."""
    from repro_torch.kernels import robust_stats as rs
    return w <= rs.NETWORK_CAP or w % 2 == 1


def same_values(a, b) -> bool:
    """Equal values, NaN equal to NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def check_order_stats(torch, w, d, trim, gen, ties=False, infs=False):
    """K4 and K5 vs their plain versions (with ``infs``, +inf and -inf in
    some columns); both give the same bits on a second launch.  On the
    network route (W <= 128) the last 64 columns hold ``trim`` NaN (K5
    finite) and ``trim + 1`` NaN (K5 NaN), and both kernels must put NaN
    and +-inf exactly where the plain versions do; past it K5 is compared
    where the plain version is finite.  Returns the largest absolute
    differences over the finite entries."""
    from repro_torch.kernels import robust_stats as rs
    z = torch.randn((w, d), generator=gen, device="cuda")
    if ties:
        z = torch.round(z * 2.0) / 2.0
    if infs:
        z[: w // 3 + 1, : d // 16] = float("inf")
        z[w // 3 + 1: w // 2 + 1, d // 32: d // 8] = float("-inf")
    network = w <= rs.NETWORK_CAP
    if network:
        z[:trim, d - 64: d - 32] = float("nan")
        z[:trim + 1, d - 32:] = float("nan")
    med_k, med_p = rs.coordinate_median_call(z), rs.coordinate_median_plain(z)
    tm_k, tm_p = rs.trimmed_mean_call(z, trim), rs.trimmed_mean_plain(z, trim)
    torch.cuda.synchronize()
    if k4_bitwise(w):
        assert same_values(med_k, med_p), f"K4 not bitwise at {(w, d)}"
    else:
        assert ulps(med_k, med_p) <= 1, \
            f"K4 off by {ulps(med_k, med_p)} ulp at {(w, d)}"
    assert torch.equal(med_k.view(torch.int32),
                       rs.coordinate_median_call(z).view(torch.int32)), \
        f"K4 gave other bits on a second launch at {(w, d)}"
    assert torch.equal(tm_k.view(torch.int32),
                       rs.trimmed_mean_call(z, trim).view(torch.int32)), \
        f"K5 gave other bits on a second launch at {(w, d)}, trim {trim}"
    fin = torch.isfinite(tm_p)
    if network:
        assert torch.equal(torch.isnan(tm_k), torch.isnan(tm_p)), \
            f"K5 NaN where the plain version has none, or the other way, at {(w, d)}"
        assert bool(torch.isnan(tm_k[d - 32:]).all()), "K5: #NaN > trim is not NaN"
        assert same_values(tm_k[~fin], tm_p[~fin]), f"K5 +-inf differ at {(w, d)}"
    ok5, err5 = close(tm_k[fin], tm_p[fin])
    assert ok5, f"K5 trimmed_mean disagrees at {(w, d)}, trim {trim}: {err5}"
    fin = torch.isfinite(med_p)
    return float((med_k[fin] - med_p[fin]).abs().max()), err5


def device_kernels(torch, fn, tries=3):
    """The names of the kernels the card ran for one call of ``fn``
    (torch.profiler's device records, one per launch).  The profiler now
    and then keeps no device record of a call at all: such an empty trace
    is taken again, up to ``tries`` times; any other is returned as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def check_segments(torch, w, d, boundaries, gen):
    """K6 vs its plain version (coordinates past the last block in none,
    the same bits on three back-to-back launches, one kernel on the card
    per call), and K3 on each block's column slice;
    returns the largest relative-tolerance errors of K6 and K3."""
    from repro_torch.core.geomed import segment_ids
    from repro_torch.kernels import weiszfeld as wz
    z = torch.randn((w, d), generator=gen, device="cuda")
    y = z.mean(0) + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    a = torch.rand((w,), generator=gen, device="cuda") + 0.5
    seg = segment_ids(tuple(boundaries), d, torch.device("cuda"))
    nseg = len(boundaries)
    runs = [wz.partial_sqdist_segments_call(z, y, seg, nseg) for _ in range(3)]
    got = runs[0]
    ok6, err6 = close(got, wz.partial_sqdist_segments_plain(z, y, seg, nseg))
    assert ok6, f"K6 partial_sqdist_segments disagrees at {(w, d)}: {err6}"
    assert all(torch.equal(r.view(torch.int32), got.view(torch.int32))
               for r in runs[1:]), "K6 gave other bits on back-to-back launches"
    names = device_kernels(torch, lambda: wz.partial_sqdist_segments_call(z, y, seg, nseg))
    assert len(names) == 1 and "sqdist_segments_kernel" in names[0], \
        f"K6 ran {names} for one call, not one kernel"
    err3 = 0.0
    for lo, hi in boundaries:
        ok3, e = close(wz.weighted_sum_call(z[:, lo:hi], a),
                       wz.weighted_sum_plain(z[:, lo:hi].contiguous(), a))
        assert ok3, f"K3 on the slice [{lo}, {hi}) disagrees: {e}"
        err3 = max(err3, e)
    torch.cuda.synchronize()
    return err6, err3


def table1_boundaries(torch):
    """The Table I network's four leaves in the packed buffer (b1, b2, w1,
    w2 in sorted-name order) -> ((start, stop), ...), D."""
    from repro_torch.core import packing
    from repro_torch.models import paper_nn
    spec = packing.pack_spec(paper_nn.init_params(SEED, device="cuda"),
                             batch_ndim=0)
    return spec.boundaries, spec.padded_dim


def phase_kernel_checks(torch):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = dict.fromkeys(KERNEL_SOURCES, 0.0)
    bounds_b, d_b = table1_boundaries(torch)
    for (w, j, d), (wm, dm) in [((7, 3, 300), (7, 300)),
                                ((50, 1200, 39760), (70, 39760))]:
        e1 = check_saga(torch, w, j, d, gen)
        e2, e3 = check_weiszfeld(torch, wm, dm, gen)
        errs["saga_correct"] = max(errs["saga_correct"], e1)
        errs["partial_sqdist"] = max(errs["partial_sqdist"], e2)
        errs["weighted_sum"] = max(errs["weighted_sum"], e3)
        log(f"kernel check table ({w}, {j}, {d}) / messages ({wm}, {dm}): "
            f"K1 max|err| {e1:.3g} (<= 1 ulp, other rows untouched), "
            f"K2 {e2:.3g}, K3 {e3:.3g} (rtol 1e-5): ok")
    # Ragged: W = 7 and 8, D = 300, three blocks and 20 coordinates in none.
    # Workload B: (70, 39,760), the Table I network's four leaves; Fig. 6's
    # trim of 20 at W = 70.
    assert d_b == 39760, d_b
    for w, d, trim, bounds in [(7, 300, 2, ((0, 100), (100, 220), (220, 280))),
                               (8, 300, 3, ((0, 100), (100, 220), (220, 280))),
                               (70, d_b, 20, bounds_b)]:
        e4, e5 = check_order_stats(torch, w, d, trim, gen)
        e6, e3 = check_segments(torch, w, d, bounds, gen)
        errs["coordinate_median"] = max(errs["coordinate_median"], e4)
        errs["trimmed_mean"] = max(errs["trimmed_mean"], e5)
        errs["partial_sqdist_segments"] = max(errs["partial_sqdist_segments"], e6)
        errs["weighted_sum"] = max(errs["weighted_sum"], e3)
        log(f"kernel check messages ({w}, {d}), blocks {list(bounds)}: "
            f"K4 max|err| {e4:.3g} ({'bitwise' if k4_bitwise(w) else '<= 1 ulp'}), "
            f"K5 (trim {trim}) {e5:.3g} (network route: NaN in columns of trim + 1 "
            f"NaN, finite with trim; same bits twice), K6 {e6:.3g} (same bits three times, one "
            f"kernel a call), "
            f"K3 on column slices {e3:.3g} (rtol 1e-5): ok")
    # K4 and K5 at their network route's cap and one past it (the rank
    # count), with and without ties, +-inf in some columns (and NaN on the
    # network route).
    from repro_torch.kernels import robust_stats as rs
    for w in (rs.NETWORK_CAP - 1, rs.NETWORK_CAP, rs.NETWORK_CAP + 1):
        for ties in (False, True):
            e4, e5 = check_order_stats(torch, w, d_b, (w - 1) // 2, gen, ties, infs=True)
            errs["coordinate_median"] = max(errs["coordinate_median"], e4)
            errs["trimmed_mean"] = max(errs["trimmed_mean"], e5)
        log(f"kernel check messages ({w}, {d_b}) with and without ties, +-inf "
            f"{'and NaN ' if w <= rs.NETWORK_CAP else ''}in columns: K4 max|err| {e4:.3g} "
            f"({'bitwise' if k4_bitwise(w) else '<= 1 ulp'}, same bits twice; "
            f"{'network' if w <= rs.NETWORK_CAP else 'rank count'} route), "
            f"K5 (trim {(w - 1) // 2}) {e5:.3g} (rtol 1e-5, same bits twice): ok")
    # K4/K5 past 454 workers (ranks counted from global memory), K2/K3 past
    # 12,288 rows (K3 compacts its weights 2,048 at a time).
    for w, d, trim in [(455, d_b, 100), (1000, d_b, 333), (5000, 1000, 2499)]:
        for ties in (False, True):
            e4, e5 = check_order_stats(torch, w, d, trim, gen, ties)
            errs["coordinate_median"] = max(errs["coordinate_median"], e4)
            errs["trimmed_mean"] = max(errs["trimmed_mean"], e5)
        log(f"kernel check messages ({w}, {d}) with and without ties: K4 max|err| "
            f"{e4:.3g} ({'bitwise' if k4_bitwise(w) else '<= 1 ulp'}), K5 (trim {trim}) "
            f"{e5:.3g} (rtol 1e-5): ok")
    e2, e3 = check_weiszfeld(torch, 12_289, 4_000, gen)
    errs["partial_sqdist"] = max(errs["partial_sqdist"], e2)
    errs["weighted_sum"] = max(errs["weighted_sum"], e3)
    log(f"kernel check messages (12289, 4000): K2 max|err| {e2:.3g}, K3 {e3:.3g} "
        "(rtol 1e-5): ok")
    mask_d = workload_d_graph(torch)[1]
    for (r, s_, d), ties, trims, mask in [
            ((7, 7, 300), True, (0, 1, 2), None),
            ((70, 70, d_b), False, (0, 12), mask_d),
            ((4, 451, 1000), True, (0, 1, 12, 16, 17, None), None),
            ((4, 1000, 1000), False, (0, 1, 12, 16, 17, None), None),
            ((4, 2048, 300), True, (0, 1, 12, 16, 17, None), None)]:
        e7, e7s, e2, e2m, e3 = check_masked(torch, r, s_, d, ties, trims, mask, gen)
        errs["masked_neighbor_reduce"] = max(errs["masked_neighbor_reduce"], e7)
        errs["masked_neighbor_reduce sum"] = max(errs["masked_neighbor_reduce sum"], e7s)
        errs["partial_sqdist"] = max(errs["partial_sqdist"], e2)
        errs["partial_sqdist masked"] = max(errs["partial_sqdist masked"], e2m)
        errs["weighted_sum"] = max(errs["weighted_sum"], e3)
        log(f"kernel check exchange ({r}, {s_}, {d}){' with ties' if ties else ''}"
            f", trim {list(trims)} (None: (n - 1) // 2): K7 max|err| {e7:.3g} "
            f"(trim 0: {e7s:.3g}), batched K2 {e2:.3g}, masked K2 {e2m:.3g} "
            f"(0 off the mask, same bits twice), batched K3 {e3:.3g} (rtol 1e-5): ok")
    return errs


def check_masked(torch, r, s, d, ties, trims, mask, gen):
    """K7 and the receiver-batched K2 (both routes) and K3 against their
    plain versions on an (r, s, d) exchange under ``mask`` (a random 0/1
    mask keeping 5 senders when None); a trim of None is (n - 1) // 2 for
    the smallest neighbourhood n.  Returns the largest absolute differences
    of K7 (every trim, and trim 0 alone), K2 unmasked and masked, and K3."""
    from repro_torch.kernels import topology as tp
    from repro_torch.kernels import weiszfeld as wz
    ex = torch.randn((r, s, d), generator=gen, device="cuda")
    if ties:
        ex = torch.round(ex * 2.0) / 2.0
    if mask is None:
        mask = (torch.rand((r, s), generator=gen, device="cuda") < 0.6).float()
        mask[:, :5] = 1.0
    e7 = e7s = 0.0
    for trim in trims:
        trim = int(mask.sum(1).min() - 1) // 2 if trim is None else trim
        got = tp.masked_neighbor_reduce_call(ex, mask, trim)
        ok, e = close(got, tp.masked_neighbor_reduce_plain(ex, mask, trim))
        assert ok, f"K7 disagrees at {(r, s, d)}, trim {trim}: {e}"
        assert torch.equal(got, tp.masked_neighbor_reduce_call(ex, mask, trim)), \
            f"K7 gave other bits on a second run at {(r, s, d)}, trim {trim}"
        e7 = max(e7, e)
        e7s = e if trim == 0 else e7s
    y = tp.masked_neighbor_reduce_call(ex, mask, 0)
    inv = mask / torch.clamp(torch.sqrt(wz.partial_sqdist_plain(ex, y)), min=1e-8)
    ok2, e2 = close(wz.partial_sqdist_call(ex, y), wz.partial_sqdist_plain(ex, y))
    sq = wz.partial_sqdist_call(ex, y, mask)
    ok2m, e2m = close(sq, wz.partial_sqdist_plain(ex, y, mask))
    ok3, e3 = close(wz.weighted_sum_call(ex, inv), wz.weighted_sum_plain(ex, inv))
    torch.cuda.synchronize()
    assert ok2, f"batched K2 disagrees at {(r, s, d)}: {e2}"
    assert ok2m, f"masked K2 disagrees at {(r, s, d)}: {e2m}"
    assert torch.equal(sq, torch.where(mask > 0, sq, 0.0)), "masked K2: not 0 off the mask"
    assert torch.equal(sq, wz.partial_sqdist_call(ex, y, mask)), \
        "masked K2 gave other bits on a second run"
    assert ok3, f"batched K3 disagrees at {(r, s, d)}: {e3}"
    del ex
    torch.cuda.empty_cache()
    return e7, e7s, e2, e2m, e3


def run_steps(torch, step_fn, state, steps):
    """Run ``steps`` steps; returns the state and per-step seconds."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times, metrics


def device_events(prof):
    """The kernel-level (device) events of a torch.profiler trace; the
    CPU-side ops that launched them are left out, so nothing counts twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_steps(torch, label, step_fn, state, steps, median_s):
    """Trace ``steps`` steps with torch.profiler: device time by kernel, and
    the device's idle share against the untraced median step time
    ``median_s`` (the tracer slows the host, so its own wall time is
    printed but not used).  Returns the state and the device busy time a
    step (us)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step_fn(state)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    events = sorted(device_events(prof), key=lambda e: e.self_device_time_total,
                    reverse=True)
    busy_us = sum(e.self_device_time_total for e in events) / steps
    log(f"profile {label}: device busy {busy_us:.1f} us/step, untraced median "
        f"step {median_s * 1e6:.1f} us, idle share {1 - busy_us / (median_s * 1e6):.3f} "
        f"(traced wall {wall_us:.1f} us/step)")
    for e in events[:10]:
        log(f"  {e.self_device_time_total / steps:9.1f} us/step "
            f"{e.count / steps:7.1f} calls/step  {e.key[:80]}")
    return state, busy_us


def logreg_cell(torch, label, loss, batch, wd, *, vr, agg, lr, steps,
                f_star=None):
    """One sign_flip run of the master step on a logistic regression (20
    Byzantine workers): ``steps`` steps with the launch counts reset just
    before and read just after, asserted for ``vr`` and ``agg`` (K1 on
    every step for saga and never otherwise; K2 and K3 for geomed, never
    the masked K2); then a 20-step profile.  mean is driven uphill by
    sign_flip; geomed with saga or minibatch (50 samples a worker) lowers
    the loss.  Returns a summary."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.kernels import ops
    from repro_torch.optim import get_optimizer
    cfg = RobustConfig(aggregator=agg, vr=vr, attack="sign_flip",
                       num_byzantine=20, minibatch_size=50)
    init_fn, step_fn = make_federated_step(
        loss, wd, cfg, get_optimizer("sgd", lr), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    st = init_fn({"w": torch.zeros(wd["a"].shape[-1], device="cuda")}, SEED)
    f0 = float(loss(st.params, batch))
    ops.reset_launch_counts()
    st, times, metrics = run_steps(torch, step_fn, st, steps)
    counts = launch_counts()
    f1 = float(loss(st.params, batch))
    peak = torch.cuda.max_memory_allocated()
    iters = counts["partial_sqdist"] / steps
    median_s = statistics.median(times)
    table = (f", SAGA table {tuple(st.vr.table.shape)} = "
             f"{st.vr.table.numel() * 4 / 1e6:.1f} MB" if vr == "saga" else "")
    gap = f" (gap {f1 - f_star:.6f})" if f_star is not None else ""
    log(f"{label}: loss {f0:.6f} -> {f1:.6f}{gap} after {steps} steps, "
        f"median step {median_s * 1e3:.3f} ms, peak memory {peak / 1e6:.1f} MB, "
        f"Weiszfeld iters/step {iters:.2f}, honest variance "
        f"{float(metrics['honest_variance']):.6g}{table}, launches {counts}")
    st, busy_us = profile_steps(torch, label, step_fn, st, 20, median_s)
    assert math.isfinite(f1), f"{label}: loss is not finite"
    assert counts["partial_sqdist masked"] == 0, counts
    assert counts["saga_correct"] == (steps if vr == "saga" else 0), counts
    if agg == "geomed":
        assert counts["partial_sqdist"] == counts["weighted_sum"] >= steps, counts
        if vr != "sgd":
            assert f1 < f0, f"{label}: geomed did not lower the loss"
    else:
        assert counts["partial_sqdist"] == counts["weighted_sum"] == 0, counts
        assert f1 > f0, f"{label}: mean was not driven uphill by sign_flip"
    summary = dict(step_ms=median_s * 1e3, busy_us=busy_us,
                   idle=1 - busy_us / (median_s * 1e6), iters=iters,
                   peak_mb=peak / 1e6, loss=f1)
    del st
    torch.cuda.empty_cache()
    return summary


def phase_workload_a(torch):
    """Workload A: SAGA (the main path) and BSGD, each with geomed and mean;
    then C1 and the card against the CPU."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    from repro_torch.optim import get_optimizer
    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=49_990, device="cuda")
    batch = {"a": data.x, "b": data.y}
    wd = partition(batch, 50, seed=1, samples_per_worker=999, device="cuda")
    for vr, lr, prefix in (("saga", 0.02, "workload A"),
                           ("minibatch", 0.01, "workload A BSGD")):
        for agg in ("geomed", "mean"):
            logreg_cell(torch, f"{prefix} {agg}", loss, batch, wd, vr=vr,
                        agg=agg, lr=lr, steps=300)

    # C1 of tests/test_convergence.py: mean fails, geomed survives.
    data = ijcnn1_like(SEED, n=960, device="cuda")
    batch = {"a": data.x, "b": data.y}
    _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
    wd = partition(batch, 12, seed=1, device="cuda")
    for attack in ("gaussian", "sign_flip", "zero_gradient"):
        gaps = {}
        for agg in ("mean", "geomed"):
            cfg = RobustConfig(aggregator=agg, vr="saga", attack=attack,
                               num_byzantine=5)
            init_fn, step_fn = make_federated_step(
                loss, wd, cfg, get_optimizer("sgd", 0.02), device="cuda")
            st, _, _ = run_steps(torch, step_fn,
                                 init_fn({"w": torch.zeros(22, device="cuda")}, 7),
                                 700)
            gaps[agg] = float(loss(st.params, batch)) - f_star
        log(f"C1 {attack}: gap geomed {gaps['geomed']:.5f} (< 0.1), "
            f"mean {gaps['mean']:.5f} (> 3x geomed)")
        assert gaps["geomed"] < 0.1, f"C1 {attack}: geomed gap {gaps['geomed']}"
        assert gaps["mean"] > 3 * gaps["geomed"], f"C1 {attack}: {gaps}"

    # The card's step against the plain CPU path, same state and draws: SAGA
    # with one sample a worker, BSGD with 20.
    for vr, shape in (("saga", (12,)), ("minibatch", (12, 20))):
        cfg = RobustConfig(aggregator="geomed", vr=vr, attack="zero_gradient",
                           num_byzantine=5, minibatch_size=20)
        runs = {}
        for dev in ("cuda", "cpu"):
            init_fn, step_fn = make_federated_step(
                loss, {k: v.cpu() for k, v in wd.items()}, cfg,
                get_optimizer("sgd", 0.02), device=dev)
            st = init_fn({"w": torch.zeros(22)}, 0)
            draws = torch.Generator().manual_seed(3)
            for _ in range(20):
                st, _ = step_fn(st, sample_idx=torch.randint(0, 80, shape,
                                                             generator=draws))
            runs[dev] = st.params["w"].cpu()
        torch.testing.assert_close(runs["cuda"], runs["cpu"], rtol=1e-4, atol=1e-5)
        log(f"20 {vr} steps on the card agree with the plain CPU path "
            f"(max|diff| {float((runs['cuda'] - runs['cpu']).abs().max()):.3g}, "
            "rtol 1e-4, atol 1e-5)")


def phase_workload_f(torch):
    """Workload F: covtype at the real set's size (581,012 x 54), 50 honest
    workers x 11,620 samples on an iid partition + 20 Byzantine, sign_flip,
    rho = 0.01; SGD, BSGD (50 samples a worker) and SAGA at ALGOS' learning
    rates, each with mean and geomed, 300 steps; a table of the runs."""
    from repro_torch.data import (covtype_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    loss = logreg_loss(0.01)
    t0 = time.perf_counter()
    data = covtype_like(SEED, n=F_N, device="cuda")
    batch = {"a": data.x, "b": data.y}
    _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
    wd = partition(batch, F_WORKERS, seed=1, samples_per_worker=F_N // F_WORKERS,
                   device="cuda")
    torch.cuda.synchronize()
    log(f"workload F: covtype_like ({F_N:,} x {data.x.shape[1]}), {F_WORKERS} honest "
        f"workers x {F_N // F_WORKERS:,} samples + {F_BYZ} Byzantine, sign_flip, "
        f"f* {f_star:.6f}; data, f* and partition in {time.perf_counter() - t0:.1f} s")
    summaries = {}
    for label, vr, lr in ALGOS:
        for agg in ("mean", "geomed"):
            run = f"F {label} {agg}"
            summaries[run] = logreg_cell(
                torch, f"workload {run}", loss, batch, wd, vr=vr, agg=agg,
                lr=lr, steps=F_STEPS, f_star=f_star)
    log(f"workload F per run: step ms / device busy us / idle share / Weiszfeld "
        "iters per step / peak MB / loss after")
    for run, r in summaries.items():
        log(f"  {run:<17} {r['step_ms']:9.3f} {r['busy_us']:9.1f} {r['idle']:7.3f} "
            f"{r['iters']:7.2f} {r['peak_mb']:9.1f} {r['loss']:10.6f}")
    del data, batch, wd
    torch.cuda.empty_cache()


def vr_tables(vr):
    """The SAGA tables of a packed state (one) or a per-leaf state (one a
    leaf)."""
    return [s.table for s in vr.values()] if isinstance(vr, dict) else [vr.table]


def phase_workload_b(torch, agg, steps=20, wire="float32", packed=True):
    """Workload B with rule ``agg`` on the ``wire`` message format (with
    ``packed=False`` the per-leaf baseline, each kernel once per leaf): 20
    steps with the launch counts reset just before and read just after,
    asserted against the rule's kernels (on the bf16 wire, every launch on
    the bf16 routes); then a 3-step profile.  Returns (counts, state,
    summary)."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.data import mnist_like, partition
    from repro_torch.kernels import ops
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    torch.cuda.reset_peak_memory_stats()
    data = mnist_like(SEED, n=60_000, device="cuda")
    batch = {"x": data.x, "y": data.y}
    wd = partition(batch, 50, seed=2, device="cuda")
    cfg = RobustConfig(aggregator=agg, vr="saga", attack="sign_flip",
                       num_byzantine=20, trim=20, num_groups=5,
                       message_dtype=wire, packed=packed)
    init_fn, step_fn = make_federated_step(
        paper_nn.nn_loss, wd, cfg, get_optimizer("sgd", 0.1), device="cuda")
    t0 = time.perf_counter()
    st = init_fn(paper_nn.init_params(SEED + 7, device="cuda"), 5)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tables = vr_tables(st.vr)
    leaves = len(tables)                 # launches a step of each kernel
    w, j = tables[0].shape[:2]
    d = sum(t.shape[-1] for t in tables)
    table_gb = sum(t.numel() * t.element_size() for t in tables) / 1e9
    tag = ("" if wire == "float32" else f" {wire}") + ("" if packed else " per-leaf")
    log(f"workload B{tag}: SAGA table ({w}, {j}, {d}) = "
        f"{table_gb:.2f} GB filled worker by worker in "
        f"{t_init:.2f} s")
    with torch.no_grad():
        f0 = float(paper_nn.nn_loss(st.params, batch))
    ops.reset_launch_counts()
    st, times, metrics = run_steps(torch, step_fn, st, steps)
    counts = launch_counts()
    with torch.no_grad():
        f1 = float(paper_nn.nn_loss(st.params, batch))
    peak = torch.cuda.max_memory_allocated()
    acc = paper_nn.accuracy(st.params, batch)
    log(f"workload B{tag} {agg}/sign_flip: loss {f0:.6f} -> {f1:.6f} after {steps} "
        f"steps, accuracy {acc:.4f}, "
        f"median step {statistics.median(times) * 1e3:.3f} ms, peak memory "
        f"{peak / 1e9:.2f} GB, honest variance "
        f"{float(metrics['honest_variance']):.6g}, launches {counts}")
    st, busy_us = profile_steps(torch, f"workload B{tag} {agg}", step_fn, st, 3,
                                statistics.median(times))
    assert math.isfinite(f1), "workload B: loss is not finite"
    assert all(bool(torch.isfinite(p).all()) for p in st.params.values())
    ran = {k: counts[k] for k in RULE_KERNELS[agg]}
    assert min(ran.values()) > 0, f"workload B {agg}: a kernel never ran: {counts}"
    assert counts["partial_sqdist masked"] == 0, counts
    assert counts["saga_correct"] == leaves * steps, counts
    if agg in ("median", "centered_clip"):
        assert counts["coordinate_median"] == leaves * steps, counts
    if agg == "trimmed_mean":
        assert counts["trimmed_mean"] == leaves * steps, counts
    if agg in ("geomed", "geomed_groups"):
        assert counts["partial_sqdist"] == counts["weighted_sum"], counts
        assert counts["partial_sqdist"] % leaves == 0, counts
    if agg == "geomed_blockwise" and packed:
        assert counts["partial_sqdist_segments"] >= steps, counts
        assert counts["partial_sqdist"] == 0, counts
    bf16 = wire == "bfloat16"
    assert tables[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    for k in RULE_KERNELS[agg]:   # the bf16 wire launches only the bf16 routes
        assert counts.get(f"{k} bf16", 0) == (counts[k] if bf16 else 0), counts
    # K2 in one launch (its cluster layout) and K4 two columns a thread (its
    # pairs layout) on every bf16 launch of B's (70, 39,760) messages, never
    # in float32.
    assert counts["partial_sqdist cluster"] == (counts["partial_sqdist"] if bf16 else 0)
    assert counts["coordinate_median pairs"] == (counts["coordinate_median"] if bf16 else 0)
    if bf16 and agg == "median":
        assert counts["coordinate_median pairs"] == steps, counts
    # K5 too: two columns a thread on every bf16 launch at B's shape.
    assert counts["trimmed_mean pairs"] == (counts["trimmed_mean"] if bf16 else 0)
    if bf16 and agg == "trimmed_mean":
        assert counts["trimmed_mean pairs"] == steps, counts
    summary = dict(step_ms=statistics.median(times) * 1e3, peak_gb=peak / 1e9,
                   loss=f1, accuracy=acc, table_gb=table_gb, busy_us=busy_us,
                   idle=1 - busy_us / (statistics.median(times) * 1e6),
                   iters=counts["partial_sqdist"] / steps / leaves)
    return counts, st, summary


def device_ms(torch, fn, reps):
    """Device time per call of ``fn``: the durations of the kernels (and
    copies) it launched, from a torch.profiler trace of ``reps`` calls after
    a warm-up.  Host launch overhead is not in it.  Where the trace holds no
    device time (torch.profiler now and then returns no kernel records in
    this long process), CUDA events time the same calls (:func:`event_ms`)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in device_events(prof))
    if total_us <= 0:
        log("torch.profiler recorded no device time; timing with CUDA events")
        return event_ms(torch, fn, reps)
    return total_us / reps / 1e3


def kernel_split(torch, fn, reps):
    """Each kernel's device time per call of ``fn`` (torch.profiler, ``reps``
    calls after a warm-up), by the kernel's name up to its argument list:
    {name: us}."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]:
            e.self_device_time_total / reps for e in device_events(prof)}


def event_ms(torch, fn, reps):
    """Device time per call of ``fn`` from two CUDA events around ``reps``
    calls after a warm-up.  The calls are queued behind a sleep kernel that
    outlasts their enqueueing, so the card runs them back to back whatever
    the host's speed; raises if the card reached the first call before the
    host had queued the last (the host, not the card, would then set the
    pace).  (torch.profiler's kernel records came back incomplete late in
    this script's long process; events count them all.)"""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Sleep 4x the calls' enqueue time, 20 ms to 2 s (cycles at up to 2 GHz).
    torch.cuda._sleep(int(2e9 * min(2.0, max(0.02, 4 * reps * host_s))))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    queued_ahead = not start.query()
    end.record()
    end.synchronize()
    total_ms = start.elapsed_time(end)
    if not queued_ahead:
        raise RuntimeError(f"event timing is host-bound: the card finished the sleep "
                           f"before {reps} calls were queued ({host_ms:.3f} ms of "
                           f"enqueueing, {total_ms:.3f} ms on the card)")
    return total_ms / reps


def sm_clock(torch):
    """(SMs, top SM clock in MHz) of card 0, for the instruction floors:
    64 min/max results a clock on each SM at the top clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return sms, mhz


def select_floor_ms(torch, mask, trim, d, coords):
    """K7 "select"'s instruction floor: the integer min/max it runs for each
    receiver's members (topology.select_minmax_ops), a key word of
    ``coords`` coordinates (1 in float32, 2 in bf16's pairs layout), over
    ceil(d / coords) words a receiver, at 64 a clock on each SM."""
    from repro_torch.kernels import topology as tp
    sms, mhz = sm_clock(torch)
    ops = sum(tp.select_minmax_ops(int(n), trim) for n in (mask > 0).sum(1).tolist())
    return ops * -(-d // coords) / (sms * 64 * mhz * 1e6) * 1e3, ops


def bound(nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    b, f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def phase_timing(torch, state):
    from repro_torch.core.geomed import segment_ids, weiszfeld_flat
    from repro_torch.kernels import robust_stats as rs
    from repro_torch.kernels import saga_correct as sc
    from repro_torch.kernels import weiszfeld as wz
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    table, avg = state.vr.table, state.vr.avg
    w, j, d = table.shape
    g = 0.01 * torch.randn((w, d), generator=gen, device="cuda")
    # A fresh draw of rows for every call, as in a step: the 50 rows read
    # and written are cold in L2 (the table is 9.5 GB); room for device_ms's
    # event fallback too.
    reps = 50
    draws = iter([torch.randint(0, j, (w,), generator=gen, device="cuda")
                  for _ in range(4 * (reps + 3))])
    out = {}
    b, by = bound(6 * w * d * 4 + w * 8, 4 * w * d)
    out["saga_correct"] = dict(
        ms=device_ms(torch, lambda: sc.saga_correct_call(g, table, avg, next(draws)),
                     reps),
        plain_ms=device_ms(
            torch, lambda: sc.saga_correct_plain(g, table, avg, next(draws)), reps),
        bound_ms=b, bound_by=by, library_ms=None)
    wm = w + 20
    z = 0.01 * torch.randn((wm, d), generator=gen, device="cuda")
    y = z.mean(0)
    a = torch.rand((wm,), generator=gen, device="cuda") + 0.5
    b, by = bound(wm * d * 4 + d * 4 + wm * 4, 3 * wm * d)
    out["partial_sqdist"] = dict(
        ms=device_ms(torch, lambda: wz.partial_sqdist_call(z, y), 200),
        plain_ms=device_ms(torch, lambda: wz.partial_sqdist_plain(z, y), 200),
        bound_ms=b, bound_by=by, library_ms=None)
    b, by = bound(wm * d * 4 + wm * 4 + d * 4, 2 * wm * d)
    out["weighted_sum"] = dict(
        ms=device_ms(torch, lambda: wz.weighted_sum_call(z, a), 200),
        plain_ms=device_ms(torch, lambda: wz.weighted_sum_plain(z, a), 200),
        bound_ms=b, bound_by=by,
        library_ms=device_ms(torch, lambda: torch.matmul(a, z), 200))
    # K4, K5: read z once, write (D,); at least one comparison per element.
    b, by = bound(wm * d * 4 + d * 4, wm * d)
    out["coordinate_median"] = dict(
        ms=device_ms(torch, lambda: rs.coordinate_median_call(z), 200),
        plain_ms=device_ms(torch, lambda: rs.coordinate_median_plain(z), 200),
        bound_ms=b, bound_by=by,
        library_ms=device_ms(torch, lambda: torch.quantile(z, 0.5, dim=0), 200))
    out["trimmed_mean"] = dict(
        ms=device_ms(torch, lambda: rs.trimmed_mean_call(z, 20), 200),
        plain_ms=device_ms(torch, lambda: rs.trimmed_mean_plain(z, 20), 200),
        bound_ms=b, bound_by=by, library_ms=None)
    # K6: z, y and the int32 ids read once, (W, L) written; 3 flops per element.
    bounds_b, _ = table1_boundaries(torch)
    seg = segment_ids(tuple(bounds_b), d, torch.device("cuda"))
    nseg = len(bounds_b)
    b, by = bound(wm * d * 4 + 2 * d * 4 + wm * nseg * 4, 3 * wm * d)
    out["partial_sqdist_segments"] = dict(
        ms=device_ms(torch, lambda: wz.partial_sqdist_segments_call(z, y, seg, nseg), 200),
        plain_ms=device_ms(
            torch, lambda: wz.partial_sqdist_segments_plain(z, y, seg, nseg), 200),
        bound_ms=b, bound_by=by, library_ms=None)
    for name, r in out.items():
        log(f"timing {name} (device time): {r['ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us"
            + (f", library {r['library_ms'] * 1e3:.2f} us" if r["library_ms"] else ""))
    # K4's and K5's network route beside its bytes bound and its instruction
    # floor: the float min/max a coordinate that the network needs at W, at
    # 64 results a clock per SM (half the float32 FMA rate) and the card's
    # top SM clock.
    sms, mhz = sm_clock(torch)
    for name, n_minmax, what in (
            ("coordinate_median", rs.median_network_ops(wm), "the ranks read"),
            ("trimmed_mean", rs.trimmed_network_ops(wm), "every rank, trim 20")):
        r = out[name]
        floor_ms = n_minmax * d / (sms * 64 * mhz * 1e6) * 1e3
        log(f"timing {name} network route (W={wm} <= {rs.NETWORK_CAP}, "
            f"{rs.median_network_pairs(wm)[0]} wires): {r['ms'] * 1e3:.2f} us, "
            f"{r['bound_ms'] / r['ms']:.0%} of its bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}, {(wm * d * 4 + d * 4) / 1e6:.1f} MB at 3.35 TB/s); "
            f"instruction floor {floor_ms * 1e3:.2f} us ({n_minmax} float min/max a "
            f"coordinate for {what} x {d} coordinates / ({sms} SMs x 64 a clock x "
            f"{mhz:.0f} MHz), against {wm * wm} comparisons a coordinate for the "
            f"rank count)")
    # The Weiszfeld loop as the step runs it: K2, (W,)-sized ops, K3 and the
    # host read of the stop test, per iteration.
    iters = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        weiszfeld_flat(z, max_iters=iters, tol=0.0)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / (reps * iters)
    log(f"timing weiszfeld_flat ({wm}, {d}): {per_iter * 1e6:.1f} us per "
        "iteration on the host clock (K2 + K3 + torch ops + one host sync)")
    return out


def federated_run(torch, loss, wd, steps, seed, lr=0.02, **cfg):
    """``steps`` steps of the master step on the card from w = 0 (sgd at
    ``lr``); returns the final params and the per-step host seconds."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.optim import get_optimizer
    init_fn, step_fn = make_federated_step(
        loss, wd, RobustConfig(**cfg), get_optimizer("sgd", lr), device="cuda")
    st = init_fn({"w": torch.zeros(wd["a"].shape[-1], device="cuda")}, seed)
    st, times, _ = run_steps(torch, step_fn, st, steps)
    return st.params, times


def phase_fig6(torch):
    """Paper Fig. 6 at workload A's scale: every rule under each attack."""
    from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=49_990, device="cuda")
    batch = {"a": data.x, "b": data.y}
    _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
    wd = partition(batch, 50, seed=1, samples_per_worker=999, device="cuda")
    gaps, step_ms = {}, {}
    t0 = time.perf_counter()
    for attack in FIG6_ATTACKS:
        b = 0 if attack == "none" else 20
        for agg in FIG6_RULES:
            params, times = federated_run(
                torch, loss, wd, 300, 11, aggregator=agg, vr="saga",
                attack=attack, num_byzantine=b, num_groups=5,
                trim=min(b, (50 + b) // 2 - 1) or 1)
            gaps[attack, agg] = float(loss(params, batch)) - f_star
            step_ms[attack, agg] = statistics.median(times) * 1e3
    log(f"Fig. 6 at workload A's scale (ijcnn1_like n=49,990, 50 + 20 "
        f"workers, D=22, SAGA, 300 steps, f* {f_star:.6f}) in "
        f"{time.perf_counter() - t0:.1f} s; optimality gap:")
    log("  " + f"{'attack':<14}" + "".join(f"{a:>17}" for a in FIG6_RULES))
    for attack in FIG6_ATTACKS:
        log("  " + f"{attack:<14}"
            + "".join(f"{gaps[attack, a]:>17.6f}" for a in FIG6_RULES))
    log("  median step (ms):")
    for attack in FIG6_ATTACKS:
        log("  " + f"{attack:<14}"
            + "".join(f"{step_ms[attack, a]:>17.3f}" for a in FIG6_RULES))
    assert all(math.isfinite(g) for g in gaps.values()), gaps
    assert gaps["sign_flip", "mean"] > gaps["sign_flip", "geomed"], \
        "Fig. 6: sign_flip did not hurt mean more than geomed"
    return gaps


def grid_table(title, values, runs, fmt):
    log(title)
    log("  " + f"{'attack':<14}" + "".join(f"{r:>13}" for r in runs))
    for attack in GRID_ATTACKS:
        log("  " + f"{attack:<14}" + "".join(format(values[attack, r], fmt).rjust(13)
                                             for r in runs))


def phase_paper_grids(torch):
    """The grids of benchmarks/fig3_ijcnn1.py, fig4_covtype.py,
    fig5_zero_outer.py and table1_nn.py at those scripts' sizes (25 honest
    + 10 Byzantine workers on 2,000 samples; Fig. 5 every worker the same
    400; Table I 10 + 4 workers on 1,500 blob images, 500 held out) and
    GRID_STEPS' steps: each attack x solver (x mean and geomed but in Fig.
    5), the optimality gap (Table I: test accuracy) as a table.  Asserts the
    orderings of GRID_ORDERINGS, which the reference's benchmarks show at the
    same sizes and steps on the CPU."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.data import (covtype_like, ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, mnist_like, partition)
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    loss = logreg_loss(0.01)
    values = {}
    t_all = time.perf_counter()
    for fig, make, replicated in (("fig3", ijcnn1_like, False),
                                  ("fig4", covtype_like, False),
                                  ("fig5", ijcnn1_like, True)):
        t0 = time.perf_counter()
        data = make(SEED, n=400 if replicated else 2000, device="cuda")
        batch = {"a": data.x, "b": data.y}
        _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
        wd = partition(batch, 25, mode="replicated" if replicated else "iid",
                       seed=1, device="cuda")
        gaps = {}
        aggs = ("geomed",) if replicated else ("mean", "geomed")
        runs = [f"{label}-{agg}" for label, _, _ in ALGOS for agg in aggs]
        for attack in GRID_ATTACKS:
            for label, vr, lr in ALGOS:
                for agg in aggs:
                    params, _ = federated_run(
                        torch, loss, wd, GRID_STEPS[fig], 11,
                        lr=lr * 0.5 if replicated else lr, aggregator=agg, vr=vr,
                        attack=attack, num_byzantine=0 if attack == "none" else 10,
                        minibatch_size=50)
                    gaps[attack, f"{label}-{agg}"] = float(loss(params, batch)) - f_star
        assert all(math.isfinite(g) for g in gaps.values()), gaps
        values[fig] = gaps
        grid_table(f"{fig} ({'replicated ' if replicated else ''}{make.__name__} "
                   f"n={data.x.shape[0]}, 25 + 10 workers, {GRID_STEPS[fig]} steps, "
                   f"f* {f_star:.6f}) in {time.perf_counter() - t0:.1f} s; "
                   "optimality gap:", gaps, runs, ".5f")
    t0 = time.perf_counter()
    train = mnist_like(SEED, n=1500, device="cuda")
    test = mnist_like(SEED + 1, n=500, device="cuda")
    wd = partition({"x": train.x, "y": train.y}, 10, seed=2, device="cuda")
    test_batch = {"x": test.x, "y": test.y}
    acc = {}
    runs = [f"{label}-{agg}" for label, _, _ in ALGOS for agg in ("mean", "geomed")]
    for attack in GRID_ATTACKS:
        # table1_nn.py's learning rates.
        for label, vr, lr in (("SGD", "sgd", 0.1), ("BSGD", "minibatch", 0.5),
                              ("SAGA", "saga", 0.1)):
            for agg in ("mean", "geomed"):
                cfg = RobustConfig(aggregator=agg, vr=vr, attack=attack,
                                   num_byzantine=0 if attack == "none" else 4,
                                   minibatch_size=20)
                init_fn, step_fn = make_federated_step(
                    paper_nn.nn_loss, wd, cfg, get_optimizer("sgd", lr),
                    device="cuda")
                st = init_fn(paper_nn.init_params(SEED + 7, device="cuda"), 5)
                st, _, _ = run_steps(torch, step_fn, st, GRID_STEPS["table1"])
                acc[attack, f"{label}-{agg}"] = paper_nn.accuracy(st.params, test_batch)
    values["table1"] = acc
    grid_table(f"table1 (mnist_like 1,500 + 500 held out, 10 + 4 workers, "
               f"{GRID_STEPS['table1']} steps) in {time.perf_counter() - t0:.1f} s; "
               "test accuracy:", acc, runs, ".4f")
    for fig, attack, lower, higher in GRID_ORDERINGS:
        lo, hi = values[fig][attack, lower], values[fig][attack, higher]
        log(f"{fig} {attack}: gap {lower} {lo:.5f} < {higher} {hi:.5f} "
            f"(ratio {hi / lo:.2f})")
        assert lo < hi, f"{fig} {attack}: {lower} {lo} not below {higher} {hi}"
    assert all(0.0 <= a <= 1.0 for a in acc.values()), acc
    log(f"paper grids in {time.perf_counter() - t_all:.1f} s")
    return values


def phase_claims(torch):
    """C2-C4 and test_krum_and_median_also_robust of
    tests/test_convergence.py, and tests/test_system.py's
    test_minibatch_between_sgd_and_saga, on the card at their sizes and
    thresholds (C1 runs in workload A's phase)."""
    from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=960, device="cuda")
    batch = {"a": data.x, "b": data.y}
    _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
    wd = partition(batch, 12, seed=1, device="cuda")

    def gap(params, b=batch, fs=f_star):
        return float(loss(params, b)) - fs

    attacked = dict(aggregator="geomed", attack="sign_flip", num_byzantine=5)
    g_saga = gap(federated_run(torch, loss, wd, 700, 7, vr="saga", **attacked)[0])
    g_sgd = gap(federated_run(torch, loss, wd, 700, 7, vr="sgd", **attacked)[0])
    log(f"C2 sign_flip: gap Byrd-SAGA {g_saga:.5f} < 0.5 x robust SGD {g_sgd:.5f}")
    assert g_saga < g_sgd and g_saga < 0.5 * g_sgd, (g_saga, g_sgd)

    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.optim import get_optimizer
    init_fn, step_fn = make_federated_step(
        loss, wd, RobustConfig(aggregator="geomed", vr="saga", attack="none",
                               num_byzantine=0),
        get_optimizer("sgd", 0.02), device="cuda")
    st = init_fn({"w": torch.zeros(22, device="cuda")}, 7)
    gaps = []
    for i in range(600):
        st, _ = step_fn(st)
        if (i + 1) % 150 == 0:
            gaps.append(gap(st.params))
    log(f"C3 attack-free gaps every 150 steps: {[round(g, 6) for g in gaps]} "
        "(second < 0.7 x first or first < 1e-3; last < 0.05)")
    assert gaps[1] < 0.7 * gaps[0] or gaps[0] < 1e-3, gaps
    assert gaps[-1] < 0.05, gaps

    data_rep = ijcnn1_like(SEED + 9, n=240, device="cuda")
    batch_rep = {"a": data_rep.x, "b": data_rep.y}
    _, f_rep = logreg_full_loss_and_opt(data_rep, iters=4000, lr=0.5)
    wd_rep = partition(batch_rep, 12, mode="replicated", seed=1, device="cuda")
    g_saga = gap(federated_run(torch, loss, wd_rep, 900, 7, vr="saga", **attacked)[0],
                 batch_rep, f_rep)
    g_sgd = gap(federated_run(torch, loss, wd_rep, 900, 7, vr="sgd", **attacked)[0],
                batch_rep, f_rep)
    log(f"C4 replicated data: gap Byrd-SAGA {g_saga:.6f} (< 0.02), robust SGD "
        f"{g_sgd:.6f} (> 2x)")
    assert g_saga < 0.02 and g_sgd > 2 * g_saga, (g_saga, g_sgd)

    for agg in ("krum", "median", "trimmed_mean"):
        g = gap(federated_run(torch, loss, wd, 700, 7, aggregator=agg, vr="saga",
                              attack="sign_flip", num_byzantine=5,
                              num_groups=4, trim=5)[0])
        log(f"{agg} sign_flip: gap {g:.5f} (< 0.2)")
        assert g < 0.2, f"{agg} failed: {g}"

    # tests/test_system.py::test_minibatch_between_sgd_and_saga: the honest
    # messages' variance under BSGD (20 samples a worker) is below SGD's.
    data = ijcnn1_like(SEED, n=600, device="cuda")
    wd = partition({"a": data.x, "b": data.y}, 10, seed=1, device="cuda")
    var = {}
    for vr in ("minibatch", "sgd"):
        init_fn, step_fn = make_federated_step(
            loss, wd, RobustConfig(aggregator="geomed", vr=vr, minibatch_size=20,
                                   attack="none", num_byzantine=0),
            get_optimizer("sgd", 0.02), device="cuda")
        st = init_fn({"w": torch.zeros(22, device="cuda")}, 3)
        _, _, metrics = run_steps(torch, step_fn, st, 400)
        var[vr] = float(metrics["honest_variance"])
    log(f"BSGD claim, 400 steps: honest variance BSGD {var['minibatch']:.6g} < "
        f"SGD {var['sgd']:.6g} (ratio {var['minibatch'] / var['sgd']:.4f})")
    assert var["minibatch"] < var["sgd"], var


def phase_quickstart():
    from repro_torch import quickstart
    t0 = time.perf_counter()
    gaps = quickstart.main(["--device", "cuda"])
    log(f"quickstart on the card in {time.perf_counter() - t0:.1f} s: {gaps}")
    assert gaps["Byrd-SAGA"] < gaps["robust SGD"], gaps
    assert gaps["Byrd-SAGA"] < gaps["plain SAGA"], gaps


def workload_d_graph(torch):
    """Workload D's graph: erdos_renyi(70, p=0.5, seed=0) -> (topology,
    its (70, 70) neighbour mask on the card, trim)."""
    from repro_torch.topology import get_topology
    topo = get_topology("erdos_renyi", 70, seed=0, p=0.5)
    trim = min(20, (topo.min_neighborhood - 1) // 2)
    return topo, torch.as_tensor(topo.neighbor_mask, device="cuda"), trim


def phase_workload_d(torch, gossip, agg, steps=20, wire="float32", packed=True):
    """Workload D (workload B's data, model and table on workload D's graph)
    with rule ``agg`` in ``gossip`` mode on the ``wire`` message format:
    ``steps`` steps with the launch counts reset just before and read just
    after, asserted (on the bf16 wire, every launch on the bf16 routes; with
    ``packed=False`` the per-leaf baseline, each kernel once per leaf); a
    3-step profile.  Returns (counts, summary)."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.data import mnist_like, partition
    from repro_torch.kernels import ops
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    topo, _, trim = workload_d_graph(torch)
    torch.cuda.reset_peak_memory_stats()
    data = mnist_like(SEED, n=60_000, device="cuda")
    batch = {"x": data.x, "y": data.y}
    wd = partition(batch, 50, seed=2, device="cuda")
    cfg = RobustConfig(aggregator=agg, vr="saga", attack="sign_flip",
                       num_byzantine=20, trim=trim, topology="erdos_renyi",
                       topology_p=0.5, topology_seed=0, gossip=gossip,
                       message_dtype=wire, packed=packed)
    init_fn, step_fn = make_federated_step(
        paper_nn.nn_loss, wd, cfg, get_optimizer("sgd", 0.1), device="cuda")
    st = init_fn(paper_nn.init_params(SEED + 7, device="cuda"), 5)

    def honest_loss_acc(params):
        nodes = [{k: v[i] for k, v in params.items()} for i in range(50)]
        with torch.no_grad():
            loss = statistics.fmean(float(paper_nn.nn_loss(p, batch)) for p in nodes)
        return loss, statistics.fmean(paper_nn.accuracy(p, batch) for p in nodes)

    f0, _ = honest_loss_acc(st.params)
    ops.reset_launch_counts()
    st, times, metrics = run_steps(torch, step_fn, st, steps)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    f1, acc = honest_loss_acc(st.params)
    label = (f"D {gossip} {agg}" + ("" if wire == "float32" else f" {wire}")
             + ("" if packed else " per-leaf"))
    leaves = len(vr_tables(st.vr))       # launches a step of each kernel
    iters = counts["partial_sqdist"] / steps / leaves
    log(f"workload {label}/sign_flip (trim {trim}): mean honest loss {f0:.6f} -> "
        f"{f1:.6f} after {steps} steps, mean honest accuracy {acc:.4f}, "
        f"consensus_dist {float(metrics['consensus_dist']):.6g}, median step "
        f"{statistics.median(times) * 1e3:.3f} ms, peak memory {peak / 1e9:.2f} GB, "
        f"Weiszfeld iters/step {iters:.2f}, launches {counts}")
    median_s = statistics.median(times)
    st, busy_us = profile_steps(torch, f"workload {label}", step_fn, st, 3, median_s)
    assert math.isfinite(f1), f"workload {label}: loss is not finite"
    assert all(bool(torch.isfinite(p).all()) for p in st.params.values())
    assert counts["saga_correct"] == leaves * steps, counts
    bf16 = wire == "bfloat16"
    if agg == "trimmed_mean":
        assert counts["masked_neighbor_reduce"] == leaves * steps, counts
        assert counts["masked_neighbor_reduce select"] == leaves * steps, counts
        # The bf16 exchange (contiguous, D even) takes two coordinates a thread.
        assert counts["masked_neighbor_reduce select pairs"] == (steps if bf16 else 0), counts
        assert counts["masked_neighbor_reduce select one"] == (
            0 if bf16 else leaves * steps), counts
        assert counts["partial_sqdist"] == counts["weighted_sum"] == 0, counts
    if agg == "geomed":
        # K7 (trim 0) starts each solve at the masked mean.
        assert counts["masked_neighbor_reduce"] == leaves * steps, counts
        assert counts["masked_neighbor_reduce sum"] == leaves * steps, counts
        assert counts["partial_sqdist"] == counts["weighted_sum"] >= steps, counts
        # Every distance sweep of the masked solve reads only the neighbours.
        assert counts["partial_sqdist masked"] == counts["partial_sqdist"], counts
        assert counts["partial_sqdist unmasked"] == 0, counts
    if agg == "mean":
        assert counts["weighted_sum"] == steps, counts
        assert counts["masked_neighbor_reduce"] == counts["partial_sqdist"] == 0
    for k in ("saga_correct", "partial_sqdist", "weighted_sum",
              "masked_neighbor_reduce"):
        assert counts.get(f"{k} bf16", 0) == (counts[k] if bf16 else 0), counts
    if wire == "sign1":
        assert tuple(st.ef.shape) == (50, st.vr.table.shape[-1]), st.ef.shape
        assert bool(torch.isfinite(st.ef).all()) and float(st.ef.abs().max()) > 0
    summary = dict(step_ms=median_s * 1e3, peak_gb=peak / 1e9, loss=f1,
                   accuracy=acc, iters=iters, busy_us=busy_us,
                   idle=1 - busy_us / (median_s * 1e6),
                   consensus=float(metrics["consensus_dist"]))
    del st
    torch.cuda.empty_cache()
    return counts, summary


def phase_timing_d(torch):
    """K7 (trim 12 and 0) and the receiver-batched K2 (masked route, and
    the unmasked route on the same inputs) and K3 at workload D's (70, 70,
    39,760) exchange under its mask: device time (CUDA events, the calls
    take hundreds of microseconds) beside the bound, the plain version and,
    for K3 and K7 with trim 0, one batched matmul (``torch.bmm``; for K7 of
    ``mask / max(n, 1)``, the masked mean)."""
    from repro_torch.kernels import topology as tp
    from repro_torch.kernels import weiszfeld as wz
    _, mask, trim = workload_d_graph(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r, s = mask.shape
    d = 39_760
    ex = 0.01 * torch.randn((r, s, d), generator=gen, device="cuda")
    y = tp.masked_neighbor_reduce_call(ex, mask, 0)
    a = torch.rand((r, s), generator=gen, device="cuda") * mask
    out = {}
    ex_b, rd_b = r * s * d * 4, r * d * 4
    # K7 reads only the masked senders' values (and the mask), writes
    # (R, D); per coordinate at least one comparison per present value and
    # round.
    nnz = float(mask.sum())
    mean_w = (mask / torch.clamp(mask.sum(1, keepdim=True), min=1.0))[:, None]
    for t in (trim, 0):
        b, by = bound(nnz * d * 4 + r * s * 4 + rd_b, nnz * d * (2 * t + 1))
        out[f"masked_neighbor_reduce trim {t}"] = dict(
            ms=event_ms(torch, lambda: tp.masked_neighbor_reduce_call(ex, mask, t), 20),
            plain_ms=event_ms(torch, lambda: tp.masked_neighbor_reduce_plain(ex, mask, t), 5),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: torch.bmm(mean_w, ex), 20) if t == 0 else None)
    # The masked route reads only the members' rows (and y and the mask),
    # writes (R, S); the unmasked route reads every row.
    b, by = bound(nnz * d * 4 + rd_b + 2 * r * s * 4, 3 * nnz * d)
    out["partial_sqdist masked batched"] = dict(
        ms=event_ms(torch, lambda: wz.partial_sqdist_call(ex, y, mask), 20),
        plain_ms=event_ms(torch, lambda: wz.partial_sqdist_plain(ex, y, mask), 5),
        bound_ms=b, bound_by=by, library_ms=None)
    b, by = bound(ex_b + rd_b + r * s * 4, 3 * r * s * d)
    out["partial_sqdist batched"] = dict(
        ms=event_ms(torch, lambda: wz.partial_sqdist_call(ex, y), 20),
        plain_ms=event_ms(torch, lambda: wz.partial_sqdist_plain(ex, y), 5),
        bound_ms=b, bound_by=by, library_ms=None)
    # K3 needs, and reads, only the rows whose weight is not 0.
    b, by = bound(float((a != 0).sum()) * d * 4 + r * s * 4 + rd_b, 2 * r * s * d)
    out["weighted_sum batched"] = dict(
        ms=event_ms(torch, lambda: wz.weighted_sum_call(ex, a), 20),
        plain_ms=event_ms(torch, lambda: wz.weighted_sum_plain(ex, a), 20),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: torch.bmm(a[:, None], ex), 20))
    for name, res in out.items():
        log(f"timing {name} ({r}, {s}, {d}) (device time): {res['ms'] * 1e3:.2f} us, "
            f"bound {res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}), plain "
            f"{res['plain_ms'] * 1e3:.2f} us"
            + (f", library {res['library_ms'] * 1e3:.2f} us" if res["library_ms"] else ""))
    del ex
    torch.cuda.empty_cache()
    return out


def decentralized_run(torch, loss, wd, steps, topology, **cfg):
    """``steps`` decentralized steps on the card from w = 0 (sgd 0.05 unless
    ``lr`` is given); returns the final state and metrics."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.optim import get_optimizer
    lr, seed = cfg.pop("lr", 0.05), cfg.pop("seed", 3)
    init_fn, step_fn = make_federated_step(
        loss, wd, RobustConfig(**cfg), get_optimizer("sgd", lr),
        topology=topology, device="cuda")
    st = init_fn({"w": torch.zeros(22, device="cuda")}, seed)
    metrics = {}
    for _ in range(steps):
        st, metrics = step_fn(st)
    return st, metrics


def phase_decentralized_claims(torch):
    """The decentralized training claims of tests/test_topology.py on the
    card, at their sizes and thresholds, with their margins."""
    from repro_torch.core import aggregators
    from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    t0 = time.perf_counter()
    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=600, device="cuda")
    wd = partition({"a": data.x, "b": data.y}, 8, seed=1, device="cuda")

    def own_loss(params, h):
        return statistics.fmean(
            float(loss({"w": params["w"][i]}, {"a": wd["a"][i], "b": wd["b"][i]}))
            for i in range(h))

    losses = {}
    for agg in ("geomed", "mean"):
        st, _ = decentralized_run(torch, loss, wd, 150, "ring", aggregator=agg,
                                  vr="saga", attack="sign_flip", num_byzantine=2,
                                  weiszfeld_iters=32)
        losses[agg] = own_loss(st.params, 8)
    log(f"ring sign_flip: mean honest loss geomed {losses['geomed']:.5f} "
        f"(< 0.60 by {0.60 - losses['geomed']:.5f}), mean {losses['mean']:.5f} "
        f"(geomed below mean - 0.02 by {losses['mean'] - 0.02 - losses['geomed']:.5f})")
    assert losses["geomed"] < 0.60 and losses["geomed"] < losses["mean"] - 0.02, losses

    st, metrics = decentralized_run(torch, loss, wd, 30, "complete",
                                    aggregator="geomed", vr="sgd",
                                    attack="sign_flip", num_byzantine=2,
                                    weiszfeld_iters=32)
    w = st.params["w"][:8]
    spread = float((w - w[:1]).abs().max())
    log(f"complete graph: consensus_dist {float(metrics['consensus_dist']):.3g} "
        f"(< 1e-8), largest honest copy difference {spread:.3g} (<= 1e-5)")
    assert float(metrics["consensus_dist"]) < 1e-8 and spread <= 1e-5

    data8 = ijcnn1_like(SEED, n=800, device="cuda")
    _, f_star = logreg_full_loss_and_opt(data8, iters=4000, lr=0.5)
    wd8 = partition({"a": data8.x, "b": data8.y}, 10, seed=1, device="cuda")
    for attack in ("sign_flip", "gaussian"):
        gaps = {}
        for gossip in ("gradient", "params"):
            st, _ = decentralized_run(
                torch, loss, wd8, 500, "ring", aggregator="geomed", vr="saga",
                attack=attack, num_byzantine=2, weiszfeld_iters=32,
                gossip=gossip, lr=0.02, seed=7)
            gaps[gossip] = statistics.fmean(
                float(loss({"w": st.params["w"][i]},
                           {"a": wd8["a"][i], "b": wd8["b"][i]}))
                for i in range(10)) - f_star
        log(f"params vs gradient gossip, {attack}, 500 steps: gap gradient "
            f"{gaps['gradient']:.5f}, params {gaps['params']:.5f} (each < 0.15; "
            f"params <= 2 x gradient + 0.01 by "
            f"{2 * gaps['gradient'] + 0.01 - gaps['params']:.5f})")
        assert max(gaps.values()) < 0.15, gaps
        assert gaps["params"] <= 2.0 * gaps["gradient"] + 0.01, gaps

    for agg in aggregators.AGGREGATOR_NAMES:
        for gossip in ("gradient", "params"):
            st, metrics = decentralized_run(
                torch, loss, wd, 5, "ring", aggregator=agg, vr="sgd",
                attack="ipm", num_byzantine=2, weiszfeld_iters=16,
                num_groups=3, gossip=gossip)
            assert tuple(st.params["w"].shape) == (10, 22)
            assert bool(torch.isfinite(st.params["w"]).all()), (agg, gossip)
            assert math.isfinite(float(metrics["consensus_dist"])), (agg, gossip)
    log(f"every rule x both gossip modes trains 5 steps on a ring with finite "
        f"values; decentralized claims in {time.perf_counter() - t0:.1f} s")

def flash_inputs(torch, shape, dtype, gen):
    b, s_, h, kv, hd = shape
    return [torch.randn((b, s_, n, hd), generator=gen, device="cuda").to(dtype)
            for n in (h, kv, kv)]


def phase_flash_checks(torch):
    """K8 against its plain version on the card at FLASH_CHECKS, float32 and
    bfloat16, each through the route ``fa.variant`` picks (asserted from
    the per-route counts); returns the largest absolute difference over all
    checks."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    worst = 0.0
    for shape, causal in FLASH_CHECKS:
        errs, routes = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, shape, dtype, gen)
            before = dict(fa.VARIANT_LAUNCHES)
            got = fa.flash_attention_call(q, k, v, causal)
            want = fa.flash_attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            ran = [r for r in fa.VARIANTS if fa.VARIANT_LAUNCHES[r] > before[r]]
            assert ran == [fa.variant(dtype, shape[-1], True)], (shape, dtype, ran)
            routes[dtype] = ran[0]
            assert got.dtype == dtype and got.shape == q.shape
            t = tol[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
            errs[dtype] = float((got.float() - want.float()).abs().max())
            del q, k, v, got, want
        worst = max(worst, *errs.values())
        log(f"kernel check flash_attention {shape} {'causal' if causal else 'bidirectional'}: "
            f"K8 max|err| f32 {errs[torch.float32]:.3g} ({routes[torch.float32]}, "
            f"rtol/atol 2e-5), bf16 {errs[torch.bfloat16]:.3g} "
            f"({routes[torch.bfloat16]}, 2e-2): ok")
    torch.cuda.empty_cache()
    return worst


def kernel_class(name):
    """K8, matmul or rest, by the device kernel's name."""
    low = name.lower()
    if "flash_attn_fwd" in low:
        return "K8"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    return "rest"


def profile_split(torch, label, fn, median_s):
    """Log one traced call of ``fn``: device time by class (K8, matmuls,
    the rest), the kernel count and the top kernels; the idle share against
    the untraced median ``median_s``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(device_events(prof), key=lambda e: e.self_device_time_total,
                    reverse=True)
    split = {"K8": 0.0, "matmul": 0.0, "rest": 0.0}
    for e in events:
        split[kernel_class(e.key)] += e.self_device_time_total / 1e3
    busy = sum(split.values())
    if busy <= 0:
        raise RuntimeError(f"profile {label}: torch.profiler recorded no device time")
    idle = 1 - busy / (median_s * 1e3)
    kernels = sum(e.count for e in events)
    log(f"profile {label}: device busy {busy:.3f} ms in {kernels} kernels, untraced "
        f"median {median_s * 1e3:.3f} ms, idle share {idle:.3f}; K8 {split['K8']:.3f} ms "
        f"({split['K8'] / busy:.3f}), matmuls {split['matmul']:.3f} ms "
        f"({split['matmul'] / busy:.3f}), rest {split['rest']:.3f} ms "
        f"({split['rest'] / busy:.3f})")
    for e in events[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  "
            f"[{kernel_class(e.key)}] {e.key[:80]}")


def phase_workload_e(torch, card):
    """Workload E: qwen2-7b served at full width and depth on one card
    through repro_torch.launch.serve.  Returns the launch counts of the
    counted run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    cfg = get_config(E_ARCH)
    b, p, t = E_BATCH, E_PROMPT, E_DECODE
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(x.numel() for x in params.parameters())
    w_bytes = sum(x.numel() * x.element_size() for x in params.parameters())
    assert n_params == 7_615_616_512, n_params
    cache = model.init_cache(b, p + t, dtype=cfg.dtype)
    c_bytes = sum(x.numel() * x.element_size() for c in cache.values()
                  for x in c.values())
    log(f"workload E {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads x {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params:,} parameters = "
        f"{w_bytes / 1e9:.2f} GB in {cfg.param_dtype}, drawn on the card in "
        f"{t_init:.2f} s; KV cache ({cfg.num_layers}, {b}, {p + t}, "
        f"{cfg.num_kv_heads}, {cfg.resolved_head_dim}) x 2 = {c_bytes / 1e6:.1f} MB")

    def run(decode_tokens):
        return serve.serve(model, params, batch=b, prompt_len=p,
                           decode_tokens=decode_tokens, seed=SEED, cache=cache)

    run(2)   # warm-up: the first prefill and decode step
    runs = []
    for i in range(3):
        if i == 0:
            ops.reset_launch_counts()
        runs.append(run(t))
        if i == 0:
            counts = ops.launch_counts()
            routes = dict(fa.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    res = runs[-1]
    assert counts["flash_attention"] == cfg.num_layers, counts
    assert routes == {"wgmma": cfg.num_layers, "simt": 0}, routes
    assert tuple(res["tokens"].shape) == (b, t), res["tokens"].shape
    assert tuple(res["logits"].shape) == (b, cfg.vocab_size)
    assert res["logits"].dtype == torch.float32
    assert bool(torch.isfinite(res["logits"]).all()), "workload E: logits not finite"
    assert tuple(cache["pos0"]["k"].shape) == (cfg.num_layers, b, p + t,
                                               cfg.num_kv_heads, cfg.resolved_head_dim)
    assert all(torch.equal(r["tokens"], res["tokens"]) for r in runs), \
        "workload E: the three runs sampled different tokens"
    # A decode step alone launches no K8.
    ops.reset_launch_counts()
    with torch.no_grad():
        model.decode_step(params, cache, res["tokens"][:, -1:], p + t - 1)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0, ops.launch_counts()
    assert fa.VARIANT_LAUNCHES == {"wgmma": 0, "simt": 0}, fa.VARIANT_LAUNCHES
    prefill_s = statistics.median(r["prefill_s"] for r in runs)
    step_s = statistics.median(r["decode_s"] for r in runs) / (t - 1)
    each = ", ".join(f"{r['prefill_s'] * 1e3:.3f}" for r in runs)
    log(f"workload E serve ({card}): prefill {b} x {p} tokens {prefill_s * 1e3:.3f} ms "
        f"(median of 3: {each}), "
        f"{b * p / prefill_s:.0f} prompt tok/s; decode {step_s * 1e3:.3f} ms/step "
        f"over {t - 1} steps, {b / step_s:.1f} tok/s; peak memory {peak / 1e9:.2f} GB; "
        f"launches of the counted run {counts}, K8 by route {routes}")
    log(f"workload E sampled token ids (first seq): {res['tokens'][0][:16].tolist()}")
    tokens = res["prompt"]

    def one_prefill():
        with torch.no_grad():
            model.prefill(params, {"tokens": tokens}, cache=cache)

    def one_decode():
        with torch.no_grad():
            model.decode_step(params, cache, res["tokens"][:, -1:], p + t - 1)

    profile_split(torch, "workload E prefill", one_prefill, prefill_s)
    profile_split(torch, "workload E decode step", one_decode, step_s)
    del params, cache, runs, res
    torch.cuda.empty_cache()
    return counts


def phase_serving_checks(torch):
    """The cache path against K8's prefill at full width (2 layers, float32),
    and the card against the CPU for the reduced qwen2-7b (float32).  Both
    within rtol 1e-4 (|got - want| <= 1e-4 (|want| + max|want|): the sums
    run in another order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config(E_ARCH), num_layers=2, param_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, s_ = 2, 100
    tokens = torch.randint(0, cfg.vocab_size, (b, s_ + 1), generator=gen, device="cuda")
    with torch.no_grad():
        cache = model.init_cache(b, s_ + 1, dtype=torch.float32)
        _, cache = model.prefill(params, {"tokens": tokens[:, :s_]}, cache=cache)
        dec, cache = model.decode_step(params, cache, tokens[:, s_:], s_)
        full, full_cache = model.prefill(params, {"tokens": tokens})
    ok, err = close(dec, full, rtol=1e-4)
    assert ok, f"cache vs prefill: decode logits disagree, max err {err}"
    ok_k, err_k = close(cache["pos0"]["k"], full_cache["pos0"]["k"], rtol=1e-4)
    assert ok_k, f"cache vs prefill: the written keys disagree, max err {err_k}"
    log(f"cache vs prefill ({cfg.name} full width, 2 layers, float32, B={b}): prefill "
        f"over {s_} + decode at {s_} against prefill over {s_ + 1}: logits max|err| "
        f"{err:.3g}, cache k {err_k:.3g} (rtol 1e-4): ok")
    del params, cache, full_cache
    torch.cuda.empty_cache()

    cfg = get_config(E_ARCH).reduced()
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(SEED + 5))
    steps = torch.randint(0, cfg.vocab_size, (4, 2, 1),
                          generator=torch.Generator().manual_seed(SEED + 6))
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = params_cpu if dev == "cpu" else copy.deepcopy(params_cpu).to(dev)
        cache = model.init_cache(2, 41, dtype=torch.float32)
        logits = []
        ops.reset_launch_counts()
        with torch.no_grad():
            lg, cache = model.prefill(params, {"tokens": tokens.to(dev)}, cache=cache)
            logits.append(lg.cpu())
            for i, tok in enumerate(steps):
                lg, cache = model.decode_step(params, cache, tok.to(dev), 37 + i)
                logits.append(lg.cpu())
        out[dev] = (torch.stack(logits), ops.launch_counts()["flash_attention"])
    ok, err = close(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert ok, f"card vs CPU: logits disagree, max err {err}"
    assert out["cuda"][1] == cfg.num_layers and out["cpu"][1] == 0, out
    log(f"card vs CPU (reduced {cfg.name}, float32, prefill 37 + 4 decode steps): "
        f"logits max|err| {err:.3g} (rtol 1e-4), K8 launches {out['cuda'][1]} on "
        "the card and 0 on the CPU: ok")


def phase_timing_e(torch):
    """K8 at workload E's per-layer shape (bf16, causal): device time (CUDA
    events) of the wgmma kernel the path runs and of the SIMT kernel on the
    same inputs (``route="simt"``, for comparison only), beside the bound,
    the plain version and one scaled_dot_product_attention call (is_causal,
    enable_gqa)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    cfg_shape = (E_BATCH, E_PROMPT, 28, 4, 128)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v = flash_inputs(torch, cfg_shape, torch.bfloat16, gen)
    b, s_, h, _, hd = cfg_shape
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v)) + q.numel() * 2
    flops = 2 * b * h * s_ * (s_ + 1) * hd       # causal pairs: S (S + 1) / 2
    bd, by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert fa.variant(q.dtype, hd, fa.tma_aligned(q, k, v)) == "wgmma"
    out = dict(
        ms=event_ms(torch, lambda: fa.flash_attention_call(q, k, v, True), 20),
        simt_ms=event_ms(torch, lambda: fa.flash_attention_call(
            q, k, v, True, route="simt"), 10),
        plain_ms=event_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True), 3),
        bound_ms=bd, bound_by=by,
        library_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20))
    log(f"timing flash_attention {cfg_shape} bf16 causal (device time): wgmma "
        f"{out['ms'] * 1e3:.2f} us, SIMT {out['simt_ms'] * 1e3:.2f} us "
        f"({out['simt_ms'] / out['ms']:.1f}x the wgmma time), "
        f"bound {out['bound_ms'] * 1e3:.2f} us ({by}: "
        f"{flops:.4g} FLOP at 989 TFLOP/s; {nbytes / 1e6:.1f} MB at 3.35 TB/s "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us), plain {out['plain_ms'] * 1e3:.2f} us, "
        f"library (scaled_dot_product_attention) {out['library_ms'] * 1e3:.2f} us; "
        f"wgmma {flops / (out['ms'] * 1e-3) / 1e12:.2f} TFLOP/s, SIMT "
        f"{flops / (out['simt_ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def check_saga_rows(torch, c, j, d, w, gen):
    """K1's client-row route on a fresh (c, j, d) resident table through w
    distinct client rows (a permutation's first w) against its plain
    version: the same bits, only the drawn (row, idx) entries and avg rows
    changed; then an out-of-range row: NaN in that message, no state
    touched.  Returns the largest absolute difference (0.0)."""
    from repro_torch.kernels import saga_correct as sc
    dev = torch.device("cuda")
    table = torch.randn((c, j, d), generator=gen, device=dev)
    avg = torch.randn((c, d), generator=gen, device=dev)
    g = torch.randn((w, d), generator=gen, device=dev)
    rows = torch.randperm(c, generator=gen, device=dev)[:w]
    idx = torch.randint(0, j, (w,), generator=gen, device=dev)
    t_kern, a_kern = table.clone(), avg.clone()
    msg_k = sc.saga_correct_call(g, t_kern, a_kern, idx, rows)
    msg_p = sc.saga_correct_plain(g, table, avg, idx, rows)
    torch.cuda.synchronize()
    assert torch.equal(msg_k, msg_p), f"K1 rows: msg off by {ulps(msg_k, msg_p)} ulp"
    assert torch.equal(a_kern, avg), f"K1 rows: avg off by {ulps(a_kern, avg)} ulp"
    assert torch.equal(t_kern, table), "K1 rows: table != plain table"
    del table, avg, t_kern
    # Only the drawn entries moved: put the old rows back and compare with
    # a second, untouched copy made from the same generator state.
    gen2 = torch.Generator(device="cuda").manual_seed(SEED + 100)
    fresh = torch.randn((c, j, d), generator=gen2, device=dev)
    fresh_avg = torch.randn((c, d), generator=gen2, device=dev)
    before, before_avg = fresh.clone(), fresh_avg.clone()
    sc.saga_correct_call(g, fresh, fresh_avg, idx, rows)
    touched = torch.zeros((c, j), dtype=torch.bool, device=dev)
    touched[rows, idx] = True
    moved = torch.zeros(c, dtype=torch.bool, device=dev)
    moved[rows] = True
    assert torch.equal(fresh[~touched], before[~touched]), "K1 rows moved other entries"
    assert torch.equal(fresh_avg[~moved], before_avg[~moved]), "K1 rows moved other avg rows"
    assert torch.equal(fresh[rows, idx], g), "K1 rows: drawn entries != gradient"
    # An out-of-range row: NaN message, the state as it was.
    bad = rows.clone()
    bad[w // 2] = c
    before, before_avg = fresh.clone(), fresh_avg.clone()
    msg = sc.saga_correct_call(g, fresh, fresh_avg, idx, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(msg[w // 2]).all()), "K1 rows: out-of-range row not NaN"
    keep = torch.ones(w, dtype=torch.bool, device=dev)
    keep[w // 2] = False
    assert bool(torch.isfinite(msg[keep]).all())
    moved = torch.zeros(c, dtype=torch.bool, device=dev)
    moved[bad[keep]] = True
    assert torch.equal(fresh[~moved], before[~moved]), \
        "K1 rows: an out-of-range row touched the state"
    assert torch.equal(fresh_avg[~moved], before_avg[~moved])
    del fresh, before
    torch.cuda.empty_cache()
    return float((msg_k - msg_p).abs().max())


def phase_client_row_checks(torch):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    err = 0.0
    for c, j, d, w in ((13, 3, 300, 7), (G_CLIENTS, 120, 39760, G_COHORT)):
        e = check_saga_rows(torch, c, j, d, w, gen)
        err = max(err, e)
        log(f"kernel check K1 client rows: table ({c}, {j}, {d}), {w} rows from a "
            f"permutation: max|err| {e:.3g} (bitwise), only the drawn entries "
            "changed; an out-of-range row gives NaN and touches no state: ok")
    return err


def mnist_clients(torch, clients):
    """Workload B's data (mnist_like 60,000 x 784 from SEED) split iid into
    ``clients`` shards on the card -> (batch, worker data)."""
    from repro_torch.data import mnist_like, partition
    data = mnist_like(SEED, n=60_000, device="cuda")
    batch = {"x": data.x, "y": data.y}
    return batch, partition(batch, clients, seed=2, device="cuda")


def nn_run(torch, label, batch, wd, steps=20, step_kw=None, **cfg_kw):
    """``steps`` master steps of the Table I network from workload B's
    initial state and seed (geomed, SAGA, 20 Byzantine, sgd 0.1 unless
    ``cfg_kw`` says otherwise), launch counts reset just before and read
    just after.  ``step_kw`` maps a step's index to extra arguments of
    ``step_fn`` (lsvrg's ``coin``).  Returns (state, per-step metrics,
    per-step seconds, counts, summary)."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.kernels import ops
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    kw = dict(aggregator="geomed", vr="saga", num_byzantine=20, trim=20,
              num_groups=5)
    kw.update(cfg_kw)
    init_fn, step_fn = make_federated_step(
        paper_nn.nn_loss, wd, RobustConfig(**kw), get_optimizer("sgd", 0.1),
        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = init_fn(paper_nn.init_params(SEED + 7, device="cuda"), 5)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ops.reset_launch_counts()
    history, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        st, metrics = step_fn(st, **(step_kw or {}).get(i, {}))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        history.append(metrics)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        f1 = float(paper_nn.nn_loss(st.params, batch))
    acc = paper_nn.accuracy(st.params, batch)
    summary = dict(step_ms=statistics.median(times) * 1e3, peak_gb=peak / 1e9,
                   loss=f1, accuracy=acc, init_s=t_init,
                   iters=counts["partial_sqdist"] / steps)
    log(f"{label}: loss {f1:.6f}, accuracy {acc:.4f} after {steps} steps, median "
        f"step {summary['step_ms']:.3f} ms, peak memory {peak / 1e9:.2f} GB, init "
        f"{t_init:.2f} s, Weiszfeld iters/step {summary['iters']:.2f}, launches {counts}")
    assert math.isfinite(f1), f"{label}: loss is not finite"
    assert all(bool(torch.isfinite(p).all()) for p in st.params.values()), label
    return st, step_fn, history, times, counts, summary


def initial_flat_params(torch):
    """Workload B's initial parameters (nn_run's), packed as the messages
    are: (D,) on the card."""
    from repro_torch.core import RobustConfig
    from repro_torch.models import paper_nn
    p0 = paper_nn.init_params(SEED + 7, device="cuda")
    return RobustConfig().message_spec(p0, batch_ndim=0).pack(p0, batch_ndim=0)


def phase_workload_g(torch, card, b_peak_gb):
    """Workload G: partial participation at MNIST size (G_RUNS); K1's two
    routes timed on G's resident table.  Returns (counts per run, K1
    client-route timing)."""
    from repro_torch.kernels import saga_correct as sc
    t_phase = time.perf_counter()
    batch, wd = mnist_clients(torch, G_CLIENTS)
    counts, summaries, timing = {}, {}, None
    for name, extra in G_RUNS:
        label = f"workload {name} {extra['attack']}"
        st, step_fn, history, times, c, summ = nn_run(
            torch, label, batch, wd, num_clients=G_CLIENTS, cohort_size=G_COHORT,
            **extra)
        st, busy_us = profile_steps(torch, label, step_fn, st, 3,
                                    summ["step_ms"] / 1e3)
        summ.update(busy_us=busy_us, idle=1 - busy_us / (summ["step_ms"] * 1e3),
                    mean_staleness=float(history[-1]["mean_staleness"]))
        log(f"{label}: resident SAGA table {tuple(st.vr.table.shape)} = "
            f"{st.vr.table.numel() * 4 / 1e9:.2f} GB, K1 launches by route "
            f"{{'workers': {c['saga_correct workers']}, 'clients': "
            f"{c['saga_correct clients']}}}, mean slot staleness "
            f"{summ['mean_staleness']:.3f}, peak {summ['peak_gb']:.2f} GB against "
            f"workload B's {b_peak_gb:.2f} GB + 0.5 GB")
        assert c["saga_correct clients"] == 20 and c["saga_correct workers"] == 0, c
        assert summ["peak_gb"] < b_peak_gb + 0.5, (summ["peak_gb"], b_peak_gb)
        counts[name], summaries[name] = c, summ
        if timing is None:
            timing = time_client_rows(torch, st.vr.table, st.vr.avg)
        del st
        torch.cuda.empty_cache()
    log(f"workload G per run ({card}): step ms / device busy us / idle share / "
        "Weiszfeld iters per step / peak GB / loss / accuracy")
    for name, r in summaries.items():
        log(f"  {name:<3} {r['step_ms']:9.3f} {r['busy_us']:9.1f} {r['idle']:7.3f} "
            f"{r['iters']:7.2f} {r['peak_gb']:7.2f} {r['loss']:10.6f} {r['accuracy']:8.4f}")
    log(f"workload G phase {time.perf_counter() - t_phase:.1f} s")
    return counts, timing


def time_client_rows(torch, table, avg):
    """K1's client-row route on G's resident (500, 120, D) table with a
    fresh cohort and draw each call, beside its plain version and the
    worker route on the first 50 clients' (50, 120, D) view (the same
    bytes), in one phase."""
    from repro_torch.kernels import saga_correct as sc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    c, j, d = table.shape
    w = G_COHORT
    g = 0.01 * torch.randn((w, d), generator=gen, device="cuda")
    reps = 50
    # (idx, a cohort of the 500 clients, a cohort of the first 50
    # clients); device_ms makes reps + 3 calls, and as many again where it
    # falls back to events.
    draws = iter([(torch.randint(0, j, (w,), generator=gen, device="cuda"),
                   torch.randperm(c, generator=gen, device="cuda")[:w],
                   torch.randperm(w, generator=gen, device="cuda"))
                  for _ in range(10 * (reps + 3))])

    def clients():
        idx, rows, _ = next(draws)
        sc.saga_correct_call(g, table, avg, idx, rows)

    def clients_plain():
        idx, rows, _ = next(draws)
        sc.saga_correct_plain(g, table, avg, idx, rows)

    view, view_avg = table[:w], avg[:w]

    def workers():
        idx, _, _ = next(draws)
        sc.saga_correct_call(g, view, view_avg, idx)

    def clients_near():
        # The client route on the view's rows: the same memory as workers().
        idx, _, near = next(draws)
        sc.saga_correct_call(g, table, avg, idx, near)

    b, by = bound(6 * w * d * 4 + 2 * w * 8, 4 * w * d)
    out = dict(ms=device_ms(torch, clients, reps),
               plain_ms=device_ms(torch, clients_plain, reps),
               bound_ms=b, bound_by=by, library_ms=None)
    workers_ms = device_ms(torch, workers, reps)
    near_ms = device_ms(torch, clients_near, reps)
    log(f"timing saga_correct client rows (device time, G's ({c}, {j}, {d}) table, "
        f"cohort {w}): {out['ms'] * 1e3:.2f} us, worker route on the (50, {j}, {d}) "
        f"view {workers_ms * 1e3:.2f} us ({out['ms'] / workers_ms:.3f}x), the client "
        f"route with its cohort among those 50 clients {near_ms * 1e3:.2f} us, bound "
        f"{b * 1e3:.2f} us ({by}), plain {out['plain_ms'] * 1e3:.2f} us")
    return out


def phase_options_b(torch, card, b_geomed):
    """Workload B with lsvrg, guards and diagnostics, 20 steps each."""
    t_phase = time.perf_counter()
    batch, wd = mnist_clients(torch, 50)
    want = f"{b_geomed['loss']:.6f}"
    rows = {}
    # At p = 1/1,200 a coin rarely comes up in 20 steps, so step 10 hands in
    # every coin: the refresh (each worker's full local gradient over its
    # 1,200 samples, then the snapshot and anchor rows) runs at full width.
    refresh = 10
    up = torch.ones(50, dtype=torch.bool, device="cuda")
    st, _, hist, _, c, summ = nn_run(torch, "workload B lsvrg geomed/sign_flip",
                                     batch, wd, step_kw={refresh: dict(coin=up)},
                                     vr="lsvrg", lsvrg_p=1 / 1200,
                                     attack="sign_flip")
    rates = [float(m["vr_snapshot_rate"]) for m in hist]
    x0 = initial_flat_params(torch)
    moved = float(torch.amax(torch.abs(st.vr.snapshot - x0), dim=1).min())
    log(f"workload B lsvrg: state 2 x {tuple(st.vr.snapshot.shape)} = "
        f"{2 * st.vr.snapshot.numel() * 4 / 1e6:.1f} MB, snapshot rate "
        f"{rates[refresh]:.4f} on step {refresh} (all coins handed in), mean "
        f"{statistics.fmean(rates):.4f}; least max-abs move of a snapshot row "
        f"from the initial params {moved:.6g}; K1 launches {c['saga_correct']}")
    assert rates[refresh] == 1.0 and statistics.fmean(rates) > 0, rates
    assert moved > 0, moved
    assert all(bool(torch.isfinite(t).all()) for t in st.vr), "lsvrg state"
    assert c["saga_correct"] == 0 and summ["peak_gb"] < 0.5 * b_geomed["peak_gb"], summ
    rows["lsvrg sign_flip"] = summ
    del st
    for attack, kw in (("nan", {}), ("inf_overflow", {}),
                       ("bitflip", dict(bitflip_prob=0.02))):
        st, _, hist, _, c, summ = nn_run(
            torch, f"workload B guards geomed/{attack}", batch, wd, attack=attack,
            guards=True, **kw)
        quarantined = [int(m["quarantined_rows"]) for m in hist]
        rejected = int(hist[-1]["rejected_rounds"])
        log(f"workload B guards {attack}: quarantined rows per step {quarantined}, "
            f"rejected rounds {rejected}")
        assert min(quarantined) >= 20, quarantined
        rows[f"guards {attack}"] = summ
        del st
    st, _, hist, _, c, summ = nn_run(torch, "workload B guards geomed/sign_flip",
                                     batch, wd, attack="sign_flip", guards=True)
    log(f"workload B guards sign_flip: loss {summ['loss']:.6f} against B geomed's "
        f"{want}, quarantined rows {[int(m['quarantined_rows']) for m in hist]}")
    assert f"{summ['loss']:.6f}" == want, (summ["loss"], want)
    rows["guards sign_flip"] = summ
    del st
    st, _, hist, _, c, summ = nn_run(torch, "workload B diagnostics geomed/sign_flip",
                                     batch, wd, attack="sign_flip", diagnostics=True)
    weight = hist[-1]["diag_weight"]
    honest, byz = float(weight[:50].mean()), float(weight[50:].mean())
    log(f"workload B diagnostics: loss {summ['loss']:.6f} against B geomed's {want}; "
        f"mean diagnostic weight honest {honest:.6g}, Byzantine {byz:.6g}; "
        f"residual {float(hist[-1]['diag_residual']):.3g}, iters "
        f"{int(hist[-1]['diag_iters'])}, converged {bool(hist[-1]['diag_converged'])}")
    assert f"{summ['loss']:.6f}" == want, (summ["loss"], want)
    assert byz < honest, (honest, byz)
    rows["diagnostics sign_flip"] = summ
    del st
    torch.cuda.empty_cache()
    log(f"workload B options ({card}): step ms / peak GB / Weiszfeld iters per "
        "step / loss / accuracy")
    for name, r in rows.items():
        log(f"  {name:<22} {r['step_ms']:9.3f} {r['peak_gb']:7.2f} {r['iters']:7.2f} "
            f"{r['loss']:10.6f} {r['accuracy']:8.4f}")
    log(f"workload B options phase {time.perf_counter() - t_phase:.1f} s")


def phase_options_d(torch, card):
    """Workload D gradient geomed with guards under per-edge bitflip and
    diagnostics, 20 steps."""
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    t_phase = time.perf_counter()
    batch, wd = mnist_clients(torch, 50)
    _, _, trim = workload_d_graph(torch)
    cfg = RobustConfig(aggregator="geomed", vr="saga", attack="bitflip",
                       num_byzantine=20, trim=trim, topology="erdos_renyi",
                       topology_p=0.5, topology_seed=0, guards=True,
                       diagnostics=True)
    init_fn, step_fn = make_federated_step(
        paper_nn.nn_loss, wd, cfg, get_optimizer("sgd", 0.1), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    st = init_fn(paper_nn.init_params(SEED + 7, device="cuda"), 5)
    st, times, metrics = run_steps(torch, step_fn, st, 20)
    nodes = [{k: v[i] for k, v in st.params.items()} for i in range(50)]
    with torch.no_grad():
        f1 = statistics.fmean(float(paper_nn.nn_loss(p, batch)) for p in nodes)
    weight = metrics["diag_weight"]
    log(f"workload D guards + diagnostics geomed/bitflip ({card}): mean honest loss "
        f"{f1:.6f} after 20 steps, median step {statistics.median(times) * 1e3:.3f} ms, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, quarantined edges "
        f"{int(metrics['quarantined_edges'])}, rejected rounds "
        f"{int(metrics['rejected_rounds'])}; per-sender diagnostic weight honest "
        f"{float(weight[:50].mean()):.6g}, Byzantine {float(weight[50:].mean()):.6g}, "
        f"mean dist honest {float(metrics['diag_dist'][:50].mean()):.6g}, iters "
        f"{int(metrics['diag_iters'])}, consensus_dist "
        f"{float(metrics['consensus_dist']):.6g} ({time.perf_counter() - t_phase:.1f} s)")
    assert math.isfinite(f1)
    assert all(bool(torch.isfinite(p).all()) for p in st.params.values())
    assert int(metrics["quarantined_edges"]) > 0
    del st
    torch.cuda.empty_cache()


def phase_options_claims(torch):
    """The twins of tests/test_convergence.py's lsvrg claim (W_h = 12,
    B = 5, n = 960, 700 steps, p = 1/80; sign_flip asserted as the
    reference asserts it; under gaussian the reference's own run fails its
    third bound -- lsvrg 0.00617 against 0.75 x SGD's 0.00500 -- so only
    the two bounds it meets are asserted) and of tests/test_guards.py's
    fault containment on the simulated master (n = 600, 8 workers, 3 fault
    rows, 150 steps)."""
    from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    t_phase = time.perf_counter()
    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=960, device="cuda")
    batch = {"a": data.x, "b": data.y}
    _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
    wd = partition(batch, 12, seed=1, device="cuda")
    for attack in ("sign_flip", "gaussian"):
        gaps = {}
        for vr in ("saga", "lsvrg", "sgd"):
            params, _ = federated_run(torch, loss, wd, 700, 7, aggregator="geomed",
                                      vr=vr, attack=attack, num_byzantine=5,
                                      lsvrg_p=1 / 80)
            gaps[vr] = float(loss(params, batch)) - f_star
        factor = 0.5 if attack == "sign_flip" else 0.75
        log(f"lsvrg claim {attack}: gap lsvrg {gaps['lsvrg']:.5f} (< 0.1, < 2 x "
            f"max(SAGA {gaps['saga']:.5f}, 0.03)), SGD {gaps['sgd']:.5f} "
            f"({factor} x SGD = {factor * gaps['sgd']:.5f}"
            f"{'' if attack == 'sign_flip' else ', not asserted: the reference fails it'})")
        assert gaps["lsvrg"] < 0.1, gaps
        assert gaps["lsvrg"] < 2 * max(gaps["saga"], 0.03), gaps
        if attack == "sign_flip":
            assert gaps["lsvrg"] < factor * gaps["sgd"], gaps
    data = ijcnn1_like(SEED, n=600, device="cuda")
    batch = {"a": data.x, "b": data.y}
    wd = partition(batch, 8, seed=1, device="cuda")

    def train(steps=150, **cfg):
        params, _ = federated_run(torch, loss, wd, steps, 3, lr=0.05,
                                  aggregator="geomed", vr="saga", **cfg)
        return float(loss(params, batch))

    floor = train(attack="none", num_byzantine=0)
    for attack in ("nan", "inf_overflow", "bitflip"):
        guarded = train(attack=attack, num_byzantine=3, guards=True,
                        bitflip_prob=0.5)
        log(f"fault containment {attack}: guarded loss {guarded:.6f} <= 2 x "
            f"attack-free {floor:.6f} + 1e-3")
        assert math.isfinite(guarded) and guarded <= 2.0 * floor + 1e-3, (guarded, floor)
    bare = train(steps=5, attack="nan", num_byzantine=3)
    log(f"fault containment nan without guards: loss {bare} (not finite)")
    assert not math.isfinite(bare)
    log(f"options claims phase {time.perf_counter() - t_phase:.1f} s")


def phase_options(torch, card, errs, counts, timing, b_geomed):
    """Phase 16: K1's client-row checks, workload G, workload B's and D's
    option runs and the two claims."""
    t0 = time.perf_counter()
    errs["saga_correct clients"] = phase_client_row_checks(torch)
    g_counts, timing["saga_correct clients"] = phase_workload_g(
        torch, card, b_geomed["peak_gb"])
    counts.update(g_counts)
    phase_options_b(torch, card, b_geomed)
    phase_options_d(torch, card)
    phase_options_claims(torch)
    log(f"options phases {time.perf_counter() - t0:.1f} s")


# ---- Phase 17: the wires (bfloat16, int8, sign1) --------------------------------

# The bf16 routes in the kernels line: entry -> (the key of its launches in
# launch_counts(), the run whose counts give them).
BF16_KERNELS = {
    "saga_correct bf16": ("saga_correct bf16", "B bfloat16 geomed"),
    "saga_correct clients bf16": ("saga_correct clients bf16", "G1 bfloat16"),
    "partial_sqdist bf16": ("partial_sqdist bf16", "B bfloat16 geomed"),
    "weighted_sum bf16": ("weighted_sum bf16", "B bfloat16 geomed"),
    "coordinate_median bf16": ("coordinate_median bf16", "B bfloat16 median"),
    "trimmed_mean bf16": ("trimmed_mean bf16", "B bfloat16 trimmed_mean"),
    "trimmed_mean bf16 pairs": ("trimmed_mean pairs", "B bfloat16 trimmed_mean"),
    "partial_sqdist_segments bf16": ("partial_sqdist_segments bf16",
                                     "B bfloat16 geomed_blockwise"),
    "masked_neighbor_reduce bf16": ("masked_neighbor_reduce select bf16",
                                    "D gradient trimmed_mean bfloat16"),
    "partial_sqdist masked bf16": ("partial_sqdist masked bf16",
                                   "D gradient geomed bfloat16"),
    "masked_neighbor_reduce sum bf16": ("masked_neighbor_reduce sum bf16",
                                        "D gradient geomed bfloat16"),
}
# The wires phase's runs: workload B (wire, rule), workload D (wire, gossip,
# rule).
WIRE_B_RUNS = (("bfloat16", "geomed"), ("bfloat16", "median"),
               ("bfloat16", "trimmed_mean"), ("bfloat16", "geomed_blockwise"),
               ("int8", "geomed"), ("sign1", "geomed"))
WIRE_D_RUNS = (("bfloat16", "gradient", "geomed"),
               ("bfloat16", "gradient", "trimmed_mean"),
               ("sign1", "params", "geomed"))
# K5's bf16 pairs layout at B's (70, 39,760), trim 20: the time predicted
# before its first card run (us, an H100 SXM at 700 W), printed beside the
# measured one.
K5_PAIRS_PREDICTED_US = (5.5, 7.5)
# Each wires run's printed mean loss, accuracy and Weiszfeld iterations a
# step.  Every kernel's bf16 route gives the float32 kernel's bits on the
# upcast (K1 its plain version's bf16 ops), so these are fixed by the seeds:
# a kernel change that moves one of them changed the result, not the speed.
WIRE_RUN_RESULTS = {
    "B bfloat16 geomed": ("1.966829", "0.8525", "12.40"),
    "B bfloat16 median": ("1.826405", "0.9598", "0.00"),
    "B bfloat16 trimmed_mean": ("1.959949", "0.8490", "0.00"),
    "B bfloat16 geomed_blockwise": ("1.971895", "0.8582", "0.00"),
    "B int8 geomed": ("1.966960", "0.8520", "12.45"),
    "B sign1 geomed": ("2.037521", "0.6797", "12.45"),
    "G1 sign1": ("1.176075", "1.0000", "30.15"),
    "G1 bfloat16": ("0.347716", "1.0000", "21.55"),
    "D gradient geomed bfloat16": ("2.024719", "0.7007", "63.50"),
    "D gradient trimmed_mean bfloat16": ("1.952774", "0.6960", "0.00"),
    "D params geomed sign1": ("2.302547", "0.1021", "64.00"),
}


def raw_bits(t):
    """A float32 or bfloat16 tensor's bits, as integers."""
    import torch
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


def same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and torch.equal(raw_bits(a), raw_bits(b))


def check_bf16_saga(torch, w, j, d, gen, c=None):
    """K1's bf16 route (the worker route, or with ``c`` the client-row
    route on a (c, j, d) resident table through w distinct rows) against its
    plain version on the same bf16 tensors: msg, avg and table bitwise, only
    the drawn rows changed.  Returns the largest |msg difference| (0.0)."""
    from repro_torch.kernels import saga_correct as sc
    dev = torch.device("cuda")
    c = w if c is None else c
    table = torch.randn((c, j, d), generator=gen, device=dev).bfloat16()
    avg = torch.randn((c, d), generator=gen, device=dev).bfloat16()
    g = torch.randn((w, d), generator=gen, device=dev).bfloat16()
    idx = torch.randint(0, j, (w,), generator=gen, device=dev)
    rows = None if c == w else torch.randperm(c, generator=gen, device=dev)[:w]
    r = torch.arange(w, device=dev) if rows is None else rows
    t_k, a_k = table.clone(), avg.clone()
    msg_k = sc.saga_correct_call(g, t_k, a_k, idx, rows)
    torch.cuda.synchronize()
    assert same_bits(t_k[r, idx], g), "K1 bf16: drawn rows != gradient"
    msg_p = sc.saga_correct_plain(g, table, avg, idx, rows)
    torch.cuda.synchronize()
    assert same_bits(msg_k, msg_p), "K1 bf16: msg != plain bf16 ops"
    assert same_bits(a_k, avg), "K1 bf16: avg != plain bf16 ops"
    assert same_bits(t_k, table), "K1 bf16: table != plain (other rows moved?)"
    err = float((msg_k.float() - msg_p.float()).abs().max())
    del table, t_k
    torch.cuda.empty_cache()
    return err


def check_bf16_flat(torch, w, d, trim, bounds, gen):
    """K2, K3, K4, K5 and K6 on a bf16 (w, d) z: float32 out, the bits of
    the float32 kernel on z.float(), and the plain version (on the bf16 z)
    within rtol 1e-5.  Returns the largest |difference| from the plain
    version per kernel."""
    from repro_torch.core.geomed import segment_ids
    from repro_torch.kernels import robust_stats as rs
    from repro_torch.kernels import weiszfeld as wz
    dev = torch.device("cuda")
    zb = torch.randn((w, d), generator=gen, device=dev).bfloat16()
    zb[min(1, w - 1)] = zb[0]                          # ties
    zf = zb.float()
    y = zf.mean(0) + 0.1 * torch.randn((d,), generator=gen, device=dev)
    a = torch.rand((w,), generator=gen, device=dev) + 0.5
    seg = segment_ids(tuple(bounds), d, dev)
    nseg = len(bounds)
    calls = {
        "partial_sqdist": (lambda z: wz.partial_sqdist_call(z, y),
                           lambda z: wz.partial_sqdist_plain(z, y)),
        "weighted_sum": (lambda z: wz.weighted_sum_call(z, a),
                         lambda z: wz.weighted_sum_plain(z, a)),
        "coordinate_median": (rs.coordinate_median_call, rs.coordinate_median_plain),
        "trimmed_mean": (lambda z: rs.trimmed_mean_call(z, trim),
                         lambda z: rs.trimmed_mean_plain(z, trim)),
        "partial_sqdist_segments": (
            lambda z: wz.partial_sqdist_segments_call(z, y, seg, nseg),
            lambda z: wz.partial_sqdist_segments_plain(z, y, seg, nseg)),
    }
    errs = {}
    for name, (call, plain) in calls.items():
        got = call(zb)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32, name
        assert same_bits(got, call(zf)), f"{name} bf16 != float32 kernel on z.float()"
        ok, errs[name] = close(got, plain(zb))
        assert ok, f"{name} bf16 disagrees with its plain version: {errs[name]}"
    check_bf16_layouts(torch, zb, y, trim)
    return errs


def check_bf16_layouts(torch, zb, y, trim):
    """K2's and K4's bf16 layouts on zb (w, d) and on a view of it that
    takes the other layout: K2 in one launch ("cluster") where d % 8 == 0,
    its two passes on a column slice one element in; K4 two columns a
    thread ("pairs") where w <= 128 and d is even, one a thread on a copy at
    an odd storage offset.  Each the float32 kernel's bits on the upcast
    laid out alike; K4 also on columns of +-inf and (on the network route)
    trim and trim + 1 NaN, with NaN and +-inf where the plain version has
    them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import robust_stats as rs
    from repro_torch.kernels import weiszfeld as wz
    w, d = zb.shape
    zs = zb[:, 1:]
    for x, yy, layout in ((zb, y, "cluster" if d % 8 == 0 else "two-pass"),
                          (zs, y[1:].contiguous(), "two-pass")):
        ops.reset_launch_counts()
        got = wz.partial_sqdist_call(x, yy)
        assert wz.SQDIST_LAYOUT_LAUNCHES[layout] == 1, (layout, wz.SQDIST_LAYOUT_LAUNCHES)
        assert same_bits(got, wz.partial_sqdist_call(x.float(), yy)), f"K2 bf16 {layout}"
    zn = zb.clone()
    zn[: w // 3 + 1, : d // 16] = float("inf")
    zn[w // 3 + 1: w // 2 + 1, d // 32: d // 8] = float("-inf")
    network = w <= rs.NETWORK_CAP
    if network:
        zn[:trim, d - 64: d - 32] = float("nan")
        zn[:trim + 1, d - 32:] = float("nan")
    odd = torch.empty(w * d + 1, dtype=torch.bfloat16, device=zb.device)[1:].view(w, d)
    odd.copy_(zn)
    pairs = network and d % 2 == 0
    for x, layout in ((zb, "pairs" if pairs else "one"), (zn, "pairs" if pairs else "one"),
                      (odd, "one")):
        ops.reset_launch_counts()
        got = rs.coordinate_median_call(x)
        torch.cuda.synchronize()
        assert rs.MEDIAN_LAYOUT_LAUNCHES[layout] == 1, (layout, rs.MEDIAN_LAYOUT_LAUNCHES)
        assert same_bits(got, rs.coordinate_median_call(x.float())), f"K4 bf16 {layout}"
        if network:
            assert same_values(got, rs.coordinate_median_plain(x)), f"K4 bf16 {layout}"


def check_bf16_masked(torch, r, s, d, trims, mask, gen, ties=True):
    """K7 (each trim), the masked and unmasked batched K2 and the batched K3
    on a bf16 (r, s, d) exchange, contiguous and as a column slice of a
    wider one (misaligned: the scalar loads): the float32 kernel's bits on
    the upcast laid out alike, and the plain versions within rtol 1e-5.
    K7 "select" (1 <= trim <= 16) takes two coordinates a thread on the
    contiguous exchange (d even) and one on the slice (a base 6 bytes off).
    Returns the largest differences (K7 trim > 0, K7 trim 0, K2 unmasked,
    K2 masked, K3)."""
    from repro_torch.kernels import topology as tp
    from repro_torch.kernels import weiszfeld as wz
    dev = torch.device("cuda")
    wide = torch.randn((r, s, d + 3), generator=gen, device=dev).bfloat16()
    if ties:
        wide[:, 1] = wide[:, 0]
    widef = wide.float()
    if mask is None:
        mask = (torch.rand((r, s), generator=gen, device=dev) < 0.6).float()
        mask[:, :min(s, 2 * max(t or 0 for t in trims) + 2)] = 1.0
    y = torch.randn((r, d), generator=gen, device=dev)
    n_min = int(mask.sum(1).min())
    e7 = e7s = e2 = e2m = e3 = 0.0
    assert d % 2 == 0, d
    for x, xf, layout in ((wide[..., :d].contiguous(), widef[..., :d].contiguous(), "pairs"),
                          (wide[..., 3:], widef[..., 3:], "one")):
        for t in trims:
            t = (n_min - 1) // 2 if t is None else t
            before = dict(tp.SELECT_LAYOUT_LAUNCHES)
            got = tp.masked_neighbor_reduce_call(x, mask, t)
            ran = {k: v - before[k] for k, v in tp.SELECT_LAYOUT_LAUNCHES.items()}
            want = {k: int(k == layout and 1 <= t <= 16) for k in tp.SELECT_LAYOUTS}
            assert ran == want, f"K7 bf16 trim {t}: layouts {ran}, want {want}"
            assert same_bits(got, tp.masked_neighbor_reduce_call(xf, mask, t)), t
            ok, e = close(got, tp.masked_neighbor_reduce_plain(x, mask, t))
            assert ok, f"K7 bf16 trim {t}: {e}"
            if t:
                e7 = max(e7, e)
            else:
                e7s = max(e7s, e)
        for m in (None, mask):
            got = wz.partial_sqdist_call(x, y, m)
            assert same_bits(got, wz.partial_sqdist_call(xf, y, m))
            ok, e = close(got, wz.partial_sqdist_plain(x, y, m))
            assert ok, f"K2 bf16 (mask {m is not None}): {e}"
            if m is None:
                e2 = max(e2, e)
            else:
                e2m = max(e2m, e)
        got = wz.weighted_sum_call(x, mask)
        assert same_bits(got, wz.weighted_sum_call(xf, mask))
        ok, e = close(got, wz.weighted_sum_plain(x, mask))
        assert ok, f"K3 bf16 batched: {e}"
        e3 = max(e3, e)
        torch.cuda.synchronize()
    del wide, widef
    torch.cuda.empty_cache()
    return e7, e7s, e2, e2m, e3


def check_bf16_trimmed_pairs(torch):
    """K5's bf16 pairs layout against the float32 kernel on the upcast, bit
    for bit (NaN included), at W = 1..9, 20, 70, 127 and 128 and trims 0, 1,
    (W - 1) // 2 and 20 where valid: ties, +-0, +-inf, and columns with trim
    (of +NaN) and trim + 1 (of -NaN) NaN; "pairs" at D = 300, "one" at D =
    301 and on a copy at an odd storage offset; the plain version at rtol
    1e-5 with NaN and +-inf where it has them.  Returns the largest
    difference from the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import robust_stats as rs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    err, cases, nan_bits = 0.0, 0, set()
    for w in (*range(1, 10), 20, 70, 127, 128):
        for trim in sorted({t for t in (0, 1, (w - 1) // 2, 20) if 2 * t < w}):
            for d in (300, 301):
                z = torch.randn((w, d), generator=gen, device="cuda").bfloat16()
                z[:, :40] = torch.round(2 * z[:, :40].float()).bfloat16()
                z[: w // 3 + 1, 40:50] = float("inf")
                z[w // 3 + 1: w // 2 + 1, 45:60] = float("-inf")
                z[:trim, 60:70] = float("nan")
                z[:trim + 1, 70:80] = -float("nan")
                z[:, 90:110] = 0.0
                z[::2, 90:110] = -0.0
                odd = torch.empty(w * d + 1, dtype=torch.bfloat16,
                                  device="cuda")[1:].view(w, d)
                odd.copy_(z)
                for x, layout in ((z, "pairs" if d % 2 == 0 else "one"), (odd, "one")):
                    ops.reset_launch_counts()
                    got = rs.trimmed_mean_call(x, trim)
                    torch.cuda.synchronize()
                    assert rs.TRIMMED_LAYOUT_LAUNCHES[layout] == 1, (
                        w, trim, d, layout, rs.TRIMMED_LAYOUT_LAUNCHES)
                    assert same_bits(got, rs.trimmed_mean_call(x.float(), trim)), (
                        f"K5 bf16 {layout}: W {w}, trim {trim}, D {d}")
                    assert bool(torch.isnan(got[70:80]).all()), (w, trim)
                    want = rs.trimmed_mean_plain(x, trim)
                    assert torch.equal(torch.isnan(got), torch.isnan(want)), (w, trim)
                    inf = torch.isinf(want)
                    assert torch.equal(got[inf], want[inf]), (w, trim)
                    fin = torch.isfinite(want)
                    ok, e = close(got[fin], want[fin])
                    assert ok, f"K5 bf16 {layout} W {w} trim {trim}: {e}"
                    err = max(err, e)
                    cases += 1
                    nan_bits.update(int(b) for b in raw_bits(got[70:80]).unique().tolist())
    log(f"kernel check K5 bf16 pairs: {cases} cases (W 1..9, 20, 70, 127, 128 x trims "
        "0, 1, (W-1)//2, 20 x D 300/301 and an odd offset): the float32 kernel's bits "
        "on the upcast (zeros' signs, +-inf, NaN), \"pairs\" at even D on an aligned "
        "base, \"one\" otherwise; NaN words "
        + ", ".join(f"0x{b & 0xffffffff:08x}" for b in sorted(nan_bits))
        + f" (the float32 kernel's NAN); max|err| against the plain {err:.3g} "
        "(rtol 1e-5): ok")
    return err


def phase_wires_kernel_checks(torch):
    """Every bf16 route against its plain version and, K2-K7, against the
    float32 kernel on the upcast input, at the ragged and the workloads'
    shapes and past each route's cap.  Returns the errors per entry of
    BF16_KERNELS."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    errs = dict.fromkeys(BF16_KERNELS, 0.0)
    bounds_b, d_b = table1_boundaries(torch)
    for w, j, d, c in ((7, 3, 300, None), (50, 1200, d_b, None),
                       (7, 3, 300, 13), (G_COHORT, 120, d_b, G_CLIENTS)):
        e = check_bf16_saga(torch, w, j, d, gen, c)
        key = "saga_correct bf16" if c is None else "saga_correct clients bf16"
        errs[key] = max(errs[key], e)
        log(f"kernel check K1 bf16 table ({c or w}, {j}, {d})"
            f"{f', {w} client rows' if c else ''}: msg, avg and table bitwise the "
            "plain version's bf16 ops, only the drawn rows changed: ok")
    ragged = ((0, 100), (100, 220), (220, 280))
    for w, d, trim, bounds in ((7, 300, 2, ragged), (8, 300, 3, ragged),
                               (70, d_b, 20, bounds_b), (455, d_b, 100, bounds_b),
                               (129, 1000, 40, ((0, 1000),))):
        e = check_bf16_flat(torch, w, d, trim, bounds, gen)
        for name, v in e.items():
            errs[f"{name} bf16"] = max(errs[f"{name} bf16"], v)
        log(f"kernel check bf16 messages ({w}, {d}), trim {trim}: K2, K3, K4, K5 "
            "and K6 the float32 kernels' bits on z.float() (K2 "
            f"{'in one launch' if d % 8 == 0 else 'in two passes'} and on a slice in "
            f"two, K4 {'two columns' if w <= 128 and d % 2 == 0 else 'one column'} a "
            "thread and one on an odd offset, with +-inf and NaN columns); max|err| "
            "against the "
            + ", ".join(f"{k} {v:.3g}" for k, v in e.items()) + " (rtol 1e-5): ok")
    mask_d = workload_d_graph(torch)[1]
    for (r, s_, d), trims, mask in (((7, 7, 300), (0, 1, 2), None),
                                    ((70, 70, d_b), range(17), mask_d),
                                    ((4, 451, 1000), (0, 1, 12, 17, None), None)):
        e7, e7s, e2, e2m, e3 = check_bf16_masked(torch, r, s_, d, trims, mask, gen)
        errs["masked_neighbor_reduce bf16"] = max(errs["masked_neighbor_reduce bf16"], e7)
        errs["masked_neighbor_reduce sum bf16"] = max(
            errs["masked_neighbor_reduce sum bf16"], e7s)
        errs["partial_sqdist bf16"] = max(errs["partial_sqdist bf16"], e2)
        errs["partial_sqdist masked bf16"] = max(errs["partial_sqdist masked bf16"], e2m)
        errs["weighted_sum bf16"] = max(errs["weighted_sum bf16"], e3)
        log(f"kernel check bf16 exchange ({r}, {s_}, {d}), contiguous and a "
            f"misaligned column slice, trim {list(trims)}: K7 (\"select\" two "
            f"coordinates a thread on the contiguous exchange, one on the slice), "
            f"batched K2 (both routes), K3 the float32 kernels' bits; max|err| K7 "
            f"{e7:.3g} (trim 0 {e7s:.3g}), K2 {e2:.3g}, masked K2 {e2m:.3g}, K3 "
            f"{e3:.3g} (rtol 1e-5): ok")
    errs["trimmed_mean bf16 pairs"] = check_bf16_trimmed_pairs(torch)
    log(f"wires kernel checks {time.perf_counter() - t0:.1f} s")
    return errs


def phase_wires_timing(torch):
    """Each bf16 route's device time beside the float32 route on the same
    values in the same phase, its bound (the message bytes at 2 B) and its
    plain version: B's shapes (torch.profiler), K1's client-row route on
    G's (500, 120, D) table, D's exchange (CUDA events); and K7 "select"'s
    time in each layout beside its instruction floor."""
    from repro_torch.core.geomed import segment_ids
    from repro_torch.kernels import ops
    from repro_torch.kernels import robust_stats as rs
    from repro_torch.kernels import saga_correct as sc
    from repro_torch.kernels import topology as tp
    from repro_torch.kernels import weiszfeld as wz
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    bounds_b, d = table1_boundaries(torch)
    w, j = 50, 1200
    out, f32 = {}, {}
    # K1 on a (50, 1,200, D) table in float32 and in bf16 (the same values),
    # then the client-row route on the same storage viewed as G's (500, 120,
    # D) table, a fresh draw (and cohort) each call.
    t32 = 0.01 * torch.randn((w, j, d), generator=gen, device="cuda")
    t16 = t32.bfloat16()
    a32 = t32[:, 0].contiguous()
    a16 = a32.bfloat16()
    g32 = 0.01 * torch.randn((w, d), generator=gen, device="cuda")
    g16 = g32.bfloat16()
    reps = 50
    draws = iter([torch.randint(0, j, (w,), generator=gen, device="cuda")
                  for _ in range(10 * (reps + 3))])
    cohorts = iter([torch.randperm(G_CLIENTS, generator=gen, device="cuda")[:G_COHORT]
                    for _ in range(10 * (reps + 3))])
    gidx = iter([torch.randint(0, 120, (G_COHORT,), generator=gen, device="cuda")
                 for _ in range(10 * (reps + 3))])
    for dt, tab, avg, g in (("bf16", t16, a16, g16), ("f32", t32, a32, g32)):
        el = tab.element_size()
        b, by = bound(6 * w * d * el + w * 8, 4 * w * d)
        res = dict(
            ms=device_ms(torch, lambda: sc.saga_correct_call(g, tab, avg, next(draws)), reps),
            plain_ms=device_ms(torch, lambda: sc.saga_correct_plain(
                g, tab, avg, next(draws)), reps),
            bound_ms=b, bound_by=by, library_ms=None)
        (out if dt == "bf16" else f32)["saga_correct bf16"] = res
        gt, ga = tab.view(G_CLIENTS, 120, d), avg.repeat(10, 1)
        b, by = bound(6 * G_COHORT * d * el + G_COHORT * 16, 4 * G_COHORT * d)
        res = dict(
            ms=device_ms(torch, lambda: sc.saga_correct_call(
                g, gt, ga, next(gidx), next(cohorts)), reps),
            plain_ms=device_ms(torch, lambda: sc.saga_correct_plain(
                g, gt, ga, next(gidx), next(cohorts)), reps),
            bound_ms=b, bound_by=by, library_ms=None)
        (out if dt == "bf16" else f32)["saga_correct clients bf16"] = res
    del t32, t16
    torch.cuda.empty_cache()
    wm = w + 20
    z32 = 0.01 * torch.randn((wm, d), generator=gen, device="cuda")
    z16 = z32.bfloat16()
    z32 = z16.float()                     # the same values in both
    y = z32.mean(0)
    a = torch.rand((wm,), generator=gen, device="cuda") + 0.5
    seg = segment_ids(tuple(bounds_b), d, torch.device("cuda"))
    nseg = len(bounds_b)
    for dt, z in (("bf16", z16), ("f32", z32)):
        el = z.element_size()
        rows = {
            "partial_sqdist bf16": (lambda: wz.partial_sqdist_call(z, y),
                                    lambda: wz.partial_sqdist_plain(z, y),
                                    wm * d * el + d * 4 + wm * 4, 3 * wm * d),
            "weighted_sum bf16": (lambda: wz.weighted_sum_call(z, a),
                                  lambda: wz.weighted_sum_plain(z, a),
                                  wm * d * el + wm * 4 + d * 4, 2 * wm * d),
            "coordinate_median bf16": (lambda: rs.coordinate_median_call(z),
                                       lambda: rs.coordinate_median_plain(z),
                                       wm * d * el + d * 4, wm * d),
            "trimmed_mean bf16": (lambda: rs.trimmed_mean_call(z, 20),
                                  lambda: rs.trimmed_mean_plain(z, 20),
                                  wm * d * el + d * 4, wm * d),
            "partial_sqdist_segments bf16": (
                lambda: wz.partial_sqdist_segments_call(z, y, seg, nseg),
                lambda: wz.partial_sqdist_segments_plain(z, y, seg, nseg),
                wm * d * el + 2 * d * 4 + wm * nseg * 4, 3 * wm * d),
        }
        for name, (call, plain, nbytes, flops) in rows.items():
            b, by = bound(nbytes, flops)
            (out if dt == "bf16" else f32)[name] = dict(
                ms=device_ms(torch, call, 200), plain_ms=device_ms(torch, plain, 200),
                bound_ms=b, bound_by=by, library_ms=None)
    # D's exchange under its mask: K7 trim 12 and 0, the masked K2, K3.
    _, mask, trim = workload_d_graph(torch)
    r, s = mask.shape
    ex16 = (0.01 * torch.randn((r, s, d), generator=gen, device="cuda")).bfloat16()
    ex32 = ex16.float()
    nnz = float(mask.sum())
    yd = tp.masked_neighbor_reduce_call(ex32, mask, 0)
    ad = torch.rand((r, s), generator=gen, device="cuda") * mask
    layouts = {}
    for dt, ex in (("bf16", ex16), ("f32", ex32)):
        el = ex.element_size()
        ops.reset_launch_counts()
        tp.masked_neighbor_reduce_call(ex, mask, trim)
        layouts[dt] = [k for k, v in tp.SELECT_LAYOUT_LAUNCHES.items() if v][0]
        rows = {
            "masked_neighbor_reduce bf16": (
                lambda: tp.masked_neighbor_reduce_call(ex, mask, trim),
                lambda: tp.masked_neighbor_reduce_plain(ex, mask, trim),
                nnz * d * el + r * s * 4 + r * d * 4, nnz * d * (2 * trim + 1)),
            "masked_neighbor_reduce sum bf16": (
                lambda: tp.masked_neighbor_reduce_call(ex, mask, 0),
                lambda: tp.masked_neighbor_reduce_plain(ex, mask, 0),
                nnz * d * el + r * s * 4 + r * d * 4, nnz * d),
            "partial_sqdist masked bf16": (
                lambda: wz.partial_sqdist_call(ex, yd, mask),
                lambda: wz.partial_sqdist_plain(ex, yd, mask),
                nnz * d * el + r * d * 4 + 2 * r * s * 4, 3 * nnz * d),
            "weighted_sum batched bf16": (
                lambda: wz.weighted_sum_call(ex, ad),
                lambda: wz.weighted_sum_plain(ex, ad),
                float((ad != 0).sum()) * d * el + r * s * 4 + r * d * 4, 2 * nnz * d),
        }
        for name, (call, plain, nbytes, flops) in rows.items():
            b, by = bound(nbytes, flops)
            (out if dt == "bf16" else f32)[name] = dict(
                ms=event_ms(torch, call, 20), plain_ms=event_ms(torch, plain, 5),
                bound_ms=b, bound_by=by, library_ms=None)
    del ex16, ex32
    torch.cuda.empty_cache()
    for name, res in out.items():
        ref = f32[name]
        log(f"timing {name} (device time): {res['ms'] * 1e3:.2f} us, bound "
            f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}), plain "
            f"{res['plain_ms'] * 1e3:.2f} us; the float32 route on the same values "
            f"{ref['ms'] * 1e3:.2f} us (bound {ref['bound_ms'] * 1e3:.2f} us), "
            f"bf16/f32 {res['ms'] / ref['ms']:.3f}")
    # K2's bf16 route in one launch beside the float32 route's two kernels,
    # each by name (torch.profiler), and K4's two columns a thread beside the
    # instruction floor of its packed min/max (one a pair) and float32's (one
    # a coordinate).
    split = {dt: kernel_split(torch, lambda: wz.partial_sqdist_call(z, y), 200)
             for dt, z in (("bf16", z16), ("f32", z32))}
    assert len(split["bf16"]) == 1 and "sqdist_cluster_kernel" in next(iter(split["bf16"])), split
    log(f"timing partial_sqdist bf16 ({wm}, {d}) by kernel: "
        + " + ".join(f"{k} {v:.2f} us" for k, v in split["bf16"].items())
        + " (one launch, the finish in a thread-block cluster); float32 route: "
        + " + ".join(f"{k} {v:.2f} us" for k, v in split["f32"].items()))
    sms, mhz = sm_clock(torch)
    n_minmax = rs.median_network_ops(wm)
    floor16 = n_minmax * (d // 2) / (sms * 64 * mhz * 1e6) * 1e3
    res, ref = out["coordinate_median bf16"], f32["coordinate_median bf16"]
    log(f"timing coordinate_median bf16 pairs ({wm}, {d}): {res['ms'] * 1e3:.2f} us, "
        f"{floor16 / res['ms']:.0%} of its instruction floor {floor16 * 1e3:.2f} us "
        f"({n_minmax} packed min/max a pair x {d // 2} pairs / ({sms} SMs x 64 a clock x "
        f"{mhz:.0f} MHz)) and {res['bound_ms'] / res['ms']:.0%} of its bytes bound "
        f"{res['bound_ms'] * 1e3:.2f} us; float32 (one column a thread) "
        f"{ref['ms'] * 1e3:.2f} us, floor {2 * floor16 * 1e3:.2f} us")
    # K5's bf16 route two columns a thread beside one a thread on the same
    # values (a copy at an odd storage offset) and the float32 route, its
    # bytes bound and the instruction floor of its unpruned network on packed
    # min/max (one a pair).
    odd16 = torch.empty(wm * d + 1, dtype=torch.bfloat16, device="cuda")[1:].view(wm, d)
    odd16.copy_(z16)
    ops.reset_launch_counts()
    rs.trimmed_mean_call(z16, 20)
    rs.trimmed_mean_call(odd16, 20)
    assert rs.TRIMMED_LAYOUT_LAUNCHES == {"one": 1, "pairs": 1}, rs.TRIMMED_LAYOUT_LAUNCHES
    pairs_ms = device_ms(torch, lambda: rs.trimmed_mean_call(z16, 20), 200)
    one_ms = device_ms(torch, lambda: rs.trimmed_mean_call(odd16, 20), 200)
    del odd16
    n_t = rs.trimmed_network_ops(wm)
    floor_t = n_t * (d // 2) / (sms * 64 * mhz * 1e6) * 1e3
    res, ref = out["trimmed_mean bf16"], f32["trimmed_mean bf16"]
    out["trimmed_mean bf16 pairs"] = dict(res, ms=pairs_ms)
    lo, hi = K5_PAIRS_PREDICTED_US
    log(f"timing trimmed_mean bf16 pairs ({wm}, {d}), trim 20: {pairs_ms * 1e3:.2f} us "
        f"(predicted {lo}-{hi} us before the first card run), "
        f"{floor_t / pairs_ms:.0%} of its instruction floor {floor_t * 1e3:.2f} us "
        f"({n_t} packed min/max a pair x {d // 2} pairs / ({sms} SMs x 64 a clock x "
        f"{mhz:.0f} MHz)) and {res['bound_ms'] / pairs_ms:.0%} of its bytes bound "
        f"{res['bound_ms'] * 1e3:.2f} us; one column a thread on the same values "
        f"{one_ms * 1e3:.2f} us; float32 {ref['ms'] * 1e3:.2f} us, floor "
        f"{2 * floor_t * 1e3:.2f} us")
    # K7 "select" is bound by its integer min/max, not bytes: its instruction
    # floor beside each layout's time.
    assert layouts == {"bf16": "pairs", "f32": "one"}, layouts
    res, ref = out["masked_neighbor_reduce bf16"], f32["masked_neighbor_reduce bf16"]
    fl16, n_ops = select_floor_ms(torch, mask, trim, d, 2)
    fl32, _ = select_floor_ms(torch, mask, trim, d, 1)
    log(f"timing masked_neighbor_reduce select trim {trim} ({r}, {s}, {d}), {int(nnz)} "
        f"members: bf16 (two coordinates a thread) {res['ms'] * 1e3:.2f} us, "
        f"{fl16 / res['ms']:.0%} of its instruction floor {fl16 * 1e3:.2f} us; float32 "
        f"(one a thread) {ref['ms'] * 1e3:.2f} us, {fl32 / ref['ms']:.0%} of "
        f"{fl32 * 1e3:.2f} us; bytes bounds {res['bound_ms'] * 1e3:.2f} / "
        f"{ref['bound_ms'] * 1e3:.2f} us (floor: {n_ops} integer min/max a key word "
        f"over the receivers x {-(-d // 2)} pairs or {d} coordinates / ({sms} SMs x "
        f"64 a clock x {mhz:.0f} MHz); a packed 16x2 min/max orders a pair)")
    log(f"wires timing {time.perf_counter() - t0:.1f} s")
    return out


def phase_wires_runs(torch, card, b_peak_gb):
    """Workload B under each wire, G1 under sign1 and bfloat16, and D under
    bfloat16 and sign1, 20 steps each, each printing WIRE_RUN_RESULTS;
    returns their launch counts and summaries by run label."""
    t0 = time.perf_counter()
    counts, rows = {}, {}
    for wire, agg in WIRE_B_RUNS:
        label = f"B {wire} {agg}"
        counts[label], st, rows[label] = phase_workload_b(torch, agg, wire=wire)
        if wire == "sign1":
            assert tuple(st.ef.shape) == (50, st.vr.table.shape[-1]), st.ef.shape
            log(f"workload B sign1: residuals {tuple(st.ef.shape)} float32, max "
                f"|ef| {float(st.ef.abs().max()):.6g}")
            assert bool(torch.isfinite(st.ef).all()) and float(st.ef.abs().max()) > 0
        del st
        torch.cuda.empty_cache()
    bf = rows["B bfloat16 geomed"]
    log(f"workload B bfloat16: SAGA table {bf['table_gb']:.2f} GB, peak "
        f"{bf['peak_gb']:.2f} GB against the float32 wire's {b_peak_gb:.2f} GB")
    assert abs(bf["table_gb"] - 4.77) < 0.01 and bf["peak_gb"] < b_peak_gb, bf
    batch, wd = mnist_clients(torch, G_CLIENTS)
    for wire in ("sign1", "bfloat16"):
        label = f"G1 {wire}"
        st, step_fn, _, _, c, summ = nn_run(
            torch, f"workload {label} straggler", batch, wd,
            num_clients=G_CLIENTS, cohort_size=G_COHORT, message_dtype=wire,
            **G_RUNS[0][1])
        st, busy_us = profile_steps(torch, f"workload {label}", step_fn, st, 3,
                                    summ["step_ms"] / 1e3)
        summ.update(busy_us=busy_us, idle=1 - busy_us / (summ["step_ms"] * 1e3),
                    table_gb=st.vr.table.numel() * st.vr.table.element_size() / 1e9)
        assert c["saga_correct clients"] == 20 and c["saga_correct workers"] == 0, c
        if wire == "sign1":
            # Every client's residual row that a cohort manned has moved; the
            # others are still 0 (a 500-client table, 20 cohorts of 50).
            moved = int((st.ef.abs().amax(1) > 0).sum())
            log(f"workload {label}: residuals {tuple(st.ef.shape)}, {moved} of "
                f"{G_CLIENTS} client rows moved (the cohorts' rows, in place)")
            assert tuple(st.ef.shape) == (G_CLIENTS, st.vr.table.shape[-1])
            assert 0 < moved <= 20 * G_COHORT, moved
        else:
            assert c.get("saga_correct clients bf16", 0) == 20, c
            assert c["partial_sqdist cluster"] == c["partial_sqdist"] > 0, c
        counts[label], rows[label] = c, summ
        del st
        torch.cuda.empty_cache()
    for wire, gossip, agg in WIRE_D_RUNS:
        label = f"D {gossip} {agg} {wire}"
        counts[label], rows[label] = phase_workload_d(torch, gossip, agg, wire=wire)
    log(f"wires runs ({card}): step ms / device busy us / idle share / Weiszfeld "
        "iters per step / peak GB / loss / accuracy")
    for label, r in rows.items():
        log(f"  {label:<34} {r['step_ms']:9.3f} {r.get('busy_us', math.nan):9.1f} "
            f"{r.get('idle', math.nan):7.3f} {r['iters']:7.2f} {r['peak_gb']:7.2f} "
            f"{r['loss']:10.6f} {r['accuracy']:8.4f}")
    assert set(rows) == set(WIRE_RUN_RESULTS), sorted(rows)
    for label, want in WIRE_RUN_RESULTS.items():
        r = rows[label]
        got = (f"{r['loss']:.6f}", f"{r['accuracy']:.4f}", f"{r['iters']:.2f}")
        assert got == want, f"wires run {label}: (loss, accuracy, iters) {got} != {want}"
    log(f"wires runs: every loss, accuracy and iteration count as fixed by the seeds "
        f"({len(rows)} runs): ok")
    log(f"wires runs {time.perf_counter() - t0:.1f} s")
    return counts, rows


def phase_wires_claims(torch):
    """Twins of tests/test_convergence.py's quantized-wire floor (W_h = 12,
    B = 5, n = 960, 700 steps, geomed, SAGA, sign_flip) and of
    tests/test_packing.py's bf16-tracks-f32 check (n = 400, 8 workers, B = 2,
    16 Weiszfeld iterations, 10 steps)."""
    from repro_torch.data import (ijcnn1_like, logreg_full_loss_and_opt,
                                  logreg_loss, partition)
    t0 = time.perf_counter()
    loss = logreg_loss(0.01)
    data = ijcnn1_like(SEED, n=960, device="cuda")
    batch = {"a": data.x, "b": data.y}
    _, f_star = logreg_full_loss_and_opt(data, iters=4000, lr=0.5)
    wd = partition(batch, 12, seed=1, device="cuda")
    gaps = {}
    for wire in ("float32", "int8", "sign1"):
        params, _ = federated_run(torch, loss, wd, 700, 7, aggregator="geomed",
                                  vr="saga", attack="sign_flip", num_byzantine=5,
                                  message_dtype=wire)
        gaps[wire] = float(loss(params, batch)) - f_star
    floor = max(gaps["float32"], 0.03)
    log(f"quantized wire claim sign_flip: gap float32 {gaps['float32']:.5f}, int8 "
        f"{gaps['int8']:.5f} (< 2 x {floor:.5f}), sign1 {gaps['sign1']:.5f} (< 4 x "
        f"{floor:.5f} and < 0.2)")
    assert gaps["int8"] < 2 * floor and gaps["sign1"] < 4 * floor, gaps
    assert gaps["sign1"] < 0.2, gaps
    data = ijcnn1_like(SEED, n=400, device="cuda")
    wd = partition({"a": data.x, "b": data.y}, 8, seed=1, device="cuda")
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.optim import get_optimizer
    out = {}
    for wire in ("float32", "bfloat16"):
        init_fn, step_fn = make_federated_step(
            loss, wd, RobustConfig(aggregator="geomed", vr="saga",
                                   attack="sign_flip", num_byzantine=2,
                                   weiszfeld_iters=16, message_dtype=wire),
            get_optimizer("sgd", 0.02), device="cuda")
        st = init_fn({"w": torch.zeros(22, device="cuda")}, 3)
        st, _, metrics = run_steps(torch, step_fn, st, 10)
        assert math.isfinite(float(metrics["honest_variance"]))
        out[wire] = st
    diff = float((out["bfloat16"].params["w"] - out["float32"].params["w"]).abs().max())
    log(f"bf16 wire claim: 10 steps, max |w_bf16 - w_f32| {diff:.3g} (< 5e-2), SAGA "
        f"table {out['bfloat16'].vr.table.dtype}")
    assert diff < 5e-2 and out["bfloat16"].vr.table.dtype == torch.bfloat16, diff
    log(f"wires claims {time.perf_counter() - t0:.1f} s")


def phase_wires(torch, card, b_peak_gb):
    """Phase 17: the bf16 routes' checks and times, the runs under each
    wire, the two claims.  Returns (errors, timing, counts by run,
    summaries by run)."""
    t0 = time.perf_counter()
    errs = phase_wires_kernel_checks(torch)
    timing = phase_wires_timing(torch)
    counts, rows = phase_wires_runs(torch, card, b_peak_gb)
    phase_wires_claims(torch)
    log(f"wires phase {time.perf_counter() - t0:.1f} s")
    return errs, timing, counts, rows


# ---- Phase 20: the per-leaf baseline (RobustConfig(packed=False)) -------------

# The rules whose per-leaf runs (B, and D gradient gossip) are held against
# the packed runs of the same process.
PERLEAF_RUNS = ("geomed", "trimmed_mean")


def step0_messages(torch):
    """Workload B's step-0 messages as per-leaf (70, ...) leaves: at step 0
    each honest worker's SAGA message is its table's mean, its full local
    gradient at the initial params (the drawn entry was computed at those
    params), then 20 sign_flip rows.  Returns (messages, is_byz)."""
    from repro_torch.core import attacks
    from repro_torch.data import mnist_like, partition
    from repro_torch.models import paper_nn
    data = mnist_like(SEED, n=60_000, device="cuda")
    wd = partition({"x": data.x, "y": data.y}, 50, seed=2, device="cuda")
    params = paper_nn.init_params(SEED + 7, device="cuda")
    grads = torch.func.vmap(torch.func.grad(paper_nn.nn_loss),
                            in_dims=(None, 0))(params, wd)
    msgs = attacks.apply_attack(attacks.AttackConfig("sign_flip", 20), grads)
    return msgs, torch.arange(70, device="cuda") >= 50


def phase_perleaf_aggregation(torch):
    """Every rule per leaf against the packed engine's shim on B's step-0
    messages (D = 39,760 in four leaves; the reference's own anchor, atol
    3e-5), and every masked rule per leaf against the flat engine on
    workload D's exchange of them ((70, 70, 39,760), atol 5e-5), with the
    kernel launches each per-leaf call made."""
    from repro_torch.core import aggregators, packing
    from repro_torch.kernels import ops
    from repro_torch.topology import build_exchange, masked
    t0 = time.perf_counter()
    msgs, is_byz = step0_messages(torch)
    opts = dict(trim=20, num_groups=5, num_byzantine=20, clip_radius=1.0)
    for name in aggregators.AGGREGATOR_NAMES:
        packed = aggregators.get_aggregator(name, **opts)(msgs)
        ops.reset_launch_counts()
        perleaf = aggregators.get_aggregator(name, perleaf=True, **opts)(msgs)
        torch.cuda.synchronize()
        c = {k: v for k, v in ops.launch_counts().items() if v}
        err = max(float((perleaf[k] - packed[k]).abs().max()) for k in msgs)
        log(f"per-leaf check B {name}: max |per-leaf - packed| {err:.3g} (atol 3e-5), "
            f"per-leaf launches {c}")
        assert err <= 3e-5, (name, err)
        if name in ("median", "trimmed_mean"):
            assert c == {"coordinate_median" if name == "median" else name: 4}, c
    topo_d, mask, trim = workload_d_graph(torch)
    spec = packing.pack_spec(msgs)
    wire = {k: v.clone() for k, v in msgs.items()}
    for v in wire.values():
        v[50:] = 0.0
    cfg = dict(aggregator="geomed", attack="sign_flip", num_byzantine=20)
    from repro_torch.core import RobustConfig
    attack = RobustConfig(**cfg).attack_config()
    # The per-leaf exchange (one tensor a leaf) is the packed exchange cut
    # at the leaf boundaries, bit for bit.
    leaves = build_exchange(wire, attack, mask, is_byz, spec=spec)
    exchange = build_exchange(spec.pack(wire), attack, mask, is_byz, spec=spec)
    assert torch.equal(spec.pack(leaves, batch_ndim=2), exchange)
    assert all(v.is_contiguous() for v in leaves.values())
    del exchange
    log("per-leaf check D exchange: four (70, 70, *shape) leaves, bitwise the "
        "packed (70, 70, 39,760) exchange")
    mopts = dict(trim=trim, num_groups=4, num_byzantine=20, clip_radius=1.0,
                 mixing=torch.as_tensor(topo_d.mixing, dtype=torch.float32,
                                        device="cuda") * mask)
    for name in masked.MASKED_AGGREGATOR_NAMES:
        flat = masked.masked_aggregate(name, leaves, mask, **mopts)
        ops.reset_launch_counts()
        perleaf = masked.masked_aggregate(name, leaves, mask, perleaf=True, **mopts)
        torch.cuda.synchronize()
        c = {k: v for k, v in launch_counts().items() if v}
        err = max(float((perleaf[k] - flat[k]).abs().max()) for k in leaves)
        log(f"per-leaf check D {name}: max |per-leaf - flat| {err:.3g} (atol 5e-5), "
            f"per-leaf launches {c}")
        assert err <= 5e-5, (name, err)
        if name == "trimmed_mean":
            assert c["masked_neighbor_reduce select"] == 4, c
        if name == "geomed":
            assert c["masked_neighbor_reduce sum"] == 4, c
            assert c["partial_sqdist masked"] == c["weighted_sum"] > 0, c
            assert c["partial_sqdist masked"] % 4 == 0, c
    del leaves, msgs, wire
    torch.cuda.empty_cache()
    log(f"per-leaf aggregation checks {time.perf_counter() - t0:.1f} s")


def phase_perleaf(torch, card, counts, summaries, summaries_d):
    """Phase 20: the per-leaf checks at full width, then workload B and D
    gradient gossip per leaf with PERLEAF_RUNS, 20 steps each: loss and
    accuracy within 1e-3 of the packed run's, four launches (one a leaf)
    where the packed run launches one, and the step time beside the packed
    run's (same process)."""
    t0 = time.perf_counter()
    phase_perleaf_aggregation(torch)
    for agg in PERLEAF_RUNS:
        c, st, r = phase_workload_b(torch, agg, packed=False)
        del st
        torch.cuda.empty_cache()
        p, pc = summaries[agg], counts[agg]
        kernel = "trimmed_mean" if agg == "trimmed_mean" else "partial_sqdist"
        log(f"per-leaf workload B {agg} ({card}): loss {r['loss']:.6f} (packed "
            f"{p['loss']:.6f}), accuracy {r['accuracy']:.4f} (packed {p['accuracy']:.4f}), "
            f"step {r['step_ms']:.3f} ms against {p['step_ms']:.3f} ms packed, device "
            f"busy {r['busy_us']:.1f} against {p['busy_us']:.1f} us a step; K1 "
            f"{c['saga_correct']} launches (packed {pc['saga_correct']}), {kernel} "
            f"{c[kernel]} (packed {pc[kernel]}), Weiszfeld iters/step {r['iters']:.2f} "
            f"(packed {p['iters']:.2f})")
        assert abs(r["loss"] - p["loss"]) < 1e-3, (agg, r["loss"], p["loss"])
        assert abs(r["accuracy"] - p["accuracy"]) < 1e-3, (agg, r, p)
        assert c["saga_correct"] == 4 * pc["saga_correct"], (c, pc)
        if agg == "trimmed_mean":
            assert c["trimmed_mean"] == 4 * pc["trimmed_mean"], (c, pc)
        else:   # one K2 and one K3 a leaf a Weiszfeld iteration
            assert c["partial_sqdist"] == c["weighted_sum"] > 0, c
            assert c["partial_sqdist"] % 4 == 0, c
    for agg in PERLEAF_RUNS:
        label = f"D gradient {agg}"
        c, r = phase_workload_d(torch, "gradient", agg, packed=False)
        p, pc = summaries_d[label], counts[label]
        log(f"per-leaf workload {label} ({card}): mean honest loss {r['loss']:.6f} "
            f"(packed {p['loss']:.6f}), accuracy {r['accuracy']:.4f} (packed "
            f"{p['accuracy']:.4f}), step {r['step_ms']:.3f} ms against "
            f"{p['step_ms']:.3f} ms packed, device busy {r['busy_us']:.1f} against "
            f"{p['busy_us']:.1f} us a step; K1 {c['saga_correct']} (packed "
            f"{pc['saga_correct']}), K7 {c['masked_neighbor_reduce']} (packed "
            f"{pc['masked_neighbor_reduce']}), masked K2 {c['partial_sqdist masked']}, "
            f"K3 {c['weighted_sum']}, Weiszfeld iters/step {r['iters']:.2f} (packed "
            f"{p['iters']:.2f})")
        assert abs(r["loss"] - p["loss"]) < 1e-3, (label, r["loss"], p["loss"])
        assert abs(r["accuracy"] - p["accuracy"]) < 1e-3, (label, r, p)
        assert c["saga_correct"] == 4 * pc["saga_correct"], (c, pc)
        assert c["masked_neighbor_reduce"] == 4 * pc["masked_neighbor_reduce"], (c, pc)
        if agg == "geomed":
            assert c["partial_sqdist masked"] == c["weighted_sum"] > 0, c
            assert c["partial_sqdist masked"] % 4 == 0, c
    log(f"per-leaf phase {time.perf_counter() - t0:.1f} s")


# ---- Phase 21: the port's twins of the two examples ---------------------------

# Steps of each twin, cut from 500 (the gallery) and 300 (the demo) so both
# run in well under 90 s.  At these steps the reference's own examples
# (examples/attack_gallery.py, examples/decentralized_gossip_demo.py, run on
# the CPU) hold every assertion below.  Under ipm at 100 steps, and under
# alie and ipm at 500, the reference's own gallery ends with mean below a
# robust rule, so those rows are printed, not asserted.
GALLERY_STEPS, DEMO_STEPS = 100, 100
GALLERY_ASSERTED = ("gaussian", "sign_flip", "zero_gradient")


def phase_twins():
    """The twins on the card: the gallery's geomed, median and krum end
    below mean under the paper's attacks; the demo's complete graph keeps
    the honest copies in consensus (distance 0, to 1e-12), the ring does
    not, and geomed ends below mean on the ring."""
    from repro_torch import attack_gallery, decentralized_gossip_demo
    t0 = time.perf_counter()
    log(f"twins: attack_gallery --steps {GALLERY_STEPS} (of 500), "
        f"decentralized_gossip_demo --steps {DEMO_STEPS} (of 300)")
    gaps = attack_gallery.main(["--steps", str(GALLERY_STEPS)])
    for attack in GALLERY_ASSERTED:
        for agg in ("geomed", "median", "krum"):
            assert gaps[attack, agg] < gaps[attack, "mean"], (attack, agg, gaps)
    log(f"gallery claim: geomed, median and krum end below mean under "
        f"{', '.join(GALLERY_ASSERTED)}: ok")
    out = decentralized_gossip_demo.main(["--steps", str(DEMO_STEPS), "--diagnostics"])
    # Every receiver of the complete graph sees the same exchange; only the
    # rounding of the per-receiver sums (row by row in a matmul) can tell the
    # copies apart.
    assert out["complete_geomed"][1] < 1e-12 and out["complete_mean"][1] < 1e-12, out
    assert out["ring_geomed"][1] > 0.0 and out["ring_mean"][1] > 0.0, out
    assert out["ring_geomed"][0] < out["ring_mean"][0], out
    log(f"demo claims: complete consensus {out['complete_geomed'][1]:.3g}, ring "
        f"{out['ring_geomed'][1]:.5f} (geomed) / {out['ring_mean'][1]:.5f} (mean); "
        f"ring honest loss geomed {out['ring_geomed'][0]:.4f} < mean "
        f"{out['ring_mean'][0]:.4f}: ok")
    log(f"twins {time.perf_counter() - t0:.1f} s")


# ---- Phase 18: the master's collectives across ranks ---------------------------

# The Table I network's gradient leaves (D = 39,760), the two meshes, and
# each rule's kernels on a rank's buffer.
DIST_LEAVES = {"b1": (50,), "b2": (10,), "w1": (784, 50), "w2": (50, 10)}
DIST_MESHES = (((4, 2), ("data", "model")), ((2, 4, 1), ("pod", "data", "model")))
DIST_KERNELS = {"geomed": ("partial_sqdist", "weighted_sum"),
                "geomed_groups": ("partial_sqdist", "weighted_sum"),
                "median": ("coordinate_median",),
                "centered_clip": ("coordinate_median",),
                "trimmed_mean": ("trimmed_mean",),
                "geomed_blockwise": ("partial_sqdist_segments", "weighted_sum"),
                "mean": (), "krum": ()}
DIST_WIRES = ("int8", "sign1", "bfloat16")
DIST_TIMEOUT = 300.0


def dist_cases(mesh_shape):
    """(rule, comm, wire) of every case on a mesh: every rule on both comm
    paths, and on the (4, 2) mesh geomed on each wire."""
    cases = [(name, comm, "float32") for name in FIG6_RULES
             for comm in ("gather", "sharded")]
    if len(mesh_shape) == 2:
        cases += [("geomed", comm, wire) for wire in DIST_WIRES
                  for comm in ("gather", "sharded")]
    return cases


def dist_shard(leaf, model, model_size):
    """A message leaf's shard of model rank ``model``: its last axis split
    ``model_size`` ways."""
    n = leaf.shape[-1] // model_size
    return leaf[..., model * n:(model + 1) * n]


def dist_rank(mesh, cases):
    """One rank of the distributed phase, on cuda:0: its worker's message
    (N(0, 1) draws from the seed, worker 0 Byzantine under sign_flip through
    ``distributed_attack``), then each case through
    ``distributed_aggregate`` or ``sharded_aggregate``, held against the
    single-process flat rule on the (W, D) stack that the rank builds from
    the draws without a collective, on the card.
    Returns, per case, its largest error, whether it passed, the
    milliseconds of the call and the kernels it launched."""
    import torch
    from repro_torch.core import packing
    from repro_torch.core.attacks import AttackConfig, apply_attack
    from repro_torch.core.robust_step import (RobustConfig,
                                              distributed_aggregate,
                                              distributed_attack,
                                              sharded_aggregate)
    from repro_torch.kernels import ops
    from repro_torch import collectives as coll
    from repro_torch.launch import mesh as mesh_lib
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    wnames = mesh_lib.worker_axes(mesh)
    wa, ma = mesh.axes(*wnames), mesh.axes("model")
    w, m_size, wid, mid = wa.size, ma.size, wa.index, ma.index
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {k: torch.randn((w,) + s, generator=gen, device="cuda")
            for k, s in sorted(DIST_LEAVES.items())}
    local = {k: dist_shard(v[wid], mid, m_size).contiguous()
             for k, v in rows.items()}
    attacked = distributed_attack(
        local, RobustConfig(attack="sign_flip", num_byzantine=1), mesh=mesh,
        worker_axes=wnames)
    # The reference stack, from this rank's own copy of every worker's draws
    # and no collective: the honest rows as drawn, row 0 the attack's.
    spec = packing.pack_spec(rows)
    honest = spec.pack({k: v[1:] for k, v in rows.items()})
    byz = spec.unpack(apply_attack(AttackConfig(name="sign_flip",
                                                num_byzantine=1),
                                   honest, spec=spec)[-1], batch_ndim=0)
    stack = {k: torch.cat([byz[k][None], v[1:]]) for k, v in rows.items()}
    # What the ranks hold, gathered, against it: the honest rows bitwise,
    # the Byzantine row within rtol 1e-5 (its honest mean is a sum over the
    # ranks, in another order).  Once checked, the held Byzantine row takes
    # row 0's place, so that the wires quantize the same bits on both sides.
    everyone = mesh.axes(*mesh.axis_names)
    ok_att, err_att = True, 0.0
    for k, v in attacked.items():
        parts = coll.all_gather(v, everyone).reshape((w, m_size) + tuple(v.shape))
        held = torch.cat([parts[:, j] for j in range(m_size)], dim=-1)
        good, e = close(held[0], stack[k][0])
        ok_att = ok_att and good and torch.equal(held[1:], stack[k][1:])
        err_att = max(err_att, e)
        stack[k] = torch.cat([held[:1], stack[k][1:]])
    out = {"attack": dict(ok=ok_att, err=err_att)}
    for name, comm, wire in cases:
        cfg = RobustConfig(aggregator=name, num_byzantine=1,
                           message_dtype=wire)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if comm == "gather":
            got = distributed_aggregate(attacked, cfg, mesh=mesh,
                                        worker_axes=wnames)
        else:
            got = sharded_aggregate(attacked, cfg, mesh=mesh,
                                    worker_axes=wnames, num_workers=w)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        # The single-process rule on what the receivers see: the quantized
        # wires' roundtrip, the bf16 buffer on the gather path (the sharded
        # path sends float32 on that wire, as the reference's).
        if wire == "bfloat16" and comm == "sharded":
            wspec = spec
        else:
            wspec = cfg.message_spec(stack)
        buf = wspec.wire_roundtrip(wspec.pack(stack))
        if wspec.quantized:
            wspec = spec
        want = wspec.unpack(cfg.flat_aggregator_fn(wspec)(buf), batch_ndim=0)
        ok, err = True, 0.0
        for k, v in got.items():
            ref = dist_shard(want[k].float(), mid, m_size)
            if name == "krum":
                ok = ok and torch.equal(v, ref)
            else:
                good, e = close(v.float(), ref)
                ok, err = ok and good, max(err, e)
        out[(name, comm, wire)] = dict(ok=ok, err=err, ms=ms,
                                       launches=launches)
    return out


def check_slice_kernels(torch):
    """K2-K6 against their plain versions at the shapes the distributed
    paths give them: the gather path's (W, D_shard) stacks and the sharded
    path's (W, ceil(D / W)) slices, K6 on each worker's slice with its
    leaf ids (slices that start inside a leaf, miss a leaf, or end in the
    padding block)."""
    from repro_torch.core import packing
    from repro_torch.core.robust_step import _local_leaf_ids
    from repro_torch.kernels import weiszfeld as wz
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    errs = {}
    sizes = packing.pack_spec({k: torch.empty(s) for k, s in
                               DIST_LEAVES.items()}, batch_ndim=0).sizes
    # The two meshes' (workers, model ranks), and 6 workers on whole
    # messages: 39,760 = 6 x 6,627 - 2, so the last slice ends in padding.
    for w, m_size in [(math.prod(s[:-1]), s[-1]) for s, _ in DIST_MESHES] + [(6, 1)]:
        leaf = [s // m_size for s in sizes]
        d = sum(leaf)
        chunk = -(-d // w)
        for rows, cols in ((w, d), (w, chunk)):
            e2, e3 = check_weiszfeld(torch, rows, cols, gen)
            e4, e5 = check_order_stats(torch, rows, cols, 1, gen)
            errs[f"{(rows, cols)}"] = (e2, e3, e4, e5)
        y = torch.randn((chunk,), generator=gen, device="cuda")
        for wid in range(w):
            seg = _local_leaf_ids(leaf, w * chunk - d, w, wid,
                                  torch.device("cuda"))
            z = torch.randn((w, chunk), generator=gen, device="cuda")
            got = wz.partial_sqdist_segments_call(z, y, seg, len(leaf) + 1)
            want = wz.partial_sqdist_segments_plain(z, y, seg, len(leaf) + 1)
            ok, err = close(got, want)
            absent = [s for s in range(len(leaf) + 1)
                      if not bool((seg == s).any())]
            assert ok, f"K6 on worker {wid}'s slice {(w, chunk)}: {err}"
            assert all(bool((got[:, s] == 0).all()) for s in absent), \
                f"K6: a block absent from worker {wid}'s slice is not 0"
            errs[f"K6 {(w, chunk)} worker {wid}"] = err
    log(f"kernels at the distributed paths' shapes against their plain "
        f"versions (rtol 1e-5; K6's absent blocks exactly 0): {errs}")


def phase_distributed(torch, card):
    """Phase 18: 8 ranks on the one card (gloo, CUDA tensors), meshes (4, 2)
    and (2, 4, 1) at the Table I network's width; every case within rtol
    1e-5 of the single-process rule (krum bitwise), each rule's kernels
    launched on every rank."""
    from repro_torch.launch import mesh as mesh_lib
    check_slice_kernels(torch)
    for shape, axes in DIST_MESHES:
        cases = dist_cases(shape)
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn_mesh(dist_rank, shape, axes, args=(cases,),
                                    timeout=DIST_TIMEOUT)
        wall = time.perf_counter() - t0
        att = [r["attack"] for r in ranks]
        assert all(a["ok"] for a in att), f"distributed_attack: {att}"
        log(f"distributed mesh {shape} {axes} ({card}; gloo staging each "
            f"collective through the host, 8 processes on one card, not an "
            f"interconnect): world {wall:.1f} s, sign_flip row max err "
            f"{max(a['err'] for a in att):.3g}")
        for case in cases:
            res = [r[case] for r in ranks]
            name, comm, wire = case
            counts = {k: [r["launches"][k] for r in res]
                      for k in DIST_KERNELS[name]}
            log(f"  {name:<17} {comm:<8} {wire:<9} max err "
                f"{max(r['err'] for r in res):.3g}, ms (rank 0) "
                f"{res[0]['ms']:.1f}, launches per rank {counts}")
            assert all(r["ok"] for r in res), f"{shape} {case}: {res}"
            for k, per_rank in counts.items():
                assert all(n > 0 for n in per_rank), \
                    f"{shape} {case}: {k} not launched on every rank"


# ---- Phase 19: resume and rollback ---------------------------------------------


def same_state(torch, a, b) -> bool:
    """Every leaf of two FederatedStates equal (the generator's state
    too)."""
    from repro_torch.checkpoint.checkpoint import _leaves
    for (ka, x), (kb, y) in zip(_leaves(a._asdict()), _leaves(b._asdict()),
                                strict=True):
        if ka != kb:
            return False
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                log(f"  leaf {ka} differs")
                return False
        elif x != y:
            return False
    return True


def phase_resume(torch, card):
    """Phase 19: 5 straight steps against 3, a checkpoint, a restore and 2
    more, then the rollback sequence, at workload A's size on the card:
    the master step (SAGA geomed, sign_flip, 50 + 20 workers) and the
    decentralized step on workload D's erdos_renyi(70, 0.5) graph."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import FederatedState, RobustConfig, make_federated_step
    from repro_torch.data import ijcnn1_like, logreg_loss, partition
    from repro_torch.launch.health import RunHealth
    from repro_torch.optim import get_optimizer
    data = ijcnn1_like(SEED, n=49_990, device="cuda")
    wd = partition({"a": data.x, "b": data.y}, 50, seed=1,
                   samples_per_worker=999, device="cuda")
    topo, _, _ = workload_d_graph(torch)

    def problem(step, **kw):
        cfg = RobustConfig(aggregator="geomed", vr="saga", attack="sign_flip",
                           num_byzantine=20, **kw)
        init_fn, step_fn = make_federated_step(
            logreg_loss(0.01), wd, cfg, get_optimizer("momentum", 0.02),
            topology=None if step == "master" else topo, device="cuda")
        return (lambda: init_fn({"w": torch.zeros(22, device="cuda")}, SEED)), step_fn

    def run(step_fn, st, n, monitor=None):
        for _ in range(n):
            st, m = step_fn(st)
            if monitor is not None:
                monitor.observe({"round_accepted": float(m["round_accepted"])})
        return st

    with tempfile.TemporaryDirectory() as tmp:
        for step in ("master", "decentralized"):
            init, step_fn = problem(step)
            straight = run(step_fn, init(), 5)
            ckpt = CheckpointManager(os.path.join(tmp, step))
            st3 = run(step_fn, init(), 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save_train_state(3, st3._asdict())
            t_save = time.perf_counter() - t0
            like = init()._asdict()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gstep, restored = ckpt.restore_latest(like)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            assert gstep == 3
            resumed = run(step_fn, FederatedState(**restored), 2)
            assert same_state(torch, straight, resumed), f"{step}: resume differs"
            log(f"resume {step} ({card}): 5 straight steps equal 3 + checkpoint "
                f"+ restore + 2 on every leaf (generator included); checkpoint "
                f"{os.path.getsize(path) / 1e6:.2f} MB, save {t_save * 1e3:.1f} ms, "
                f"restore {t_restore * 1e3:.1f} ms (host clock, warm file cache)")

            init, step_fn = problem(step, guards=True)
            straight = run(step_fn, init(), 5)
            monitor = RunHealth(patience=2)
            st3 = run(step_fn, init(), 3, monitor)
            assert monitor.healthy, f"{step}: a warm-up round was rejected"
            ckpt = CheckpointManager(os.path.join(tmp, step + "-rollback"))
            ckpt.save_train_state(3, st3._asdict())
            ckpt.mark_good(3)
            w3 = st3.params["w"].clone()
            bad = run(step_fn, st3._replace(health=torch.tensor(
                [1e-8, 1e-16, 0.0, 10.0], device="cuda")), 2, monitor)
            assert torch.equal(bad.params["w"], w3) and monitor.rollback_pending
            gstep, restored = ckpt.restore_last_good(init()._asdict())
            monitor.on_rollback()
            resumed = run(step_fn, FederatedState(**restored), 2, monitor)
            assert gstep == 3 and monitor.healthy
            assert same_state(torch, straight, resumed), f"{step}: rollback differs"
            log(f"rollback {step} ({card}): two rejected rounds arm RunHealth "
                f"(patience 2), restore_last_good(3), and the descent equals "
                f"the straight guarded run on every leaf")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    errs = phase_kernel_checks(torch)
    phase_distributed(torch, card)
    phase_resume(torch, card)
    phase_workload_a(torch)
    phase_workload_f(torch)
    counts, summaries = {}, {}
    counts["geomed"], state, summaries["geomed"] = phase_workload_b(torch, "geomed")
    timing = phase_timing(torch, state)
    del state
    torch.cuda.empty_cache()
    # The options phase (16) runs here, early: late in this long process
    # torch.profiler's kernel records come back incomplete (phase 6's
    # device_ms, which its K1 timing uses, is reliable at this point).
    phase_options(torch, card, errs, counts, timing, summaries["geomed"])
    # The wires (phase 17), early too: its timing uses torch.profiler.
    w_errs, w_timing, w_counts, w_rows = phase_wires(torch, card,
                                                     summaries["geomed"]["peak_gb"])
    errs.update(w_errs)
    counts.update(w_counts)
    # The step without the Weiszfeld loop, then every other rule.
    for agg in ("mean", "median", "trimmed_mean", "krum", "geomed_groups",
                "centered_clip", "geomed_blockwise"):
        counts[agg], state, summaries[agg] = phase_workload_b(torch, agg)
        del state   # frees the 9.5 GB SAGA table before the next run
        torch.cuda.empty_cache()
    log(f"workload B per rule ({card}): step ms / peak GB / loss / accuracy")
    for agg, r in summaries.items():
        log(f"  {agg:<17} {r['step_ms']:9.3f} {r['peak_gb']:7.2f} "
            f"{r['loss']:10.6f} {r['accuracy']:8.4f}")
    phase_fig6(torch)
    phase_paper_grids(torch)
    phase_claims(torch)
    phase_quickstart()
    topo_d, _, trim_d = workload_d_graph(torch)
    log(f"workload D graph: {topo_d.describe()}, min_neighborhood "
        f"{topo_d.min_neighborhood}, most Byzantine neighbours of an honest "
        f"node {int(topo_d.adjacency[:50, 50:].sum(1).max())}, trim {trim_d}")
    summaries_d = {}
    for gossip, agg in D_RUNS:
        label = f"D {gossip} {agg}"
        counts[label], summaries_d[label] = phase_workload_d(torch, gossip, agg)
    log(f"workload D per run ({card}): step ms / peak GB / mean honest loss / "
        "accuracy / Weiszfeld iters per step / consensus_dist")
    for label, r in summaries_d.items():
        log(f"  {label:<24} {r['step_ms']:9.3f} {r['peak_gb']:7.2f} "
            f"{r['loss']:10.6f} {r['accuracy']:8.4f} {r['iters']:7.2f} "
            f"{r['consensus']:.6g}")
    phase_perleaf(torch, card, counts, summaries, summaries_d)
    b16, b32 = w_rows["D gradient geomed bfloat16"], summaries_d["D gradient geomed"]
    log(f"workload D gradient geomed device busy ({card}): bfloat16 "
        f"{b16['busy_us']:.1f} us a step, float32 {b32['busy_us']:.1f} us, "
        f"bf16/f32 {b16['busy_us'] / b32['busy_us']:.3f} (same process)")
    timing_d = phase_timing_d(torch)
    timing["masked_neighbor_reduce"] = timing_d[f"masked_neighbor_reduce trim {trim_d}"]
    timing["masked_neighbor_reduce sum"] = timing_d["masked_neighbor_reduce trim 0"]
    timing["partial_sqdist masked"] = timing_d["partial_sqdist masked batched"]
    phase_decentralized_claims(torch)
    phase_twins()
    errs["flash_attention"] = phase_flash_checks(torch)
    counts["E serve"] = phase_workload_e(torch, card)
    phase_serving_checks(torch)
    timing["flash_attention"] = phase_timing_e(torch)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[KERNEL_PATH[name]][name],
                    max_abs_err=errs[name], **timing[name])
               for name, (src, rep) in KERNEL_SOURCES.items()]
    for name, (key, path) in BF16_KERNELS.items():
        src, rep = KERNEL_SOURCES[name.split(" bf16")[0]]
        launches = counts[path].get(key, 0)
        assert launches > 0, f"{name}: no launch on {path}"
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=launches, max_abs_err=errs[name],
                            **w_timing[name]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
