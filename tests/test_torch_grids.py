"""The orderings of the paper's grids that ``chip_smoke.py`` asserts on the
card, and the reference run they come from.

``chip_smoke.py`` runs the grids of ``benchmarks/fig3_ijcnn1.py``,
``fig4_covtype.py``, ``fig5_zero_outer.py`` and ``table1_nn.py`` through the
port on the card, with ``GRID_STEPS`` steps, and asserts ``GRID_ORDERINGS``.
Each ordering must also hold in the reference's own benchmark loops at the
same sizes and steps; run them on the CPU with

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_grids.py

which prints every run's optimality gap (Table I: test accuracy) and each
ordering with its ratio (about five minutes).  The tests below check that
the orderings name runs of the grids and drive the runner for a few steps.
"""
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (no JAX, no repro: constants only)

GRIDS = ("fig3", "fig4", "fig5", "table1")
# The benchmarks' own step counts (fig3/fig4 common.STEPS, fig5's steps=800,
# table1's main(steps=500)).
BENCH_STEPS = {"fig3": 600, "fig4": 600, "fig5": 800, "table1": 500}


def grid_runs(grid: str) -> list[str]:
    """The runs of one grid: solver-rule labels as the benchmarks emit them."""
    aggs = ("geomed",) if grid == "fig5" else ("mean", "geomed")
    return [f"{label}-{agg}" for label, _, _ in chip_smoke.ALGOS for agg in aggs]


def reference_grid(grid: str, steps: int, attacks=chip_smoke.GRID_ATTACKS) -> dict:
    """The reference's loop of ``benchmarks/<grid>`` at ``steps`` steps:
    {(attack, run): optimality gap, or test accuracy for table1}."""
    import jax

    from benchmarks import common, table1_nn
    from repro.core import RobustConfig, make_federated_step
    from repro.data import mnist_like, partition
    from repro.optim import get_optimizer
    out = {}
    if grid == "table1":
        key = jax.random.PRNGKey(0)
        train = mnist_like(key, n=1500)
        test = mnist_like(jax.random.fold_in(key, 1), n=500)
        wd = partition({"x": train.x, "y": train.y}, table1_nn.WH, seed=2)
        test_batch = {"x": test.x, "y": test.y}
        algos = [("SGD", "sgd", 0.1), ("BSGD", "minibatch", 0.5), ("SAGA", "saga", 0.1)]
        for attack in attacks:
            for label, vr, lr in algos:
                for agg in ("mean", "geomed"):
                    cfg = RobustConfig(aggregator=agg, vr=vr, attack=attack,
                                       num_byzantine=0 if attack == "none" else table1_nn.B,
                                       minibatch_size=20)
                    init_fn, step_fn = make_federated_step(
                        table1_nn.nn_loss, wd, cfg, get_optimizer("sgd", lr))
                    st = init_fn(table1_nn.init_params(jax.random.fold_in(key, 7)),
                                 jax.random.PRNGKey(5))
                    jstep = jax.jit(step_fn)
                    for _ in range(steps):
                        st, _ = jstep(st)
                    out[attack, f"{label}-{agg}"] = table1_nn.accuracy(st.params, test_batch)
        return out
    replicated = grid == "fig5"
    loss, batch, f_star, wd = common.build_problem(
        "covtype" if grid == "fig4" else "ijcnn1", replicated=replicated)
    for attack in attacks:
        for label, vr, lr in common.ALGOS:
            for agg in ("geomed",) if replicated else ("mean", "geomed"):
                cfg = RobustConfig(aggregator=agg, vr=vr, attack=attack,
                                   num_byzantine=0 if attack == "none" else common.B,
                                   minibatch_size=50)
                st, _, _ = common.run_algorithm(loss, wd, cfg,
                                                lr * 0.5 if replicated else lr,
                                                steps=steps)
                out[attack, f"{label}-{agg}"] = float(loss(st.params, batch)) - f_star
    return out


def test_grid_orderings_name_runs_of_the_grids():
    """Every asserted ordering compares two runs of one grid under one of
    the benchmarks' attacks; Table I, whose accuracies sit near chance at
    these steps, has none; no grid runs more steps than its benchmark."""
    assert chip_smoke.GRID_ORDERINGS
    for grid, attack, lower, higher in chip_smoke.GRID_ORDERINGS:
        assert grid in GRIDS and grid != "table1"
        assert attack in chip_smoke.GRID_ATTACKS
        assert lower != higher and {lower, higher} <= set(grid_runs(grid))
    assert len(set(chip_smoke.GRID_ORDERINGS)) == len(chip_smoke.GRID_ORDERINGS)
    for grid in GRIDS:
        assert 0 < chip_smoke.GRID_STEPS[grid] <= BENCH_STEPS[grid]
    assert [vr for _, vr, _ in chip_smoke.ALGOS] == ["sgd", "minibatch", "saga"]


def test_reference_grid_runner_takes_few_steps():
    """The runner drives the reference's loop: a finite gap for every run
    of Fig. 5's grid under one attack."""
    got = reference_grid("fig5", 2, attacks=("sign_flip",))
    assert sorted(r for _, r in got) == sorted(grid_runs("fig5"))
    assert all(math.isfinite(v) and v > 0 for v in got.values())


def main() -> int:
    values = {}
    for grid in GRIDS:
        steps = chip_smoke.GRID_STEPS[grid]
        values[grid] = reference_grid(grid, steps)
        runs = grid_runs(grid)
        print(f"{grid} (reference, {steps} steps): "
              f"{'test accuracy' if grid == 'table1' else 'optimality gap'}")
        print("  " + f"{'attack':<14}" + "".join(f"{r:>13}" for r in runs))
        for attack in chip_smoke.GRID_ATTACKS:
            print("  " + f"{attack:<14}"
                  + "".join(f"{values[grid][attack, r]:>13.5f}" for r in runs))
    failed = 0
    for grid, attack, lower, higher in chip_smoke.GRID_ORDERINGS:
        lo, hi = values[grid][attack, lower], values[grid][attack, higher]
        failed += not lo < hi
        print(f"{grid} {attack}: {lower} {lo:.5f} < {higher} {hi:.5f} "
              f"(ratio {hi / lo:.2f}) {'holds' if lo < hi else 'FAILS'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
