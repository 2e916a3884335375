"""Throughput of the Mosek-accuracy path: ADMM warm solve + plane-layout
IPM polish + feasibility snap (solver/ipm_lanes.solve_qcqp_polished_batch)
on the flagship 10-segment configuration.

The headline bench reports the pure-ADMM throughput config (~0.3% median
optimality gap, ~1.5e-4 median violation); this one prices the strict path
(violations in the 1e-6 class, cost at the interior-point optimum) for
deployments that need Mosek parity per solve rather than statistical
quality.

--rows runs the legacy row-layout IPM (solver/ipm.solve_qcqp_ipm) for
comparison: it streams the constraint tensors ~8x per Newton step where the
lanes path evaluates once (ops/ipm_eval).

Usage: python benchmarks/polished_bench.py [--batch=N] [--rows]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def main():
    import bench
    from mav_tube_trajectory_generation.solver import (ipm, ipm_lanes,
                                                           linear, qcqp)

    k, batch = 10, 6144
    rows = "--rows" in sys.argv
    for a in sys.argv:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
    (std, free, df_std, df_free, times, waypoints, radii,
     values) = bench.make_inputs(k, batch)

    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)

    if rows:
        n_ipm = 10
        for a in sys.argv:
            if a.startswith("--ipm-iters="):
                n_ipm = int(a.split("=")[1])
        ipm_cfg = ipm.IPMConfig(n_iters=n_ipm)

        def full_solve(df_free_b, times_b, waypoints_b, radii_b, values_b):
            a = qcqp.solve_qcqp_batch(free, df_free_b, times_b, waypoints_b,
                                      radii_b, config=admm,
                                      warmstart_values=values_b,
                                      scenario_block=4)
            pol = jax.vmap(lambda *xs: ipm.solve_qcqp_ipm(
                free, xs[0], xs[1], xs[2], xs[3], config=ipm_cfg, x0=xs[4],
                lam0_ball=xs[5], lam0_half=xs[6]))(
                df_free_b, times_b, waypoints_b, radii_b, a.d_free,
                a.dual_ball, a.dual_half)
            return pol.cost, pol.max_violation, a.cost
    else:
        def full_solve(df_free_b, times_b, waypoints_b, radii_b, values_b):
            pol = ipm_lanes.solve_qcqp_polished_batch(
                free, df_free_b, times_b, waypoints_b, radii_b,
                admm_config=admm, warmstart_values=values_b,
                scenario_block=4)
            return pol.cost, pol.max_violation, pol.cost

    f = jax.jit(full_solve)
    args = (df_free, times, waypoints, radii, values)
    out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(5):
        out = f(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 5
    cost, viol, _ = out
    viol = np.asarray(viol)
    n_feas = int(np.sum(viol < 1e-4))
    tag = "rows" if rows else "lanes"
    print(f"[polished:{tag}] ADMM+IPM: {dt*1e3:.1f} ms/batch of {batch}; "
          f"{batch/dt:,.0f} solves/s; {n_feas}/{batch} strictly feasible "
          f"(viol < 1e-4; median {float(np.median(viol)):.1e}, p99 "
          f"{float(np.percentile(viol, 99)):.1e})", flush=True)


if __name__ == "__main__":
    main()
