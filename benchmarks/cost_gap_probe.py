"""Cost-gap attribution probe: WHICH router tier produces the suboptimal
tail? (round-4 VERDICT next #2: cost_gap_p99 rose to 0.79 -- a composition
effect from newly-determinate tight-radius rows entering the both-feasible
set with snap-repaired, cost-suboptimal points.)

Runs the strict router on a tight-radius-heavy batch (the parity study's
regime), tags every row with the tier that produced its final solution
(AutoResult.tier), and reports the cost-gap distribution vs the f64
interior-point optimum PER TIER.  This decides where the cost polish must
fire: if the tail is tier-1.5/tier-2 residue rows, a small polish bucket
suffices; if tier-1's 10-iter IPM itself ships suboptimal points, the
polish must cover the whole escalated set.

Usage: python benchmarks/cost_gap_probe.py [--total=384] [--seed=0]
       [--rmin=0.05] [--rmax=0.3] [--polish]

(CPU + x64 study tool, like verdict_parity.py.)
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    total, seed, rmin, rmax = 384, 0, 0.05, 0.3
    for a in sys.argv[1:]:
        if a.startswith("--total="):
            total = int(a.split("=")[1])
        if a.startswith("--seed="):
            seed = int(a.split("=")[1])
        if a.startswith("--rmin="):
            rmin = float(a.split("=")[1])
        if a.startswith("--rmax="):
            rmax = float(a.split("=")[1])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import bench
    from mav_tube_trajectory_generation.solver import auto, ipm, qcqp

    k = 10
    admm_cfg = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                               rho_tube_factor=0.125, rho_half_factor=0.125,
                               padded_lanes=False)
    (_, free, _, df_free, times, waypoints, _, values) = bench.make_inputs(
        k, total, seed=seed)
    df_free = np.asarray(df_free, np.float64)
    times = np.asarray(times, np.float64)
    waypoints = np.asarray(waypoints, np.float64)
    rng = np.random.RandomState(1000 + seed)
    scale = np.exp(rng.uniform(np.log(rmin), np.log(rmax),
                               size=(total, 1, 1)))
    radii = np.broadcast_to(scale, (total, k, 2)).copy()

    t0 = time.perf_counter()
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df_free), jnp.asarray(times),
        jnp.asarray(waypoints), jnp.asarray(radii),
        warmstart_values=jnp.asarray(values))
    t_router = time.perf_counter() - t0
    print(f"[probe] router: {t_router:.1f}s, {res.n_escalated}/{total} "
          f"escalated, tiers {np.bincount(res.tier, minlength=6).tolist()}",
          flush=True)

    # f64 ground truth (30 -> 120 iters, exhibition outranks certificate).
    gt_f = jax.jit(jax.vmap(lambda d1, d2, d3, d4: ipm.solve_qcqp_polished(
        free, d1, d2, d3, d4, admm_config=admm_cfg,
        ipm_config=ipm.IPMConfig(n_iters=30))))
    t0 = time.perf_counter()
    p = gt_f(jnp.asarray(df_free), jnp.asarray(times),
             jnp.asarray(waypoints), jnp.asarray(radii))
    p_viol = np.asarray(p.max_violation).copy()
    p_inf = np.asarray(p.infeasible).copy()
    p_cost = np.asarray(p.cost).copy()
    und = ~(p_viol < 1e-4) | p_inf
    if und.any():
        ui = np.nonzero(und)[0]
        nb = 1
        while nb < ui.size:
            nb *= 2
        pad = np.concatenate([ui, np.full(nb - ui.size, ui[-1])])
        gt_long = jax.jit(jax.vmap(
            lambda d1, d2, d3, d4: ipm.solve_qcqp_polished(
                free, d1, d2, d3, d4, admm_config=admm_cfg,
                ipm_config=ipm.IPMConfig(n_iters=120))))
        pl = gt_long(jnp.asarray(df_free[pad]), jnp.asarray(times[pad]),
                     jnp.asarray(waypoints[pad]), jnp.asarray(radii[pad]))
        lv = np.asarray(pl.max_violation)[:ui.size]
        p_viol[ui] = np.minimum(p_viol[ui], lv)
        p_inf[ui] = p_inf[ui] | np.asarray(pl.infeasible)[:ui.size]
        p_cost[ui] = np.where(lv < 1e-4, np.asarray(pl.cost)[:ui.size],
                              p_cost[ui])
    t_gt = time.perf_counter() - t0
    print(f"[probe] ground truth: {t_gt:.1f}s", flush=True)

    a_feas = res.verdict == auto.FEASIBLE
    gt_feas = p_viol < 1e-4
    both = a_feas & gt_feas
    a_cost = np.asarray(res.solution.cost)
    gap = (a_cost - p_cost) / np.maximum(np.abs(p_cost), 1e-12)

    report = {"total": total, "rmin": rmin, "rmax": rmax,
              "n_escalated": int(res.n_escalated),
              "n_both_feasible": int(both.sum())}
    for t in range(6):
        sel = both & (res.tier == t)
        n = int(sel.sum())
        if n == 0:
            continue
        g = gap[sel]
        report[f"tier{t}"] = {
            "n": n,
            "gap_median": float(np.median(g)),
            "gap_p95": float(np.percentile(g, 95)),
            "gap_p99": float(np.percentile(g, 99)),
            "gap_max": float(np.max(g)),
            "n_gap_gt_1pct": int(np.sum(g > 0.01)),
        }
    g = gap[both]
    report["all"] = {"gap_median": float(np.median(g)),
                     "gap_p95": float(np.percentile(g, 95)),
                     "gap_p99": float(np.percentile(g, 99)),
                     "gap_max": float(np.max(g))}
    print("[probe] " + json.dumps(report, indent=1), flush=True)
    with open("benchmarks/cost_gap_probe_results.json", "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
