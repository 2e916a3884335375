"""What resolves the strict tail?

On the bench distribution (r=0.8), tier-0 + tier-1 can leave a few rows
above the strict 1e-4 gate with no certificate -- the rows that force the
f64 tier-2 (and its cost).  This probe isolates those rows and tries f32
escalations on them: more snap sweeps, a longer polish, and the Mehrotra
corrector.

Usage: python benchmarks/residue_probe.py [--batch=6144]
"""

import sys
import time

import numpy as np


def main():
    batch = 6144
    for a in sys.argv:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, ".")
    from bench import make_inputs
    from mav_tube_trajectory_generation.solver import auto, ipm_lanes
    from mav_tube_trajectory_generation.solver.ipm import IPMConfig

    (std, free, df_std, df_free, times, waypoints, radii,
     values) = make_inputs(10, batch)

    res = auto.solve_qcqp_strict(free, df_free, times, waypoints, radii,
                                 warmstart_values=values, scenario_block=4,
                                 tier1_block=8, tier2_f64=False)
    viol = np.asarray(res.solution.max_violation)
    bad = np.nonzero((viol >= 1e-4) & (res.verdict != auto.INFEASIBLE))[0]
    print(f"residue rows: {bad.size} -> {bad.tolist()[:16]} "
          f"(viol {viol[bad][:16].round(6).tolist()})", flush=True)
    if bad.size == 0:
        return
    nb = 8
    pad = np.concatenate([bad, np.full(nb - bad.size % nb if bad.size % nb
                                       else 0, bad[-1])]).astype(np.int32)
    idx = jnp.asarray(pad)
    d_free = res.solution.d_free
    lb, lh = res.solution.dual_ball, res.solution.dual_half

    variants = {
        "scan_it10s6": IPMConfig(n_iters=10, snap_iters=6, sigma_min=0.3,
                                 corrector=False),
        "scan_it30s4": IPMConfig(n_iters=30, snap_iters=4, sigma_min=0.3,
                                 corrector=False),
        "corrector_it10s2": IPMConfig(n_iters=10, snap_iters=2,
                                      sigma_min=0.3, corrector=True),
    }
    for name, cfg in variants.items():
        t0 = time.perf_counter()
        f = jax.jit(lambda ip, cfg=cfg: ipm_lanes.solve_qcqp_ipm_lanes(
            free, df_free[ip], times[ip], waypoints[ip], radii[ip],
            config=cfg, x0=d_free[ip], lam0_ball=lb[ip],
            lam0_half=lh[ip], scenario_block=8))
        out = f(idx)
        jax.block_until_ready(out)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            out = f(idx)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        v = np.asarray(out.max_violation)[:bad.size]
        inf = np.asarray(out.infeasible)[:bad.size]
        n_fix = int(np.sum((v < 1e-4) | inf))
        print(f"[{name:18s}] resolves {n_fix}/{bad.size}  "
              f"residual viol {np.sort(v[~((v < 1e-4) | inf)])[:4]}  "
              f"{dt*1e3:6.1f} ms/call (compile {t_c:.0f}s)", flush=True)

if __name__ == "__main__":
    main()
