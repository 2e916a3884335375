"""Tight-radius strict-router throughput line (round-4 VERDICT weak #3 /
task #5): the strict entry's worst-case composition, measured.

The recorded strict line (bench.py) runs at the deployed r=0.8 regime
(~1k/6144 escalate, residue ~tens of rows).  The parity study's regime --
radii log-uniform over tight corridors -- escalates the MAJORITY of the
batch and funnels a large slice through the serial host-CPU f64 tier
(cost_gap_probe: 257/384 rows at radii [0.05, 0.3]); a deployment on
tight corridors must see that number, not an extrapolation from r=0.8.

Usage: python benchmarks/strict_tight.py [--batch=2048] [--reps=2]
       [--rmin=0.05] [--rmax=0.3] [--no-tier2]
"""

import sys
import time

import numpy as np


def main():
    batch, reps, rmin, rmax = 2048, 2, 0.05, 0.3
    tier2 = "--no-tier2" not in sys.argv
    for a in sys.argv:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
        if a.startswith("--reps="):
            reps = int(a.split("=")[1])
        if a.startswith("--rmin="):
            rmin = float(a.split("=")[1])
        if a.startswith("--rmax="):
            rmax = float(a.split("=")[1])
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, ".")
    from bench import make_inputs
    from mav_tube_trajectory_generation.solver import auto

    (std, free, df_std, df_free, times, waypoints, _,
     values) = make_inputs(10, batch)
    k = 10
    rng = np.random.RandomState(7)
    scale = np.exp(rng.uniform(np.log(rmin), np.log(rmax),
                               size=(batch, 1, 1)))
    radii = jnp.asarray(np.broadcast_to(scale, (batch, k, 2)).astype(
        np.float32).copy())

    def strict_once():
        return auto.solve_qcqp_strict(
            free, df_free, times, waypoints, radii,
            warmstart_values=values, tier2_f64=tier2)

    res = strict_once()                     # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        res = strict_once()
    dt = (time.perf_counter() - t0) / reps
    viol = np.asarray(res.solution.max_violation)
    tiers = np.bincount(res.tier, minlength=6).tolist()
    n_det = int(np.sum(res.verdict != auto.UNDETERMINED))
    n_strict = int(np.sum(viol < 1e-4))
    print(f"[strict-tight r=[{rmin},{rmax}] tier2={tier2}] "
          f"{dt*1e3:,.0f} ms/batch {batch/dt:,.0f} solves/s  "
          f"{n_strict}/{batch}<1e-4  {n_det}/{batch} determinate  "
          f"esc {res.n_escalated}  tiers(last-ran) {tiers}  "
          f"p99 {float(np.percentile(viol[res.verdict == 1], 99)):.1e}",
          flush=True)


if __name__ == "__main__":
    main()
