"""Headline benchmark: trajectory solves/s/chip, 10-segment min-snap QP+QCQP.

One "solve" = one full scenario pass: the linear min-snap QP (warm start)
followed by the tube-constrained QCQP (ADMM), on the flagship 10-segment
3-D N=10 configuration, float32, megabatched so one jitted program
amortizes dispatch over thousands of scenarios -- the batched replacement
for the reference's one-solve-per-call loop
(polynomial_timing_evaluation.cpp:104-128).

Also reports the reference's K in {2, 10, 50, 100} linear-QP sweep as
secondary metrics (printed to stderr; the driver consumes only the final
stdout JSON line).

Usage: python bench.py            # full (QP+QCQP headline + sweep)
       python bench.py --quick    # headline only
"""

import json
import sys
import time

import numpy as np


def make_inputs(k, batch, seed=0):
    from mav_tube_trajectory_generation.solver import linear
    from mav_tube_trajectory_generation.solver import structure as sm
    from mav_tube_trajectory_generation.models.vertex import segment_times_nfabian
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, k + 1, 3)),
                          axis=1).astype(np.float32)
    std = sm.make_structure(sm.standard_mask(k + 1, 10), 3, 10)
    free = sm.make_structure(sm.free_interior_mask(k + 1, 10), 3, 10)
    values = np.zeros((batch, k + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0),
                       dtype=np.float32)
    d_fixed_std = np.asarray(
        linear.extract_fixed_values(std, jnp.asarray(values)),
        dtype=np.float32)
    d_fixed_free = np.asarray(
        linear.extract_fixed_values(free, jnp.asarray(values)),
        dtype=np.float32)
    radii = np.full((batch, k, 2), 0.8, dtype=np.float32)
    return (std, free, jnp.asarray(d_fixed_std), jnp.asarray(d_fixed_free),
            jnp.asarray(times), jnp.asarray(waypoints), jnp.asarray(radii),
            jnp.asarray(values))


def time_fn(fn, args, n_iters=10):
    import jax
    out = fn(*args)          # compile + warmup
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iters, out


def main():
    quick = "--quick" in sys.argv
    import jax
    # No global x64: the router scopes the x64 flag PER TIER internally
    # (solver/auto._X64_NOTE), so the f64 tier-2 endgame is reachable
    # without it.
    import jax.numpy as jnp
    from mav_tube_trajectory_generation.solver import linear, qcqp
    from mav_tube_trajectory_generation.utils import compile_cache
    compile_cache.enable()

    k = 10
    batch = 6144  # see --batch
    for a in sys.argv:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
    (std, free, df_std, df_free, times, waypoints, radii,
     values) = make_inputs(k, batch)

    # Tuned for warm-started scenarios (sweeps on the bench distribution):
    # rho=0.005 with tube/end-cap penalty factors 0.125 concentrates the
    # penalty on the (usually active) sphere constraints -- median cost
    # within ~0.3% of a 1600-iteration reference at only 48 iterations,
    # all-feasible at the 1e-2 gate.
    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)

    def full_solve(df_free_b, times_b, waypoints_b, radii_b, values_b):
        """QP (standard mask) warm start + tube QCQP: one scenario pass of
        BASELINE config 4.  The warm start (schur linear solve) is FUSED
        into the QCQP's per-scenario trace (warmstart_values) so XLA CSEs
        the shared Hessian blocks."""
        con = qcqp.solve_qcqp_batch(free, df_free_b, times_b, waypoints_b,
                                    radii_b, config=admm,
                                    warmstart_values=values_b,
                                    scenario_block=4)
        return con.cost, con.max_violation, con.converged

    solve = jax.jit(full_solve)
    dt, out = time_fn(solve, (df_free, times, waypoints, radii, values),
                      n_iters=5)
    qcqp_cost, viol, conv = out
    n_ok = int(jnp.sum(jnp.isfinite(qcqp_cost)
                       & (viol < 1e-2)))
    solves_per_s = batch / dt

    print(f"[bench] QP+QCQP: {dt*1e3:.1f} ms/batch of {batch}; "
          f"{solves_per_s:,.0f} solves/s; {n_ok}/{batch} feasible; "
          f"median viol {float(jnp.median(viol)):.2e}", file=sys.stderr)

    if not quick:
        # Reference timing-sweep shapes (linear QP only).  K >= 50 also runs
        # the O(K log K) block-tridiagonal cyclic-reduction path.
        from mav_tube_trajectory_generation.solver import banded
        for k_sweep in (2, 10, 50, 100):
            stdk, _, dfk, _, tk, _, _, _ = make_inputs(k_sweep, 2048, seed=1)
            f = jax.jit(jax.vmap(lambda a, b: linear.solve_linear(stdk, a, b)))
            dt_k, _ = time_fn(f, (dfk, tk), n_iters=5)
            line = f"[bench] linear K={k_sweep}: {2048/dt_k:,.0f} solves/s"
            if k_sweep >= 50:
                fb = jax.jit(jax.vmap(
                    lambda a, b: banded.solve_linear_banded(stdk, a, b)))
                dt_b, _ = time_fn(fb, (dfk, tk), n_iters=5)
                line += f" (banded: {2048/dt_b:,.0f})"
            print(line, file=sys.stderr)

        # BASELINE config 5: batch solve + extrema feasibility checks via
        # batched root-finding.
        from mav_tube_trajectory_generation.models import trajectory as tj

        def solve_and_check(df, t):
            with jax.default_matmul_precision('highest'):
                sol = linear.solve_linear(std, df, t)
                traj = tj.Trajectory(sol.coefficients, sol.times)
                vmax = tj.max_magnitude(traj, 1, n_grid=64).value
                amax = tj.max_magnitude(traj, 2, n_grid=64).value
            # Reference slack: 2.5x the heuristic's v/a bounds
            # (TimeAllocation test, test_polynomial_optimization.cpp:572-613).
            return vmax, amax, (vmax <= 3.0 * 2.5) & (amax <= 5.0 * 2.5)

        f5 = jax.jit(jax.vmap(solve_and_check))
        dt5, out5 = time_fn(f5, (df_std, times), n_iters=5)
        print(f"[bench] solve+extrema feasibility: {batch/dt5:,.0f} "
              f"scenarios/s (median vmax {float(jnp.median(out5[0])):.2f}, "
              f"amax {float(jnp.median(out5[1])):.2f})", file=sys.stderr)

        # Strict-feasibility (Mosek-grade) path: the ROUTER
        # (solver/auto.solve_qcqp_strict) -- ADMM + snap-only Gauss-Newton
        # tier 0 (one band factor), then ONLY the rows still >= 1e-4
        # escalate to the warm-started plane-layout IPM polish.  This is
        # the per-solve feasibility-semantics match to the reference's
        # Mosek backend (qcqp_impl.h:709-788) with the polish cost paid
        # only where needed; the headline above is the statistical-quality
        # gate.  Timed end-to-end including the host routing.
        from mav_tube_trajectory_generation.solver import auto as auto_m

        def strict_once():
            return auto_m.solve_qcqp_strict(
                free, df_free, times, waypoints, radii,
                warmstart_values=values, scenario_block=4, tier1_block=8)

        res = strict_once()                          # compile + warm
        t0 = time.perf_counter()
        n_rep = 3
        for _ in range(n_rep):
            res = strict_once()
        dtp = (time.perf_counter() - t0) / n_rep
        violp = jnp.asarray(res.solution.max_violation)
        n_strict = int(jnp.sum(violp < 1e-4))
        n_det = int(np.sum(res.verdict != 0))
        print(f"[bench] strict-feasibility (router: ADMM+snap -> "
              f"IPM escalation): {batch/dtp:,.0f} solves/s; "
              f"{n_strict}/{batch} at viol<1e-4 "
              f"(p99 {float(jnp.percentile(violp, 99)):.1e}; "
              f"{res.n_escalated} escalated; "
              f"{n_det}/{batch} determinate)", file=sys.stderr)

        # Mosek-verdict agreement vs the interior-point ground truth
        # (recorded 12k-scenario study; benchmarks/verdict_parity.py).
        import os
        bdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmarks")
        vp = os.path.join(bdir, "verdict_parity_results.json")
        if os.path.exists(vp):
            with open(vp) as fh:
                v = json.load(fh)
            print(f"[bench] Mosek-verdict parity (recorded, "
                  f"n={v['n_total']}): false-feasible {v['false_feasible']}, "
                  f"agreement {v['agreement[r>=0.5]']*100:.1f}% at r>=0.5, "
                  f"certificate recall {v['certificate_recall']*100:.1f}%, "
                  f"cost gap median {v['cost_gap_median']*100:.3f}%",
                  file=sys.stderr)
        vr = os.path.join(bdir, "verdict_parity_router_results.json")
        if os.path.exists(vr):
            with open(vr) as fh:
                v = json.load(fh)
            worst = min(val for key, val in v.items()
                        if key.startswith("agreement["))
            print(f"[bench] router verdict parity (recorded, "
                  f"n={v['n_total']}): worst-bucket agreement "
                  f"{worst*100:.1f}%, false-feasible {v['false_feasible']}, "
                  f"escalated {v['n_escalated']}/{v['n_total']}, "
                  f"undetermined(gt) {v['n_undetermined']}, "
                  f"cost gap p99 {v['cost_gap_p99']:.1e}",
                  file=sys.stderr)
        ep = os.path.join(bdir, "external_parity_results.json")
        if os.path.exists(ep):
            with open(ep) as fh:
                v = json.load(fh)["report"]
            print(f"[bench] external (scipy SLSQP) parity (recorded, "
                  f"n={v['n_total']}): verdict agreement "
                  f"{v['verdict_agreement[det]']*100:.1f}%, cost gap median "
                  f"{v['cost_gap_median']:.1e}",
                  file=sys.stderr)

    print(json.dumps({
        "metric": "trajectory solves/s/chip (10-seg min-snap QP+QCQP)",
        "value": round(solves_per_s, 1),
        "unit": "solves/s/chip",
    }))


if __name__ == "__main__":
    main()
