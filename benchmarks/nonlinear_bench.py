"""BASELINE config 3: nonlinear segment-time optimization over the linear
inner solve, batched (the reference's optimizeTime path, stack 3.4 of
SURVEY.md: one full inner solve per outer evaluation).

Two batched backends are timed on the flagship 10-segment 3-D N=10 family:

  * Nelder-Mead (the reference's gradient-free LN_SBPLX analogue,
    nonlinear.h:61,125): K+1 simplex points, one batched inner solve per
    iteration per point.
  * Gradient descent THROUGH the inner Cholesky solve (optimize_time_gradient)
    -- the batched replacement for the reference's 2K-finite-difference
    time gradients (getCostAndGradientTime, nonlinear_impl.h:2495-2584).

Usage: python benchmarks/nonlinear_bench.py [--batch=N] [--iters=N]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from mav_tube_trajectory_generation.solver import (linear, nonlinear,
                                                           structure as sm)
    from mav_tube_trajectory_generation.models.vertex import (
        segment_times_nfabian)

    batch, iters, k = 1024, 30, 10
    for a in sys.argv:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
        if a.startswith("--iters="):
            iters = int(a.split("=")[1])

    std = sm.make_structure(sm.standard_mask(k + 1, 10), 3, 10)
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, k + 1, 3)),
                          axis=1).astype(np.float32)
    values = np.zeros((batch, k + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = jnp.asarray(np.asarray(
        segment_times_nfabian(waypoints, 3.0, 5.0), dtype=np.float32))
    d_fixed = jnp.asarray(np.asarray(
        linear.extract_fixed_values(std, jnp.asarray(values)),
        dtype=np.float32))

    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=iters,
        time_penalty=500.0, use_soft_constraints=False)
    params_bt = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=iters,
        time_penalty=500.0, use_soft_constraints=False,
        lbfgs_linesearch="backtracking")
    params_hy = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=iters,
        time_penalty=500.0, use_soft_constraints=False,
        lbfgs_linesearch="hybrid", hybrid_zoom_iters=4)

    def run_nm(df, t):
        return jax.vmap(lambda a, b: nonlinear.optimize(
            std, a, b, params)).__call__(df, t)

    def run_grad(df, t):
        return jax.vmap(lambda a, b: nonlinear.optimize_time_gradient(
            std, a, b, params, n_iters=iters))(df, t)

    def run_grad_bt(df, t):
        # Backtracking linesearch: one reverse sweep per step (probes are
        # value-only forward solves) -- ~3x the zoom throughput at ~2%
        # higher final cost (the speed/quality knob of this path).
        return jax.vmap(lambda a, b: nonlinear.optimize_time_gradient(
            std, a, b, params_bt, n_iters=iters))(df, t)

    def run_grad_hy(df, t):
        # Hybrid: backtracking for iters-4 steps, strong-Wolfe zoom
        # endgame from the plateau (fresh L-BFGS memory) -- targets
        # backtracking's throughput with zoom's final cost.
        return jax.vmap(lambda a, b: nonlinear.optimize_time_gradient(
            std, a, b, params_hy, n_iters=iters))(df, t)

    for name, fn in (("nelder-mead/time", run_nm),
                     ("grad-through-solve/time", run_grad),
                     ("grad-backtracking/time", run_grad_bt),
                     ("grad-hybrid/time", run_grad_hy)):
        f = jax.jit(fn)
        out = f(d_fixed, times)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out = f(d_fixed, times)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        if name.startswith("nelder"):
            final = float(jnp.median(out.cost.total))
            init = float(jnp.median(out.initial_cost.total))
        else:
            hist = out[1]
            init = float(jnp.median(hist[:, 0]))
            final = float(jnp.median(hist[:, -1]))
        print(f"[nl-bench] {name}: {batch/dt:,.0f} scenarios/s "
              f"({dt*1e3:.1f} ms/batch of {batch}, {iters} outer iters); "
              f"median cost {init:.4g} -> {final:.4g}")


if __name__ == "__main__":
    main()
