"""Receding-horizon replanning: a fleet of agents re-solving tube QCQPs in
real time, warm-started across ticks.

The BASELINE north star asks for reference-matching solves "under the same
planning horizon and real-time replan budget".  This example runs B agents,
each tracking a moving goal through its waypoint corridor; every tick

  1. re-anchors the start state from the CURRENT trajectory (position..snap
     at the flight time -- ``get_vertex_at_time``, the reference's
     Trajectory::getVertexAtTime workflow for replanning),
  2. moves the goal,
  3. re-solves the tube QCQP warm-started from the previous tick's free
     derivatives (solve_qcqp_batch on the padded lane layout).

One jitted ``tick`` program; the loop measures the sustained replan rate
(agents x Hz) on one chip.

Usage: python examples/replanning.py [--agents=N] [--ticks=N] [--cpu]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def main():
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from mav_tube_trajectory_generation.utils import compile_cache
    compile_cache.enable()
    from mav_tube_trajectory_generation.solver import linear, qcqp
    from mav_tube_trajectory_generation.solver import structure as sm
    from mav_tube_trajectory_generation.models import trajectory as tj
    from mav_tube_trajectory_generation.models.vertex import (
        segment_times_nfabian)

    agents, ticks, k = 2048, 20, 10
    for a in sys.argv:
        if a.startswith("--agents="):
            agents = int(a.split("=")[1])
        if a.startswith("--ticks="):
            ticks = int(a.split("=")[1])

    free = sm.make_structure(sm.free_interior_mask(k + 1, 10), 3, 10)
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.8, 1.6, size=(agents, k + 1, 3)),
                          axis=1).astype(np.float32)
    times = jnp.asarray(np.asarray(
        segment_times_nfabian(waypoints, 3.0, 5.0), dtype=np.float32))
    radii = jnp.full((agents, k, 2), 0.8, jnp.float32)
    waypoints = jnp.asarray(waypoints)

    n_fixed_d = 5   # start/goal each pin derivatives 0..4

    def build_d_fixed(start_state, goal_state):
        # free_interior family fixes all 5 derivatives of start then goal
        # (structure.fixed_cols order: vertex-major).
        return jnp.concatenate([start_state, goal_state], axis=0)

    values0 = jnp.zeros((agents, k + 1, n_fixed_d, 3), jnp.float32)
    values0 = values0.at[:, :, 0, :].set(waypoints)
    d_fixed0 = jax.vmap(lambda v: linear.extract_fixed_values(free, v))(
        values0)
    x00 = jax.vmap(lambda v, t: qcqp.position_constrained_warmstart(
        free, v, t))(values0, times)

    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)

    def tick(d_fixed, x_prev, wps, t_fly):
        """One replan: solve, fly t_fly along it, re-anchor, move goal."""
        sol = qcqp.solve_qcqp_batch(free, d_fixed, times, wps, radii,
                                    config=admm, x0=x_prev)
        traj = tj.Trajectory(sol.coefficients, sol.times)
        # Re-anchor the start at the flown state (pos..snap).
        start_state = jax.vmap(
            lambda tr_c, tr_t: tj.get_vertex_at_time(
                tj.Trajectory(tr_c, tr_t), t_fly, n_fixed_d - 1))(
            traj.coefficients, traj.times)
        # Moving goal: drift the last waypoint; goal state = position only.
        new_wps = wps.at[:, -1, :].add(
            jnp.asarray([0.05, 0.03, 0.0], jnp.float32))
        goal_state = jnp.zeros_like(start_state)
        goal_state = goal_state.at[:, 0, :].set(new_wps[:, -1, :])
        new_wps = new_wps.at[:, 0, :].set(start_state[:, 0, :])
        d_new = jax.vmap(build_d_fixed)(start_state, goal_state)
        return d_new, sol.d_free, new_wps, sol.cost, sol.max_violation

    step = jax.jit(tick)
    d_fixed, x_prev, wps = d_fixed0, x00, waypoints
    t_fly = jnp.asarray(0.25, jnp.float32)

    # Warmup/compile.
    d_fixed, x_prev, wps, cost, viol = step(d_fixed, x_prev, wps, t_fly)
    jax.block_until_ready(cost)

    t0 = time.perf_counter()
    n_feasible = 0
    for _ in range(ticks):
        d_fixed, x_prev, wps, cost, viol = step(d_fixed, x_prev, wps, t_fly)
    jax.block_until_ready(cost)
    dt = (time.perf_counter() - t0) / ticks
    n_feasible = int(jnp.sum(viol < 1e-2))
    print(f"[replan] {agents} agents x {1.0/dt:,.1f} Hz replan rate "
          f"({dt*1e3:.1f} ms/tick, {agents/dt:,.0f} replans/s); final tick: "
          f"{n_feasible}/{agents} feasible, median viol "
          f"{float(jnp.median(viol)):.1e}, median cost "
          f"{float(jnp.median(cost)):.3f}", flush=True)


if __name__ == "__main__":
    main()
