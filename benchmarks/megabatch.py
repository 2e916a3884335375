"""BASELINE config 5 at its stated scale: 100k random waypoint-set scenarios
with extrema feasibility checks via batched root-finding -- resumable.

Processes the scenario set in fixed-shape chunks (one compiled program,
reused), checkpointing accumulated metrics + the next chunk index after
every chunk (utils/checkpointing), so a preempted run resumes exactly where
it stopped: the checkpoint/resume subsystem the reference lacks entirely
(SURVEY.md section 5.4), exercised end-to-end.

Usage: python benchmarks/megabatch.py [--total=100000] [--chunk=6144]
       [--ckpt=/tmp/megabatch_ckpt.npz]
Interrupt and re-run with the same --ckpt to resume.
"""

import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from mav_tube_trajectory_generation.solver import linear
    from mav_tube_trajectory_generation.solver import structure as sm
    from mav_tube_trajectory_generation.models import trajectory as tj
    from mav_tube_trajectory_generation.models.vertex import (
        segment_times_velocity_ramp)
    from mav_tube_trajectory_generation.utils import checkpointing

    total, chunk, k = 100_000, 6144, 10
    ckpt_path = "/tmp/megabatch_ckpt.npz"
    for a in sys.argv:
        if a.startswith("--total="):
            total = int(a.split("=")[1])
        if a.startswith("--chunk="):
            chunk = int(a.split("=")[1])
        if a.startswith("--ckpt="):
            ckpt_path = a.split("=")[1]
    n_chunks = (total + chunk - 1) // chunk

    std = sm.make_structure(sm.standard_mask(k + 1, 10), 3, 10)

    # One jitted prep program: eager per-op dispatch costs a host round
    # trip per op; jitted it is two dispatches total.
    # Velocity-ramp times: the conservative heuristic -- on this dense
    # waypoint distribution Nfabian times exceed the reference's 2.5x
    # acceleration slack (TimeAllocation semantics hold per-heuristic
    # on its own fixtures; see tests/test_linear.py).
    @jax.jit
    def prep(waypoints, values):
        return (linear.extract_fixed_values(std, values),
                segment_times_velocity_ramp(waypoints, 3.0, 5.0))

    def make_chunk(seed):
        rng = np.random.RandomState(seed)
        waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(chunk, k + 1, 3)),
                              axis=1).astype(np.float32)
        values = np.zeros((chunk, k + 1, 5, 3), dtype=np.float32)
        values[:, :, 0, :] = waypoints
        return prep(jnp.asarray(waypoints), jnp.asarray(values))

    def solve_and_check(df, t):
        # Full matmul precision: the assembly einsums at reduced matmul
        # precision lose the solve entirely for short segment times (T^(1-2d) spans
        # many decades; NaN costs observed with ramp times at 'default').
        with jax.default_matmul_precision('highest'):
            sol = linear.solve_linear(std, df, t)
            traj = tj.Trajectory(sol.coefficients, sol.times)
            vmax = tj.max_magnitude(traj, 1, n_grid=64).value
            amax = tj.max_magnitude(traj, 2, n_grid=64).value
        v_ok = vmax <= 3.0 * 2.5
        a_ok = amax <= 5.0 * 2.5
        return sol.cost, vmax, amax, v_ok & a_ok, v_ok, a_ok

    f = jax.jit(jax.vmap(solve_and_check))

    @jax.jit
    def update_state(state, cost, vmax, ok, v_ok, a_ok, valid):
        # One jitted program: eager per-op updates cost a host round trip
        # EACH.
        return {
            "next_chunk": state["next_chunk"] + 1,
            "n_done": state["n_done"] + jnp.sum(valid.astype(jnp.int32)),
            "n_feasible": state["n_feasible"]
            + jnp.sum((ok & valid).astype(jnp.int32)),
            "sum_cost": state["sum_cost"]
            + jnp.sum(jnp.where(valid, cost, 0.0)),
            "n_v_ok": state["n_v_ok"]
            + jnp.sum((v_ok & valid).astype(jnp.int32)),
            "n_a_ok": state["n_a_ok"]
            + jnp.sum((a_ok & valid).astype(jnp.int32)),
            "max_vmax": jnp.maximum(
                state["max_vmax"],
                jnp.max(jnp.where(valid, vmax, 0.0))),
        }

    state = {"next_chunk": jnp.asarray(0),
             "n_done": jnp.asarray(0),
             "n_feasible": jnp.asarray(0),
             "sum_cost": jnp.asarray(0.0, jnp.float64
                                     if jax.config.read("jax_enable_x64")
                                     else jnp.float32),
             "n_v_ok": jnp.asarray(0),
             "n_a_ok": jnp.asarray(0),
             "max_vmax": jnp.asarray(0.0, jnp.float32)}
    if os.path.exists(ckpt_path):
        state = checkpointing.load_pytree(ckpt_path, state)
        print(f"[megabatch] resumed at chunk {int(state['next_chunk'])}"
              f" ({int(state['n_done'])} scenarios done)", flush=True)

    t0 = time.perf_counter()
    start_chunk = int(state["next_chunk"])
    for ci in range(start_chunk, n_chunks):
        df, t = make_chunk(seed=1000 + ci)
        cost, vmax, amax, ok, v_ok, a_ok = f(df, t)
        n_valid = min(chunk, total - ci * chunk)
        valid = jnp.arange(chunk) < n_valid
        state = update_state(state, cost, vmax, ok, v_ok, a_ok, valid)
        # One bulk transfer; save from host arrays.
        checkpointing.save_pytree(ckpt_path, jax.device_get(state))
    dt = time.perf_counter() - t0

    done = int(state["n_done"])
    print(f"[megabatch] {done} scenarios, "
          f"{int(state['n_feasible'])} feasible "
          f"({100.0 * int(state['n_feasible']) / max(done, 1):.1f}%; "
          f"v-gate {100.0 * int(state['n_v_ok']) / max(done, 1):.1f}%, "
          f"a-gate {100.0 * int(state['n_a_ok']) / max(done, 1):.1f}%), "
          f"mean cost {float(state['sum_cost']) / max(done, 1):.3f}, "
          f"max |v| {float(state['max_vmax']):.2f}", flush=True)
    if n_chunks > start_chunk:
        solved = (n_chunks - start_chunk) * chunk
        print(f"[megabatch] this run: {solved} scenarios in {dt:.2f} s "
              f"({solved / dt:,.0f} scenarios/s incl. host datagen + "
              f"checkpoint I/O)", flush=True)


if __name__ == "__main__":
    main()
