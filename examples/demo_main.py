"""End-to-end demo mirroring the reference's mav_main executable
(/root/reference/src/main.cpp:15-126): collision-aware nonlinear trajectory
optimization through a forest-like map -- same waypoints, radii, weights --
but batched: the same scenario solves at 1x and at 1024x to show the
megabatch path.

The reference loads a supereight octree from disk; here the map is a
procedurally generated obstacle forest rasterized into a signed ESDF
(the reference's own dormant ESDF path legitimizes the dense-grid
equivalent, nonlinear_impl.h:2045-2141).

Run: python examples/demo_main.py [--cpu]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation.solver import nonlinear
from mav_tube_trajectory_generation.utils import compile_cache, timing, export

compile_cache.enable()


def build_map():
    """Forest-like obstacle map around the reference's flight corridor."""
    rng = np.random.RandomState(12345678)
    origin = (1.4, 1.4, 3.9)
    shape = (100, 100, 50)
    res = 0.1
    waypoints = np.array([[2.7, 9.5], [3.50796, 4.34802],
                          [3.95552, 3.23008], [5.06673, 2.31032],
                          [7.0, 2.2]])

    def near_corridor(p, margin=0.7):
        for a, b in zip(waypoints[:-1], waypoints[1:]):
            ab = b - a
            t = np.clip((p - a) @ ab / (ab @ ab), 0.0, 1.0)
            if np.linalg.norm(p - (a + t * ab)) < margin:
                return True
        return False

    trees = []
    for _ in range(40):
        x = 1.4 + rng.rand() * 9.0
        y = 1.4 + rng.rand() * 9.0
        if near_corridor(np.array([x, y])):
            continue  # keep the flight corridor plantable-free
        trees.append(((x - 0.15, y - 0.15, 3.9),
                      (x + 0.15, y + 0.15, 8.8)))
    occ = mtg.make_obstacle_grid(shape, origin, res, boxes=trees)
    return mtg.esdf_from_occupancy(occ, origin, res)


def main():
    # Waypoints of main.cpp:26-48.
    dimension = 3
    start = mtg.Vertex(dimension)
    start.make_start_or_end([2.7, 9.5, 4.8], mtg.SNAP)
    middles = [[3.50796, 4.34802, 4.56653],
               [3.95552, 3.23008, 4.75131],
               [5.06673, 2.31032, 4.79433]]
    verts = [start]
    for m in middles:
        v = mtg.Vertex(dimension)
        v.add_constraint(mtg.POSITION, m)
        verts.append(v)
    end = mtg.Vertex(dimension)
    end.make_start_or_end([7.0, 2.2, 4.8], mtg.SNAP)
    verts.append(end)

    times = mtg.estimate_segment_times_nfabian(verts, v_max=2.0, a_max=2.0)
    radii = jnp.full((4, 2), 0.15)               # main.cpp:55-68
    waypoints = jnp.asarray([v.get_constraint(mtg.POSITION) for v in verts])

    with timing.Timer("demo/build_map"):
        field = build_map()

    structure, values = mtg.structure_from_vertices(verts, 10, mtg.SNAP)
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))

    # Parameter block of main.cpp:75-110 (relevant fields).
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_COLLISION,
        max_iterations=25,
        use_soft_constraints=False,
        time_penalty=500.0,
        epsilon=0.3,
        robot_radius=0.15,
        coll_pot_multiplier=20.0,
        weights=nonlinear.CostWeights(w_d=50.0, w_c=50.0, w_t=0.1, w_sc=1.0),
    )

    with timing.Timer("demo/optimize"):
        res = nonlinear.optimize(structure, d_fixed, jnp.asarray(times),
                                 params, field=field)
        jax.block_until_ready(res.coefficients)

    print(f"cost: {float(res.initial_cost.total):.4f} -> "
          f"{float(res.cost.total):.4f} "
          f"(J_d {float(res.cost.trajectory):.4f}, "
          f"J_c {float(res.cost.collision):.6f})")

    traj = mtg.Trajectory(res.coefficients, res.times)
    ts = np.linspace(0, float(np.sum(times)) - 1e-9, 200)
    clearance = mtg.distance_at(field, mtg.evaluate(traj, jnp.asarray(ts), 0))
    print(f"min clearance along path: {float(jnp.min(clearance)):.3f} m "
          f"(robot radius {params.robot_radius} m)")

    export.write_matlab_sampled_trajectory(traj, "/tmp/demo_trajectory.txt")
    print("sampled trajectory written to /tmp/demo_trajectory.txt")

    # Megabatch: the same optimization over 1024 perturbed scenarios.
    batch = 1024
    rng = np.random.RandomState(0)
    d_batch = jnp.asarray(np.asarray(d_fixed)[None] +
                          0.05 * rng.randn(batch, *np.shape(d_fixed)))
    t_batch = jnp.tile(jnp.asarray(times)[None], (batch, 1))
    fn = jax.jit(jax.vmap(lambda df, t: nonlinear.optimize(
        structure, df, t, params, field=field).cost.total))
    fn(d_batch, t_batch).block_until_ready()      # compile
    with timing.Timer("demo/optimize_batch"):
        costs = fn(d_batch, t_batch)
        costs.block_until_ready()
    dt = timing.Timing.get_mean("demo/optimize_batch")
    print(f"batched: {batch} scenarios in {dt:.2f} s "
          f"({batch / dt:,.0f} nonlinear optimizations/s)")
    print()
    print(timing.Timing.print())


if __name__ == "__main__":
    main()
