"""Scenario-parallel scaling measurement (BASELINE north star: >= 80%
efficiency at 2+ hosts).

Runs the sharded flagship solve on 1 device and on all available devices and
reports throughput + scaling efficiency.  On several hosts, run one process
per host with jax.distributed (parallel/mesh.initialize_distributed); without
several devices it can be exercised with the virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py

Scenario sharding has no cross-scenario communication (metrics psum only),
so efficiency loss measures pure collective/dispatch overhead.
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from mav_tube_trajectory_generation.parallel import mesh as pmesh
    from mav_tube_trajectory_generation.solver import linear
    from mav_tube_trajectory_generation.solver import structure as sm
    from mav_tube_trajectory_generation.models.vertex import (
        segment_times_nfabian)

    devices = jax.devices()
    n_dev = len(devices)
    k = 10
    per_device = 2048
    structure = sm.make_structure(sm.standard_mask(k + 1, 10), 3, 10)

    def inputs(batch):
        rng = np.random.RandomState(0)
        waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, k + 1, 3)),
                              axis=1).astype(np.float32)
        values = np.zeros((batch, k + 1, 5, 3), dtype=np.float32)
        values[:, :, 0, :] = waypoints
        times = np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0),
                           dtype=np.float32)
        d_fixed = np.asarray(
            linear.extract_fixed_values(structure, jnp.asarray(values)))
        return jnp.asarray(d_fixed), jnp.asarray(times)

    def measure(n):
        mesh = pmesh.make_mesh(devices[:n])
        batch = per_device * n
        d_fixed, times = inputs(batch)
        fn = jax.jit(lambda a, b: pmesh.solve_linear_sharded(
            structure, mesh, a, b))
        out = fn(d_fixed, times)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(d_fixed, times)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 5
        return batch / dt

    rate1 = measure(1)
    print(f"1 device:  {rate1:,.0f} solves/s")
    if n_dev > 1:
        rate_n = measure(n_dev)
        eff = rate_n / (rate1 * n_dev)
        print(f"{n_dev} devices: {rate_n:,.0f} solves/s "
              f"-> scaling efficiency {eff:.1%}")
        if devices[0].platform == "cpu":
            print("NOTE: virtual host-platform devices share one physical "
                  "CPU -- this run validates the sharded program, not "
                  "scaling (a single-device XLA:CPU program already uses "
                  "all cores).  Run on a pod slice for a real efficiency "
                  "number.")
    else:
        print("single device only; run on a pod slice (or the virtual CPU "
              "mesh) for a scaling number")


if __name__ == "__main__":
    main()
