"""Coefficient-parity gate vs the native C++ reference solver.

BASELINE.json metric: "bit-tolerant coefficient parity with the C++ linear
solver on 10-segment snap minimization".  The C++ side
(native/parity_oracle.cpp) is an independent implementation of the same
closed form; agreement to double-precision tolerance on random problems is
the parity evidence.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation import native
from mav_tube_trajectory_generation.solver import structure as sm

N, H = 10, 5

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain available")


@pytest.mark.parametrize("dim,k,derivative,seed", [
    (1, 1, mtg.SNAP, 1),
    (3, 10, mtg.SNAP, 2),      # the BASELINE parity configuration
    (3, 10, mtg.ACCELERATION, 3),
    (3, 25, mtg.JERK, 4),
    (2, 5, mtg.SNAP, 5),
])
def test_cpp_parity(dim, k, derivative, seed):
    verts = mtg.create_random_vertices(H - 1, k, -10 * np.ones(dim),
                                       10 * np.ones(dim), seed)
    structure, values = mtg.structure_from_vertices(verts, N, derivative)
    times = np.asarray(mtg.estimate_segment_times(verts, 3.0, 5.0))

    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    ours = np.asarray(mtg.solve_linear(structure, d_fixed,
                                       jnp.asarray(times)).coefficients)
    cpp = native.solve_linear_cpp(structure.fixed_mask, values, times,
                                  derivative, N)
    scale = np.abs(cpp).max() + 1.0
    np.testing.assert_allclose(ours, cpp, rtol=1e-7, atol=1e-9 * scale)


def test_cpp_parity_interior_constraints():
    # Mixed fixed derivatives at interior vertices.
    rng = np.random.RandomState(0)
    v = 6
    mask = sm.standard_mask(v, N)
    mask[2, 1] = True   # also fix a velocity
    mask[3, 2] = True   # and an acceleration
    values = rng.randn(v, H, 3)
    structure = sm.make_structure(mask, 3, N, mtg.SNAP)
    times = rng.uniform(0.5, 3.0, size=v - 1)
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    ours = np.asarray(mtg.solve_linear(structure, d_fixed,
                                       jnp.asarray(times)).coefficients)
    cpp = native.solve_linear_cpp(mask, values, times, mtg.SNAP, N)
    scale = np.abs(cpp).max() + 1.0
    np.testing.assert_allclose(ours, cpp, rtol=1e-7, atol=1e-9 * scale)
