"""Tests for the dense ESDF collision map (octree replacement)."""

import numpy as np
import jax.numpy as jnp
import pytest

from mav_tube_trajectory_generation.models import esdf


def test_edt_matches_bruteforce():
    rng = np.random.RandomState(0)
    occ = rng.rand(9, 10, 11) < 0.1
    occ[4, 5, 6] = True  # ensure at least one occupied voxel
    res = 0.25
    field = esdf.esdf_from_occupancy(occ, origin=(0, 0, 0), resolution=res,
                                     dtype=jnp.float64)
    dist = np.asarray(field.distance)
    occ_idx = np.argwhere(occ)
    free_idx = np.argwhere(~occ)
    for _ in range(50):
        i, j, k = (rng.randint(9), rng.randint(10), rng.randint(11))
        if occ[i, j, k]:
            # Signed: minus the distance to the nearest free voxel.
            brute = -np.min(np.linalg.norm(free_idx - np.array([i, j, k]),
                                           axis=1)) * res
        else:
            brute = np.min(np.linalg.norm(occ_idx - np.array([i, j, k]),
                                          axis=1)) * res
        assert dist[i, j, k] == pytest.approx(brute, abs=1e-10)


def test_trilinear_matches_scipy():
    from scipy.ndimage import map_coordinates
    rng = np.random.RandomState(1)
    occ = rng.rand(8, 8, 8) < 0.15
    occ[3, 3, 3] = True
    res = 0.5
    origin = np.array([1.0, -2.0, 0.5])
    field = esdf.esdf_from_occupancy(occ, origin=origin, resolution=res,
                                     dtype=jnp.float64)
    dist = np.asarray(field.distance)
    pts = origin + rng.rand(40, 3) * (np.array(occ.shape) - 1) * res
    ours = np.asarray(esdf.distance_at(field, jnp.asarray(pts)))
    grid_coords = ((pts - origin) / res).T
    oracle = map_coordinates(dist, grid_coords, order=1, mode="nearest")
    np.testing.assert_allclose(ours, oracle, rtol=1e-10, atol=1e-10)


def test_collision_potential_formula():
    eps, rr = 0.5, 0.3
    # Far: zero.
    assert float(esdf.collision_potential(jnp.asarray(2.0), eps, rr)) == 0.0
    # Boundary d' = eps: zero.
    assert float(esdf.collision_potential(jnp.asarray(rr + eps), eps, rr)) == \
        pytest.approx(0.0)
    # Quadratic zone: d' = eps/2 -> (eps/2)^2/(2 eps) = eps/8.
    val = float(esdf.collision_potential(jnp.asarray(rr + eps / 2), eps, rr))
    assert val == pytest.approx(eps / 8)
    # Collision zone: d' = -0.1 -> mult*0.1 + eps/2.
    val = float(esdf.collision_potential(jnp.asarray(rr - 0.1), eps, rr, 2.0))
    assert val == pytest.approx(2.0 * 0.1 + 0.5 * eps)
    # Continuity at d' = 0: both branches give eps/2.
    val = float(esdf.collision_potential(jnp.asarray(rr), eps, rr))
    assert val == pytest.approx(0.5 * eps)


def test_out_of_map_clamps():
    occ = np.zeros((4, 4, 4), bool)
    occ[0, 0, 0] = True
    field = esdf.esdf_from_occupancy(occ, origin=(0, 0, 0), resolution=1.0,
                                     dtype=jnp.float64)
    inside = float(esdf.distance_at(field, jnp.asarray([3.0, 3.0, 3.0])))
    outside = float(esdf.distance_at(field, jnp.asarray([30.0, 30.0, 30.0])))
    assert outside == pytest.approx(inside)


def test_obstacle_grid_helper():
    occ = esdf.make_obstacle_grid((10, 10, 10), (0, 0, 0), 0.1,
                                  boxes=[((0.3, 0.3, 0.3), (0.5, 0.5, 0.5))])
    assert occ[4, 4, 4]
    assert not occ[9, 9, 9]


def test_native_edt_matches_xla():
    """The O(n) C++ Felzenszwalb builder (native/edt.cpp) must agree with
    the in-graph XLA min-plus EDT exactly (both are exact transforms) --
    non-cubic shape on purpose (a stride bug once survived cubic tests)."""
    from mav_tube_trajectory_generation import native
    if not native.edt_available():
        pytest.skip("C++ toolchain unavailable")
    rng = np.random.RandomState(3)
    occ = rng.rand(23, 17, 31) < 0.03
    occ[4, 5, 6] = True
    f_xla = esdf.esdf_from_occupancy(occ, (0, 0, 0), 0.1, method="xla")
    f_nat = esdf.esdf_from_occupancy(occ, (0, 0, 0), 0.1, method="native")
    np.testing.assert_array_equal(np.asarray(f_xla.distance),
                                  np.asarray(f_nat.distance))
    # Unsigned variant too.
    f_xla_u = esdf.esdf_from_occupancy(occ, (0, 0, 0), 0.1, method="xla",
                                       signed=False)
    f_nat_u = esdf.esdf_from_occupancy(occ, (0, 0, 0), 0.1, method="native",
                                       signed=False)
    np.testing.assert_array_equal(np.asarray(f_xla_u.distance),
                                  np.asarray(f_nat_u.distance))


def test_native_edt_bruteforce_oracle():
    from mav_tube_trajectory_generation import native
    if not native.edt_available():
        pytest.skip("C++ toolchain unavailable")
    rng = np.random.RandomState(1)
    occ = rng.rand(9, 8, 7) < 0.08
    occ[2, 3, 4] = True
    sq = native.edt_squared_cpp(occ)
    pts = np.argwhere(occ)
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in occ.shape],
                               indexing="ij"), -1)
    brute = ((idx[..., None, :] - pts[None, None, None]) ** 2).sum(-1).min(-1)
    np.testing.assert_array_equal(sq, brute.astype(np.float32))
