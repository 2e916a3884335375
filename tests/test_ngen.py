"""N != 10 generalization: the reference is templated over the coefficient
count with kMaxN = 12 (polynomial.h:45) and works for any even N; every
solver layer here must too.  Sweeps N in {8, 10, 12} (and D in {2, 3})
through the linear QP, C++ parity oracle, extrema machinery, banded long-K
path, tube QCQP (XLA f64 + Pallas f32 + IPM), and the nonlinear loop.

The former N = 12 f32 caveat (fast path losing feasibility digits) is
FIXED: the Bezier control-point maps' T^l dynamic range pushed real
constraint-row norms below the [1e-2, 1e2] equilibration clamp, leaving
the f32 stage KKT at cond ~1.9e6; qcqp._row_scale_bounds widens the clamp
to [1e-4, 1e4] for N > 10 (cond ~3.4e3, the N=10 class), and the f32
XLA/Pallas paths now land in the f64 feasibility class at every N
(test_qcqp_pallas_matches_xla_f32 pins this against the f64 answer).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation import native
from mav_tube_trajectory_generation.solver import (banded, ipm, linear,
                                                       nonlinear, qcqp)
from mav_tube_trajectory_generation.solver import structure as sm
from mav_tube_trajectory_generation.models import trajectory as tj
from mav_tube_trajectory_generation.ops import roots

NS = [8, 10, 12]


def linear_problem(n, dim=3, k=4, seed=1):
    h = n // 2
    verts = mtg.create_random_vertices(h - 1, k, np.zeros(dim),
                                       6 * np.ones(dim), seed)
    structure, values = mtg.structure_from_vertices(verts, n, n // 2 - 1)
    times = jnp.asarray(mtg.estimate_segment_times(verts, 2.0, 2.0))
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    return structure, d_fixed, times, values


def qcqp_problem(n, k=4, seed=2):
    h = n // 2
    free = sm.make_structure(sm.free_interior_mask(k + 1, n), 3, n)
    wp = np.cumsum(np.random.RandomState(seed).uniform(
        0.8, 1.4, size=(k + 1, 3)), axis=0)
    vals = np.zeros((k + 1, h, 3))
    vals[0, 0] = wp[0]
    vals[-1, 0] = wp[-1]
    dff = mtg.extract_fixed_values(free, jnp.asarray(vals))
    times = jnp.full((k,), 1.2)
    radii = jnp.full((k, 2), 0.6)
    return free, dff, times, jnp.asarray(wp), radii


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dim", [2, 3])
def test_linear_solve_constraints_and_continuity(n, dim):
    """checkPath semantics at every N: fixed constraints hit, C^(N/2-1)
    continuity across vertices (test_polynomial_optimization.cpp:113-172)."""
    structure, d_fixed, times, values = linear_problem(n, dim=dim)
    sol = linear.solve_linear(structure, d_fixed, times)
    h = n // 2
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    # Fixed position constraints at vertices.
    t_acc = np.concatenate([[0.0], np.cumsum(np.asarray(times))])
    for v in range(structure.n_vertices):
        pos = np.asarray(mtg.evaluate(traj, jnp.asarray(
            min(t_acc[v], t_acc[-1] - 1e-9)), 0))
        np.testing.assert_allclose(pos.ravel(), values[v, 0], atol=1e-6)
    # Continuity of derivatives 0..h-1 at interior vertices.
    for v in range(1, structure.n_vertices - 1):
        for d in range(h):
            left = np.asarray(mtg.evaluate(
                traj, jnp.asarray(t_acc[v] - 1e-9), d))
            right = np.asarray(mtg.evaluate(
                traj, jnp.asarray(t_acc[v] + 1e-9), d))
            np.testing.assert_allclose(left, right, atol=1e-4 * max(
                1.0, np.abs(left).max()))


@pytest.mark.parametrize("n", NS)
def test_cpp_parity_all_n(n):
    """Coefficient parity vs the independent C++ solver at every N."""
    if not native.available():
        pytest.skip("no C++ toolchain")
    h = n // 2
    deriv = min(mtg.SNAP, h - 1)   # N=8 caps the optimizable order at jerk
    verts = mtg.create_random_vertices(h - 1, 6, -10 * np.ones(3),
                                       10 * np.ones(3), seed=n)
    structure, values = mtg.structure_from_vertices(verts, n, deriv)
    times = np.asarray(mtg.estimate_segment_times(verts, 3.0, 5.0))
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    ours = np.asarray(linear.solve_linear(structure, d_fixed,
                                          jnp.asarray(times)).coefficients)
    cpp = native.solve_linear_cpp(structure.fixed_mask, values, times,
                                  deriv, n)
    scale = np.abs(cpp).max() + 1.0
    np.testing.assert_allclose(ours, cpp, rtol=1e-7, atol=1e-9 * scale)


@pytest.mark.parametrize("n", NS)
def test_banded_matches_dense(n):
    """The long-K banded path (cyclic reduction) at every N."""
    structure, d_fixed, times, _ = linear_problem(n, k=12, seed=3)
    dense = linear.solve_linear(structure, d_fixed, times)
    band = banded.solve_linear_banded(structure, d_fixed, times)
    np.testing.assert_allclose(np.asarray(band.coefficients),
                               np.asarray(dense.coefficients),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n", NS)
def test_extrema_vs_sampling(n):
    """Magnitude-extrema machinery (degree 2N-3 candidate polynomials) at
    every N, vs a dense sampling oracle."""
    structure, d_fixed, times, _ = linear_problem(n, seed=5)
    sol = linear.solve_linear(structure, d_fixed, times)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    for deriv in (1, 2):
        analytic = float(mtg.max_magnitude(traj, deriv).value)
        ts = np.linspace(0, float(traj.max_time) - 1e-9, 4000)
        vals = np.asarray(mtg.evaluate(traj, jnp.asarray(ts), deriv))
        sampled = float(np.linalg.norm(vals, axis=-1).max())
        assert analytic == pytest.approx(sampled, rel=1e-2)
        assert analytic >= sampled - 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("n", NS)
def test_qcqp_xla_f64_feasible(n):
    """Tube QCQP (XLA path, f64) reaches feasibility at every N."""
    free, dff, times, wp, radii = qcqp_problem(n)
    s = qcqp.solve_qcqp(free, dff, times, wp, radii,
                        config=qcqp.ADMMConfig(n_stages=3, n_iters=40,
                                               padded_lanes=False))
    assert float(s.max_violation) < 5e-3, float(s.max_violation)
    assert np.isfinite(float(s.cost))


@pytest.mark.slow
@pytest.mark.parametrize("n", NS)
def test_ipm_converges_all_n(n):
    free, dff, times, wp, radii = qcqp_problem(n)
    s = ipm.solve_qcqp_ipm(free, dff, times, wp, radii)
    assert bool(s.converged)
    assert float(s.max_violation) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("n", NS)
def test_qcqp_pallas_matches_xla_f32(n):
    """_PadLayout lane math + the in-kernel block-Thomas sweeps hold at
    every N, and (since the N-aware _row_scale_bounds fix) the f32 paths
    land in the f64 answer's feasibility class -- measured agreement is
    ~1e-6 relative on the violation and <0.1% on cost at N=12."""
    free, dff, times, wp, radii = qcqp_problem(n)
    f32 = jnp.float32
    args = (dff.astype(f32), times.astype(f32), wp.astype(f32),
            radii.astype(f32))
    sx = qcqp.solve_qcqp(free, *args, config=qcqp.ADMMConfig(
        n_stages=2, n_iters=30, padded_lanes=False))
    sp = qcqp.solve_qcqp(free, *args, config=qcqp.ADMMConfig(
        n_stages=2, n_iters=30, padded_lanes=True))
    s64 = qcqp.solve_qcqp(free, dff, times, wp, radii,
                          config=qcqp.ADMMConfig(n_stages=2, n_iters=30,
                                                 padded_lanes=False))
    assert float(sp.max_violation) == pytest.approx(
        float(sx.max_violation), abs=1e-4)
    assert float(sp.cost) == pytest.approx(float(sx.cost), rel=1e-2)
    # f32 vs f64: same feasibility class and cost to f32 accuracy.
    assert float(sx.max_violation) == pytest.approx(
        float(s64.max_violation), abs=5e-4)
    assert float(sx.cost) == pytest.approx(float(s64.cost), rel=2e-3)


@pytest.mark.slow
@pytest.mark.parametrize("n", [8, 12])
def test_nonlinear_optimize_all_n(n):
    structure, d_fixed, times, _ = linear_problem(n, seed=7)
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_TIME,
        max_iterations=15, use_soft_constraints=False)
    res = nonlinear.optimize(structure, d_fixed, times, params)
    assert float(res.cost.total) <= 1.1 * float(res.initial_cost.total)
    assert np.isfinite(float(res.cost.total))
