"""End-to-end tests of the linear min-derivative solver.

Replicates the reference test strategy (SURVEY.md section 4):
  * checkPath: fixed-constraint satisfaction + C^(N/2-1) continuity
    (test_polynomial_optimization.cpp:113-172),
  * analytic vs numeric cost (checkCost, :174-195; oracle test_utils.h:56-64),
  * golden Matlab coefficients (TwoVerticesSetup, :707-751),
  * parameterized sweeps over dimension/segment-count/derivative (:754-851),
  * a NumPy transliteration of the reference closed form as a full-solution
    parity oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation.ops import basis
from mav_tube_trajectory_generation.solver import linear, structure as structure_mod

N = 10
H = N // 2


# ---------------------------------------------------------------------------
# NumPy oracle: direct transliteration of the closed form of SURVEY.md 3.1.
# (Independent construction: dense matrices, explicit inverses -- no reuse of
# the jax code paths under test.)
# ---------------------------------------------------------------------------

def oracle_solve(fixed_mask, values, times, derivative):
    v, h = fixed_mask.shape
    k = v - 1
    dim = values.shape[-1]
    n = 2 * h

    def a_matrix(t):
        a = np.zeros((n, n))
        for i in range(h):
            a[i] = basis.base_coeffs_with_time(n, i, 0.0)
            a[i + h] = basis.base_coeffs_with_time(n, i, t)
        return a

    def q_matrix(t):
        bc = basis.base_coefficients(n)
        q = np.zeros((n, n))
        for r in range(derivative, n):
            for c in range(derivative, n):
                e = r + c + 1 - 2 * derivative
                q[r, c] = bc[derivative, r] * bc[derivative, c] * 2.0 / e * t ** e
        return q

    fixed = [(vi, j) for vi in range(v) for j in range(h) if fixed_mask[vi, j]]
    free = [(vi, j) for vi in range(v) for j in range(h) if not fixed_mask[vi, j]]
    col = {c: i for i, c in enumerate(fixed + free)}
    nf, npn = len(fixed), len(free)
    nt = nf + npn

    m = np.zeros((k * n, nt))
    for seg in range(k):
        for j in range(h):
            m[seg * n + j, col[(seg, j)]] = 1.0
            m[seg * n + h + j, col[(seg + 1, j)]] = 1.0

    h_big = np.zeros((k * n, k * n))
    for seg in range(k):
        a = a_matrix(times[seg])
        ainv = np.linalg.inv(a)
        h_big[seg * n:(seg + 1) * n, seg * n:(seg + 1) * n] = (
            ainv.T @ q_matrix(times[seg]) @ ainv)
    r = m.T @ h_big @ m

    df = np.stack([values[vi, j] for (vi, j) in fixed]) if nf else np.zeros((0, dim))
    if npn:
        rpf = r[nf:, :nf]
        rpp = r[nf:, nf:]
        dp = -np.linalg.solve(rpp, rpf @ df)
    else:
        dp = np.zeros((0, dim))
    d_all = np.concatenate([df, dp], axis=0)
    coeffs = np.zeros((k, n, dim))
    for seg in range(k):
        d_seg = m[seg * n:(seg + 1) * n] @ d_all
        coeffs[seg] = np.linalg.inv(a_matrix(times[seg])) @ d_seg
    cost = 0.0
    for seg in range(k):
        q = q_matrix(times[seg])
        for d in range(dim):
            cost += 0.5 * coeffs[seg, :, d] @ q @ coeffs[seg, :, d]
    return coeffs, d_all, cost


def check_path(fixed_mask, values, coeffs, times, tol=1e-6):
    """Reference checkPath (test_polynomial_optimization.cpp:113-172)."""
    v, h = fixed_mask.shape
    k = v - 1
    dim = values.shape[-1]
    for seg in range(k):
        poly = [np.polynomial.Polynomial(coeffs[seg, :, d]) for d in range(dim)]
        for j in range(h):
            # Fixed constraints at segment start (vertex seg).
            if fixed_mask[seg, j]:
                for d in range(dim):
                    assert poly[d].deriv(j)(0.0) == pytest.approx(
                        values[seg, j, d], abs=tol), (seg, j, d)
            # Fixed constraints at segment end (vertex seg+1).
            if fixed_mask[seg + 1, j]:
                for d in range(dim):
                    assert poly[d].deriv(j)(times[seg]) == pytest.approx(
                        values[seg + 1, j, d], abs=tol), (seg, j, d)
        # Continuity at interior boundary.
        if seg + 1 < k:
            nxt = [np.polynomial.Polynomial(coeffs[seg + 1, :, d])
                   for d in range(dim)]
            for j in range(h):
                for d in range(dim):
                    assert poly[d].deriv(j)(times[seg]) == pytest.approx(
                        nxt[d].deriv(j)(0.0), abs=tol, rel=1e-6), (seg, j, d)


def numeric_cost(coeffs, times, derivative, n_samples=20001):
    total = 0.0
    k, n, dim = coeffs.shape
    for seg in range(k):
        ts = np.linspace(0, times[seg], n_samples)
        acc = np.zeros_like(ts)
        for d in range(dim):
            acc += np.polynomial.Polynomial(coeffs[seg, :, d]).deriv(derivative)(ts) ** 2
        total += np.trapezoid(acc, ts)
    return total


# ---------------------------------------------------------------------------
# Golden Matlab coefficients (TwoVerticesSetup, fully constrained case).
# ---------------------------------------------------------------------------

def test_two_vertices_golden_coefficients():
    start = mtg.Vertex(1)
    start.add_constraint(mtg.POSITION, 0.0)
    for d in range(1, 5):
        start.add_constraint(d, 0.0)
    goal = mtg.Vertex(1)
    goal.add_constraint(mtg.POSITION, 5.0)
    for d in range(1, 5):
        goal.add_constraint(d, 0.0)
    segment_time = 5.0  # |5 - 0| * 2 / v_max(=2)

    structure, values = mtg.structure_from_vertices([start, goal], N, mtg.SNAP)
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    sol = mtg.solve_linear(structure, d_fixed, jnp.asarray([segment_time]))

    matlab_coeffs = np.array([
        -0.000000000000004, 0.000000000000004, -0.000000000000006,
        0.000000000000003, -0.000000000000001, 0.201600000000015,
        -0.134400000000012, 0.034560000000004, -0.004032000000000,
        0.000179200000000])
    ours = np.asarray(sol.coefficients)[0, :, 0]
    np.testing.assert_allclose(ours, matlab_coeffs, atol=1e-10)


# ---------------------------------------------------------------------------
# Parameterized sweeps (reference :754-851 pattern).
# ---------------------------------------------------------------------------

CASES = [
    # (dimension, n_segments, derivative_to_optimize, seed)
    (1, 1, mtg.SNAP, 100),
    (1, 10, mtg.SNAP, 101),
    (1, 50, mtg.SNAP, 102),
    (3, 1, mtg.SNAP, 103),
    (3, 10, mtg.SNAP, 104),
    (3, 50, mtg.SNAP, 105),
    (3, 10, mtg.ACCELERATION, 106),
    (3, 10, mtg.JERK, 107),
]


@pytest.mark.parametrize("dim,k,derivative,seed", CASES)
def test_linear_solve_sweep(dim, k, derivative, seed):
    vertices = mtg.create_random_vertices(
        H - 1, k, -10 * np.ones(dim), 10 * np.ones(dim), seed)
    structure, values = mtg.structure_from_vertices(vertices, N, derivative)
    times = mtg.estimate_segment_times(vertices, v_max=3.0, a_max=5.0)
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    sol = mtg.solve_linear(structure, d_fixed, jnp.asarray(times))
    coeffs = np.asarray(sol.coefficients)

    # 1) Constraints + continuity.
    check_path(structure.fixed_mask, values, coeffs, times)

    # 2) Parity vs the NumPy oracle transliteration.
    oracle_coeffs, _, oracle_cost = oracle_solve(
        structure.fixed_mask, values, times, derivative)
    np.testing.assert_allclose(coeffs, oracle_coeffs, rtol=1e-6, atol=1e-8)

    # 3) Analytic cost vs oracle and vs numeric integration (10% tol as in
    #    checkCost).
    assert float(sol.cost) == pytest.approx(oracle_cost, rel=1e-8)
    if k <= 10:
        assert float(sol.cost) == pytest.approx(
            numeric_cost(coeffs, times, derivative), rel=0.1)


def test_vmap_batched_solve_matches_loop():
    dim, k = 3, 10
    batch = 8
    rng = np.random.RandomState(0)
    structure = structure_mod.make_structure(
        structure_mod.standard_mask(k + 1, N), dim, N, mtg.SNAP)

    d_fixed = []
    times = []
    for b in range(batch):
        verts = mtg.create_random_vertices(H - 1, k, -10 * np.ones(dim),
                                           10 * np.ones(dim), seed=200 + b)
        _, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
        d_fixed.append(np.asarray(
            mtg.extract_fixed_values(structure, jnp.asarray(values))))
        times.append(mtg.estimate_segment_times(verts, 3.0, 5.0))
    d_fixed = jnp.asarray(np.stack(d_fixed))
    times = jnp.asarray(np.stack(times))

    solve = jax.vmap(lambda df, t: mtg.solve_linear(structure, df, t))
    batched = solve(d_fixed, times)
    for b in range(batch):
        single = mtg.solve_linear(structure, d_fixed[b], times[b])
        np.testing.assert_allclose(np.asarray(batched.coefficients[b]),
                                   np.asarray(single.coefficients),
                                   rtol=1e-9, atol=1e-10)


def test_fully_constrained_path():
    # Fully fixed => no free constraints; solver must pass through.
    mask = np.ones((2, H), dtype=bool)
    structure = structure_mod.make_structure(mask, 1, N, mtg.SNAP)
    values = np.zeros((2, H, 1))
    values[1, 0, 0] = 5.0
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    sol = mtg.solve_linear(structure, d_fixed, jnp.asarray([5.0]))
    assert structure.n_free == 0
    check_path(mask, values, np.asarray(sol.coefficients), [5.0])


def test_derivative_cost_and_grad_consistency():
    # Analytic gradient vs autodiff through the quadratic form.
    dim, k = 3, 5
    verts = mtg.create_random_vertices(H - 1, k, -5 * np.ones(dim),
                                       5 * np.ones(dim), seed=7)
    structure, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
    times = jnp.asarray(mtg.estimate_segment_times(verts, 3.0, 5.0))
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    rng = np.random.RandomState(3)
    d_free = jnp.asarray(rng.randn(structure.n_free, dim))

    cost, grad = linear.derivative_cost_and_grad(structure, d_fixed, d_free, times)
    auto = jax.grad(
        lambda dp: linear.derivative_cost_and_grad(structure, d_fixed, dp, times)[0]
    )(d_free)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(auto),
                               rtol=1e-8, atol=1e-8)

    # Optimality: at the linear solution the free-gradient must vanish.
    sol = mtg.solve_linear(structure, d_fixed, times)
    _, grad_opt = linear.derivative_cost_and_grad(
        structure, d_fixed, sol.d_free, times)
    assert float(jnp.max(jnp.abs(grad_opt))) < 1e-5


def test_packing_roundtrip():
    """d -> segment derivatives -> M^+ -> d round trip
    (ConstraintPacking, test_polynomial_optimization.cpp:511-570)."""
    dim, k = 3, 6
    verts = mtg.create_random_vertices(H - 1, k, -5 * np.ones(dim),
                                       5 * np.ones(dim), seed=17)
    structure, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
    times = jnp.asarray(mtg.estimate_segment_times(verts, 3.0, 5.0))
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    sol = mtg.solve_linear(structure, d_fixed, times)
    d_seg = linear.segment_derivatives(structure, sol.d_fixed, sol.d_free)
    compact = mtg.compact_from_segment_derivatives(structure, d_seg)
    expect = jnp.concatenate([sol.d_fixed, sol.d_free], axis=-2)
    np.testing.assert_allclose(np.asarray(compact), np.asarray(expect),
                               rtol=1e-10, atol=1e-12)

    # And through the coefficients: d_all = M^+ A p (the reference's
    # re-seeding identity, nonlinear_impl.h:199-272).
    from mav_tube_trajectory_generation.ops import qmatrix
    d_seg_back = qmatrix.endpoint_derivatives_from_coefficients(
        sol.coefficients, times)
    compact2 = mtg.compact_from_segment_derivatives(structure, d_seg_back)
    np.testing.assert_allclose(np.asarray(compact2), np.asarray(expect),
                               rtol=1e-6, atol=1e-8)


def test_solve_from_positions():
    """setupFromPositons convenience path (linear.h:79-80)."""
    positions = np.array([[0.0], [2.0], [5.0]])
    structure, sol = mtg.solve_from_positions(positions, [1.5, 2.0])
    coeffs = np.asarray(sol.coefficients)
    check_path(structure.fixed_mask,
               np.concatenate([positions[:, None, :],
                               np.zeros((3, 4, 1))], axis=1),
               coeffs, [1.5, 2.0])


@pytest.mark.parametrize("heuristic", ["ramp", "nfabian"])
def test_time_allocation_bounds(heuristic):
    """Time-allocation sanity (TimeAllocation,
    test_polynomial_optimization.cpp:572-613): positive times, and the solved
    trajectory's extrema within 2.5x the heuristic's v/a bounds."""
    from mav_tube_trajectory_generation.models import trajectory as tj
    v_max, a_max = 2.0, 3.0
    ok_v = ok_a = total = 0
    for seed in range(5):
        verts = mtg.create_random_vertices(H - 1, 5, np.zeros(3),
                                           5 * np.ones(3), 300 + seed)
        if heuristic == "ramp":
            times = mtg.estimate_segment_times_velocity_ramp(verts, v_max,
                                                             a_max)
        else:
            times = mtg.estimate_segment_times_nfabian(verts, v_max, a_max)
        assert np.all(times > 0)
        structure, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
        d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
        sol = mtg.solve_linear(structure, d_fixed, jnp.asarray(times))
        traj = mtg.Trajectory(sol.coefficients, sol.times)
        vmax = float(tj.max_magnitude(traj, 1).value)
        amax = float(tj.max_magnitude(traj, 2).value)
        total += 1
        ok_v += vmax <= 2.5 * v_max
        ok_a += amax <= 2.5 * a_max
    # Pinned: EVERY seed satisfies the 2.5x bound (measured on CPU/f64:
    # worst case is ramp seed 300 with vmax 1.92x / amax 1.50x -- a short
    # 1.29-unit segment between two long ones makes the min-snap solution
    # overshoot the per-segment ramp profile; nfabian's longer times keep
    # vmax <= 1.09x and amax <= 0.49x on all five).  An earlier revision of
    # this test allowed 1-2 failing seeds; that slack was stale.
    assert ok_v == total, (heuristic, ok_v, total)
    assert ok_a == total, (heuristic, ok_a, total)
