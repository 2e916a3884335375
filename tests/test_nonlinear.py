"""Tests for the nonlinear outer loop (reference test pattern: optimizer must
not fail, final cost <= 1.1x initial, magnitudes within bounds --
UnconstrainedNonlinear, test_polynomial_optimization.cpp:408-508)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation.solver import linear, nonlinear
from mav_tube_trajectory_generation.solver import structure as sm

N = 10
H = N // 2


def build(dim=3, k=4, seed=3):
    verts = mtg.create_random_vertices(H - 1, k, np.zeros(dim),
                                       6 * np.ones(dim), seed)
    structure, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
    times = jnp.asarray(mtg.estimate_segment_times(verts, 2.0, 2.0))
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    return structure, d_fixed, times, values


def test_time_objective_nelder_mead_decreases_cost():
    structure, d_fixed, times, _ = build()
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=40,
        time_penalty=500.0, use_soft_constraints=False)
    res = nonlinear.optimize(structure, d_fixed, times, params)
    assert float(res.cost.total) <= 1.1 * float(res.initial_cost.total)
    # Times must respect the reference box [0.1, 2 t_init].
    t = np.asarray(res.times)
    assert np.all(t >= 0.1 - 1e-9)
    assert np.all(t <= 2.0 * np.asarray(times) + 1e-9)


def test_time_gradient_beats_nelder_mead():
    structure, d_fixed, times, _ = build()
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=30,
        time_penalty=500.0, use_soft_constraints=False)
    t_nm_res = nonlinear.optimize(structure, d_fixed, times, params)
    t_gd, values = nonlinear.optimize_time_gradient(
        structure, d_fixed, times, params, n_iters=30)
    sol_gd = mtg.solve_linear(structure, d_fixed, t_gd)
    cost_gd = float(sol_gd.cost) + float(
        nonlinear.time_cost(t_gd, params.time_penalty))
    sol_nm = mtg.solve_linear(structure, d_fixed, t_nm_res.times)
    cost_nm = float(sol_nm.cost) + float(
        nonlinear.time_cost(t_nm_res.times, params.time_penalty))
    # Analytic gradients through the solve should match or beat the simplex.
    assert cost_gd <= cost_nm * 1.05
    # And strictly improve on the initial guess.
    sol_0 = mtg.solve_linear(structure, d_fixed, times)
    cost_0 = float(sol_0.cost) + float(
        nonlinear.time_cost(times, params.time_penalty))
    assert cost_gd < cost_0


def test_free_constraints_objective_reduces_derivative_cost():
    structure, d_fixed, times, _ = build()
    # Perturb the free constraints away from the optimum; L-BFGS must pull
    # the derivative cost back to (near) the closed-form minimum.
    sol = mtg.solve_linear(structure, d_fixed, times)
    rng = np.random.RandomState(0)
    d_free0 = sol.d_free + 0.5 * jnp.asarray(
        rng.randn(*np.asarray(sol.d_free).shape))
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS, max_iterations=40,
        use_soft_constraints=False)
    res = nonlinear.optimize(structure, d_fixed, times, params,
                             d_free_init=d_free0)
    j_opt = float(nonlinear.derivative_cost(structure, d_fixed, sol.d_free,
                                            times))
    j_fin = float(nonlinear.derivative_cost(structure, d_fixed, res.d_free,
                                            times))
    j_init = float(nonlinear.derivative_cost(structure, d_fixed, d_free0,
                                             times))
    assert j_fin < j_init
    assert j_fin <= j_opt * 1.01 + 1e-9


def test_soft_constraints_reduce_max_velocity():
    structure, d_fixed, times, _ = build(seed=9)
    v_limit = 1.5
    cons = [nonlinear.MagnitudeConstraint(mtg.VELOCITY, v_limit)]
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_TIME,
        max_iterations=60, time_penalty=0.0,
        use_soft_constraints=True, soft_constraint_weight=10.0,
        weights=nonlinear.CostWeights(w_d=0.1, w_sc=10.0))
    sol0 = mtg.solve_linear(structure, d_fixed, times)
    vmax0 = float(nonlinear.max_magnitude_from_d(
        structure, d_fixed, sol0.d_free, times, mtg.VELOCITY))
    res = nonlinear.optimize(structure, d_fixed, times, params,
                             constraints=cons)
    vmax1 = float(nonlinear.max_magnitude_from_d(
        structure, d_fixed, res.d_free, res.times, mtg.VELOCITY))
    # Reference pattern: extrema within 1.5x bounds after optimization.
    if vmax0 > v_limit:
        assert vmax1 < vmax0 * 1.001
    assert vmax1 <= 1.5 * v_limit


def test_collision_objective_avoids_obstacle():
    # Straight path through a box obstacle; collision objective must push the
    # path around it.
    dim, k = 3, 2
    structure = sm.make_structure(sm.standard_mask(k + 1, N), dim, N)
    values = np.zeros((k + 1, H, dim))
    values[0, 0] = [0.2, 1.0, 1.0]
    values[1, 0] = [1.0, 1.0, 1.0]   # waypoint right in front of the box
    values[2, 0] = [1.8, 1.0, 1.0]
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    times = jnp.asarray([3.0, 3.0])

    # Asymmetric box so the straight-through path is not a gradient saddle.
    occ = mtg.make_obstacle_grid((20, 20, 20), (0, 0, 0), 0.1,
                                 boxes=[((1.15, 0.9, 0.85),
                                         (1.45, 1.35, 1.3))])
    field = mtg.esdf_from_occupancy(occ, (0, 0, 0), 0.1, dtype=jnp.float64)

    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_COLLISION,
        max_iterations=100, use_soft_constraints=False,
        robot_radius=0.1, epsilon=0.3, collision_samples_per_segment=64,
        weights=nonlinear.CostWeights(w_d=0.1, w_c=1000.0))
    res = nonlinear.optimize(structure, d_fixed, times, params, field=field)
    j_c0 = float(res.initial_cost.collision)
    j_c1 = float(res.cost.collision)
    assert j_c1 < j_c0 * 0.5, (j_c0, j_c1)

    # The optimized path must keep clearance >= robot radius at samples.
    traj = mtg.Trajectory(res.coefficients, res.times)
    ts = np.linspace(0, float(np.sum(np.asarray(res.times))) - 1e-9, 200)
    pos = mtg.evaluate(traj, jnp.asarray(ts), 0)
    dmin = float(jnp.min(mtg.distance_at(field, pos)))
    assert dmin > params.robot_radius, dmin


def test_vmapped_nonlinear_optimize():
    structure, d_fixed, times, _ = build()
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_TIME,
        max_iterations=10, use_soft_constraints=False)
    batch_df = jnp.stack([d_fixed, d_fixed * 1.1, d_fixed * 0.9])
    batch_t = jnp.stack([times, times, times * 1.2])
    res = jax.vmap(lambda df, t: nonlinear.optimize(
        structure, df, t, params))(batch_df, batch_t)
    assert res.cost.total.shape == (3,)
    assert np.all(np.isfinite(np.asarray(res.cost.total)))


def test_time_objective_with_qcqp_inner():
    """TIME objective re-solving the tube QCQP per evaluation (the
    reference's objectiveFunctionTime path, stack 3.4 of SURVEY.md)."""
    from mav_tube_trajectory_generation.solver import qcqp as qcqp_mod
    k = 3
    rng = np.random.RandomState(5)
    waypoints = np.cumsum(rng.uniform(0.8, 1.5, size=(k + 1, 3)), axis=0)
    structure = sm.make_structure(sm.free_interior_mask(k + 1, N), 3, N)
    values = np.zeros((k + 1, H, 3))
    values[0, 0] = waypoints[0]
    values[-1, 0] = waypoints[-1]
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    times = jnp.asarray(mtg.segment_times_nfabian(waypoints, 2.0, 2.0))
    radii = jnp.full((k, 2), 0.6)
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=12,
        time_penalty=100.0, use_soft_constraints=False)
    res = nonlinear.optimize(
        structure, d_fixed, times, params, waypoints=jnp.asarray(waypoints),
        radii=radii,
        admm_config=qcqp_mod.ADMMConfig(rho=0.01, n_stages=2, n_iters=60))
    assert float(res.cost.total) <= 1.1 * float(res.initial_cost.total)
    assert np.all(np.isfinite(np.asarray(res.coefficients)))


def test_collision_and_time_joint_objective():
    structure, d_fixed, times, _ = build(k=2, seed=11)
    occ = mtg.make_obstacle_grid((16, 16, 16), (0, 0, 0), 0.4, spheres=[
        ((3.0, 3.0, 3.0), 0.5)])
    field = mtg.esdf_from_occupancy(occ, (0, 0, 0), 0.4, dtype=jnp.float64)
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME,
        max_iterations=15, time_penalty=10.0, use_soft_constraints=False,
        weights=nonlinear.CostWeights(w_d=0.1, w_c=10.0, w_t=1.0))
    res = nonlinear.optimize(structure, d_fixed, times, params, field=field)
    assert float(res.cost.total) <= 1.1 * float(res.initial_cost.total)
    assert np.all(np.isfinite(np.asarray(res.times)))


def test_format_result():
    structure, d_fixed, times, _ = build(k=2, seed=1)
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS, max_iterations=3,
        use_soft_constraints=False)
    res = nonlinear.optimize(structure, d_fixed, times, params)
    report = nonlinear.format_result(res)
    assert "cost trajectory" in report and "iterations:" in report
    # n_iterations is the EFFECTIVE convergence iteration (<= the budget).
    assert 1 <= int(res.n_iterations) <= 3


def test_hard_magnitude_constraint_augmented_lagrangian():
    """use_soft_constraints=False + constraints engages the augmented-
    Lagrangian hard path (reference: NLOPT add_inequality_constraint,
    nonlinear_impl.h:848-875): the final max ||v|| must respect the bound
    within inequality_constraint_tolerance, and the derivative cost must
    stay finite and above the unconstrained optimum."""
    structure, d_fixed, times, _ = build(seed=7)
    params0 = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS, max_iterations=40,
        use_soft_constraints=False)
    free0 = nonlinear.optimize(structure, d_fixed, times, params0)
    vmax0 = float(nonlinear.max_magnitude_from_d(
        structure, d_fixed, free0.d_free, times, 1))
    bound = 0.8 * vmax0   # force the constraint to be active

    cons = [nonlinear.MagnitudeConstraint(derivative=1, value=bound)]
    res = nonlinear.optimize(structure, d_fixed, times, params0,
                             constraints=cons)
    vmax = float(nonlinear.max_magnitude_from_d(
        structure, d_fixed, res.d_free, times, 1))
    tol = params0.inequality_constraint_tolerance
    assert vmax <= bound * (1.0 + tol), (vmax, bound)
    # Constrained optimum cannot beat the unconstrained one.
    assert float(res.cost.trajectory) >= float(free0.cost.trajectory) - 1e-6
    assert np.isfinite(float(res.cost.total))
    # maxima report reflects the constrained derivative.
    assert 1 in res.maxima


def test_effective_iterations_and_stopping_reason():
    """n_iterations must be the EFFECTIVE convergence iteration derived from
    the cost trace, not the static scan length (VERDICT round-1 missing #6)."""
    # Synthetic traces first: converges at step 3 of 6.
    hist = jnp.asarray([10.0, 5.0, 2.0, 1.999, 1.998, 1.997])
    n_it, reason = nonlinear.effective_iterations(hist, f_rel=0.05)
    assert int(n_it) == 3
    assert int(reason) == nonlinear.STOP_FTOL_REACHED
    # Never converges -> full length + MAXEVAL.
    hist2 = jnp.asarray([16.0, 8.0, 4.0, 2.0, 1.0, 0.5])
    n_it2, reason2 = nonlinear.effective_iterations(hist2, f_rel=0.05)
    assert int(n_it2) == 6
    assert int(reason2) == nonlinear.STOP_MAX_ITERATIONS
    # End-to-end: a generous iteration budget on a smooth problem must
    # report an effective count BELOW the budget with FTOL_REACHED.
    structure, d_fixed, times, _ = build()
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS, max_iterations=40,
        use_soft_constraints=False)
    res = nonlinear.optimize(structure, d_fixed, times, params)
    assert int(res.n_iterations) < 40
    assert int(res.stopping_reason) == nonlinear.STOP_FTOL_REACHED
    assert "FTOL_REACHED" in nonlinear.format_result(res)


def test_free_derivative_bounds_layout():
    """Box construction (setFreeEndpointDerivativeHardConstraints,
    nonlinear_impl.h:2858-2905): magnitude constraints box their derivative's
    free columns to +-|value|; free positions get the map box; everything
    else stays infinite."""
    structure = sm.make_structure(sm.free_interior_mask(4, N), 3, N)
    cons = [nonlinear.MagnitudeConstraint(mtg.VELOCITY, 2.5),
            nonlinear.MagnitudeConstraint(mtg.ACCELERATION, -4.0)]
    lo, hi = nonlinear.free_derivative_bounds(
        structure, cons, min_bound=(0.0, -1.0, 0.0),
        max_bound=(6.0, 7.0, 8.0), dtype=jnp.float64)
    lo, hi = np.asarray(lo), np.asarray(hi)
    derivs = structure.free_cols[:, 1]
    np.testing.assert_allclose(lo[derivs == 1], -2.5)
    np.testing.assert_allclose(hi[derivs == 1], 2.5)
    # abs(value) semantics: a negative bound value still gives +-|value|.
    np.testing.assert_allclose(lo[derivs == 2], -4.0)
    np.testing.assert_allclose(hi[derivs == 2], 4.0)
    np.testing.assert_allclose(lo[derivs == 0], [[0.0, -1.0, 0.0]] * 2)
    np.testing.assert_allclose(hi[derivs == 0], [[6.0, 7.0, 8.0]] * 2)
    assert np.all(np.isinf(lo[derivs >= 3])) and np.all(np.isinf(hi[derivs >= 3]))


def test_hard_map_bounds_confine_free_positions():
    """VERDICT round-1 missing #1 'done' criterion: an obstacle whose cheap
    escape is outside the map pushes the UNBOUNDED optimizer out of the map;
    with hard bounds (the default) the iterate provably stays inside
    (map bounds on free positions, nonlinear_impl.h:2883-2887)."""
    dim, k = 3, 2
    structure = sm.make_structure(sm.free_interior_mask(k + 1, N), dim, N)
    values = np.zeros((k + 1, H, dim))
    values[0, 0] = [0.2, 0.3, 0.5]
    values[2, 0] = [1.7, 0.3, 0.5]
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    times = jnp.asarray([3.0, 3.0])
    # Sphere just above the straight path: the collision gradient pushes the
    # free midpoint toward -y, and clearance-satisfying detours lie below
    # y = 0 -- outside the map box [0, 1.9] x [0, 1.9] x [0, 0.9].
    occ = mtg.make_obstacle_grid((20, 20, 10), (0, 0, 0), 0.1,
                                 spheres=[((0.95, 0.5, 0.5), 0.4)])
    field = mtg.esdf_from_occupancy(occ, (0, 0, 0), 0.1, dtype=jnp.float64)
    pos_rows = structure.free_cols[:, 1] == 0
    mn, mx = nonlinear.map_bounds(field)

    def run(hard):
        params = nonlinear.NonlinearParameters(
            objective=nonlinear.Objective.FREE_CONSTRAINTS_AND_COLLISION,
            max_iterations=80, use_soft_constraints=False,
            robot_radius=0.1, epsilon=0.3, collision_samples_per_segment=64,
            weights=nonlinear.CostWeights(w_d=0.1, w_c=1000.0),
            use_hard_bounds=hard)
        res = nonlinear.optimize(structure, d_fixed, times, params,
                                 field=field)
        return np.asarray(res.d_free)[pos_rows], res

    free_nb, _ = run(False)
    assert np.any((free_nb < mn) | (free_nb > mx)), free_nb  # escapes the map
    free_b, res_b = run(True)
    assert np.all((free_b >= mn) & (free_b <= mx)), free_b   # confined
    # The bounded optimizer still makes real collision progress.
    assert float(res_b.cost.collision) < 0.3 * float(
        res_b.initial_cost.collision)


def test_hard_bounds_box_magnitude_constraints():
    """Magnitude constraints additionally BOX each free derivative component
    to +-|value| (nonlinear_impl.h:2890-2904) on top of the AL magnitude
    handling: every velocity component of d_free must end inside the box."""
    structure, d_fixed, times, _ = build(seed=7)
    v_limit = 1.5
    cons = [nonlinear.MagnitudeConstraint(mtg.VELOCITY, v_limit)]
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS, max_iterations=40,
        use_soft_constraints=False)
    res = nonlinear.optimize(structure, d_fixed, times, params, cons)
    vel_rows = structure.free_cols[:, 1] == 1
    vel = np.asarray(res.d_free)[vel_rows]
    assert np.all(np.abs(vel) <= v_limit + 1e-9), vel
