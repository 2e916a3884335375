"""Tests for the Trajectory model: evaluation, sampling, extrema."""

import numpy as np
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation.models import trajectory as traj_mod

N = 10
H = N // 2


def build_solution(dim=3, k=5, seed=42):
    verts = mtg.create_random_vertices(H - 1, k, -10 * np.ones(dim),
                                       10 * np.ones(dim), seed)
    structure, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
    times = mtg.estimate_segment_times(verts, 3.0, 5.0)
    d_fixed = mtg.extract_fixed_values(structure, jnp.asarray(values))
    sol = mtg.solve_linear(structure, d_fixed, jnp.asarray(times))
    return verts, structure, values, times, sol


def test_evaluate_against_polyval():
    _, _, _, times, sol = build_solution()
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    coeffs = np.asarray(sol.coefficients)
    total = float(np.sum(times))
    ts = np.linspace(0.0, total - 1e-9, 57)
    for derivative in [0, 1, 2]:
        ours = np.asarray(mtg.evaluate(traj, jnp.asarray(ts), derivative))
        cum = np.cumsum(times)
        for i, t in enumerate(ts):
            seg = int(np.searchsorted(cum[:-1], t, side="right"))
            local = t - (cum[seg] - times[seg])
            for d in range(3):
                oracle = np.polynomial.Polynomial(
                    coeffs[seg, :, d]).deriv(derivative)(local)
                assert ours[i, d] == pytest.approx(oracle, rel=1e-9, abs=1e-9)


def test_evaluate_endpoints_match_vertices():
    verts, structure, values, times, sol = build_solution()
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    start = np.asarray(traj_mod.start_position(traj))
    goal = np.asarray(traj_mod.goal_position(traj))
    np.testing.assert_allclose(start, values[0, 0], atol=1e-8)
    np.testing.assert_allclose(goal, values[-1, 0], atol=1e-7)


def test_max_magnitude_vs_dense_sampling():
    _, _, _, times, sol = build_solution(seed=5)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    total = float(np.sum(times))
    ts = np.linspace(0, total, 200001)
    samples = np.asarray(mtg.evaluate(traj, jnp.asarray(ts), 1))
    sampled_max = np.linalg.norm(samples, axis=-1).max()
    ext = mtg.max_magnitude(traj, 1)
    assert float(ext.value) == pytest.approx(sampled_max, rel=1e-4)

    mins, maxs = mtg.min_max_magnitude(traj, 2)
    samples2 = np.asarray(mtg.evaluate(traj, jnp.asarray(ts), 2))
    mags2 = np.linalg.norm(samples2, axis=-1)
    assert float(maxs.value) == pytest.approx(mags2.max(), rel=1e-4)
    assert float(mins.value) == pytest.approx(mags2.min(), rel=1e-3, abs=1e-3)


def test_append_and_projection():
    _, _, _, _, sol = build_solution(k=3)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    double = traj_mod.append(traj, traj)
    assert double.n_segments == 6
    sub = traj_mod.get_segment_dimension(traj, [0, 2])
    assert sub.dimension == 2
    np.testing.assert_allclose(np.asarray(sub.coefficients),
                               np.asarray(traj.coefficients[..., [0, 2]]))


def test_append_dimension_and_vertex_at_time():
    _, _, _, times, sol = build_solution(k=3)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    stacked = traj_mod.append_dimension(traj, traj)
    assert stacked.dimension == 6
    t = 0.4 * float(np.sum(times))
    v6 = np.asarray(traj_mod.get_vertex_at_time(stacked, t, 2))
    assert v6.shape == (3, 6)
    np.testing.assert_allclose(v6[:, :3], v6[:, 3:], atol=1e-12)
    # Row d equals the d-th derivative of the original trajectory at t.
    for d in range(3):
        np.testing.assert_allclose(
            v6[d, :3], np.asarray(mtg.evaluate(traj, jnp.asarray(t), d))[0],
            atol=1e-12)


def test_sample_times():
    ts = traj_mod.sample_times(np.array([1.0, 2.0]), 0.5)
    np.testing.assert_allclose(ts, [0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0])


def test_scale_trajectory_time_exact():
    """x_scaled(factor * t) == x(t) exactly; derivatives scale by 1/f^d."""
    _, _, _, times, sol = build_solution(k=3, seed=9)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    f = 1.7
    scaled = traj_mod.scale_trajectory_time(traj, f)
    ts = np.linspace(0.0, float(np.sum(times)) - 1e-9, 23)
    for d in (0, 1, 2):
        orig = np.asarray(mtg.evaluate(traj, jnp.asarray(ts), d))
        got = np.asarray(mtg.evaluate(scaled, jnp.asarray(f * ts), d))
        np.testing.assert_allclose(got, orig / f**d, rtol=1e-9, atol=1e-10)


def test_scale_times_to_limits_repairs_violation():
    """After scaling, v/a limits hold (scaleSegmentTimesWithViolation
    intent, test_polynomial_optimization.cpp:661)."""
    _, _, _, _, sol = build_solution(k=4, seed=11)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    vmax0 = float(mtg.max_magnitude(traj, 1).value)
    amax0 = float(mtg.max_magnitude(traj, 2).value)
    v_lim, a_lim = 0.5 * vmax0, 0.5 * amax0   # force a violation
    fixed = traj_mod.scale_times_to_limits(traj, v_lim, a_lim)
    assert float(mtg.max_magnitude(fixed, 1).value) <= v_lim * (1 + 1e-6)
    assert float(mtg.max_magnitude(fixed, 2).value) <= a_lim * (1 + 1e-6)
    # A trajectory already within limits is untouched.
    same = traj_mod.scale_times_to_limits(traj, vmax0 * 2, amax0 * 2)
    np.testing.assert_allclose(np.asarray(same.times), np.asarray(traj.times))


def test_add_trajectories_merge_and_continuity():
    """N-way merge (Trajectory::addTrajectories, trajectory.cpp:230-249):
    compatible pieces concatenate; a continuity gap raises."""
    _, structure, values, times, sol = build_solution(k=3, seed=7)
    traj = mtg.Trajectory(sol.coefficients, sol.times)
    # Build a continuation that starts exactly at the goal state: re-solve
    # with the start vertex = goal of traj.
    goal_state = np.asarray(
        traj_mod.get_vertex_at_time(traj, traj.max_time, H - 1))
    verts2 = mtg.create_random_vertices(H - 1, 3, -10 * np.ones(3),
                                        10 * np.ones(3), seed=8)
    for d in range(H):
        verts2[0].add_constraint(d, goal_state[d])
    structure2, values2 = mtg.structure_from_vertices(verts2, N, mtg.SNAP)
    times2 = mtg.estimate_segment_times(verts2, 3.0, 5.0)
    d_fixed2 = mtg.extract_fixed_values(structure2, jnp.asarray(values2))
    sol2 = mtg.solve_linear(structure2, d_fixed2, jnp.asarray(times2))
    traj2 = mtg.Trajectory(sol2.coefficients, sol2.times)

    merged = traj_mod.add_trajectories([traj, traj2], max_derivative=H - 1,
                                       tolerance=1e-6)
    assert merged.n_segments == 6
    # Merged trajectory evaluates identically on each piece's time range.
    t_mid2 = float(traj.max_time) + 0.3 * float(traj2.max_time)
    np.testing.assert_allclose(
        np.asarray(mtg.evaluate(merged, jnp.asarray(t_mid2))),
        np.asarray(mtg.evaluate(traj2,
                                jnp.asarray(t_mid2 - float(traj.max_time)))),
        atol=1e-8)

    # A discontinuous pair must raise.
    with pytest.raises(ValueError, match="goal vertex"):
        traj_mod.add_trajectories([traj, traj], max_derivative=0)

    # D/N mismatch must raise (reference D/N check).
    sub = traj_mod.get_segment_dimension(traj, [0, 1])
    with pytest.raises(ValueError, match="D="):
        traj_mod.add_trajectories([traj, sub], check_continuity=False)
