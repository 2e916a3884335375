"""Trajectory model: stacked piecewise-polynomial segments as a pytree.

Batched replacement for the reference ``Segment``/``Trajectory`` classes
(segment.h:43-125, trajectory.h:32-130): one NamedTuple of arrays,

    coefficients: (..., K, N, D) increasing-power monomial coefficients,
    times:        (..., K) per-segment durations,

so a whole batch of trajectories is a single pytree and every operation
(evaluation, sampling, extrema) is batched and jit/vmap-safe.  Evaluation
uses fused Horner sweeps; global-time lookup replaces the reference's
accumulate-and-compare loop (trajectory.cpp:41-72) with a vectorized
boundary count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import basis, roots


class Trajectory(NamedTuple):
    coefficients: jnp.ndarray    # (..., K, N, D)
    times: jnp.ndarray           # (..., K)

    @property
    def n_segments(self) -> int:
        return self.coefficients.shape[-3]

    @property
    def n_coefficients(self) -> int:
        return self.coefficients.shape[-2]

    @property
    def dimension(self) -> int:
        return self.coefficients.shape[-1]

    @property
    def max_time(self) -> jnp.ndarray:
        """Total duration (trajectory.h getMaxTime analogue)."""
        return jnp.sum(self.times, axis=-1)


class Extremum(NamedTuple):
    """(time-within-segment, value, segment index) -- extremum.h:30-44."""
    time: jnp.ndarray
    value: jnp.ndarray
    segment_index: jnp.ndarray


def _segment_lookup(times: jnp.ndarray, t: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Global time -> (segment index, local time).  Vectorized boundary count."""
    cum = jnp.cumsum(times, axis=-1)                      # (..., K)
    boundaries = cum[..., :-1]                            # (..., K-1)
    seg = jnp.sum(t[..., None] >= boundaries[..., None, :], axis=-1)
    start = jnp.concatenate(
        [jnp.zeros_like(cum[..., :1]), cum[..., :-1]], axis=-1)
    local = t - jnp.take_along_axis(start, seg, axis=-1)
    return seg, local


def evaluate(traj: Trajectory, t: jnp.ndarray, derivative: int = 0
             ) -> jnp.ndarray:
    """Evaluate the trajectory at global times t: (..., T) -> (..., T, D).

    Reference: Trajectory::evaluate (trajectory.cpp:41-72) +
    Segment::evaluate (segment.cpp:51-58), batched.
    """
    t = jnp.atleast_1d(jnp.asarray(t, traj.coefficients.dtype))
    seg, local = _segment_lookup(traj.times, t)           # (..., T)
    # Gather per-query coefficients: (..., T, N, D).
    k = traj.n_segments
    seg = jnp.clip(seg, 0, k - 1)
    coeffs = jnp.take_along_axis(
        traj.coefficients, seg[..., None, None], axis=-3)
    # Horner over the coefficient axis, per dimension.
    per_dim = jnp.moveaxis(coeffs, -1, -3)                # (..., D, T, N)
    vals = basis.polyval(per_dim, jnp.expand_dims(local, -2), derivative)
    return jnp.moveaxis(vals, -2, -1)                     # (..., T, D)


def evaluate_segment(traj: Trajectory, segment_index, local_t,
                     derivative: int = 0) -> jnp.ndarray:
    """Evaluate one segment at local time(s); (..., T, D)."""
    coeffs = jnp.take_along_axis(
        traj.coefficients,
        jnp.asarray(segment_index)[..., None, None, None], axis=-3)[..., 0, :, :]
    per_dim = jnp.moveaxis(coeffs, -1, -2)                # (..., D, N)
    local_t = jnp.atleast_1d(jnp.asarray(local_t, traj.coefficients.dtype))
    vals = basis.polyval(per_dim[..., None, :], jnp.expand_dims(local_t, -2),
                         derivative)
    return jnp.moveaxis(vals, -2, -1)


def sample_times(traj_times: np.ndarray, dt: float) -> np.ndarray:
    """Host helper: sampling instants [0, total] at spacing dt (static length).

    Mirrors Trajectory::evaluateRange's stepping (trajectory.cpp:74-134).
    """
    total = float(np.sum(traj_times))
    n = int(np.floor(total / dt)) + 1
    return np.arange(n) * dt


def evaluate_range(traj: Trajectory, ts: jnp.ndarray, derivative: int = 0
                   ) -> jnp.ndarray:
    """Evaluate at a precomputed (static-length) grid of global times."""
    return evaluate(traj, ts, derivative)


def min_max_magnitude(traj: Trajectory, derivative: int,
                      n_grid: int = roots.DEFAULT_GRID
                      ) -> Tuple[Extremum, Extremum]:
    """Global min/max of ||x^(d)(t)|| over the whole trajectory.

    Analytic candidates per segment (magnitude-derivative roots + segment
    endpoints) exactly as Trajectory::computeMinMaxMagnitude
    (trajectory.cpp:184-220) / Segment::computeMinMaxMagnitudeCandidates
    (segment.cpp:135-158), but batched over segments (and any leading batch).
    """
    coeffs = traj.coefficients                             # (..., K, N, D)
    times = traj.times
    zeros = jnp.zeros_like(times)
    cand_t, valid = roots.magnitude_minmax_candidates(
        coeffs, derivative, zeros, times, n_grid=n_grid)   # (..., K, C)
    per_dim = jnp.moveaxis(coeffs, -1, -3)                 # (..., D, K, N)
    vals = basis.polyval(per_dim[..., None, :],
                         jnp.expand_dims(cand_t, -3), derivative)
    mag = jnp.linalg.norm(jnp.moveaxis(vals, -3, -1), axis=-1)   # (..., K, C)

    big = jnp.asarray(jnp.finfo(mag.dtype).max, mag.dtype)
    k, c = mag.shape[-2], mag.shape[-1]
    flat_mag_min = jnp.where(valid, mag, big).reshape(mag.shape[:-2] + (k * c,))
    flat_mag_max = jnp.where(valid, mag, -big).reshape(mag.shape[:-2] + (k * c,))
    flat_t = cand_t.reshape(cand_t.shape[:-2] + (k * c,))

    imin = jnp.argmin(flat_mag_min, axis=-1)
    imax = jnp.argmax(flat_mag_max, axis=-1)
    take = lambda a, i: jnp.take_along_axis(a, i[..., None], axis=-1)[..., 0]
    mins = Extremum(time=take(flat_t, imin), value=take(flat_mag_min, imin),
                    segment_index=imin // c)
    maxs = Extremum(time=take(flat_t, imax), value=take(flat_mag_max, imax),
                    segment_index=imax // c)
    return mins, maxs


def max_magnitude(traj: Trajectory, derivative: int,
                  n_grid: int = roots.DEFAULT_GRID) -> Extremum:
    """Global maximum of ||x^(d)||; the optimizer's feasibility primitive
    (computeMaximumOfMagnitude, linear_impl.h:455-487)."""
    return min_max_magnitude(traj, derivative, n_grid)[1]


def get_segment_dimension(traj: Trajectory, dims: Sequence[int]) -> Trajectory:
    """Project a trajectory onto a subset of spatial dimensions
    (Trajectory::getTrajectoryWithSingleDimension analogue,
    trajectory.cpp:136-182)."""
    idx = jnp.asarray(list(dims))
    return Trajectory(coefficients=jnp.take(traj.coefficients, idx, axis=-1),
                      times=traj.times)


def append(a: Trajectory, b: Trajectory) -> Trajectory:
    """Concatenate two trajectories in time (trajectory.cpp:230-249)."""
    return Trajectory(
        coefficients=jnp.concatenate([a.coefficients, b.coefficients], axis=-3),
        times=jnp.concatenate([a.times, b.times], axis=-1))


def add_trajectories(trajectories: Sequence[Trajectory],
                     check_continuity: bool = True,
                     max_derivative: int = 0,
                     tolerance: float = 1e-6) -> Trajectory:
    """N-way time-concatenation (Trajectory::addTrajectories,
    trajectory.h:93-94, trajectory.cpp:230-249).

    The reference validates only D/N compatibility; ``check_continuity``
    additionally asserts each piece starts where the previous one ends
    (start/goal vertex equality up to ``max_derivative``, the check the
    reference's isEqualTol-based call sites imply).  Host-side builder API:
    the continuity check pulls values off device and raises ValueError on a
    gap, so call it OUTSIDE jit (inside jit, pass check_continuity=False).
    """
    if not trajectories:
        raise ValueError("Need at least one trajectory.")
    n = trajectories[0].n_coefficients
    d = trajectories[0].dimension
    for i, t in enumerate(trajectories[1:], start=1):
        if t.n_coefficients != n or t.dimension != d:
            raise ValueError(
                f"Trajectory {i} has (N={t.n_coefficients}, D={t.dimension})"
                f" != (N={n}, D={d}) of trajectory 0 (reference "
                "addTrajectories D/N check, trajectory.cpp:239-241).")
    if check_continuity:
        for i in range(len(trajectories) - 1):
            goal = np.asarray(get_vertex_at_time(
                trajectories[i], trajectories[i].max_time, max_derivative))
            start = np.asarray(get_vertex_at_time(
                trajectories[i + 1], 0.0, max_derivative))
            gap = np.max(np.abs(goal - start))
            if not np.all(np.isfinite(gap)) or gap > tolerance:
                raise ValueError(
                    f"Trajectory {i}'s goal vertex != trajectory {i + 1}'s "
                    f"start vertex (max gap {gap:.3e} > tol {tolerance:.1e} "
                    f"over derivatives 0..{max_derivative}).")
    merged = trajectories[0]
    for t in trajectories[1:]:
        merged = append(merged, t)
    return merged


def scale_trajectory_time(traj: Trajectory, factor) -> Trajectory:
    """Uniformly stretch the trajectory in time by ``factor`` (> 1 slows).

    Exact closed form: with s = 1/factor, coefficient i rescales by s^i so
    that x'(t) = x(s t); derivative d scales by s^d.  (The upstream
    project's scaleSegmentTimes intent -- this fork's inherited tests call
    it but the fork never implemented it; see SURVEY.md section 4.)"""
    factor = jnp.asarray(factor, traj.coefficients.dtype)
    n = traj.n_coefficients
    i = jnp.arange(n, dtype=traj.coefficients.dtype)
    scale = (1.0 / factor) ** i                            # (N,)
    return Trajectory(
        coefficients=traj.coefficients * scale[..., None, :, None],
        times=traj.times * factor)


def scale_times_to_limits(traj: Trajectory, v_max: float, a_max: float,
                          n_grid: int = roots.DEFAULT_GRID) -> Trajectory:
    """Smallest uniform time stretch making the trajectory satisfy v/a
    limits (scaleSegmentTimesWithViolation intent,
    test_polynomial_optimization.cpp:661): velocity scales by 1/factor and
    acceleration by 1/factor^2, so factor = max(1, vmax/v_max,
    sqrt(amax/a_max)) repairs both in closed form -- no iteration."""
    vmax = min_max_magnitude(traj, 1, n_grid)[1].value
    amax = min_max_magnitude(traj, 2, n_grid)[1].value
    factor = jnp.maximum(1.0, jnp.maximum(
        vmax / v_max, jnp.sqrt(jnp.maximum(amax / a_max, 0.0))))
    return scale_trajectory_time(traj, factor)


def append_dimension(a: Trajectory, b: Trajectory) -> Trajectory:
    """Stack two trajectories' spatial dimensions (same K and times):
    Trajectory::getTrajectoryWithAppendedDimension analogue
    (trajectory.cpp:156-182)."""
    return Trajectory(
        coefficients=jnp.concatenate([a.coefficients, b.coefficients],
                                     axis=-1),
        times=a.times)


def get_vertex_at_time(traj: Trajectory, t, max_derivative: int
                       ) -> jnp.ndarray:
    """States 0..max_derivative at global time t, as a (max_derivative+1, D)
    array (Trajectory::getVertexAtTime, trajectory.h:97): row d is the d-th
    derivative of position -- the constraint set of a Vertex pinned at t."""
    t_arr = jnp.asarray(t)
    # evaluate() promotes scalar t to (1,): rows land at axis -3 as (..., 1, D)
    out = jnp.stack([evaluate(traj, t_arr, d)
                     for d in range(max_derivative + 1)], axis=-3)
    if t_arr.ndim == 0:
        out = out[..., 0, :]       # drop the promoted time axis
    return out


def start_position(traj: Trajectory, derivative: int = 0) -> jnp.ndarray:
    """Trajectory start state (Trajectory::getStartVertex analogue)."""
    per_dim = jnp.moveaxis(traj.coefficients[..., 0, :, :], -1, -2)
    return basis.polyval(per_dim, jnp.zeros((), traj.coefficients.dtype),
                         derivative)


def goal_position(traj: Trajectory, derivative: int = 0) -> jnp.ndarray:
    """Trajectory goal state (Trajectory::getGoalVertex analogue)."""
    per_dim = jnp.moveaxis(traj.coefficients[..., -1, :, :], -1, -2)
    t_end = traj.times[..., -1]
    return basis.polyval(per_dim, t_end[..., None], derivative)
