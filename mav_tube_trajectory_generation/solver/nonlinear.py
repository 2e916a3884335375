"""Nonlinear trajectory refinement: batched, differentiable outer loop.

Re-designs the reference's ``PolynomialOptimizationNonLinear`` (NLOPT outer
loop, polynomial_optimization_nonlinear.h:239-674 + impl) as pure-function
cost terms over ``(d_free, segment_times)`` plus two batch-friendly optimizers:

  * L-BFGS (optax, zoom linesearch) for the smooth objectives -- where the
    reference needed hand-derived analytic gradients (J_d via R blocks,
    nonlinear_impl.h:1537-1606; J_c via eq. 14, :1608-1780) and central-
    difference numerics for everything else (:2365-2657), JAX autodiff
    differentiates every term, including *through the inner linear solve*
    (Cholesky), making even the segment-time gradient analytic.
  * A fixed-shape Nelder-Mead simplex for the gradient-free time-only
    objective, mirroring the reference's LN_SBPLX default
    (nonlinear.h:61,125) -- iteration counts are static, candidates are
    evaluated as one batched inner solve, and everything vmaps over
    scenarios.

Cost terms (weights per NonlinearOptimizationParameters::cost_weights,
nonlinear.h:161-169):
  J_d  derivative energy          (getCostAndGradientDerivative convention)
  J_t  (total time)^2 * penalty   (objectiveFunctionTime, :894-896)
  J_c  collision line integral    sum c(x(t)) ||v(t)|| dt (:1608-1780),
       sampled on a fixed per-segment grid against a dense ESDF
       (models.esdf) instead of octree traversal
  J_sc soft max-magnitude costs   min(max_cost, exp(rel_violation * w))
       over analytic extrema (:2735-2766), candidate times treated as
       constants under differentiation (implicit-function treatment).

Positivity of segment times is enforced by the log reparameterization
``times = t_init * exp(theta)`` instead of NLOPT box bounds; the time-only
path additionally clips to the reference's [0.1, 2 t_init] box
(optimizeTime, :342-378).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models import esdf as esdf_mod
from ..ops import basis, roots
from . import linear, qcqp
from .structure import ProblemStructure


class Objective(enum.Enum):
    """Mirrors NonlinearOptimizationParameters::OptimizationObjective
    (nonlinear.h:151-158)."""
    FREE_CONSTRAINTS = "free_constraints"
    FREE_CONSTRAINTS_AND_TIME = "free_constraints_and_time"
    TIME = "time"
    FREE_CONSTRAINTS_AND_COLLISION = "free_constraints_and_collision"
    FREE_CONSTRAINTS_AND_COLLISION_AND_TIME = (
        "free_constraints_and_collision_and_time")


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """cost_weights (nonlinear.h:161-169), reference defaults."""
    w_d: float = 0.1
    w_c: float = 10.0
    w_t: float = 1.0
    w_sc: float = 1.0


@dataclasses.dataclass(frozen=True)
class MagnitudeConstraint:
    """addMaximumMagnitudeConstraint input (nonlinear.h:270-271)."""
    derivative: int
    value: float


@dataclasses.dataclass(frozen=True)
class NonlinearParameters:
    """Static optimizer configuration (NonlinearOptimizationParameters,
    nonlinear.h:46-210; fields without a batched analogue -- NLOPT tolerances,
    numeric-gradient switches -- are intentionally absent because autodiff
    and fixed iteration counts subsume them)."""
    objective: Objective = Objective.FREE_CONSTRAINTS_AND_TIME
    max_iterations: int = 50
    time_penalty: float = 500.0
    use_soft_constraints: bool = True
    soft_constraint_weight: float = 100.0
    soft_constraint_max_cost: float = 1.0e12
    weights: CostWeights = CostWeights()
    epsilon: float = 0.5
    robot_radius: float = 0.5
    coll_pot_multiplier: float = 1.0
    collision_samples_per_segment: int = 32
    # Time-only path box (optimizeTime, nonlinear_impl.h:342-378).
    time_lower_bound: float = 0.1
    time_upper_factor: float = 2.0
    nelder_mead_scale: float = 0.15
    extrema_grid: int = 64
    # Hard max-magnitude constraints (use_soft_constraints=False +
    # constraints): augmented-Lagrangian rounds around L-BFGS -- the batched
    # analogue of the reference's NLOPT add_inequality_constraint path
    # (addMaximumMagnitudeConstraint, nonlinear_impl.h:848-875).  The
    # reference's inequality_constraint_tolerance default is 0.1
    # (nonlinear.h:57).
    inequality_constraint_tolerance: float = 0.1
    al_rounds: int = 4
    al_penalty: float = 10.0
    al_penalty_growth: float = 4.0
    # Relative cost-decrease tolerance (NLOPT ftol_rel; reference default
    # 0.05, nonlinear.h:51).  The batched build runs FIXED-length scans, so
    # f_rel does not truncate the loop; it defines the *effective*
    # convergence iteration and stopping reason reported in
    # NonlinearResult (OptimizationInfo::stopping_reason analogue).
    f_rel: float = 0.05
    # Hard box bounds on the free endpoint derivatives
    # (setFreeEndpointDerivativeHardConstraints, nonlinear_impl.h:2858-2905,
    # consumed at :461,552,781): each magnitude constraint boxes its
    # derivative's free columns to +-|value|; free POSITIONS are pinned
    # inside [min_bound, max_bound] (the map box, nonlinear.h min_bound/
    # max_bound params).  The reference feeds these to NLOPT's
    # set_lower/upper_bounds; the batched analogue is projected L-BFGS (clip
    # after every update).  min/max_bound default to the ESDF extent when a
    # collision field is given.
    use_hard_bounds: bool = True
    min_bound: Optional[Tuple[float, ...]] = None
    max_bound: Optional[Tuple[float, ...]] = None
    # L-BFGS linesearch ("zoom" | "backtracking" | "hybrid"; see
    # _lbfgs_minimize).  Backtracking stores the step-start gradient and
    # probes value-only: one reverse sweep through the inner solve per
    # step instead of one per probe -- the hot choice for gradient-
    # through-the-solve paths, but it plateaus ~2.5% above zoom's final
    # cost (measured, benchmarks/nonlinear_bench.py).  "hybrid" runs
    # backtracking for all but ``hybrid_zoom_iters`` iterations, then a
    # strong-Wolfe zoom endgame from the plateau -- backtracking's
    # throughput with zoom's final cost.
    lbfgs_linesearch: str = "zoom"
    # Zoom-endgame length for lbfgs_linesearch="hybrid".
    hybrid_zoom_iters: int = 4


class CostBreakdown(NamedTuple):
    total: jnp.ndarray
    trajectory: jnp.ndarray
    collision: jnp.ndarray
    time: jnp.ndarray
    soft_constraints: jnp.ndarray


# Stopping-reason codes (per-scenario; the NLOPT return-code analogue,
# nlopt_impl.h return strings at nonlinear_impl.h:3009-3036).
STOP_MAX_ITERATIONS = 0   # ran the full fixed-length scan, still improving
STOP_FTOL_REACHED = 1     # relative cost decrease fell below f_rel

STOPPING_REASON_STRINGS = {
    STOP_MAX_ITERATIONS: "MAXEVAL_REACHED",
    STOP_FTOL_REACHED: "FTOL_REACHED",
}


def effective_iterations(cost_history: jnp.ndarray, f_rel: float,
                         round_length: int = 0):
    """(n_iterations, stopping_reason) from a per-iteration cost trace.

    The reference's NLOPT loop stops at the first iteration whose relative
    cost decrease is below ftol_rel and records the count in
    OptimizationInfo::n_iterations (nonlinear.h:212-231); the batched build
    runs fixed-length scans, so the equivalent is derived from the cost
    trace: the first step i with |c_i - c_{i-1}| <= f_rel * |c_i| (else the
    scan length).  Batched: cost_history (..., T) -> ((...,), (...,)) int32.

    ``round_length``: for augmented-Lagrangian traces that concatenate one
    fixed-length history per penalty round, the objective is DISCONTINUOUS
    at round boundaries (mu grows al_penalty_growth-fold), so the step
    crossing each boundary is excluded from the FTOL detection -- it would
    otherwise fire on (or be masked by) the boundary jump rather than
    actual convergence.  0 = single continuous trace.
    """
    c = cost_history
    t = c.shape[-1]
    prev, cur = c[..., :-1], c[..., 1:]
    small = jnp.abs(prev - cur) <= f_rel * jnp.maximum(
        jnp.abs(cur), jnp.asarray(1e-30, c.dtype))
    if round_length:
        # Pair j compares c[j] -> c[j+1]; boundary pairs have j+1 a round
        # start (j + 1 ≡ 0 mod round_length).
        j1 = np.arange(1, t)
        small = jnp.where(jnp.asarray((j1 % round_length) != 0), small,
                          False)
    any_small = jnp.any(small, axis=-1)
    first = jnp.argmax(small, axis=-1).astype(jnp.int32) + 1
    n_it = jnp.where(any_small, first, jnp.int32(t))
    reason = jnp.where(any_small, jnp.int32(STOP_FTOL_REACHED),
                       jnp.int32(STOP_MAX_ITERATIONS))
    return n_it, reason


class NonlinearResult(NamedTuple):
    """OptimizationInfo analogue (nonlinear.h:212-231) + the solution.

    ``maxima`` maps constraint derivative order -> final max magnitude
    (OptimizationInfo::maxima, nonlinear.h:230).  ``cost_history`` is the
    per-outer-iteration objective value (the reference retains every NLOPT
    iterate in ``all_trajectories_``, nonlinear.h:316-328; the cost trace is
    the batch-friendly equivalent -- recover any iterate's trajectory by
    re-solving at its times).  ``n_iterations`` is the EFFECTIVE convergence
    iteration derived from the trace (see ``effective_iterations``);
    ``stopping_reason`` the matching code (STOPPING_REASON_STRINGS)."""
    coefficients: jnp.ndarray
    times: jnp.ndarray
    d_fixed: jnp.ndarray
    d_free: jnp.ndarray
    cost: CostBreakdown
    initial_cost: CostBreakdown
    n_iterations: jnp.ndarray
    maxima: dict
    cost_history: Optional[jnp.ndarray] = None
    stopping_reason: Optional[jnp.ndarray] = None


def format_result(res: "NonlinearResult") -> str:
    """Printable report (OptimizationInfo::print, nonlinear_impl.h:29-47)."""
    c, c0 = res.cost, res.initial_cost
    reason = ""
    if res.stopping_reason is not None:
        reason = " (" + STOPPING_REASON_STRINGS.get(
            int(res.stopping_reason), "?") + ")"
    lines = ["Optimization info:",
             f"  iterations: {int(res.n_iterations)}{reason}",
             f"  total cost:            {float(c0.total):.6g} -> "
             f"{float(c.total):.6g}",
             f"  cost trajectory (J_d): {float(c.trajectory):.6g}",
             f"  cost collision (J_c):  {float(c.collision):.6g}",
             f"  cost time (J_t):       {float(c.time):.6g}",
             f"  cost soft constraints: {float(c.soft_constraints):.6g}",
             f"  total time:            {float(jnp.sum(res.times)):.6g}"]
    for deriv, value in sorted(res.maxima.items()):
        lines.append(f"  max magnitude (deriv {deriv}): {float(value):.6g}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cost terms.
# ---------------------------------------------------------------------------

def derivative_cost(structure: ProblemStructure, d_fixed, d_free, times):
    """J_d = d^T R d (reference convention: 2x the 0.5 c^T Q c energy)."""
    cost, _ = linear.derivative_cost_and_grad(structure, d_fixed, d_free,
                                              times)
    return cost


def time_cost(times, time_penalty: float):
    """J_t = (sum T)^2 * penalty (objectiveFunctionTime, impl:894-896)."""
    total = jnp.sum(times, axis=-1)
    return total * total * time_penalty


def _sample_segments(structure: ProblemStructure, d_fixed, d_free, times,
                     n_samples: int, derivative_max: int = 1):
    """Positions and velocities on a fixed midpoint grid per segment.

    Returns (pos (K, S, D), vel (K, S, D), dt (K,)).
    """
    d_seg = linear.segment_derivatives(structure, d_fixed, d_free)
    from ..ops import qmatrix
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    tau = (jnp.arange(n_samples, dtype=times.dtype) + 0.5) / n_samples
    t_local = times[..., None] * tau                         # (K, S)
    per_dim = jnp.moveaxis(coeffs, -1, -3)                   # (D, K, N)
    pos = basis.polyval(per_dim[..., None, :], t_local[None], 0)
    vel = basis.polyval(per_dim[..., None, :], t_local[None], 1)
    pos = jnp.moveaxis(pos, 0, -1)                           # (K, S, D)
    vel = jnp.moveaxis(vel, 0, -1)
    return pos, vel, times / n_samples


def collision_cost(structure: ProblemStructure, d_fixed, d_free, times,
                   field: esdf_mod.Esdf, params: NonlinearParameters):
    """J_c = sum_i sum_t c(x(t)) ||v(t)|| dt  (getCostAndGradientCollision,
    impl:1608-1780), with the reference's distance-triggered sampling
    replaced by a fixed midpoint rule (static shapes, exact autodiff)."""
    pos, vel, dt = _sample_segments(
        structure, d_fixed, d_free, times,
        params.collision_samples_per_segment)
    dist = esdf_mod.distance_at(field, pos)
    c = esdf_mod.collision_potential(dist, params.epsilon, params.robot_radius,
                                     params.coll_pot_multiplier)
    # Safe speed: sqrt gradient at ||v|| = 0 would be NaN (the reference
    # simply drops those samples' gradients, impl:1737-1745).
    sq = jnp.sum(vel ** 2, axis=-1)
    speed = jnp.sqrt(jnp.where(sq > 0, sq, 1.0))
    speed = jnp.where(sq > 0, speed, 0.0)
    return jnp.sum(c * speed * dt[..., None], axis=(-2, -1))


def max_magnitude_from_d(structure: ProblemStructure, d_fixed, d_free, times,
                         derivative: int, n_grid: int = 64):
    """Differentiable global max of ||x^(der)||: analytic candidate times
    (held constant under AD) + evaluation (computeMaximumOfMagnitude,
    linear_impl.h:455-487)."""
    d_seg = linear.segment_derivatives(structure, d_fixed, d_free)
    from ..ops import qmatrix
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    zeros = jnp.zeros_like(times)
    cand_t, valid = roots.magnitude_minmax_candidates(
        coeffs, derivative, zeros, times, n_grid=n_grid, n_bisections=40)
    cand_t = jax.lax.stop_gradient(cand_t)
    per_dim = jnp.moveaxis(coeffs, -1, -3)                   # (D, K, N)
    vals = basis.polyval(per_dim[..., None, :], cand_t[None], derivative)
    sq = jnp.sum(jnp.moveaxis(vals, 0, -1) ** 2, axis=-1)    # (K, C)
    # Double-where so masked/zero candidates cannot poison the sqrt gradient.
    sq_safe = jnp.where(valid & (sq > 0), sq, 1.0)
    mag = jnp.where(valid & (sq > 0), jnp.sqrt(sq_safe), 0.0)
    return jnp.max(mag, axis=(-2, -1))


def soft_constraint_cost(structure: ProblemStructure, d_fixed, d_free, times,
                         constraints: Sequence[MagnitudeConstraint],
                         params: NonlinearParameters):
    """J_sc = sum min(max_cost, exp(rel_violation * weight))
    (evaluateMaximumMagnitudeAsSoftConstraint, impl:2735-2766)."""
    if not constraints:
        return jnp.zeros(jnp.shape(times)[:-1], dtype=times.dtype)
    cost = jnp.zeros(jnp.shape(times)[:-1], dtype=times.dtype)
    for c in constraints:
        mx = max_magnitude_from_d(structure, d_fixed, d_free, times,
                                  c.derivative, params.extrema_grid)
        rel = (mx - c.value) / c.value
        # min(max_cost, exp(.)) computed in log space so the exp cannot
        # overflow before the clamp.
        log_cap = jnp.log(jnp.asarray(params.soft_constraint_max_cost,
                                      times.dtype))
        cost = cost + jnp.exp(jnp.minimum(
            rel * params.soft_constraint_weight, log_cap))
    return cost


def total_cost(structure: ProblemStructure, d_fixed, d_free, times,
               params: NonlinearParameters,
               constraints: Sequence[MagnitudeConstraint] = (),
               field: Optional[esdf_mod.Esdf] = None,
               include_derivative_weight: bool = True) -> CostBreakdown:
    """Weighted objective used by the FREE_CONSTRAINTS* objectives."""
    w = params.weights
    j_d = derivative_cost(structure, d_fixed, d_free, times)
    j_t = time_cost(times, params.time_penalty)
    zero = jnp.zeros_like(j_d)
    j_c = (collision_cost(structure, d_fixed, d_free, times, field, params)
           if field is not None else zero)
    j_sc = (soft_constraint_cost(structure, d_fixed, d_free, times,
                                 constraints, params)
            if params.use_soft_constraints and constraints else zero)
    w_d = w.w_d if include_derivative_weight else 1.0
    obj = params.objective
    use_time = obj in (Objective.FREE_CONSTRAINTS_AND_TIME,
                       Objective.TIME,
                       Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME)
    use_coll = field is not None and obj in (
        Objective.TIME,
        Objective.FREE_CONSTRAINTS_AND_COLLISION,
        Objective.FREE_CONSTRAINTS_AND_COLLISION_AND_TIME)
    total = (w_d * j_d
             + (w.w_t * j_t if use_time else zero)
             + (w.w_c * j_c if use_coll else zero)
             + (w.w_sc * j_sc))
    return CostBreakdown(total=total, trajectory=j_d, collision=j_c,
                         time=j_t, soft_constraints=j_sc)


def map_bounds(field: esdf_mod.Esdf) -> Tuple[np.ndarray, np.ndarray]:
    """(min_bound, max_bound) spanned by an ESDF's voxel centers -- the
    default map box when NonlinearParameters does not pin one explicitly."""
    shape = np.asarray(field.distance.shape, np.float64)
    origin = np.asarray(field.origin, np.float64)
    res = float(field.resolution)
    return origin, origin + (shape - 1.0) * res


def free_derivative_bounds(structure: ProblemStructure,
                           constraints: Sequence[MagnitudeConstraint] = (),
                           min_bound=None, max_bound=None,
                           dtype=jnp.float32):
    """Per-free-column box bounds (lo, hi), each (n_free, D).

    Reference semantics (setFreeEndpointDerivativeHardConstraints,
    nonlinear_impl.h:2858-2905): every bound starts at +-inf; each magnitude
    constraint boxes its derivative order's free columns to +-|value|; when
    positions are free (the QCQP pattern), the position columns are pinned to
    the map box [min_bound, max_bound] per spatial dimension.
    """
    n_free, dim = structure.n_free, structure.dimension
    lo = np.full((n_free, dim), -np.inf)
    hi = np.full((n_free, dim), np.inf)
    derivs = structure.free_cols[:, 1]
    for c in constraints:
        rows = derivs == c.derivative
        lo[rows] = -abs(c.value)
        hi[rows] = abs(c.value)
    if min_bound is not None or max_bound is not None:
        rows = derivs == 0
        if min_bound is not None:
            lo[rows] = np.broadcast_to(np.asarray(min_bound, np.float64),
                                       (dim,))
        if max_bound is not None:
            hi[rows] = np.broadcast_to(np.asarray(max_bound, np.float64),
                                       (dim,))
    return jnp.asarray(lo, dtype), jnp.asarray(hi, dtype)


def _resolve_bounds(structure: ProblemStructure,
                    params: NonlinearParameters,
                    constraints: Sequence[MagnitudeConstraint],
                    field: Optional[esdf_mod.Esdf],
                    dtype):
    """The (lo, hi) box for this optimize() call, or None when every bound
    would be infinite (no constraints, no map)."""
    if not params.use_hard_bounds:
        return None
    mn, mx = params.min_bound, params.max_bound
    if mn is None and mx is None and field is not None:
        mn, mx = map_bounds(field)
    if not constraints and mn is None and mx is None:
        return None
    return free_derivative_bounds(structure, constraints, mn, mx, dtype)


# ---------------------------------------------------------------------------
# Optimizers.
# ---------------------------------------------------------------------------

def _lbfgs_minimize(fn, x0, n_iters: int, project=None,
                    linesearch: str = "zoom", hybrid_zoom_iters: int = 4):
    """Fixed-iteration L-BFGS over a pytree.

    ``project`` (optional) maps the iterate back onto a feasible box after
    every update -- projected L-BFGS, the batched analogue of NLOPT's
    set_lower/upper_bounds box handling (the iterate, and therefore every
    subsequent linesearch probe, stays inside the box).

    ``linesearch``: "zoom" (strong-Wolfe; several value+GRADIENT probes
    per step -- each probe differentiates through the inner solve),
    "backtracking" (Armijo with the step-start gradient stored: ONE
    reverse sweep per step, probes are value-only forward solves --
    measured ~3x cheaper per step on the gradient-through-the-solve path
    but plateauing ~2.5% above zoom's final cost), or "hybrid"
    (backtracking for ``n_iters - hybrid_zoom_iters`` steps, then a
    strong-Wolfe zoom endgame from the plateau with fresh L-BFGS memory:
    Armijo-only steps violate the curvature condition, so the memory that
    produced the plateau is the wrong Hessian model to escape it --
    benchmarks/nonlinear_bench.py)."""

    def run(opt, x_init, length):
        value_and_grad = optax.value_and_grad_from_state(fn)

        def step(carry, _):
            params, state = carry
            value, grad = value_and_grad(params, state=state)
            updates, state = opt.update(grad, state, params, value=value,
                                        grad=grad, value_fn=fn)
            params = optax.apply_updates(params, updates)
            if project is not None:
                params = project(params)
            return (params, state), value

        (x_fin, _), values = jax.lax.scan(step, (x_init, opt.init(x_init)),
                                          None, length=length)
        return x_fin, values

    def backtracking_opt():
        # scale_by_lbfgs emits the +H g (ascent-sign) direction -- the zoom
        # linesearch negates internally, backtracking does not (verified on
        # a quadratic: without scale(-1) the chain ASCENDS).
        ls = optax.scale_by_backtracking_linesearch(
            max_backtracking_steps=12, store_grad=True)
        return optax.chain(optax.scale_by_lbfgs(), optax.scale(-1.0), ls)

    x0 = x0 if project is None else project(x0)
    if linesearch == "backtracking":
        return run(backtracking_opt(), x0, n_iters)
    if linesearch == "hybrid":
        n_zoom = min(hybrid_zoom_iters, n_iters)
        n_bt = n_iters - n_zoom
        if n_bt == 0:
            return run(optax.lbfgs(), x0, n_iters)
        x_mid, v_bt = run(backtracking_opt(), x0, n_bt)
        x_fin, v_zoom = run(optax.lbfgs(), x_mid, n_zoom)
        return x_fin, jnp.concatenate([v_bt, v_zoom], axis=0)
    return run(optax.lbfgs(), x0, n_iters)


def nelder_mead(fn, x0, n_iters: int, scale: float):
    """Fixed-shape Nelder-Mead over x (..., n): the gradient-free path for
    the TIME objective (the reference CHECKs that no gradient is requested,
    impl:881-882).  All four trial points are evaluated per iteration as one
    batched call; under vmap a branchy NM would evaluate them anyway."""
    n = x0.shape[-1]
    pts = jnp.concatenate(
        [x0[None], x0[None] + scale * jnp.eye(n, dtype=x0.dtype)], axis=0)
    fvals = jax.vmap(fn)(pts)

    def step(carry, _):
        pts, fvals = carry
        order = jnp.argsort(fvals)
        pts = pts[order]
        fvals = fvals[order]
        best, worst = pts[0], pts[-1]
        centroid = jnp.mean(pts[:-1], axis=0)
        xr = centroid + 1.0 * (centroid - worst)
        xe = centroid + 2.0 * (centroid - worst)
        xoc = centroid + 0.5 * (centroid - worst)
        xic = centroid - 0.5 * (centroid - worst)
        cands = jnp.stack([xr, xe, xoc, xic])
        fr, fe, foc, fic = jax.vmap(fn)(cands)

        f_best, f_second, f_worst = fvals[0], fvals[-2], fvals[-1]
        # Standard NM acceptance, expressed with selects.
        use_expand = (fr < f_best) & (fe < fr)
        use_reflect = (fr < f_second) & ~use_expand
        use_oc = (fr >= f_second) & (fr < f_worst) & (foc <= fr)
        use_ic = (fr >= f_worst) & (fic < f_worst)
        accepted = use_expand | use_reflect | use_oc | use_ic
        new_pt = jnp.where(use_expand, xe,
                  jnp.where(use_reflect, xr,
                   jnp.where(use_oc, xoc,
                    jnp.where(use_ic, xic, worst))))
        new_f = jnp.where(use_expand, fe,
                 jnp.where(use_reflect, fr,
                  jnp.where(use_oc, foc,
                   jnp.where(use_ic, fic, f_worst))))
        # No candidate accepted -> pull the worst point toward the best
        # (single-point shrink; keeps evaluation count fixed).
        shrink_pt = best + 0.5 * (worst - best)
        f_shrink = fn(shrink_pt)
        new_pt = jnp.where(accepted, new_pt, shrink_pt)
        new_f = jnp.where(accepted, new_f, f_shrink)
        pts = pts.at[-1].set(new_pt)
        fvals = fvals.at[-1].set(new_f)
        return (pts, fvals), jnp.min(fvals)

    (pts, fvals), history = jax.lax.scan(step, (pts, fvals), None,
                                         length=n_iters)
    ibest = jnp.argmin(fvals)
    return pts[ibest], fvals[ibest], history


# ---------------------------------------------------------------------------
# Top-level optimize().
# ---------------------------------------------------------------------------

@linear.full_matmul_precision
def optimize(structure: ProblemStructure,
             d_fixed: jnp.ndarray,
             times_init: jnp.ndarray,
             params: NonlinearParameters,
             constraints: Sequence[MagnitudeConstraint] = (),
             field: Optional[esdf_mod.Esdf] = None,
             waypoints: Optional[jnp.ndarray] = None,
             radii: Optional[jnp.ndarray] = None,
             admm_config: qcqp.ADMMConfig = qcqp.ADMMConfig(),
             d_free_init: Optional[jnp.ndarray] = None) -> NonlinearResult:
    """Run the configured nonlinear objective (reference optimize(),
    nonlinear_impl.h:275-331).

    For the TIME objective the inner problem is re-solved per evaluation
    (QCQP when ``radii`` given, else the linear QP -- stack 3.4 of
    SURVEY.md); the *_TIME smooth objectives optimize log-time scalings
    jointly with d_free via L-BFGS.
    """
    dtype = jnp.result_type(d_fixed, times_init)
    d_fixed = jnp.asarray(d_fixed, dtype)
    times_init = jnp.asarray(times_init, dtype)

    def inner_solve(times):
        if radii is not None:
            return qcqp.solve_qcqp(structure, d_fixed, times, waypoints,
                                   radii, config=admm_config)
        return linear.solve_linear(structure, d_fixed, times)

    if d_free_init is None:
        d_free_init = inner_solve(times_init).d_free

    breakdown0 = total_cost(structure, d_fixed, d_free_init, times_init,
                            params, constraints, field)

    # Hard box bounds on d_free (nonlinear_impl.h:2858-2905, consumed by all
    # FREE_CONSTRAINTS* objectives at :461,552,781): projected L-BFGS.
    bounds = _resolve_bounds(structure, params, constraints, field, dtype)
    project_d = (None if bounds is None
                 else (lambda d: jnp.clip(d, bounds[0], bounds[1])))

    obj = params.objective
    ftol_round_length = 0     # AL path overrides (per-round FTOL masking)
    if obj == Objective.TIME:
        t_lo = jnp.asarray(params.time_lower_bound, dtype)
        t_hi = params.time_upper_factor * times_init

        def clip_times(theta):
            return jnp.clip(times_init * jnp.exp(theta), t_lo, t_hi)

        def fn(theta):
            times = clip_times(theta)
            sol = inner_solve(times)
            # objectiveFunctionTime composition (impl:894-944): J_traj is
            # the 0.5 c^T Q c cost, plus time/collision/soft terms.
            cost = sol.cost + time_cost(times, params.time_penalty)
            if field is not None:
                cost = cost + params.weights.w_c * collision_cost(
                    structure, d_fixed, sol.d_free, times, field, params)
            if params.use_soft_constraints and constraints:
                cost = cost + soft_constraint_cost(
                    structure, d_fixed, sol.d_free, times, constraints,
                    params)
            # Physical guard: derivative energy >= 0; negative/non-finite
            # means the float32 solve overflowed near the 0.1 s box edge
            # (T^(1-2d) spans ~17 decades) -- repel the simplex from it.
            return jnp.where(jnp.isfinite(cost) & (sol.cost >= 0.0), cost,
                             jnp.asarray(jnp.inf, cost.dtype))

        theta0 = jnp.zeros_like(times_init)
        theta, _, history = nelder_mead(fn, theta0, params.max_iterations,
                                  params.nelder_mead_scale)
        times_fin = clip_times(theta)
        sol = inner_solve(times_fin)
        d_free_fin = sol.d_free
    elif obj in (Objective.FREE_CONSTRAINTS,
                 Objective.FREE_CONSTRAINTS_AND_COLLISION):
        hard = constraints and not params.use_soft_constraints

        if hard:
            # Augmented Lagrangian over the hard max-magnitude inequalities
            # g_c = max||x^(der)|| - value <= 0 (the reference's NLOPT
            # add_inequality_constraint path, impl:848-875, 2686-2733):
            # minimize f + sum_c [ lam_c g_c + 0.5 mu relu(g_c + lam_c/mu)^2 ]
            # with multiplier updates lam <- relu(lam + mu g) per round.
            n_c = len(constraints)
            inner_iters = max(params.max_iterations // params.al_rounds, 1)
            ftol_round_length = inner_iters

            def g_of(d_free):
                return jnp.stack([
                    max_magnitude_from_d(structure, d_fixed, d_free,
                                         times_init, c.derivative,
                                         params.extrema_grid) - c.value
                    for c in constraints])

            def al_cost(d_free, lam, mu):
                base = total_cost(structure, d_fixed, d_free, times_init,
                                  params, (), field).total
                g = g_of(d_free)
                shifted = jnp.maximum(g + lam / mu, 0.0)
                return base + jnp.sum(0.5 * mu * shifted * shifted
                                      - 0.5 * lam * lam / mu)

            d_free_fin = d_free_init
            histories = []
            lam = jnp.zeros((n_c,), dtype)
            mu = jnp.asarray(params.al_penalty, dtype)
            for _ in range(params.al_rounds):
                d_free_fin, vals = _lbfgs_minimize(
                    lambda d: al_cost(d, lam, mu), d_free_fin, inner_iters,
                    project=project_d)
                histories.append(vals)
                lam = jnp.maximum(lam + mu * g_of(d_free_fin), 0.0)
                mu = mu * params.al_penalty_growth
            history = jnp.concatenate(histories)
        else:
            def fn(d_free):
                return total_cost(structure, d_fixed, d_free, times_init,
                                  params, constraints, field).total
            d_free_fin, history = _lbfgs_minimize(fn, d_free_init,
                                                  params.max_iterations,
                                                  project=project_d)
        times_fin = times_init
    else:  # joint (d_free, theta) objectives
        # Bound the log-time scaling to the reference's spirit of
        # [0.1, 2 t_init] box bounds (optimizeTime, impl:342-378): an
        # unbounded linesearch step in theta would overflow T^(2N-1) powers.
        theta_cap = jnp.asarray(np.log(params.time_upper_factor),
                                dtype)

        def scale_times(theta):
            return times_init * jnp.exp(jnp.clip(theta, -theta_cap,
                                                 theta_cap))

        def fn(xs):
            d_free, theta = xs
            times = scale_times(theta)
            return total_cost(structure, d_fixed, d_free, times, params,
                              constraints, field).total
        project_joint = (None if project_d is None
                         else (lambda xs: (project_d(xs[0]), xs[1])))
        (d_free_fin, theta_fin), history = _lbfgs_minimize(
            fn, (d_free_init, jnp.zeros_like(times_init)),
            params.max_iterations, project=project_joint)
        times_fin = scale_times(theta_fin)

    sol = linear.solve_linear_with_free(structure, d_fixed, d_free_fin,
                                        times_fin)
    breakdown = total_cost(structure, d_fixed, d_free_fin, times_fin, params,
                           constraints, field)
    maxima = {c.derivative: max_magnitude_from_d(
        structure, d_fixed, d_free_fin, times_fin, c.derivative,
        params.extrema_grid) for c in constraints}
    n_eff, stop_reason = effective_iterations(
        history, params.f_rel, round_length=ftol_round_length)
    return NonlinearResult(
        coefficients=sol.coefficients, times=times_fin, d_fixed=d_fixed,
        d_free=d_free_fin, cost=breakdown, initial_cost=breakdown0,
        n_iterations=n_eff, maxima=maxima,
        cost_history=history, stopping_reason=stop_reason)


@linear.full_matmul_precision
def optimize_time_gradient(structure: ProblemStructure,
                           d_fixed: jnp.ndarray,
                           times_init: jnp.ndarray,
                           params: NonlinearParameters,
                           n_iters: Optional[int] = None):
    """Gradient-based segment-time optimization THROUGH the inner solve.

    The reference insists time gradients are unavailable (nonlinear.h:396-402)
    and falls back to 2K-per-iteration finite differencing
    (getCostAndGradientTime, impl:2495-2584); with JAX the inner Cholesky
    solve is differentiable, so d(cost)/d(times) is a single reverse-mode
    sweep.  Returns (times, cost_history)."""
    dtype = jnp.result_type(d_fixed, times_init)
    times_init = jnp.asarray(times_init, dtype)

    # Bound the log scaling to the reference's time box [t_lo, f_up * t_init]
    # (optimizeTime, impl:342-378): an unbounded linesearch step overflows
    # T^(2N-1) powers in float32 (observed: cost diverging to large
    # negatives after ~30 iterations).
    theta_lo = jnp.log(jnp.asarray(params.time_lower_bound, dtype)
                       / times_init)
    theta_hi = jnp.asarray(np.log(params.time_upper_factor), dtype)

    def fn(theta):
        times = times_init * jnp.exp(jnp.clip(theta, theta_lo, theta_hi))
        sol = linear.solve_linear(structure, jnp.asarray(d_fixed, dtype),
                                  times)
        cost = sol.cost + time_cost(times, params.time_penalty)
        # Physical guard: the derivative energy is >= 0 by construction; a
        # negative or non-finite value means the float32 solve overflowed
        # (T^(1-2d) spans ~17 decades near the reference's 0.1 s box edge,
        # fine in the reference's doubles, fatal in f32).  Return +inf so
        # the linesearch backs off instead of diving into garbage.
        return jnp.where(jnp.isfinite(cost) & (sol.cost >= 0.0), cost,
                         jnp.asarray(jnp.inf, cost.dtype))

    # Normalize by the initial cost so the first L-BFGS direction (raw
    # steepest descent) is O(1) regardless of the ~1e5-scale objective --
    # without this the backtracking linesearch's geometric backoff cannot
    # recover the step scale (zoom interpolates, so it only benefits).
    c0 = jax.lax.stop_gradient(fn(jnp.zeros_like(times_init)))
    c0 = jnp.where(jnp.isfinite(c0) & (c0 > 0), c0,
                   jnp.ones_like(c0))
    theta, values = _lbfgs_minimize(
        lambda th: fn(th) / c0, jnp.zeros_like(times_init),
        params.max_iterations if n_iters is None else n_iters,
        project=lambda th: jnp.clip(th, theta_lo, theta_hi),
        linesearch=params.lbfgs_linesearch,
        hybrid_zoom_iters=params.hybrid_zoom_iters)
    theta = jnp.clip(theta, theta_lo, theta_hi)
    return times_init * jnp.exp(theta), values * c0
