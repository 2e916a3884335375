"""Batched real-root finding and interval extrema (rpoly replacement).

The reference finds derivative extrema with the Jenkins-Traub rpoly solver
(/root/reference/src/rpoly/rpoly_ak1.cpp, TOMS/493) -- an inherently scalar,
branch-heavy algorithm that is hostile to batched execution, and the obvious
batched alternative (companion-matrix eigensolve) is unavailable on
accelerators because XLA lowers nonsymmetric eigendecomposition only on
the CPU.

Batched design used here: we only ever need **real roots inside a known
interval [t0, t1]** (extrema candidates, polynomial.cpp:102-114).  Those are
found with a fixed-shape two-phase scheme that vmaps perfectly:

  1. evaluate the polynomial on a static grid over [t0, t1] (one fused Horner
     sweep),
  2. bracket sign changes and polish each bracket with a fixed-iteration
     bisection (binary search -> ~1 ulp of interval width in 50 iterations).

Strict extrema of a function can only occur where its derivative *crosses*
zero, so sign-change bracketing loses nothing for min/max computation:
tangential (even-multiplicity) roots are horizontal inflections whose value
is dominated by neighboring candidates or the interval endpoints, which are
always included (polynomial.cpp:43-45).

A companion-matrix path (``roots_companion``) is provided for CPU test
oracles and cross-checking.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .basis import polyval, derivative_coefficients, convolve_full

# Grid fine enough that two real roots of a degree<=21 polynomial falling in
# the same cell (and thus being missed) requires pathological clustering.
DEFAULT_GRID = 256
DEFAULT_BISECTIONS = 52


def _polyval_raw(coeffs: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Horner evaluation of raw coefficients (no derivative table)."""
    n = coeffs.shape[-1]
    acc = coeffs[..., n - 1]
    for j in range(n - 2, -1, -1):
        acc = acc * t + coeffs[..., j]
    return acc


class IntervalRoots(NamedTuple):
    roots: jnp.ndarray   # (..., max_roots) root locations (t0 where invalid)
    valid: jnp.ndarray   # (..., max_roots) bool


def roots_in_interval(coeffs: jnp.ndarray,
                      t0: jnp.ndarray,
                      t1: jnp.ndarray,
                      n_grid: int = DEFAULT_GRID,
                      n_bisections: int = DEFAULT_BISECTIONS) -> IntervalRoots:
    """All sign-crossing real roots of ``coeffs`` in [t0, t1], fixed shape.

    Args:
      coeffs: (..., L) increasing-power coefficients.
      t0, t1: scalars or arrays broadcastable to the batch shape.
      n_grid: static number of grid cells for bracketing.
      n_bisections: static bisection iterations per bracket.

    Returns:
      IntervalRoots with ``max_roots = L - 1`` slots (the max number of real
      roots of a degree L-1 polynomial).
    """
    coeffs = jnp.asarray(coeffs)
    ell = coeffs.shape[-1]
    max_roots = max(ell - 1, 1)
    t0 = jnp.asarray(t0, dtype=coeffs.dtype)
    t1 = jnp.asarray(t1, dtype=coeffs.dtype)
    batch = jnp.broadcast_shapes(coeffs.shape[:-1], t0.shape, t1.shape)
    t0 = jnp.broadcast_to(t0, batch)
    t1 = jnp.broadcast_to(t1, batch)

    # Phase 1: grid sweep.  tau in [0, 1] to keep the grid static.
    tau = jnp.linspace(0.0, 1.0, n_grid + 1, dtype=coeffs.dtype)
    tgrid = t0[..., None] + (t1 - t0)[..., None] * tau          # (..., G+1)
    vals = _polyval_raw(coeffs[..., None, :], tgrid)            # (..., G+1)

    lo_vals = vals[..., :-1]
    hi_vals = vals[..., 1:]
    crossing = (jnp.sign(lo_vals) * jnp.sign(hi_vals)) < 0
    exact_zero = (lo_vals == 0)
    bracket = crossing | exact_zero                              # (..., G)

    # Select up to max_roots bracket cells, in ascending-t order, fixed shape:
    # sort key puts bracketed cells first while preserving cell order.
    cell_idx = jnp.arange(n_grid)
    key = jnp.where(bracket, cell_idx, n_grid + cell_idx)
    order = jnp.argsort(key, axis=-1)[..., :max_roots]           # (..., R)
    valid = jnp.take_along_axis(bracket, order, axis=-1)

    cell_w = (t1 - t0)[..., None] / n_grid
    lo = t0[..., None] + order.astype(coeffs.dtype) * cell_w     # (..., R)
    hi = lo + cell_w
    flo = jnp.take_along_axis(lo_vals, order, axis=-1)

    # Phase 2: fixed-iteration bisection on each bracket (vectorized).
    def body(_, state):
        lo, hi, flo = state
        mid = 0.5 * (lo + hi)
        fmid = _polyval_raw(coeffs[..., None, :], mid)
        go_right = jnp.sign(fmid) == jnp.sign(flo)
        new_lo = jnp.where(go_right, mid, lo)
        new_hi = jnp.where(go_right, hi, mid)
        new_flo = jnp.where(go_right, fmid, flo)
        return new_lo, new_hi, new_flo

    lo, hi, _ = jax.lax.fori_loop(0, n_bisections, body, (lo, hi, flo))
    roots = 0.5 * (lo + hi)
    roots = jnp.where(valid, roots, t0[..., None])
    return IntervalRoots(roots=roots, valid=valid)


def roots_companion(coeffs: np.ndarray) -> np.ndarray:
    """All complex roots via the companion matrix (CPU-only test oracle).

    Host/NumPy implementation; trims trailing (high-order) zero coefficients
    like the reference's findLastNonZeroCoeff (rpoly_ak1.cpp:70-117).
    """
    c = np.asarray(coeffs, dtype=np.float64)
    nz = np.flatnonzero(np.abs(c) > 0)
    if nz.size == 0 or nz[-1] == 0:
        return np.zeros((0,), dtype=np.complex128)
    c = c[: nz[-1] + 1]
    deg = len(c) - 1
    comp = np.zeros((deg, deg))
    comp[1:, :-1] = np.eye(deg - 1)
    comp[:, -1] = -c[:-1] / c[-1]
    return np.linalg.eigvals(comp)


class IntervalMinMax(NamedTuple):
    t_min: jnp.ndarray
    v_min: jnp.ndarray
    t_max: jnp.ndarray
    v_max: jnp.ndarray


def minmax_in_interval(coeffs: jnp.ndarray,
                       t0, t1,
                       derivative: int = 0,
                       n_grid: int = DEFAULT_GRID,
                       n_bisections: int = DEFAULT_BISECTIONS) -> IntervalMinMax:
    """Min/max of the ``derivative``-th derivative over [t0, t1].

    Candidates = interval endpoints + real roots of the (derivative+1)-th
    derivative, exactly as Polynomial::computeMinMax (polynomial.cpp:102-114).
    """
    coeffs = jnp.asarray(coeffs)
    dcoeffs = derivative_coefficients(coeffs, derivative + 1)
    # Drop the known-zero tail so root count stays tight.
    n = coeffs.shape[-1]
    dcoeffs = dcoeffs[..., : max(n - derivative - 1, 1)]
    r = roots_in_interval(dcoeffs, t0, t1, n_grid, n_bisections)

    t0b = jnp.broadcast_to(jnp.asarray(t0, coeffs.dtype), r.roots.shape[:-1])
    t1b = jnp.broadcast_to(jnp.asarray(t1, coeffs.dtype), r.roots.shape[:-1])
    cand_t = jnp.concatenate(
        [t0b[..., None], t1b[..., None], r.roots], axis=-1)
    cand_valid = jnp.concatenate(
        [jnp.ones(t0b.shape + (2,), bool), r.valid], axis=-1)

    vals = polyval(coeffs[..., None, :], cand_t, derivative)
    big = jnp.asarray(jnp.finfo(coeffs.dtype).max, coeffs.dtype)
    vmin_masked = jnp.where(cand_valid, vals, big)
    vmax_masked = jnp.where(cand_valid, vals, -big)
    imin = jnp.argmin(vmin_masked, axis=-1)
    imax = jnp.argmax(vmax_masked, axis=-1)
    take = lambda a, i: jnp.take_along_axis(a, i[..., None], axis=-1)[..., 0]
    return IntervalMinMax(
        t_min=take(cand_t, imin), v_min=take(vals, imin),
        t_max=take(cand_t, imax), v_max=take(vals, imax))


def magnitude_candidate_polynomial(coeffs: jnp.ndarray,
                                   derivative: int) -> jnp.ndarray:
    """Coefficients of d/dt ||x^(d)(t)||^2 / 2 = sum_dim x^(d) x^(d+1).

    Args:
      coeffs: (..., N, D) per-dimension monomial coefficients.
      derivative: static derivative order d.

    Returns:
      (..., 2(N-d) - 2) convolution polynomial, summed over dimensions.
      Reference: Segment::computeMinMaxMagnitudeCandidateTimes
      (segment.cpp:82-123).
    """
    coeffs = jnp.moveaxis(jnp.asarray(coeffs), -1, -2)   # (..., D, N)
    n = coeffs.shape[-1]
    n_d = n - derivative
    n_dd = n_d - 1
    d = derivative_coefficients(coeffs, derivative)[..., :n_d]
    dd = derivative_coefficients(coeffs, derivative + 1)[..., :n_dd]
    conv = convolve_full(d, dd)                          # (..., D, n_d+n_dd-1)
    return jnp.sum(conv, axis=-2)


def magnitude_minmax_candidates(coeffs: jnp.ndarray,
                                derivative: int,
                                t0, t1,
                                n_grid: int = DEFAULT_GRID,
                                n_bisections: int = DEFAULT_BISECTIONS
                                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Candidate times for extrema of ||x^(d)(t)|| over [t0, t1].

    Returns (times (..., 2 + max_roots), valid mask): endpoints first, then
    the magnitude-derivative roots.  Mirrors
    Segment::computeMinMaxMagnitudeCandidateTimes (segment.cpp:82-133).
    """
    conv = magnitude_candidate_polynomial(coeffs, derivative)
    r = roots_in_interval(conv, t0, t1, n_grid, n_bisections)
    t0b = jnp.broadcast_to(jnp.asarray(t0, r.roots.dtype), r.roots.shape[:-1])
    t1b = jnp.broadcast_to(jnp.asarray(t1, r.roots.dtype), r.roots.shape[:-1])
    cand_t = jnp.concatenate([t0b[..., None], t1b[..., None], r.roots], axis=-1)
    valid = jnp.concatenate(
        [jnp.ones(t0b.shape + (2,), bool), r.valid], axis=-1)
    return cand_t, valid
