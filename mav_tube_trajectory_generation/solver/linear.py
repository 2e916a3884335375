"""Batched closed-form min-derivative QP solver (the heart of the framework).

Batched re-design of the reference's ``PolynomialOptimization<N>``
(polynomial_optimization_linear.h + impl, Richter/Bry/Roy ISRR 2013 closed
form):

  reference (per problem, scalar C++)            here (per mega-batch, XLA)
  ---------------------------------------------  -------------------------------
  per-segment A, Schur inverse (impl:101-169)    constant Ahat^{-1} + T-power
                                                 diagonal scaling (ops.qmatrix)
  per-segment dense H = A^-T Q A^-1 (impl:317)   elementwise power scaling of a
                                                 constant Hhat (no matmul)
  sparse M assembly + sparse R = M^T H M         static one-hot einsum over the
  (impl:171-252, 306-335)                        gather map (solver.structure)
  SparseQR factor of R_pp (impl:358-366)         batched dense Cholesky (R_pp is
                                                 SPD; QR was overkill) with
                                                 Jacobi equilibration for the
                                                 float32 fast path
  per-dimension solve loop (impl:368-375)        one (n_p, D) matmul solve
  coefficient recovery loop (impl:254-275)       batched gather + scaled matmul

Everything is a pure function of ``(d_fixed, times)`` for a static
``ProblemStructure`` -- jit once per problem family, ``vmap``/``shard_map``
over scenarios.  Known reference quirks intentionally not replicated: the
hot-path debug prints (impl:287-292, 370).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg, qmatrix
from .structure import ProblemStructure


def full_matmul_precision(fn):
    """Trace the wrapped solver with float32 matmuls regardless of the
    caller's precision context.

    Accelerator matmuls may default to reduced-precision passes (TF32 on
    NVIDIA GPUs, bfloat16 elsewhere); the solvers' assembly einsums span
    ~T^(1-2d) dynamic range (17 decades for snap at N=10), and at bfloat16
    a short-segment-time solve NaNs outright (observed with velocity-ramp
    times).  Correct-by-default matters more than the matmul-pass cost;
    callers wanting the fast path must opt in per-op.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision('highest'):
            return fn(*args, **kwargs)
    return wrapped


class LinearSolution(NamedTuple):
    """Result of one (or a batch of) linear solves.

    Attributes:
      coefficients: (..., K, N, D) real-time monomial coefficients.
      times: (..., K) segment times (passed through).
      d_fixed: (..., n_fixed, D) fixed endpoint derivatives.
      d_free: (..., n_free, D) optimized free endpoint derivatives.
      cost: (...,) 0.5 * sum_k sum_d c^T Q c  (computeCost, impl:113-130).
    """
    coefficients: jnp.ndarray
    times: jnp.ndarray
    d_fixed: jnp.ndarray
    d_free: jnp.ndarray
    cost: jnp.ndarray


def assemble_r(structure: ProblemStructure, times: jnp.ndarray) -> jnp.ndarray:
    """R = M^T blockdiag(H_k) M, dense (n_total, n_total).

    Replaces constructR (linear_impl.h:306-335).  The one-hot M is a static
    constant; the contraction is two small batched matmuls.
    """
    n = structure.n_coefficients
    h_blocks = qmatrix.hessian_blocks(times, n, structure.derivative_to_optimize)
    m_hot = jnp.asarray(structure.one_hot_m(), dtype=h_blocks.dtype)
    # (K,N,nt),(...,K,N,N),(K,N,nt) -> (...,nt,nt)
    hm = jnp.einsum('...krc,kcb->...krb', h_blocks, m_hot)
    return jnp.einsum('kra,...krb->...ab', m_hot, hm)


def segment_derivatives(structure: ProblemStructure,
                        d_fixed: jnp.ndarray,
                        d_free: jnp.ndarray) -> jnp.ndarray:
    """Gather [d_f; d_p] into per-segment endpoint derivatives (..., K, N, D)."""
    d_all = jnp.concatenate([d_fixed, d_free], axis=-2)
    return jnp.take(d_all, jnp.asarray(structure.gather_idx), axis=-2)


def cost_from_derivatives(structure: ProblemStructure,
                          d_seg: jnp.ndarray,
                          times: jnp.ndarray) -> jnp.ndarray:
    """0.5 sum_k sum_dim d_seg^T H_k d_seg  ( == 0.5 c^T Q c, impl:113-130)."""
    n = structure.n_coefficients
    h_blocks = qmatrix.hessian_blocks(times, n, structure.derivative_to_optimize)
    return 0.5 * jnp.einsum('...krd,...krc,...kcd->...', d_seg, h_blocks, d_seg)


def solve_free_derivatives(structure: ProblemStructure,
                           d_fixed: jnp.ndarray,
                           times: jnp.ndarray,
                           method: str = "cholesky") -> jnp.ndarray:
    """d_free only -- the closed-form solve WITHOUT coefficient recovery or
    cost evaluation.  For consumers that only need the compact free
    derivatives (e.g. the QCQP warm start), the full ``solve_linear`` wastes
    the per-segment coefficient matmuls and gathers per scenario."""
    with jax.default_matmul_precision('highest'):
        nf = structure.n_fixed
        d_fixed = jnp.asarray(d_fixed)
        times = jnp.asarray(times)
        dtype = jnp.result_type(d_fixed, times)
        d_fixed = d_fixed.astype(dtype)
        times = times.astype(dtype)
        if structure.n_free == 0:
            return jnp.zeros(d_fixed.shape[:-2] + (0, structure.dimension),
                             dtype)
        r = assemble_r(structure, times)
        r_pf = r[..., nf:, :nf]
        r_pp = r[..., nf:, nf:]
        scale = jax.lax.rsqrt(jnp.diagonal(r_pp, axis1=-2, axis2=-1))
        r_pp_eq = r_pp * scale[..., :, None] * scale[..., None, :]
        rhs = (-jnp.einsum('...pf,...fd->...pd', r_pf, d_fixed)
               * scale[..., :, None])
        if method == "schur":
            sol_eq = linalg.spd_inverse_schur(r_pp_eq) @ rhs
        else:
            chol = jax.scipy.linalg.cho_factor(r_pp_eq, lower=True)
            sol_eq = jax.scipy.linalg.cho_solve(chol, rhs)
        return sol_eq * scale[..., :, None]


@full_matmul_precision
def solve_linear(structure: ProblemStructure,
                 d_fixed: jnp.ndarray,
                 times: jnp.ndarray,
                 method: str = "cholesky") -> LinearSolution:
    """Closed-form solve: d_p = -R_pp^{-1} R_pf d_f, then coefficient recovery.

    Args:
      structure: static problem family (closed over at trace time).
      d_fixed: (..., n_fixed, D) fixed endpoint-derivative values, ordered as
        ``structure.fixed_cols`` (lexicographic (vertex, derivative) -- the
        reference's std::set order).
      times: (..., K) positive segment times.
      method: "cholesky" (backward-stable, default) or "schur" -- the
        block-Schur inverse (ops/linalg.spd_inverse_schur).  Safe when the equilibrated
        R_pp is well-conditioned: for the standard position-constrained
        family it is ~5e2 (measured), so float32 error is ~1e-4 relative --
        used by the throughput bench's warm-start path.

    Returns:
      LinearSolution.  Batch dims broadcast between d_fixed and times.

    Reference: solveLinear (linear_impl.h:337-379) -- with SparseQR replaced
    by Jacobi-equilibrated Cholesky on the SPD R_pp.
    """
    nf = structure.n_fixed
    d_fixed = jnp.asarray(d_fixed)
    times = jnp.asarray(times)
    dtype = jnp.result_type(d_fixed, times)
    d_fixed = d_fixed.astype(dtype)
    times = times.astype(dtype)

    if structure.n_free == 0:
        # Fully constrained: nothing to optimize (impl:341-347).
        d_free = jnp.zeros(d_fixed.shape[:-2] + (0, structure.dimension), dtype)
        d_seg = segment_derivatives(structure, d_fixed, d_free)
        coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
        cost = cost_from_derivatives(structure, d_seg, times)
        return LinearSolution(coeffs, times, d_fixed, d_free, cost)

    r = assemble_r(structure, times)
    r_pf = r[..., nf:, :nf]
    r_pp = r[..., nf:, nf:]

    # Jacobi (symmetric diagonal) equilibration: essential for the float32
    # path -- R entries span T^(1-2d-i_r-i_c) across derivative orders.
    scale = jax.lax.rsqrt(jnp.diagonal(r_pp, axis1=-2, axis2=-1))
    r_pp_eq = r_pp * scale[..., :, None] * scale[..., None, :]
    rhs = -jnp.einsum('...pf,...fd->...pd', r_pf, d_fixed) * scale[..., :, None]
    if method == "schur":
        sol_eq = linalg.spd_inverse_schur(r_pp_eq) @ rhs
    else:
        chol = jax.scipy.linalg.cho_factor(r_pp_eq, lower=True)
        sol_eq = jax.scipy.linalg.cho_solve(chol, rhs)
    d_free = sol_eq * scale[..., :, None]

    d_seg = segment_derivatives(structure, d_fixed, d_free)
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    cost = cost_from_derivatives(structure, d_seg, times)
    return LinearSolution(coeffs, times, d_fixed, d_free, cost)


@full_matmul_precision
def solve_linear_with_free(structure: ProblemStructure,
                           d_fixed: jnp.ndarray,
                           d_free: jnp.ndarray,
                           times: jnp.ndarray) -> LinearSolution:
    """Recover coefficients/cost for externally chosen free derivatives.

    The reference's setFreeConstraints + updateSegmentsFromCompactConstraints
    path (linear_impl.h:490-498, 254-275); used by the nonlinear outer loop.
    """
    d_fixed = jnp.asarray(d_fixed)
    d_free = jnp.asarray(d_free)
    times = jnp.asarray(times)
    d_seg = segment_derivatives(structure, d_fixed, d_free)
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    cost = cost_from_derivatives(structure, d_seg, times)
    return LinearSolution(coeffs, times, d_fixed, d_free, cost)


def derivative_cost_and_grad(structure: ProblemStructure,
                             d_fixed: jnp.ndarray,
                             d_free: jnp.ndarray,
                             times: jnp.ndarray):
    """J_d = [d_f; d_p]^T R [d_f; d_p] and dJ_d/dd_p, from the R blocks.

    Matches getCostAndGradientDerivative (nonlinear_impl.h:1537-1606):
    J_d = d_f^T R_ff d_f + 2 d_f^T R_fp d_p + d_p^T R_pp d_p  (per dimension,
    summed), grad = 2 R_fp^T d_f + 2 R_pp d_p.  Note the reference's J_d here
    is *twice* the 0.5 c^T Q c cost; we keep the reference's convention for
    the nonlinear objective.
    """
    nf = structure.n_fixed
    r = assemble_r(structure, times)
    r_ff = r[..., :nf, :nf]
    r_fp = r[..., :nf, nf:]
    r_pp = r[..., nf:, nf:]
    jf = jnp.einsum('...fd,...fg,...gd->...', d_fixed, r_ff, d_fixed)
    jc = 2.0 * jnp.einsum('...fd,...fp,...pd->...', d_fixed, r_fp, d_free)
    jp = jnp.einsum('...pd,...pq,...qd->...', d_free, r_pp, d_free)
    grad = (2.0 * jnp.einsum('...fp,...fd->...pd', r_fp, d_fixed)
            + 2.0 * jnp.einsum('...pq,...qd->...pd', r_pp, d_free))
    return jf + jc + jp, grad


def compact_from_segment_derivatives(structure: ProblemStructure,
                                     d_seg: jnp.ndarray) -> jnp.ndarray:
    """M^+ d_seg: recover the compact [d_f; d_p] vector from per-segment
    endpoint derivatives by averaging duplicated interior entries.

    The reference's row-normalized pseudo-inverse getMpinv
    (linear_impl.h:547-555) -- valid because M is 0/1 with row sums equal to
    the duplication count.  Exact inverse of ``segment_derivatives`` for any
    continuity-consistent d_seg (packing round-trip test,
    test_polynomial_optimization.cpp:511-570).
    """
    d_seg = jnp.asarray(d_seg)
    k, n = structure.gather_idx.shape
    counts = np.bincount(structure.gather_idx.ravel(),
                         minlength=structure.n_total).astype(np.float64)
    flat_idx = jnp.asarray(structure.gather_idx.reshape(k * n))
    batch = d_seg.shape[:-3]
    d_flat = d_seg.reshape(batch + (k * n, d_seg.shape[-1]))
    summed = jnp.zeros(batch + (structure.n_total, d_seg.shape[-1]),
                       d_seg.dtype).at[..., flat_idx, :].add(d_flat)
    return summed / jnp.asarray(counts, d_seg.dtype)[..., :, None]


def solve_from_positions(positions, times, n_coefficients: int = 10,
                         derivative_to_optimize: Optional[int] = None):
    """Convenience one-call solve from a plain position list.

    The reference's setupFromPositons (linear.h:79-80): endpoints pinned to
    rest up to N/2-1, interior vertices position-only.

    Args:
      positions: (V, D) waypoint positions (host array).
      times: (V-1,) segment times.

    Returns:
      (ProblemStructure, LinearSolution).
    """
    from .structure import make_structure, standard_mask
    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim == 1:
        positions = positions[:, None]
    v, dim = positions.shape
    n = n_coefficients
    structure = make_structure(standard_mask(v, n), dim, n,
                               derivative_to_optimize)
    values = np.zeros((v, n // 2, dim))
    values[:, 0, :] = positions
    d_fixed = extract_fixed_values(structure, jnp.asarray(values))
    return structure, solve_linear(structure, d_fixed, jnp.asarray(times))


def extract_fixed_values(structure: ProblemStructure,
                         vertex_values: jnp.ndarray) -> jnp.ndarray:
    """Build d_fixed (n_fixed, D) from a dense (V, N/2, D) vertex-value array.

    Free entries of ``vertex_values`` are ignored.  Static gather; jit/vmap
    safe.
    """
    v = structure.n_vertices
    h = structure.half_n
    flat = jnp.reshape(vertex_values,
                       vertex_values.shape[:-3] + (v * h, vertex_values.shape[-1]))
    return jnp.take(flat, jnp.asarray(structure.fixed_value_gather()), axis=-2)
