"""Cost (Q), mapping (A) and unconstrained-Hessian (H) matrices, batch-style.

The reference builds, per segment and per segment-time T:

* the mapping matrix A(T) sampling derivatives 0..N/2-1 at t = 0 and t = T
  (linear_impl.h:101-111),
* its structured inverse via a Schur complement (linear_impl.h:132-169),
* the quadratic-cost Jacobian Q(T) of the integral of the squared d-th
  derivative (linear_impl.h:557-573),
* and the per-segment Hessian block H(T) = A(T)^{-T} Q(T) A(T)^{-1}
  (constructR, linear_impl.h:306-335).

Key design decision (this is NOT how the reference computes it):
all of these factor exactly into a *constant unit-time matrix* and *diagonal
powers of T*:

    A(T)   = diag(T^-i_r) @ Ahat   @ diag(T^j)         (rows r sample deriv i_r)
    Q(T)   = T^(1-2d) diag(T^j) @ Qhat_d @ diag(T^j)
    H(T)   = T^(1-2d) diag(T^i_r) @ Hhat_d @ diag(T^i_r)

with ``i_r = (0..N/2-1, 0..N/2-1)`` the derivative order sampled by row r, and
``Hhat_d = Ahat^{-T} Qhat_d Ahat^{-1}`` a constant.  So the per-scenario hot
path needs **no matrix inversion and no matrix product at all** to build every
H block -- just an elementwise rank-1 power scaling, which vmaps over
thousands of scenarios and feeds one batched einsum + Cholesky.  The constant
matrices are computed once on host in float64 and closed over.

This factorization is also the conditioning story for the float32 fast
path: ``Ahat`` is inverted once at unit time (well-conditioned), never per
segment time.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from .basis import base_coefficients, base_coeffs_with_time


@functools.lru_cache(maxsize=None)
def row_derivative_orders(n: int) -> np.ndarray:
    """Derivative order sampled by each row of A: (0..N/2-1, 0..N/2-1)."""
    h = n // 2
    out = np.concatenate([np.arange(h), np.arange(h)]).astype(np.float64)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def mapping_matrix_unit(n: int) -> np.ndarray:
    """Ahat = A(T=1): rows = derivs 0..N/2-1 at t=0, then at t=1.

    Reference: setupMappingMatrix (linear_impl.h:101-111) evaluated at T = 1.
    """
    h = n // 2
    a = np.zeros((n, n), dtype=np.float64)
    for i in range(h):
        a[i] = base_coeffs_with_time(n, i, 0.0)
        a[i + h] = base_coeffs_with_time(n, i, 1.0)
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def inv_mapping_matrix_unit(n: int) -> np.ndarray:
    """Ahat^{-1} via the same Schur-complement structure as the reference.

    A(1) = [diag(d)  0; C  D]  =>  A^{-1} = [diag(1/d) 0; -D^{-1} C diag(1/d), D^{-1}]
    (reference invertMappingMatrix, linear_impl.h:132-169).  Computed once on
    host in float64.
    """
    h = n // 2
    a = mapping_matrix_unit(n)
    a_diag_inv = np.diag(1.0 / np.diag(a[:h, :h]))
    c = a[h:, :h]
    d_inv = np.linalg.inv(a[h:, h:])
    inv = np.zeros((n, n), dtype=np.float64)
    inv[:h, :h] = a_diag_inv
    inv[h:, :h] = -d_inv @ c @ a_diag_inv
    inv[h:, h:] = d_inv
    inv.setflags(write=False)
    return inv


@functools.lru_cache(maxsize=None)
def quadratic_cost_unit(n: int, derivative: int) -> np.ndarray:
    """Qhat_d = Q(derivative, T=1): integral Jacobian of squared derivative.

    Qhat[r, c] = bc[d, r] bc[d, c] * 2 / (r + c + 1 - 2d) for r, c >= d.
    Matches computeQuadraticCostJacobian (linear_impl.h:557-573) at T = 1.
    """
    bc = base_coefficients(n)
    q = np.zeros((n, n), dtype=np.float64)
    for r in range(derivative, n):
        for c in range(derivative, n):
            e = r + c + 1 - 2 * derivative
            q[r, c] = bc[derivative, r] * bc[derivative, c] * 2.0 / e
    q.setflags(write=False)
    return q


def quadratic_cost(n: int, derivative: int, t) -> jnp.ndarray:
    """Q(derivative, T) for (batched) segment times ``t``: (..., N, N)."""
    t = jnp.asarray(t)
    qhat = jnp.asarray(quadratic_cost_unit(n, derivative), dtype=t.dtype)
    jpow = t[..., None] ** jnp.arange(n, dtype=t.dtype)          # (..., N)
    scale = t ** (1 - 2 * derivative)
    return scale[..., None, None] * jpow[..., :, None] * jpow[..., None, :] * qhat


@functools.lru_cache(maxsize=None)
def hessian_unit(n: int, derivative: int) -> np.ndarray:
    """Hhat_d = Ahat^{-T} Qhat_d Ahat^{-1} (constant, host float64)."""
    ainv = inv_mapping_matrix_unit(n)
    h = ainv.T @ quadratic_cost_unit(n, derivative) @ ainv
    # Symmetrize: exact math is symmetric; float64 roundoff is not.
    h = 0.5 * (h + h.T)
    h.setflags(write=False)
    return h


def hessian_blocks(times: jnp.ndarray, n: int, derivative: int) -> jnp.ndarray:
    """H(T_k) = A^{-T} Q A^{-1} for every segment, shape (..., K, N, N).

    Replaces the per-segment dense triple product of constructR
    (linear_impl.h:314-317) with an elementwise power scaling of the constant
    ``hessian_unit``:  H[r, c] = Hhat[r, c] * T^(1 - 2d + i_r + i_c).
    """
    times = jnp.asarray(times)
    hhat = jnp.asarray(hessian_unit(n, derivative), dtype=times.dtype)
    iord = jnp.asarray(row_derivative_orders(n), dtype=times.dtype)
    tpow = times[..., None] ** iord                               # (..., K, N)
    scale = times ** (1 - 2 * derivative)
    return (scale[..., None, None] * tpow[..., :, None] * tpow[..., None, :]
            * hhat)


def mapping_matrix(times: jnp.ndarray, n: int) -> jnp.ndarray:
    """A(T_k) for (batched) times: (..., N, N).  For tests/diagnostics."""
    times = jnp.asarray(times)
    ahat = jnp.asarray(mapping_matrix_unit(n), dtype=times.dtype)
    iord = jnp.asarray(row_derivative_orders(n), dtype=times.dtype)
    jpow = times[..., None] ** jnp.arange(n, dtype=times.dtype)
    ipow = times[..., None] ** iord
    return ahat * jpow[..., None, :] / ipow[..., :, None]


def inv_mapping_matrix(times: jnp.ndarray, n: int) -> jnp.ndarray:
    """A(T_k)^{-1} for (batched) times: (..., N, N).  For tests/diagnostics."""
    times = jnp.asarray(times)
    ainv_hat = jnp.asarray(inv_mapping_matrix_unit(n), dtype=times.dtype)
    iord = jnp.asarray(row_derivative_orders(n), dtype=times.dtype)
    jpow = times[..., None] ** jnp.arange(n, dtype=times.dtype)
    ipow = times[..., None] ** iord
    return ainv_hat * ipow[..., None, :] / jpow[..., :, None]


def coefficients_from_endpoint_derivatives(d_seg: jnp.ndarray,
                                           times: jnp.ndarray) -> jnp.ndarray:
    """p = A(T)^{-1} d per segment, without materializing A^{-1}.

    Args:
      d_seg: (..., K, N, D) endpoint derivatives per segment (start derivs
        0..N/2-1, then end derivs 0..N/2-1) -- the reference's per-segment
        ``new_d`` (updateSegmentsFromCompactConstraints, linear_impl.h:265-273).
      times: (..., K) segment times.

    Returns:
      (..., K, N, D) monomial coefficients in *real time*.

    Uses A^{-1}(T) = diag(T^-j) Ahat^{-1} diag(T^i_r).
    """
    n = d_seg.shape[-2]
    times = jnp.asarray(times)
    ainv_hat = jnp.asarray(inv_mapping_matrix_unit(n), dtype=d_seg.dtype)
    iord = jnp.asarray(row_derivative_orders(n), dtype=times.dtype)
    ipow = times[..., None] ** iord                               # (..., K, N)
    jpow = times[..., None] ** jnp.arange(n, dtype=times.dtype)   # (..., K, N)
    scaled = d_seg * ipow[..., :, None]
    coeffs = jnp.einsum('ij,...jd->...id', ainv_hat, scaled)
    return coeffs / jpow[..., :, None]


def endpoint_derivatives_from_coefficients(coeffs: jnp.ndarray,
                                           times: jnp.ndarray) -> jnp.ndarray:
    """d = A(T) p per segment: inverse of the above (used for QCQP warm starts
    and the d_all = M^+ A p re-seeding path, nonlinear_impl.h:199-272)."""
    n = coeffs.shape[-2]
    times = jnp.asarray(times)
    ahat = jnp.asarray(mapping_matrix_unit(n), dtype=coeffs.dtype)
    iord = jnp.asarray(row_derivative_orders(n), dtype=times.dtype)
    ipow = times[..., None] ** iord
    jpow = times[..., None] ** jnp.arange(n, dtype=times.dtype)
    scaled = coeffs * jpow[..., :, None]
    d = jnp.einsum('ij,...jd->...id', ahat, scaled)
    return d / ipow[..., :, None]
