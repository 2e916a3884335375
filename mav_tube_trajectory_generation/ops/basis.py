"""Monomial-basis polynomial numerics (batched substrate).

Re-implements the capabilities of the reference `Polynomial` class
(/root/reference/include/mav_tube_trajectory_generation/polynomial.h:38-242,
/root/reference/src/polynomial.cpp:145-201) as fixed-shape, batch-first
functions:

* ``base_coefficients(n)`` -- the falling-factorial table ``bc[d, j] =
  j!/(j-d)!`` used for every derivative computation (reference
  ``computeBaseCoefficients``, polynomial.cpp:145-161).  Computed once in
  float64 NumPy and closed over as a compile-time constant; nothing about it
  is traced.
* ``polyval`` / ``polyval_all`` -- Horner evaluation of any derivative of a
  coefficient stack at arbitrary (batched) times (reference
  ``Polynomial::evaluate``, polynomial.h:118-149).  The Horner loop is a
  Python-unrolled loop over the static coefficient count so XLA sees a pure
  fused chain of multiply-adds (no dynamic control flow).
* ``derivative_coefficients`` -- coefficients of the d-th derivative
  (reference ``Polynomial::getCoefficients``, polynomial.h:99-113), kept in
  the same fixed-length layout with explicit zero padding so shapes stay
  static under vmap.
* ``convolve_full`` -- polynomial product as coefficient convolution
  (reference ``Polynomial::convolve``, polynomial.cpp:163-181), batched.
* ``base_coeffs_with_time`` -- one row of the derivative-sampling matrix A
  (reference ``Polynomial::baseCoeffsWithTime``, polynomial.h:201-228).

Coefficients are stored with increasing powers: c0 + c1 t + ... + c_{N-1}
t^{N-1}, identical to the reference convention.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

# Mirrors Polynomial::kMaxN / kMaxConvolutionSize (polynomial.h:45-48): the
# largest table we ever need is for the magnitude-derivative convolution of an
# N = 12 polynomial, degree 2N - 3 -> 2N - 2 coefficients.
MAX_N = 12
MAX_CONVOLUTION_SIZE = 2 * MAX_N - 2


@functools.lru_cache(maxsize=None)
def base_coefficients(n: int) -> np.ndarray:
    """Falling-factorial derivative table, shape (n, n), float64.

    ``bc[d, j] = j! / (j - d)!`` for ``j >= d`` and 0 otherwise; row 0 is all
    ones.  ``bc[d] * coeffs`` gives the polynomial coefficients of the d-th
    derivative evaluated against increasing powers ``t^(j-d)``.
    """
    bc = np.zeros((n, n), dtype=np.float64)
    bc[0] = 1.0
    for d in range(1, n):
        for j in range(d, n):
            bc[d, j] = (j - d + 1) * bc[d - 1, j]
    bc.setflags(write=False)
    return bc


def base_coeffs_with_time(n: int, derivative: int, t: float) -> np.ndarray:
    """Row of the mapping matrix A: d-th derivative sampled at time t.

    Host-side helper (NumPy): used for building static matrices and test
    oracles.  Reference: polynomial.h:201-228.
    """
    bc = base_coefficients(n)
    out = np.zeros(n, dtype=np.float64)
    out[derivative] = bc[derivative, derivative]
    if abs(t) < np.finfo(np.float64).eps:
        return out
    t_power = t
    for j in range(derivative + 1, n):
        out[j] = bc[derivative, j] * t_power
        t_power *= t
    return out


def polyval(coeffs: jnp.ndarray, t: jnp.ndarray, derivative: int) -> jnp.ndarray:
    """Evaluate the ``derivative``-th derivative of polynomial(s) at ``t``.

    Args:
      coeffs: (..., N) increasing-power coefficients.
      t: scalar or array broadcastable against ``coeffs[..., 0]``.
      derivative: static non-negative derivative order.

    Returns:
      Array broadcast of ``coeffs[..., 0]`` and ``t``.

    Horner scheme identical in structure to Polynomial::evaluate
    (polynomial.h:136-149); unrolled at trace time over the static N.
    """
    n = coeffs.shape[-1]
    if derivative >= n:
        return jnp.zeros(jnp.broadcast_shapes(coeffs[..., 0].shape, jnp.shape(t)),
                         dtype=coeffs.dtype)
    bc = base_coefficients(n)[derivative]
    acc = coeffs[..., n - 1] * bc[n - 1]
    for j in range(n - 2, derivative - 1, -1):
        acc = acc * t + coeffs[..., j] * bc[j]
    return acc


def polyval_all(coeffs: jnp.ndarray, t: jnp.ndarray, max_derivative: int) -> jnp.ndarray:
    """Evaluate derivatives 0..max_derivative, stacked on a new leading axis.

    Returns shape (max_derivative + 1, ...) matching ``polyval`` broadcasting.
    Reference: the vector variant of Polynomial::evaluate (polynomial.h:118-132).
    """
    return jnp.stack([polyval(coeffs, t, d) for d in range(max_derivative + 1)])


def derivative_coefficients(coeffs: jnp.ndarray, derivative: int) -> jnp.ndarray:
    """Coefficients of the d-th derivative, zero-padded to length N.

    ``out[j] = coeffs[j + d] * (j + d)!/j!`` for ``j < N - d``; the tail is
    zero.  Matches Polynomial::getCoefficients (polynomial.h:99-113) but keeps
    the fixed length-N layout for static shapes.
    """
    n = coeffs.shape[-1]
    if derivative == 0:
        return coeffs
    if derivative >= n:
        return jnp.zeros_like(coeffs)
    bc = base_coefficients(n)
    scaled = coeffs[..., derivative:] * bc[derivative, derivative:]
    pad = [(0, 0)] * (coeffs.ndim - 1) + [(0, derivative)]
    return jnp.pad(scaled, pad)


def convolve_full(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full discrete convolution of trailing axes: out length = la + lb - 1.

    Batched polynomial product (reference Polynomial::convolve,
    polynomial.cpp:163-181).  Implemented as a static unrolled
    shift-multiply-add, which XLA fuses into vector code; sizes here are tiny
    (<= 2 * MAX_N - 2).
    """
    la = a.shape[-1]
    lb = b.shape[-1]
    out_len = la + lb - 1
    batch_shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = jnp.zeros(batch_shape + (out_len,), dtype=jnp.result_type(a, b))
    for k in range(lb):
        out = out.at[..., k:k + la].add(a * b[..., k:k + 1])
    return out


def pad_coefficients(coeffs: jnp.ndarray, new_n: int) -> jnp.ndarray:
    """Zero-pad increasing-power coefficients to a higher order: the same
    polynomial expressed with ``new_n`` coefficients
    (Polynomial::getPolynomialWithAppendedCoefficients,
    polynomial.cpp:183-198).  No-op if already >= new_n (reference warns and
    returns the original)."""
    n = coeffs.shape[-1]
    if new_n <= n:
        return coeffs
    pad = [(0, 0)] * (coeffs.ndim - 1) + [(0, new_n - n)]
    return jnp.pad(coeffs, pad)


def powers(t: jnp.ndarray, n: int) -> jnp.ndarray:
    """[1, t, t^2, ..., t^(n-1)] stacked on a trailing axis."""
    t = jnp.asarray(t)
    pows = [jnp.ones_like(t)]
    for _ in range(n - 1):
        pows.append(pows[-1] * t)
    return jnp.stack(pows, axis=-1)
