"""Tests for the Q/A/H matrix factorizations (ops.qmatrix).

Includes the reference's AMatrixInversion identity test
(test_polynomial_optimization.cpp:694-705) and numeric-integration checks of
the cost matrix.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mav_tube_trajectory_generation.ops import basis, qmatrix

N = 10


def reference_mapping_matrix(n, t):
    """Direct construction per setupMappingMatrix (linear_impl.h:101-111)."""
    h = n // 2
    a = np.zeros((n, n))
    for i in range(h):
        a[i] = basis.base_coeffs_with_time(n, i, 0.0)
        a[i + h] = basis.base_coeffs_with_time(n, i, t)
    return a


def reference_cost_matrix(n, derivative, t):
    """Direct construction per computeQuadraticCostJacobian (impl:557-573)."""
    bc = basis.base_coefficients(n)
    q = np.zeros((n, n))
    for col in range(n - derivative):
        for row in range(n - derivative):
            exponent = (n - 1 - derivative) * 2 + 1 - row - col
            q[n - 1 - row, n - 1 - col] = (
                bc[derivative, n - 1 - row] * bc[derivative, n - 1 - col]
                * t ** exponent * 2.0 / exponent)
    return q


def test_mapping_matrix_scaling_identity():
    for t in [0.3, 1.0, 2.5, 7.0]:
        ours = np.asarray(qmatrix.mapping_matrix(jnp.asarray([t]), N))[0]
        ref = reference_mapping_matrix(N, t)
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


def test_a_matrix_inversion_identity():
    # Reference test AMatrixInversion (test_polynomial_optimization.cpp:694-705):
    # structured inverse vs dense matrix inverse for t = 1..60.
    for t in np.arange(1.0, 61.0, 1.0):
        a = np.asarray(qmatrix.mapping_matrix(jnp.asarray([t]), N))[0]
        ainv = np.asarray(qmatrix.inv_mapping_matrix(jnp.asarray([t]), N))[0]
        ainv_dense = np.linalg.inv(a)
        np.testing.assert_allclose(ainv, ainv_dense, atol=1e-9,
                                   rtol=1e-8)


def test_cost_matrix_matches_reference_formula():
    for derivative in [2, 3, 4]:
        for t in [0.5, 1.0, 3.2]:
            ours = np.asarray(
                qmatrix.quadratic_cost(N, derivative, jnp.asarray([t])))[0]
            ref = reference_cost_matrix(N, derivative, t)
            np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


def test_cost_matrix_matches_numeric_integral():
    # c^T Q c == 2 * integral_0^T (x^(d))^2 dt  (Q has factor 2/e, so
    # 0.5 c^T Q c is the true integral... verify directly).
    rng = np.random.RandomState(0)
    c = rng.randn(N)
    t_seg = 1.7
    for derivative in [2, 4]:
        q = np.asarray(qmatrix.quadratic_cost(N, derivative,
                                              jnp.asarray([t_seg])))[0]
        analytic = 0.5 * c @ q @ c
        ts = np.linspace(0, t_seg, 200001)
        vals = np.polynomial.Polynomial(c).deriv(derivative)(ts) ** 2
        numeric = np.trapezoid(vals, ts)
        assert analytic == pytest.approx(numeric, rel=1e-6)


def test_hessian_blocks_match_direct_product():
    times = jnp.asarray([0.7, 1.0, 2.9])
    for derivative in [2, 4]:
        h = np.asarray(qmatrix.hessian_blocks(times, N, derivative))
        for i, t in enumerate(np.asarray(times)):
            a = reference_mapping_matrix(N, t)
            q = reference_cost_matrix(N, derivative, t)
            ainv = np.linalg.inv(a)
            np.testing.assert_allclose(h[i], ainv.T @ q @ ainv,
                                       rtol=1e-8, atol=1e-8)


def test_coefficient_roundtrip():
    rng = np.random.RandomState(1)
    d_seg = jnp.asarray(rng.randn(4, N, 3))
    times = jnp.asarray([0.4, 1.0, 2.0, 5.5])
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    d_back = qmatrix.endpoint_derivatives_from_coefficients(coeffs, times)
    np.testing.assert_allclose(np.asarray(d_back), np.asarray(d_seg),
                               rtol=1e-8, atol=1e-8)


def test_coefficients_satisfy_endpoint_derivatives():
    # p = A^{-1} d must reproduce d when evaluated at 0 and T.
    rng = np.random.RandomState(2)
    h = N // 2
    d_seg = rng.randn(1, N, 1)
    t = 2.3
    coeffs = np.asarray(qmatrix.coefficients_from_endpoint_derivatives(
        jnp.asarray(d_seg), jnp.asarray([t])))[0, :, 0]
    poly = np.polynomial.Polynomial(coeffs)
    for i in range(h):
        assert poly.deriv(i)(0.0) == pytest.approx(d_seg[0, i, 0],
                                                   rel=1e-9, abs=1e-9)
        assert poly.deriv(i)(t) == pytest.approx(d_seg[0, h + i, 0],
                                                 rel=1e-9, abs=1e-9)
