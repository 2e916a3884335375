"""Property tests for the polynomial numerics substrate (ops.basis).

Mirrors the reference test intent of test/test_polynomial.cpp: evaluation,
derivative coefficients and convolution checked against independent NumPy
oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mav_tube_trajectory_generation.ops import basis


def test_base_coefficients_table():
    bc = basis.base_coefficients(10)
    # bc[d, j] = j!/(j-d)! ; spot-check against factorials.
    import math
    for d in range(10):
        for j in range(10):
            expected = math.factorial(j) / math.factorial(j - d) if j >= d else 0.0
            assert bc[d, j] == pytest.approx(expected)


def test_polyval_matches_numpy():
    rng = np.random.RandomState(0)
    coeffs = rng.randn(50, 10)
    ts = rng.uniform(-2, 2, size=50)
    for d in range(0, 5):
        ours = np.asarray(basis.polyval(jnp.asarray(coeffs), jnp.asarray(ts), d))
        for i in range(50):
            poly = np.polynomial.Polynomial(coeffs[i]).deriv(d)
            assert ours[i] == pytest.approx(poly(ts[i]), rel=1e-10, abs=1e-9)


def test_polyval_derivative_beyond_order_is_zero():
    coeffs = jnp.ones((3, 10))
    out = basis.polyval(coeffs, jnp.ones(3), 12)
    assert np.all(np.asarray(out) == 0.0)


def test_derivative_coefficients():
    rng = np.random.RandomState(1)
    coeffs = rng.randn(10)
    for d in range(0, 6):
        ours = np.asarray(basis.derivative_coefficients(jnp.asarray(coeffs), d))
        oracle = np.polynomial.Polynomial(coeffs).deriv(d).coef
        np.testing.assert_allclose(ours[: len(oracle)], oracle, rtol=1e-12)
        assert np.all(ours[len(oracle):] == 0.0)


def test_convolve_matches_numpy():
    rng = np.random.RandomState(2)
    a = rng.randn(4, 9)
    b = rng.randn(4, 8)
    ours = np.asarray(basis.convolve_full(jnp.asarray(a), jnp.asarray(b)))
    for i in range(4):
        np.testing.assert_allclose(ours[i], np.convolve(a[i], b[i]), rtol=1e-12)


def test_convolution_is_polynomial_product():
    # Exact example in the spirit of test_polynomial.cpp:68-79.
    a = np.array([1.0, 2.0, 3.0])        # 1 + 2t + 3t^2
    b = np.array([0.0, 1.0])             # t
    ours = np.asarray(basis.convolve_full(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ours, [0.0, 1.0, 2.0, 3.0])


def test_base_coeffs_with_time_is_a_row():
    # A row built by base_coeffs_with_time equals derivative evaluation.
    rng = np.random.RandomState(3)
    coeffs = rng.randn(10)
    for d in range(5):
        for t in [0.0, 0.7, 2.3]:
            row = basis.base_coeffs_with_time(10, d, t)
            val = float(row @ coeffs)
            oracle = np.polynomial.Polynomial(coeffs).deriv(d)(t)
            assert val == pytest.approx(oracle, rel=1e-10, abs=1e-12)


def test_powers():
    out = np.asarray(basis.powers(jnp.asarray([2.0, 3.0]), 4))
    np.testing.assert_allclose(out, [[1, 2, 4, 8], [1, 3, 9, 27]])


def test_pad_coefficients_preserves_polynomial():
    """getPolynomialWithAppendedCoefficients parity (polynomial.cpp:183-198):
    zero-padding must not change evaluations; padding down is a no-op."""
    import jax.numpy as jnp
    c = jnp.asarray([1.0, -2.0, 0.5])
    padded = basis.pad_coefficients(c, 7)
    assert padded.shape == (7,)
    ts = jnp.linspace(-1.0, 2.0, 11)
    np.testing.assert_allclose(
        np.asarray(basis.polyval(padded[None], ts, 0))[0],
        np.asarray(basis.polyval(c[None], ts, 0))[0], rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(basis.pad_coefficients(c, 2)),
                                  np.asarray(c))
