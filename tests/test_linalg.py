"""ops/linalg: batched SPD linear algebra vs NumPy oracles.

These tests pin the numerics of the block-Schur and matmul-only triangular
inverses the solvers use (SURVEY.md section 7, stage 5 "speed-of-light"
requirement is a perf concern -- correctness is pinned here).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mav_tube_trajectory_generation.ops import linalg


def _random_spd(rng, batch, n, cond):
    q, _ = np.linalg.qr(rng.randn(batch, n, n))
    eig = np.logspace(0, np.log10(cond), n)
    return np.einsum('bij,j,bkj->bik', q, eig, q)


def test_tri_lower_inverse_matches_numpy():
    rng = np.random.RandomState(0)
    a = _random_spd(rng, 4, 135, 1e6)
    chol = np.linalg.cholesky(a)
    inv = np.asarray(linalg.tri_lower_inverse(jnp.asarray(chol)))
    np.testing.assert_allclose(inv, np.linalg.inv(chol), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 45, 135])
def test_spd_inverse_schur_f64(n):
    # Residual scales ~cond * eps * O(100) (unpivoted block elimination
    # over LU-inverted leaves).
    rng = np.random.RandomState(n)
    a = _random_spd(rng, 3, n, 1e4)
    inv = np.asarray(linalg.spd_inverse_schur(jnp.asarray(a)))
    resid = np.einsum('bij,bjk->bik', a, inv) - np.eye(n)
    assert np.max(np.abs(resid)) < 1e-9
    # Symmetric output.
    np.testing.assert_allclose(inv, np.swapaxes(inv, -1, -2),
                               rtol=0, atol=1e-12 * np.max(np.abs(inv)))


def test_spd_inverse_schur_f32_kkt_conditioning():
    """float32 accuracy at the QCQP KKT's measured conditioning (~2e2)."""
    rng = np.random.RandomState(7)
    a = _random_spd(rng, 8, 135, 2e2).astype(np.float32)
    inv = np.asarray(linalg.spd_inverse_schur(jnp.asarray(a)))
    resid = np.einsum('bij,bjk->bik', a.astype(np.float64),
                      inv.astype(np.float64)) - np.eye(135)
    assert np.max(np.abs(resid)) < 5e-4


def test_spd_inverse_matches_schur():
    rng = np.random.RandomState(3)
    a = _random_spd(rng, 2, 64, 1e4)
    w_chol = np.asarray(linalg.spd_inverse(jnp.asarray(a)))
    w_schur = np.asarray(linalg.spd_inverse_schur(jnp.asarray(a)))
    np.testing.assert_allclose(w_chol, w_schur, rtol=1e-6, atol=1e-9)


def test_solve_linear_schur_matches_cholesky():
    """solve_linear(method='schur') agrees with the Cholesky path on the
    standard 10-segment family (the bench's warm-start configuration)."""
    import mav_tube_trajectory_generation as mtg
    from mav_tube_trajectory_generation.solver import linear, structure as sm

    rng = np.random.RandomState(11)
    k = 10
    wp = np.cumsum(rng.uniform(0.5, 2.0, size=(k + 1, 3)), axis=0)
    std = sm.make_structure(sm.standard_mask(k + 1, 10), 3, 10)
    values = np.zeros((k + 1, 5, 3))
    values[:, 0] = wp
    times = jnp.asarray(rng.uniform(0.5, 2.0, size=(k,)))
    df = linear.extract_fixed_values(std, jnp.asarray(values))
    a = linear.solve_linear(std, df, times)
    b = linear.solve_linear(std, df, times, method="schur")
    np.testing.assert_allclose(np.asarray(b.d_free), np.asarray(a.d_free),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-10)


def test_spd_solve_vector_and_matrix_rhs():
    rng = np.random.RandomState(5)
    a = _random_spd(rng, 2, 33, 1e5)
    x_vec = rng.randn(2, 33)
    x_mat = rng.randn(2, 33, 4)
    b_vec = np.einsum('bij,bj->bi', a, x_vec)
    b_mat = a @ x_mat
    got_vec = np.asarray(linalg.spd_solve(jnp.asarray(a), jnp.asarray(b_vec)))
    got_mat = np.asarray(linalg.spd_solve(jnp.asarray(a), jnp.asarray(b_mat)))
    np.testing.assert_allclose(got_vec, x_vec, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got_mat, x_mat, rtol=1e-6, atol=1e-8)
