"""Tests for the giant-K block-tridiagonal (cyclic reduction) fast path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation as mtg
from mav_tube_trajectory_generation.solver import banded, structure as sm

N, H = 10, 5


def test_block_tridiag_solve_vs_dense():
    rng = np.random.RandomState(0)
    for m, b in [(1, 4), (2, 4), (3, 5), (7, 4), (10, 5), (99, 4)]:
        blocks = []
        for _ in range(m):
            a = rng.randn(b, b)
            blocks.append(a @ a.T + 5 * np.eye(b))
        u = rng.randn(max(m - 1, 0), b, b) * 0.3
        dense = np.zeros((m * b, m * b))
        for i in range(m):
            dense[i * b:(i + 1) * b, i * b:(i + 1) * b] = blocks[i]
        for i in range(m - 1):
            dense[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = u[i]
            dense[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = u[i].T
        rhs = rng.randn(m, b, 2)
        x = np.asarray(banded.block_tridiag_solve(
            jnp.asarray(np.stack(blocks)), jnp.asarray(u), jnp.asarray(rhs)))
        x_dense = np.linalg.solve(dense, rhs.reshape(m * b, 2)).reshape(m, b, 2)
        np.testing.assert_allclose(x, x_dense, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("k,dim,seed", [(2, 3, 0), (5, 3, 1), (10, 3, 2),
                                        (50, 1, 3), (100, 3, 4)])
def test_banded_matches_dense_solver(k, dim, seed):
    verts = mtg.create_random_vertices(H - 1, k, -10 * np.ones(dim),
                                       10 * np.ones(dim), seed)
    structure, values = mtg.structure_from_vertices(verts, N, mtg.SNAP)
    times = jnp.asarray(mtg.estimate_segment_times(verts, 3.0, 5.0))
    df = mtg.extract_fixed_values(structure, jnp.asarray(values))
    dense = mtg.solve_linear(structure, df, times)
    fast = banded.solve_linear_banded(structure, df, times)
    scale = float(jnp.max(jnp.abs(dense.coefficients)))
    np.testing.assert_allclose(np.asarray(fast.coefficients),
                               np.asarray(dense.coefficients),
                               rtol=1e-8, atol=1e-10 * scale)
    assert float(fast.cost) == pytest.approx(float(dense.cost), rel=1e-9)


def test_banded_free_interior_family():
    # The QCQP's free-interior pattern also has a uniform interior.
    k = 20
    structure = sm.make_structure(sm.free_interior_mask(k + 1, N), 3, N)
    rng = np.random.RandomState(7)
    waypoints = np.cumsum(rng.uniform(0.5, 1.5, size=(k + 1, 3)), axis=0)
    values = np.zeros((k + 1, H, 3))
    values[0, 0] = waypoints[0]
    values[-1, 0] = waypoints[-1]
    times = jnp.asarray(mtg.segment_times_nfabian(waypoints, 2.0, 2.0))
    df = mtg.extract_fixed_values(structure, jnp.asarray(values))
    dense = mtg.solve_linear(structure, df, times)
    fast = banded.solve_linear_banded(structure, df, times)
    # The unconstrained free-interior system is poorly conditioned (interior
    # positions unpinned), so agreement is looser than the standard family.
    scale = float(jnp.max(jnp.abs(dense.coefficients)))
    np.testing.assert_allclose(np.asarray(fast.coefficients),
                               np.asarray(dense.coefficients),
                               rtol=1e-5, atol=1e-6 * scale)


def test_banded_rejects_nonuniform():
    mask = sm.standard_mask(6, N)
    mask[2, 1] = True   # break uniformity
    structure = sm.make_structure(mask, 3, N)
    assert banded.uniform_interior_pattern(structure) is None
    with pytest.raises(ValueError):
        banded.solve_linear_banded(structure, jnp.zeros((structure.n_fixed, 3)),
                                   jnp.ones(5))


def test_banded_vmap():
    k = 30
    structure = sm.make_structure(sm.standard_mask(k + 1, N), 3, N)
    rng = np.random.RandomState(9)
    batch = 4
    waypoints = np.cumsum(rng.uniform(0.5, 1.5, size=(batch, k + 1, 3)),
                          axis=1)
    values = np.zeros((batch, k + 1, H, 3))
    values[:, :, 0] = waypoints
    times = jnp.asarray(mtg.segment_times_nfabian(waypoints, 2.0, 2.0))
    df = mtg.extract_fixed_values(structure, jnp.asarray(values))
    out = jax.vmap(lambda a, b: banded.solve_linear_banded(structure, a, b))(
        df, times)
    ref = jax.vmap(lambda a, b: mtg.solve_linear(structure, a, b))(df, times)
    np.testing.assert_allclose(np.asarray(out.cost), np.asarray(ref.cost),
                               rtol=1e-8)


def test_spd_block_tridiag_inverse_matches_dense():
    """Block-Thomas inverse vs the dense Schur inverse on SPD
    block-tridiagonal matrices (the QCQP stage-KKT structure)."""
    from mav_tube_trajectory_generation.ops import linalg
    rng = np.random.RandomState(0)
    m, b = 9, 15
    n = m * b
    a = np.zeros((3, n, n))
    for i in range(m):
        q = rng.randn(3, b, b)
        a[:, i*b:(i+1)*b, i*b:(i+1)*b] = q @ np.swapaxes(q, -1, -2) \
            + 10 * np.eye(b)
    for i in range(m - 1):
        c = 0.5 * rng.randn(3, b, b)
        a[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b] = c
        a[:, (i+1)*b:(i+2)*b, i*b:(i+1)*b] = np.swapaxes(c, -1, -2)
    w = np.asarray(banded.spd_block_tridiag_inverse(jnp.asarray(a), b))
    resid = a @ w - np.eye(n)
    assert np.abs(resid).max() < 1e-10      # f64 under tests' x64 config
    dense = np.asarray(linalg.spd_inverse_schur(jnp.asarray(a)))
    np.testing.assert_allclose(w, dense, rtol=1e-7, atol=1e-9)


def test_spd_block_tridiag_factor_solve():
    """Factor + single-rhs solve (the IPM Newton path) vs the full inverse."""
    rng = np.random.RandomState(2)
    m, b = 9, 15
    n = m * b
    a = np.zeros((2, n, n))
    for i in range(m):
        q = rng.randn(2, b, b)
        a[:, i*b:(i+1)*b, i*b:(i+1)*b] = q @ np.swapaxes(q, -1, -2) \
            + 10 * np.eye(b)
    for i in range(m - 1):
        c = 0.5 * rng.randn(2, b, b)
        a[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b] = c
        a[:, (i+1)*b:(i+2)*b, i*b:(i+1)*b] = np.swapaxes(c, -1, -2)
    dblk = jnp.asarray(np.stack(
        [a[:, i*b:(i+1)*b, i*b:(i+1)*b] for i in range(m)], axis=1))
    ublk = jnp.asarray(np.stack(
        [a[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b] for i in range(m - 1)], axis=1))
    rhs = jnp.asarray(rng.randn(2, n, 3))
    s_inv, t = banded.spd_block_tridiag_factor(dblk, ublk)
    x = np.asarray(banded.spd_block_tridiag_solve_factored(s_inv, t, rhs))
    resid = a @ x - np.asarray(rhs)
    assert np.abs(resid).max() < 1e-9
    w = np.asarray(banded.spd_block_tridiag_inverse(jnp.asarray(a), b))
    np.testing.assert_allclose(x, w @ np.asarray(rhs), rtol=1e-7, atol=1e-9)


def test_qcqp_kkt_is_block_tridiagonal():
    """The structured KKT-inverse fast path's load-bearing assumption:
    kron(R_pp, I3) + rho G^T G is EXACTLY block-tridiagonal in vertex-major
    free-column order for the free-interior family."""
    from mav_tube_trajectory_generation.solver import qcqp, linear
    k = 6
    free = sm.make_structure(sm.free_interior_mask(k + 1, N), 3, N)
    blk = qcqp._kkt_tridiag_block(free)
    assert blk == 3 * H
    rng = np.random.RandomState(1)
    wp = np.cumsum(rng.uniform(0.5, 2.0, size=(k + 1, 3)), axis=0)
    vals = np.zeros((k + 1, H, 3)); vals[:, 0] = wp
    times = jnp.asarray(mtg.segment_times_nfabian(wp[None], 3.0, 5.0))[0]
    df = mtg.extract_fixed_values(free, jnp.asarray(vals))
    layout = qcqp._flagship_layout(free)
    cfg = qcqp.ADMMConfig(rho=0.01, padded_lanes=True)
    pre = qcqp._padded_pre(free, df, times, jnp.asarray(wp),
                           jnp.full((k, 2), 0.7), cfg, None, layout)
    gt = np.asarray(pre.gt, np.float64)
    kkt = np.asarray(pre.p_big, np.float64) + 0.01 * (gt @ gt.T)
    m = kkt.shape[0] // blk
    for i in range(m):
        for j in range(m):
            if abs(i - j) > 1:
                blkij = kkt[i*blk:(i+1)*blk, j*blk:(j+1)*blk]
                assert np.abs(blkij).max() == 0.0, (i, j)
