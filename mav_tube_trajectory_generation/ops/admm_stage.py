"""One ADMM stage of the padded-lane tube QCQP, as plain ``jax.numpy``.

A stage runs ``n_iters`` over-relaxed ADMM iterations against two
per-scenario matrices stored in the same (nfd, m_p) orientation,

    x_col (nfd, 1) = sum_lanes   ( M1 (nfd, m_p) * v_row (1, m_p) )
    y_row (1, m_p) = sum_sublane ( Gt (nfd, m_p) * x_col (nfd, 1) )

where M1 = W^{-1} G^T (the KKT inverse applied to G^T) and Gt = G^T.  Both
matvecs are broadcast-multiply-reduce: exact float32 arithmetic whatever the
matmul precision context, and the alternating row/column vector orientation
needs no transposes.  Every matvec streams its matrix once, so a stage moves
about 2 * n_iters * nfd * m_p * 4 bytes per scenario.

Every array carries a leading scenario axis S (any batch shape in front of
the per-scenario shapes broadcasts the same way).

Constraint vector layout (lanes): [ball-x | ball-y | ball-z | half], each
ball plane nb_p lanes with lanes >= n_ball carrying packed half-space rows
(solver.qcqp._PadLayout).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST

#: Name scope of every stage's ops in traces (benchmarks/stage_profile.py).
SCOPE = "admm_stage"


def _project(w, rb, nb_p: int, n_ball: int):
    """Projection onto balls x half-lines in the padded lane layout: lanes
    < n_ball of each ball plane are the coupled (x, y, z) ball rows; lanes
    >= n_ball are packed half-space rows, projected by min(., 0)."""
    wx = w[..., 0:nb_p]
    wy = w[..., nb_p:2 * nb_p]
    wz = w[..., 2 * nb_p:3 * nb_p]
    sq = wx * wx + wy * wy + wz * wz
    scale = jnp.where(sq > rb * rb,
                      rb * jax.lax.rsqrt(jnp.maximum(sq, 1e-30)), 1.0)
    ball = jnp.arange(nb_p) < n_ball
    parts = [jnp.where(ball, wx * scale, jnp.minimum(wx, 0.0)),
             jnp.where(ball, wy * scale, jnp.minimum(wy, 0.0)),
             jnp.where(ball, wz * scale, jnp.minimum(wz, 0.0))]
    if w.shape[-1] > 3 * nb_p:   # final half-space plane (may be absent)
        parts.append(jnp.minimum(w[..., 3 * nb_p:], 0.0))
    return jnp.concatenate(parts, axis=-1)


def _stage_core(rho, m1, gt, b, rb, xq, x0, z0, u0, *, n_iters: int,
                alpha: float, nb_p: int, n_ball: int, init_z: bool):
    """Iteration chain, z/u warm-start init, final y = G x + b and the
    dual-residual matvec.  Returns (x, z, z_prev, u, prim, dual_mv, y)."""
    gx = lambda x: jnp.sum(gt * x, axis=-2, keepdims=True) + b

    def body(_, carry):
        x, z, zp, u, prim, y = carry
        v = z - u - b                                     # (S, 1, m_p)
        x_new = xq + rho * jnp.sum(m1 * v, axis=-1, keepdims=True)
        y = gx(x_new)
        y_rel = alpha * y + (1.0 - alpha) * z
        z_new = _project(y_rel + u, rb, nb_p, n_ball)
        u_new = u + y_rel - z_new
        prim = jnp.max(jnp.abs(y - z_new), axis=-1, keepdims=True)
        return x_new, z_new, z, u_new, prim, y

    y0 = gx(x0)
    if init_z:
        z_init = _project(y0, rb, nb_p, n_ball)
        u_init = jnp.zeros_like(z_init)
    else:
        z_init, u_init = z0, u0
    # Initial values derive from the data (full_like), so the carry keeps
    # the data's sharding type inside shard_map.
    init = (x0, z_init, z_init, u_init,
            jnp.full_like(x0[..., :1, :], jnp.inf, jnp.float32), y0)
    x, z, zp, u, prim, y = jax.lax.fori_loop(0, n_iters, body, init)
    # Dual-residual matvec G^T dz, max-reduced.
    gdz = jnp.sum(gt * (z - zp), axis=-1, keepdims=True)  # (S, nfd, 1)
    dual = jnp.max(jnp.abs(gdz), axis=-2, keepdims=True)  # (S, 1, 1)
    return x, z, zp, u, prim, dual, y


def admm_stage(rho, winv, gt, b, rb, xq, x0, z0=None, u0=None, *,
               n_iters: int, alpha: float, nb_p: int, n_ball: int,
               init_z: bool = True):
    """ADMM stage from a dense KKT inverse: m1 = winv @ gt, the iteration
    chain, z/u init from the warm start (init_z=True; pass z0/u0 and
    init_z=False for stage > 0), and the final y / dual-residual matvecs.

    Args:
      rho: (S, 1, 1).  winv: (S, nfd, nfd) KKT inverse.  gt: (S, nfd, m_p).
      b: (S, 1, m_p).  rb: (S, 1, nb_p).  xq: (S, nfd, 1).  x0: (S, nfd, 1).
      z0/u0: (S, 1, m_p), read only when init_z=False.
      n_ball: lanes < n_ball of each ball plane are ball rows; the rest are
        packed half-space rows.

    Returns:
      (x (S, nfd, 1), z, z_prev, u (S, 1, m_p), prim (S, 1, 1),
       dual_matvec_max (S, 1, 1) -- multiply by rho for the dual residual,
       y (S, 1, m_p) = G x + b).
    """
    with jax.named_scope(SCOPE):
        m1 = jnp.matmul(winv, gt, precision=_HIGHEST)
        return _stage_core(rho, m1, gt, b, rb, xq, x0, z0, u0,
                           n_iters=n_iters, alpha=alpha, nb_p=nb_p,
                           n_ball=n_ball, init_z=init_z)


def factored_m1(sinv, t, tt, gt):
    """m1 = W^{-1} G^T from the block-LDL^T KKT factors by block-Thomas
    sweeps: forward (I+L) y = G^T, diagonal z = S^{-1} y, backward
    (I+L)^T x = z.  The dense (nfd, nfd) inverse is never formed.

    sinv: (S, m, b, b) inverted pivot blocks; t/tt: (S, m-1, b, b) with
    t[:, i-1] = T_i = U_{i-1}^T S_{i-1}^{-1} and tt its transpose
    (banded.spd_block_tridiag_factor).  gt: (S, m*b, m_p).
    """
    dot = lambda a, c: jnp.matmul(a, c, precision=_HIGHEST)
    m_blk = sinv.shape[-3]
    bsz = sinv.shape[-1]
    y_p = []
    for i in range(m_blk):
        r_i = gt[..., i * bsz:(i + 1) * bsz, :]
        if i:
            r_i = r_i - dot(t[..., i - 1, :, :], y_p[i - 1])
        y_p.append(r_i)
    z_p = [dot(sinv[..., i, :, :], y_p[i]) for i in range(m_blk)]
    x_p = [None] * m_blk
    x_p[m_blk - 1] = z_p[m_blk - 1]
    for i in range(m_blk - 2, -1, -1):
        x_p[i] = z_p[i] - dot(tt[..., i, :, :], x_p[i + 1])
    return jnp.concatenate(x_p, axis=-2)


def admm_stage_factored(rho, sinv, t, tt, gt, b, rb, xq, x0, z0=None,
                        u0=None, *, n_iters: int, alpha: float, nb_p: int,
                        n_ball: int, init_z: bool = True):
    """ADMM stage from block-LDL^T KKT factors (``factored_m1``).

    Args:
      rho: (S, 1, 1).  sinv: (S, m, b, b) pivot-block inverses.
      t/tt: (S, m-1, b, b) subdiagonal factors T_i and their transposes
      (banded.spd_block_tridiag_factor).  gt: (S, nfd, m_p) with
      nfd = m * b.  b: (S, 1, m_p).  rb: (S, 1, nb_p).  xq/x0: (S, nfd, 1).

    Returns: same tuple as ``admm_stage``.
    """
    with jax.named_scope(SCOPE):
        m1 = factored_m1(sinv, t, tt, gt)
        return _stage_core(rho, m1, gt, b, rb, xq, x0, z0, u0,
                           n_iters=n_iters, alpha=alpha, nb_p=nb_p,
                           n_ball=n_ball, init_z=init_z)
