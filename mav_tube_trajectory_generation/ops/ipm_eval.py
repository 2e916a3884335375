"""IPM Newton-step evaluation in the padded lane layout, as plain ``jax.numpy``.

The interior-point polish (solver/ipm_lanes.py) evaluates, per Newton step,
everything it needs from the constraint tensor G^T in the SAME padded
component-plane lane layout as the ADMM stage (ops/admm_stage.py,
solver/qcqp._PadLayout): lanes [ball-x | ball-y | ball-z | half], ball
constraint i at lane c*nb_p + i of plane c, packed half-space rows in the
ball planes' tails.

Per step ``ipm_eval_step`` returns

  y      = G x + b                       (constraint-space point)
  c      = constraint values in LANE layout (ball values replicated over the
           3 planes, halves in place, pads carry y=0)
  jtwr2  = J^T (w * r2)                  (the Jacobian part of the affine
           Newton rhs; J^T lam cancels against r1's +J^T lam)
  jts    = J^T (1/s)                     (so the Mehrotra corrector rhs is
           rhs_a - sigma*mu * jts -- no second pass)
  gd, gu = the block-tridiagonal BAND of the weighted Gram
           J^T W J + sum_i lam_i G_i^T G_i, as stacked diagonal and
           super-diagonal vertex blocks -- the only part the band factor
           reads; the full (nfd, nfd) Gram is never formed.

Jacobian rows are never materialized: for ball i, J_i = sum_c y_ic G_ic, so
every J^T v is a lane-weighted reduce of G^T (weights v_i y_ic on ball lanes,
v_j on half lanes), and the J-row Gram term uses the derived plane matrix
aj = sum_c gt_c * y_c (ball lanes of plane 0; halves as-is).

Reference: the role of Mosek's per-iteration task data
(qcqp_impl.h:477-788); the math matches solver/ipm.solve_qcqp_ipm.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg import gram_band

#: Name scope of every evaluation's ops in traces
#: (benchmarks/stage_profile.py).
SCOPE = "ipm_eval"


def _eval_core(gt, b, rb, x, s, lam, *, nb_p: int, n_ball: int,
               w_cap: float, phr: bool = False):
    """Lane-layout evaluation at (x, s, lam).

    gt: (S, nfd, m_p); b/s/lam: (S, 1, m_p); rb: (S, 1, nb_p);
    x: (S, nfd, 1).  Returns (y, c, jtwr2, jts, lam_ball, aj, w_aj) where
    the weighted Gram is (gt*lam_ball) @ gt^T + (aj*w_aj) @ aj^T.

    phr=True switches to the clipped-penalty (PHR) evaluation used by the
    feasibility snap (solver/ipm_lanes): with s fed as lam/rho, w*r2
    equals the multiplier estimate lam + rho*c, CLIPPED at zero -- jtwr2
    becomes J^T max(lam + rho c, 0) (Gauss-Newton pull on violated rows
    only), the Gram keeps weight rho on every lam > 0 row (tangency
    stiffness for near-boundary rows the caller floors), and the curvature
    weight is the clipped estimate instead of lam.
    """
    m_p = gt.shape[-1]
    y = jnp.sum(gt * x, axis=-2, keepdims=True) + b       # (S, 1, m_p)
    yx = y[..., 0:nb_p]
    yy = y[..., nb_p:2 * nb_p]
    yz = y[..., 2 * nb_p:3 * nb_p]
    cb = 0.5 * (yx * yx + yy * yy + yz * yz - rb * rb)    # (S, 1, nb_p)
    ball = jnp.arange(nb_p) < n_ball
    # c in lane layout: ball lanes carry the (replicated) ball value, the
    # packed half lanes their own y.  Pads have y=0, b=0 -> c = -0.5 rb^2;
    # the caller masks pads out of every lane reduce.
    parts = [jnp.where(ball, cb, yx), jnp.where(ball, cb, yy),
             jnp.where(ball, cb, yz)]
    if m_p > 3 * nb_p:
        parts.append(y[..., 3 * nb_p:])
    c = jnp.concatenate(parts, axis=-1)                   # (S, 1, m_p)

    s_safe = jnp.maximum(s, 1e-14)
    r2 = c + s
    w = jnp.minimum(lam / s_safe, w_cap)                  # (S, 1, m_p)

    # ymul: ball lanes y_ic, half lanes 1, pads 0 (gt is 0 there anyway).
    ones = jnp.ones_like(yx)
    parts_m = [jnp.where(ball, yx, ones), jnp.where(ball, yy, ones),
               jnp.where(ball, yz, ones)]
    if m_p > 3 * nb_p:
        parts_m.append(jnp.ones_like(y[..., 3 * nb_p:]))
    ymul = jnp.concatenate(parts_m, axis=-1)

    if phr:
        # Clipped PHR multiplier estimate drives the gradient.  The Gram
        # keeps weight w = rho on EVERY lam > 0 lane (not just estimate-
        # positive ones): the feasibility snap floors lam on near-boundary
        # rows so their rho J J^T stiffness keeps the step TANGENT to
        # boundaries it would otherwise push through, with no rhs force.
        m_est = jnp.maximum(w * r2, 0.0)      # max(lam + rho c, 0) per lane
        jtwr2 = jnp.sum(gt * (m_est * ymul), axis=-1, keepdims=True)
    else:
        jtwr2 = jnp.sum(gt * (w * r2 * ymul), axis=-1, keepdims=True)
    jts = jnp.sum(gt * (ymul / s_safe), axis=-1, keepdims=True)

    # Curvature part sum_i lam_i sum_c G_ic G_ic^T: one-sided lane scale of
    # gt (ball lanes only).  J-row part: aj holds J_i on plane-0 ball lanes,
    # the half rows as-is, zeros elsewhere; weight w per matching lane.
    zeros = jnp.zeros_like(yx)
    curv = m_est if phr else lam              # ball-curvature lane weights
    lam_ball = jnp.concatenate(
        [jnp.where(ball, curv[..., 0:nb_p], zeros),
         jnp.where(ball, curv[..., nb_p:2 * nb_p], zeros),
         jnp.where(ball, curv[..., 2 * nb_p:3 * nb_p], zeros)]
        + ([jnp.zeros_like(y[..., 3 * nb_p:])] if m_p > 3 * nb_p else []),
        axis=-1)

    gtx = gt[..., 0:nb_p]
    gty = gt[..., nb_p:2 * nb_p]
    gtz = gt[..., 2 * nb_p:3 * nb_p]
    j_plane0 = gtx * yx + gty * yy + gtz * yz             # (S, nfd, nb_p)
    aj_parts = [jnp.where(ball, j_plane0, gtx),
                jnp.where(ball, 0.0, gty),
                jnp.where(ball, 0.0, gtz)]
    if m_p > 3 * nb_p:
        aj_parts.append(gt[..., 3 * nb_p:])
    aj = jnp.concatenate(aj_parts, axis=-1)               # (S, nfd, m_p)
    # Plane 0 keeps w as-is: ball lanes carry the ball w (replicated lane
    # vector), tail lanes their packed half w.
    w_aj_parts = [w[..., 0:nb_p],
                  jnp.where(ball, zeros, w[..., nb_p:2 * nb_p]),
                  jnp.where(ball, zeros, w[..., 2 * nb_p:3 * nb_p])]
    if m_p > 3 * nb_p:
        w_aj_parts.append(w[..., 3 * nb_p:])
    w_aj = jnp.concatenate(w_aj_parts, axis=-1)
    return y, c, jtwr2, jts, lam_ball, aj, w_aj


def ipm_eval_step(gt, b, rb, x, s, lam, *, nb_p: int, n_ball: int,
                  band_block: int, w_cap: float = 1e10, phr: bool = False):
    """One IPM evaluation at (x, s, lam) in the padded lane layout.

    Args:
      gt: (S, nfd, m_p) equilibrated G^T in the padded plane layout.
      b: (S, 1, m_p).  rb: (S, 1, nb_p) scaled ball radii (pads 1).
      x: (S, nfd, 1).  s, lam: (S, 1, m_p) slack/multiplier LANE vectors
        (ball entries replicated across the 3 planes, pads s=1, lam=0).
      band_block: vertex block size of the block-tridiagonal weighted Gram
        (banded.kkt_tridiag_block).

    Returns (y, c, jtwr2, jts, gd, gu) per the module docstring.
    """
    with jax.named_scope(SCOPE):
        y, c, jtwr2, jts, lam_ball, aj, w_aj = _eval_core(
            gt, b, rb, x, s, lam, nb_p=nb_p, n_ball=n_ball, w_cap=w_cap,
            phr=phr)
        gd1, gu1 = gram_band(gt * lam_ball, gt, band_block)
        gd2, gu2 = gram_band(aj * w_aj, aj, band_block)
        return y, c, jtwr2, jts, gd1 + gd2, gu1 + gu2
