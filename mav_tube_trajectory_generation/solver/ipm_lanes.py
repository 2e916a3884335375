"""Plane-layout batched IPM: the Mosek-grade polish at batch throughput.

Same primal-dual interior-point method as solver/ipm.solve_qcqp_ipm (Mehrotra
predictor-corrector, fraction-to-boundary, best-iterate tracking, Farkas-style
infeasibility evidence), re-laid-out for a batched accelerator:

  * The constraint system lives in the SAME padded component-plane layout as
    the ADMM stage (solver/qcqp._PadLayout: lanes [ball-x|ball-y|ball-z|
    half], packed half rows in the ball planes' tails) -- assembled once by
    qcqp._padded_constraint_system, no build_constraints tensors, no
    per-step Jacobian/weighted-row materialization.
  * Per Newton step, one evaluation (ops/ipm_eval.ipm_eval_step) reads G^T
    and emits y, c, the Jacobian-transposed rhs pieces, and only the
    block-tridiagonal BAND of the weighted Gram; the rest is small-tensor
    work (the band factorization, the factored solves, the G dx matvecs,
    and the scalar step logic).  The row-layout path streamed the
    constraint tensors ~8x per step.
  * Slacks/multipliers are LANE vectors (ball values replicated over the 3
    planes, pads pinned inert), so every per-constraint update is a fused
    elementwise op and the fraction-to-boundary/complementarity reductions
    are single lane reduces with static count weights.

Intended use: `solve_qcqp_polished_batch` -- ADMM throughput solve + this
polish = the per-solve feasibility-semantics match to the reference's Mosek
backend (qcqp_impl.h:477-788) at batch throughput.  float32; for f64
ground-truth studies use solver/ipm.solve_qcqp_ipm (row layout).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ipm_eval
from . import banded, linear
from .ipm import IPMConfig
from .qcqp import (ADMMConfig, QCQPSolution, _PadLayout, _flagship_layout,
                   _objective_blocks, _padded_constraint_system)
from .structure import ProblemStructure


class _LaneMaps(NamedTuple):
    act: np.ndarray        # (m_p,) 1.0 on real constraint lanes, 0 pads
    cw: np.ndarray         # (m_p,) count weights: 1 on plane-0 balls + halves
    lane_src: np.ndarray   # (m_p,) int32 into [ball | half | zero-pad]
    half_lane: np.ndarray  # (n_half,) int32 lane index of half row h


_LANE_MAP_CACHE: dict = {}


def _lane_maps(layout: _PadLayout) -> _LaneMaps:
    maps = _LANE_MAP_CACHE.get(layout)
    if maps is not None:
        return maps
    m_p, nb_p, n_ball, n_half = (layout.m_p, layout.nb_p, layout.n_ball,
                                 layout.n_half)
    act = np.zeros(m_p, np.float32)
    cw = np.zeros(m_p, np.float32)
    lane_src = np.full(m_p, n_ball + n_half, np.int32)
    half_lane = np.zeros(n_half, np.int32)
    for c in range(3):
        act[c * nb_p:c * nb_p + n_ball] = 1.0
        lane_src[c * nb_p:c * nb_p + n_ball] = np.arange(n_ball)
    cw[:n_ball] = 1.0
    for (c, lane0, off, ln) in layout.half_chunks():
        base = c * nb_p if c < 3 else 3 * nb_p
        lanes = base + lane0 + np.arange(ln)
        act[lanes] = 1.0
        cw[lanes] = 1.0
        lane_src[lanes] = n_ball + off + np.arange(ln)
        half_lane[off:off + ln] = lanes
    maps = _LaneMaps(act=act, cw=cw, lane_src=lane_src, half_lane=half_lane)
    _LANE_MAP_CACHE[layout] = maps
    return maps


def _finite_step_mask(alpha, ds, dlam):
    """Per-scenario update gate: True only where the step length is positive
    AND the Newton direction is finite.

    A NaN direction makes every fraction-to-boundary ratio inf (NaN < 0
    compares False), so alpha alone comes back as a *finite* 1.0 and an
    `isfinite(alpha)` guard never fires -- the NaN must be caught on the
    direction itself or it permanently poisons the running s/lam/y state
    (and with it the dual outputs and the dynamic infeasibility
    certificate).  dx finiteness is implied: ds = (-r2 - jdx) and
    dlam = ... - w*ds both contain G dx terms.
    """
    finite = jnp.all(jnp.isfinite(ds) & jnp.isfinite(dlam), axis=-1,
                     keepdims=True)
    return (alpha > 0) & finite


def _c_lanes(y, rb_pad, nb_p: int, n_ball: int):
    """Constraint values in lane layout from y = G x + b (batched (..., m_p)).
    Ball values replicated over the 3 planes; halves in place."""
    yx = y[..., 0:nb_p]
    yy = y[..., nb_p:2 * nb_p]
    yz = y[..., 2 * nb_p:3 * nb_p]
    cb = 0.5 * (yx * yx + yy * yy + yz * yz - rb_pad * rb_pad)
    ball = (np.arange(nb_p) < n_ball)[None, :]
    parts = [jnp.where(ball, cb, yx), jnp.where(ball, cb, yy),
             jnp.where(ball, cb, yz)]
    if y.shape[-1] > 3 * nb_p:
        parts.append(y[..., 3 * nb_p:])
    return jnp.concatenate(parts, axis=-1)


def _jdx_lanes(gdx, y, nb_p: int, n_ball: int):
    """J dx in lane layout from gdx = G dx: ball lanes sum_c y_c gdx_c
    (replicated), half lanes gdx as-is."""
    jb = (y[..., 0:nb_p] * gdx[..., 0:nb_p]
          + y[..., nb_p:2 * nb_p] * gdx[..., nb_p:2 * nb_p]
          + y[..., 2 * nb_p:3 * nb_p] * gdx[..., 2 * nb_p:3 * nb_p])
    ball = (np.arange(nb_p) < n_ball)[None, :]
    parts = [jnp.where(ball, jb, gdx[..., c * nb_p:(c + 1) * nb_p])
             for c in range(3)]
    if y.shape[-1] > 3 * nb_p:
        parts.append(gdx[..., 3 * nb_p:])
    return jnp.concatenate(parts, axis=-1)


def _equilibrated_band_solve(hd, hu):
    """Jacobi-equilibrated block-tridiagonal factor + solve.

    The penalty/complementarity-weighted Newton Hessians put O(rho) entries
    next to O(1) curvature blocks; the unpivoted f32 block-LDL^T factor
    loses the solve entirely at that scale spread (measured: dx flips to an
    ASCENT direction on scenarios with a stiff active set).  Scaling to a
    unit diagonal first (D H D, with the band transformed in place) bounds
    the factored system's condition like every other solver in this
    package.  Returns a solve(rhs_col) closure over the factors.
    """
    diag = jnp.diagonal(hd, axis1=-2, axis2=-1).reshape(hd.shape[0], -1)
    d = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))            # (B, n)
    blk = hd.shape[-1]
    m = hd.shape[1]
    db = d.reshape(d.shape[0], m, blk)
    hd_s = hd * db[:, :, :, None] * db[:, :, None, :]
    hu_s = hu * db[:, :-1, :, None] * db[:, 1:, None, :]
    s_inv, t_fac = banded.spd_block_tridiag_factor(hd_s, hu_s)

    def solve(rhs_col):
        z = banded.spd_block_tridiag_solve_factored(
            s_inv, t_fac, rhs_col * d[:, :, None])
        return z * d[:, :, None]

    return solve


def _pe_band(p_eq, dim: int, blk: int):
    """Batched kron-expanded band of kron(p_eq, I_dim): (B, m, blk, blk)
    diagonal and (B, m-1, blk, blk) super blocks."""
    b = p_eq.shape[0]
    bp = blk // dim
    m_blk = p_eq.shape[-1] // bp
    eye_d = jnp.eye(dim, dtype=p_eq.dtype)
    pe = p_eq.reshape(b, m_blk, bp, m_blk, bp)
    pe_d = jnp.stack([pe[:, i, :, i, :] for i in range(m_blk)], axis=1)
    pe_u = jnp.stack([pe[:, i, :, i + 1, :] for i in range(m_blk - 1)],
                     axis=1)
    kron = lambda a: jnp.einsum('smab,cd->smacbd', a, eye_d).reshape(
        b, a.shape[1], blk, blk)
    return kron(pe_d), kron(pe_u)


def _lanes_setup(structure, d_fixed, times, waypoints, radii, x0, layout):
    """Per-scenario objective blocks + padded constraint system, batched and
    cast to float32."""
    f32 = jnp.float32
    obj_cfg = ADMMConfig()          # only .sigma is read (cold-start solve)

    def setup_one(df, t, w, r, xx):
        p_eq, q_eq, d_scale, x_init = _objective_blocks(
            structure, df, t, obj_cfg, xx, f32)
        gt, b_pad, rb, sb, sh = _padded_constraint_system(
            structure, t, df, w, r, d_scale, layout)
        return (p_eq.astype(f32), q_eq.astype(f32), d_scale.astype(f32),
                x_init.astype(f32), gt, b_pad, rb.astype(f32),
                sb.astype(f32), sh.astype(f32))

    if x0 is None:
        return jax.vmap(lambda df, t, w, r: setup_one(df, t, w, r, None))(
            d_fixed, times, waypoints, radii)
    return jax.vmap(setup_one)(d_fixed, times, waypoints, radii,
                               jnp.asarray(x0, f32))


@linear.full_matmul_precision
def solve_qcqp_ipm_lanes(structure: ProblemStructure,
                         d_fixed: jnp.ndarray,
                         times: jnp.ndarray,
                         waypoints: jnp.ndarray,
                         radii: jnp.ndarray,
                         config: IPMConfig = IPMConfig(),
                         x0: Optional[jnp.ndarray] = None,
                         lam0_ball: Optional[jnp.ndarray] = None,
                         lam0_half: Optional[jnp.ndarray] = None,
                         scenario_block: int = 4,
                         pre=None,
                         pre_penalty=None) -> QCQPSolution:
    """Batched plane-layout IPM solve (ALL args carry a leading batch axis).

    Same semantics as ``jax.vmap(ipm.solve_qcqp_ipm)`` for the flagship
    (free-interior, D=3, block-tridiagonal) family, float32.  See the module
    docstring for the layout/performance story.

    ``pre``: a qcqp._PaddedPre bundle from solve_qcqp_batch(_return_pre=
    True) -- the ADMM's already-assembled padded system.  Its row scales
    carry the ADMM's per-family penalty factors (sqrt(f) baked in); pass
    the (f_sphere, f_tube, f_half) triple as ``pre_penalty`` and the
    system is converted back to the penalty-free form by STATIC per-lane
    multipliers (qcqp.penalty_unscale_maps) -- one broadcast multiply
    over G^T instead of a second assembly + relayout chain.
    """
    from .banded import kkt_tridiag_block
    blk = kkt_tridiag_block(structure)
    if blk is None or structure.dimension != 3:
        raise ValueError("lanes IPM requires the flagship free-interior "
                         "3-D family (block-tridiagonal KKT).")
    f32 = jnp.float32
    d_fixed = jnp.asarray(d_fixed, f32)
    times = jnp.asarray(times, f32)
    waypoints = jnp.asarray(waypoints, f32)
    radii = jnp.asarray(radii, f32)

    n_free = structure.n_free
    dim = structure.dimension
    nfd = n_free * dim
    layout = _flagship_layout(structure)
    maps = _lane_maps(layout)
    nb_p, n_ball, n_half, m_p = (layout.nb_p, layout.n_ball, layout.n_half,
                                 layout.m_p)
    mc = n_ball + n_half
    act = jnp.asarray(maps.act)[None, :]                   # (1, m_p)
    cw = jnp.asarray(maps.cw)[None, :]
    lane_src = jnp.asarray(maps.lane_src)
    half_lane = jnp.asarray(maps.half_lane)

    # f32 endgame safeguards (measured on the flagship family): Mehrotra's
    # unrestricted steps drive mu to ~1e-5 within 3 warm-started iterations,
    # where float32 can no longer evaluate r2 = c + s consistently against
    # complementarity weights w = lam/s spanning ~7 decades -- the Newton
    # directions blow up and the fraction-to-boundary collapses to alpha ~ 0
    # (the rows-layout path has the same failure mode and survives on
    # best-iterate luck).  A sigma floor + step cap keep mu's decrease
    # geometric-but-bounded, and the tighter w cap bounds the Newton system's
    # condition number to what f32 factorization can actually deliver.
    sigma_min = config.sigma_min
    alpha_max = config.alpha_max
    w_cap = config.w_cap

    orig_b = d_fixed.shape[0]
    s_blk = scenario_block
    bsz = ((orig_b + s_blk - 1) // s_blk) * s_blk
    if bsz != orig_b:
        # Pad to a scenario-block multiple by repeating the last scenario
        # (valid data, so the pad rows solve cleanly); outputs are sliced
        # back below.  Same contract as qcqp.solve_qcqp_batch.
        def _pad(a):
            if a is None:
                return None
            a = jnp.asarray(a, f32)
            return jnp.concatenate(
                [a, jnp.repeat(a[-1:], bsz - orig_b, axis=0)], axis=0)
        d_fixed, times, waypoints, radii, x0, lam0_ball, lam0_half = (
            _pad(a) for a in (d_fixed, times, waypoints, radii, x0,
                              lam0_ball, lam0_half))

    if pre is not None:
        from .qcqp import penalty_unscale_maps
        if pre_penalty is None:
            pre_penalty = (1.0, 1.0, 1.0)
        lane_r, ball_r, half_r = penalty_unscale_maps(
            structure, layout, *pre_penalty)
        lane_rj = jnp.asarray(lane_r)[None, None, :]
        if bsz != orig_b:
            pre = type(pre)(*(_pad(f) for f in pre))
        # The pre bundle's objective blocks carry the CALLER's dtype (f64
        # under an x64 dry run); the lanes path is f32 throughout.
        p_eq = jnp.asarray(pre.p_eq, f32)
        q_eq = jnp.asarray(pre.q_flat, f32).reshape(bsz, n_free, dim)
        d_scale = jnp.asarray(pre.d_scale, f32)
        # x0 is the tier-0 solution's d_free (true space); rescale like
        # _objective_blocks does.
        x_init = (jnp.asarray(x0, f32)
                  / d_scale[:, :, None]) if x0 is not None else None
        gt = jnp.asarray(pre.gt, f32) * lane_rj
        b_pad = jnp.asarray(pre.b_pad, f32) * lane_rj      # (B, 1, m_p)
        rb = jnp.asarray(pre.rb, f32) * jnp.asarray(ball_r)[None, :]
        sb = jnp.asarray(pre.sb, f32) * jnp.asarray(ball_r)[None, :]
        sh = jnp.asarray(pre.sh, f32) * jnp.asarray(half_r)[None, :]
        if x_init is None:
            raise ValueError("pre reuse requires x0 (the tier-0 iterate)")
    else:
        (p_eq, q_eq, d_scale, x_init, gt, b_pad, rb, sb, sh) = _lanes_setup(
            structure, d_fixed, times, waypoints, radii, x0, layout)

    rb_pad = jnp.concatenate(
        [rb, jnp.ones((bsz, layout.tail), f32)], axis=-1)  # (B, nb_p)
    pe_d, pe_u = _pe_band(p_eq, dim, blk)
    eye_b = jnp.eye(blk, dtype=f32)
    q_flat = q_eq.reshape(bsz, nfd, 1)
    x_flat0 = x_init.reshape(bsz, nfd, 1)

    def gt_matvec(v_col):
        """(B, nfd, 1) -> (B, 1, m_p) row: G v."""
        return jnp.einsum('bnm,bno->bom', gt, v_col,
                          precision=jax.lax.Precision.HIGHEST)

    def p_big_mv(x_col):
        xm = x_col.reshape(bsz, n_free, dim)
        return jnp.einsum('bpq,bqd->bpd', p_eq, xm).reshape(bsz, nfd, 1)

    # ---- Initial point. ---------------------------------------------------
    y0 = gt_matvec(x_flat0) + b_pad                        # (B, 1, m_p)
    c0 = _c_lanes(y0[:, 0, :], rb_pad, nb_p, n_ball)       # (B, m_p)
    if (lam0_ball is None) != (lam0_half is None):
        raise ValueError("pass lam0_ball and lam0_half together")
    if lam0_ball is not None:
        yx0 = y0[:, 0, 0:nb_p][:, :n_ball]
        yy0 = y0[:, 0, nb_p:2 * nb_p][:, :n_ball]
        yz0 = y0[:, 0, 2 * nb_p:3 * nb_p][:, :n_ball]
        nrm_y0 = jnp.sqrt(yx0 ** 2 + yy0 ** 2 + yz0 ** 2)
        lam_b = (jnp.linalg.norm(jnp.asarray(lam0_ball, f32), axis=-1)
                 / jnp.maximum(2.0 * sb * nrm_y0, 1e-12))  # (B, n_ball)
        lam_h = jnp.asarray(lam0_half, f32) / (2.0 * sh)
        lam_flat = jnp.clip(jnp.concatenate([lam_b, lam_h], axis=-1),
                            config.warm_lam_min, 1e8)
        lam_flat = jnp.concatenate(
            [lam_flat, jnp.zeros((bsz, 1), f32)], axis=-1)
        lam_est = lam_flat[:, lane_src] * act              # (B, m_p) lanes
        s_lane = jnp.maximum(-c0, config.warm_s_min) * act + (1.0 - act)
        beta = config.warm_beta
        mu0 = jnp.maximum(config.warm_mu_boost
                          * jnp.sum(cw * s_lane * lam_est, axis=-1,
                                    keepdims=True) / mc, 1e-10)
        lam_lane = jnp.clip(lam_est, mu0 / (beta * s_lane),
                            beta * mu0 / s_lane) * act
    else:
        s_lane = jnp.maximum(-c0, config.s_init) * act + (1.0 - act)
        lam_lane = jnp.full_like(c0, config.lam_init) * act

    def eval_step_k(x, s, lam, w_cap_k, phr=False):
        """One evaluation; the weighted Gram comes back as its block-
        tridiagonal BAND (stacked (B, m, blk, blk) diag/super blocks)."""
        y, c, jtwr2, jts, gd, gu = ipm_eval.ipm_eval_step(
            gt, b_pad, rb_pad[:, None, :], x, s[:, None, :],
            lam[:, None, :], nb_p=nb_p, n_ball=n_ball, band_block=blk,
            w_cap=w_cap_k, phr=phr)
        return y[:, 0, :], c[:, 0, :], jtwr2, jts, gd, gu

    def eval_step(x, s, lam):
        return eval_step_k(x, s, lam, w_cap)

    def max_step(v, dv):
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, config.tau
                           * jnp.min(ratio, axis=-1, keepdims=True))

    def merit_lane(c, s, lam):
        neg = -jnp.inf
        m1 = jnp.max(jnp.where(act > 0, jnp.maximum(c, 0.0), neg), axis=-1)
        m2 = jnp.max(jnp.where(act > 0, jnp.abs(c + s), neg), axis=-1)
        m3 = jnp.sum(cw * s * lam, axis=-1) / mc
        return m1 + m2 + m3

    def newton_step(carry, _):
        x, s, lam, y_c, best_x, best_y, best_merit = carry
        s = jnp.maximum(s, 1e-14) * act + (1.0 - act)
        y_row, c, jtwr2, jts, gd, gu = eval_step(x, s, lam)
        y = y_row                                          # (B, m_p)
        r2 = (c + s) * act
        w = jnp.minimum(lam / s, w_cap)

        hd = pe_d + gd + config.reg * eye_b
        hu = pe_u + gu
        mu = jnp.sum(cw * s * lam, axis=-1, keepdims=True) / mc
        rhs_a = -(p_big_mv(x) + q_flat + jtwr2)
        solve_h = _equilibrated_band_solve(hd, hu)

        def direction(rhs):
            dx = solve_h(rhs)                              # (B, nfd, 1)
            gdx = gt_matvec(dx)[:, 0, :]                   # (B, m_p)
            jdx = _jdx_lanes(gdx, y, nb_p, n_ball)
            ds = (-r2 - jdx) * act
            return dx, gdx, ds, jdx

        if config.corrector:
            dx_a, gdx_a, ds_a, _ = direction(rhs_a)
            dlam_a = (-lam - w * ds_a) * act
            alpha_a = jnp.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
            mu_aff = jnp.sum(cw * (s + alpha_a * ds_a)
                             * (lam + alpha_a * dlam_a), axis=-1,
                             keepdims=True) / mc
            sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3,
                             sigma_min, 0.9)
        else:
            # Fixed centering: one factored solve + one G dx per step.
            sigma = jnp.full((bsz, 1), sigma_min, f32)
        sig_mu = sigma * mu                                # (B, 1)

        dx, gdx, ds, _ = direction(rhs_a - sig_mu[:, :, None] * jts)
        dlam = ((sig_mu - lam * s) / s - w * ds) * act
        alpha = jnp.minimum(jnp.minimum(max_step(s, ds),
                                        max_step(lam, dlam)), alpha_max)

        # Select, don't scale: a blown-up direction (NaN dx in the f32
        # endgame) must freeze the state for that scenario, not poison it
        # through 0 * NaN -- best-iterate tracking already preserves the
        # answer, this keeps the RUNNING state (and the dual outputs
        # derived from it) finite too.  Gated on direction finiteness, not
        # alpha: NaN directions yield a finite alpha (see _finite_step_mask).
        upd = _finite_step_mask(alpha, ds, dlam)
        alpha = jnp.where(upd, alpha, 0.0)
        x_new = jnp.where(upd[:, :, None], x + alpha[:, :, None] * dx, x)
        s_new = jnp.where(upd, s + alpha * ds, s)
        lam_new = jnp.where(act > 0,
                            jnp.where(upd,
                                      jnp.maximum(lam + alpha * dlam, 1e-16),
                                      lam), 0.0)
        y_new = jnp.where(upd, y + alpha * gdx, y)
        c_new = _c_lanes(y_new, rb_pad, nb_p, n_ball)

        merit = merit_lane(c_new, s_new, lam_new)
        better = merit < best_merit
        best_x = jnp.where(better[:, None, None], x_new, best_x)
        best_y = jnp.where(better[:, None], y_new, best_y)
        best_merit = jnp.where(better, merit, best_merit)
        max_lam = jnp.max(jnp.where(act > 0, lam_new, 0.0), axis=-1)
        return (x_new, s_new, lam_new, y_new, best_x, best_y, best_merit), \
            max_lam

    # full_like: the carry keeps the data's sharding type in shard_map.
    carry0 = (x_flat0, s_lane, lam_lane, y0[:, 0, :], x_flat0,
              y0[:, 0, :], jnp.full_like(c0[:, 0], jnp.inf))
    (x_last, s_fin, lam_fin, y_last, x_fin, y_fin, best_merit), \
        lam_hist = jax.lax.scan(newton_step, carry0, None,
                                length=config.n_iters)
    if config.n_iters:
        lam_growth = (lam_hist[-1]
                      / jnp.maximum(lam_hist[config.n_iters // 2], 1e-30))
    else:
        # Snap-only (n_iters=0): no Newton history, so the dynamic
        # (lam-growth) certificate is off.
        lam_growth = jnp.ones((bsz,), f32)

    # ---- Feasibility snap (tail repair). ---------------------------------
    # f32 Mehrotra endgames leave a fat violation tail (best-iterate luck,
    # see the safeguards above).  Pure Gauss-Newton on the VIOLATED rows is
    # immune to the deactivation pathology that sinks an augmented-
    # Lagrangian here (c > 0 rows are branch-stable by definition): minimize
    # sum max(c, 0)^2 in the P metric, exact grid line search via the
    # affine-in-alpha y.  Moves are O(violation)-sized and the cost changes
    # second-order; measured: pulls the 1e-3 tail into the 1e-5 class in 2
    # sweeps.
    snap_iters = config.snap_iters
    snap_rho = config.snap_rho
    if snap_iters:
        snap_alphas = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01,
                       0.003)

        def phi(y_a):
            c_a = _c_lanes(y_a, rb_pad, nb_p, n_ball)
            v = jnp.maximum(c_a, 0.0)
            return jnp.sum(cw * v * v, axis=-1)

        def snap_step(carry, _):
            x, y = carry
            c = _c_lanes(y, rb_pad, nb_p, n_ball)
            # Violated rows get the Gauss-Newton pull (m_est = rho c > 0);
            # near-boundary rows enter the Gram only, as tangency stiffness
            # (their clipped estimate is 0 -- no rhs force), so the step
            # does not trade one violation for a new one.
            margin = 3.0 / snap_rho
            lam_s = jnp.where((c > -margin) & (act > 0),
                              jnp.float32(1e-6), jnp.float32(0.0))
            s_s = lam_s / snap_rho
            _, _, jtwr2, _, gd, gu = eval_step_k(x, s_s, lam_s,
                                                 w_cap_k=snap_rho, phr=True)
            dx = _equilibrated_band_solve(
                pe_d + gd + 1e-6 * eye_b, pe_u + gu)(-jtwr2)
            gdx = gt_matvec(dx)[:, 0, :]
            best_a = jnp.zeros((bsz,), f32)
            best_p = phi(y)
            for a_t in snap_alphas:
                p_t = phi(y + a_t * gdx)
                better = p_t < best_p
                best_a = jnp.where(better, a_t, best_a)
                best_p = jnp.where(better, p_t, best_p)
            # Select, don't scale: a rejected (alpha=0) step must not leak
            # 0 * NaN from a blown-up dx into the state (observed on ~1% of
            # scenarios at batch 6144 in f32).
            al = best_a[:, None]
            x_n = jnp.where(al[:, :, None] > 0, x + al[:, :, None] * dx, x)
            y_n = jnp.where(al > 0, y + al * gdx, y)
            return (x_n, y_n), None

        (x_fin, y_fin), _ = jax.lax.scan(
            snap_step, (x_fin, y_fin), None, length=snap_iters)

    # ---- Status / certificates (same semantics as ipm.solve_qcqp_ipm). ----
    c_fin = _c_lanes(y_fin, rb_pad, nb_p, n_ball)
    mu_fin = jnp.sum(cw * s_fin * lam_fin, axis=-1) / mc
    prim_res = jnp.max(jnp.where(act > 0, jnp.maximum(c_fin, 0.0), -jnp.inf),
                       axis=-1)
    obj_scale = 1.0 + jnp.max(jnp.abs(q_flat[:, :, 0]), axis=-1)
    converged = ((prim_res < config.eps_feas)
                 & (best_merit < config.eps_merit * obj_scale))
    growth = lam_growth
    c_last = _c_lanes(y_last, rb_pad, nb_p, n_ball)
    lam_cw = cw * lam_fin
    farkas = (jnp.sum(lam_cw * c_last, axis=-1)
              / jnp.maximum(jnp.sum(lam_cw, axis=-1), 1e-30))
    dyn_infeasible = ((prim_res > 10.0 * config.eps_feas)
                      & (growth > config.infeas_growth)
                      & (farkas > config.eps_feas))
    static_infeasible = _static_certificate(structure, times, d_fixed,
                                            waypoints, radii, config)
    infeasible = static_infeasible | dyn_infeasible

    # ---- Outputs. ---------------------------------------------------------
    d_free = (x_fin.reshape(bsz, n_free, dim)
              * d_scale[:, :, None])
    sol = jax.vmap(lambda df, dfr, t: linear.solve_linear_with_free(
        structure, df, dfr, t))(d_fixed, d_free, times)

    # True-space violation from the scaled y at the best iterate.
    yb = jnp.stack([y_fin[:, c * nb_p:c * nb_p + n_ball] for c in range(3)],
                   axis=-1)                                # (B, n_ball, 3)
    nb_norm = jnp.linalg.norm(yb, axis=-1)
    viol_ball = jnp.max((nb_norm - rb) / sb, axis=-1)
    yh = jnp.take_along_axis(y_fin, half_lane[None, :], axis=-1)
    viol = jnp.maximum(viol_ball, jnp.max(yh / sh, axis=-1))

    lam_ball_f = lam_fin[:, :n_ball]
    dual_ball = 2.0 * sb[:, :, None] * lam_ball_f[:, :, None] * yb
    lam_half_f = jnp.take_along_axis(lam_fin, half_lane[None, :], axis=-1)
    dual_half = 2.0 * sh * lam_half_f

    out = QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=mu_fin,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half,
        infeasible=infeasible)
    if bsz != orig_b:
        out = jax.tree_util.tree_map(lambda a: a[:orig_b], out)
    return out


def _static_certificate(structure, times, d_fixed, waypoints, radii,
                        config: IPMConfig):
    """Closed-form infeasibility certificate for violated CONSTANT rows
    (zero-Jacobian constraints; see ipm.solve_qcqp_ipm).  Recomputed from
    the cheap control-point maps -- no constraint tensors streamed."""
    from .qcqp import build_constraints

    def one(t, df, w, r):
        cons = build_constraints(structure, t, df, w, r)
        ball_jac = jnp.sqrt(jnp.sum(cons.g_ball ** 2, axis=(1, 2, 3)))
        ball_const = jnp.linalg.norm(cons.b_ball, axis=1)
        half_jac = jnp.sqrt(jnp.sum(cons.g_half ** 2, axis=(1, 2)))
        return (
            jnp.any((ball_jac < 1e-9 * (1.0 + ball_const))
                    & (ball_const - cons.r_ball > config.eps_feas))
            | jnp.any((half_jac < 1e-9 * (1.0 + jnp.abs(cons.b_half)))
                      & (cons.b_half > config.eps_feas)))

    return jax.vmap(one)(times, d_fixed, waypoints, radii)


def solve_qcqp_polished_batch(structure: ProblemStructure,
                              d_fixed: jnp.ndarray,
                              times: jnp.ndarray,
                              waypoints: jnp.ndarray,
                              radii: jnp.ndarray,
                              admm_config: Optional[ADMMConfig] = None,
                              ipm_config: Optional[IPMConfig] = None,
                              warmstart_values: Optional[jnp.ndarray] = None,
                              scenario_block: int = 4) -> QCQPSolution:
    """Batched Mosek-grade path: ADMM throughput solve (padded lanes) +
    plane-layout IPM polish, both S-blocked.  The production strict-feasibility
    entry point (see solve_qcqp_ipm_lanes)."""
    from . import qcqp as qcqp_mod
    if admm_config is None:
        admm_config = ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                 rho_tube_factor=0.125, rho_half_factor=0.125,
                                 padded_lanes=True)
    if ipm_config is None:
        # Tuned on the flagship family: 10 single-direction (corrector-off)
        # Newton steps at fixed centering 0.3 + the 2-sweep snap match the
        # Mehrotra variant's quality (61/64 vs 58/64 under the 1e-4 strict
        # gate, median 5e-7) at one factored solve + one G dx per step.
        ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)
    reuse = admm_config.padded_lanes and structure.dimension == 3
    if reuse:
        # Reuse the ADMM's assembled padded system for the polish: the
        # lanes setup would otherwise re-assemble G^T (a second gather +
        # broadcast-multiply + relayout chain); static per-lane multipliers
        # undo the ADMM's per-family penalty scaling instead.
        a, pre = qcqp_mod.solve_qcqp_batch(
            structure, d_fixed, times, waypoints, radii,
            config=admm_config, warmstart_values=warmstart_values,
            scenario_block=scenario_block, _return_pre=True)
        return solve_qcqp_ipm_lanes(
            structure, d_fixed, times, waypoints, radii,
            config=ipm_config, x0=a.d_free, lam0_ball=a.dual_ball,
            lam0_half=a.dual_half, scenario_block=scenario_block,
            pre=pre, pre_penalty=(admm_config.rho_sphere_factor,
                                  admm_config.rho_tube_factor,
                                  admm_config.rho_half_factor))
    a = qcqp_mod.solve_qcqp_batch(structure, d_fixed, times, waypoints,
                                  radii, config=admm_config,
                                  warmstart_values=warmstart_values,
                                  scenario_block=scenario_block)
    return solve_qcqp_ipm_lanes(structure, d_fixed, times, waypoints, radii,
                                config=ipm_config, x0=a.d_free,
                                lam0_ball=a.dual_ball, lam0_half=a.dual_half,
                                scenario_block=scenario_block)
