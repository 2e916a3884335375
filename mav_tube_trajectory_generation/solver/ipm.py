"""Batched primal-dual interior-point QCQP solver (the batched Mosek).

Second backend for the tube-constrained QCQP (same problem as solver/qcqp.py's
ADMM).  Rationale: on a batched accelerator the classic CPU trade-off
inverts.  First-order methods exist to avoid factorizations, but a batch of
135x135 KKT factorizations is a few large batched ops while every ADMM
iteration is a bandwidth-bound batched matvec.  An interior-point method
spends its time in dense batched linear algebra -- weighted Gram matrices
A^T D A and small dense inverses -- and delivers ~1e-8 KKT accuracy
in ~25 Newton steps where ADMM needs hundreds of iterations for 1e-5.  This
is the backend that matches the reference's Mosek IPM solution quality
(qcqp_impl.h:477-788) rather than approximating it.

Formulation (internal 0.5 convention; duals returned in the reference's
J_d = x^T R x + ... convention like solver/qcqp.py):

    min 0.5 x^T P x + q^T x
    s.t.  c_i(x) <= 0,   i = 1..m_c
      ball i:  c_i = 0.5 (||G_i x + b_i||^2 - r_i^2)   (grad G_i^T y_i,
                                                        hess G_i^T G_i)
      half j:  c_j = g_j^T x + b_j                      (linear)

Infeasible-start primal-dual path following with slacks s > 0, multipliers
lambda > 0, fraction-to-boundary steps, fixed iteration count (static scan;
vmappable), per-scenario convergence status.  The Newton system is reduced to
x-space:

    [P + sum_i lambda_i hess_i + J^T diag(lambda/s) J] dx = rhs

assembled as ONE stacked weighted Gram matmul per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg
from . import linear
from .qcqp import QCQPSolution, build_constraints
from .structure import ProblemStructure


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Static IPM knobs."""
    n_iters: int = 25           # Newton iterations (static scan length)
    sigma: float = 0.1          # centering parameter
    tau: float = 0.995          # fraction-to-boundary
    reg: float = 1e-9           # Hessian regularization
    s_init: float = 1.0         # initial slack floor
    lam_init: float = 1.0       # initial multiplier
    eps_feas: float = 1e-6      # convergence thresholds for status output
    eps_mu: float = 1e-8
    # Relative merit threshold for `converged`: best_merit is compared
    # against eps_merit * (1 + ||q_eq||_inf) -- the merit's complementarity
    # term scales linearly with the (equilibrated) objective's gradient
    # scale, so an absolute threshold would mislabel large-cost problems.
    eps_merit: float = 1e-4
    # Primal-infeasibility certificate (QCQPSolution.infeasible): the max
    # multiplier growing by more than this factor over the second half of
    # the scan while the lam-weighted average violation stays positive.  On
    # a feasible problem the multipliers CONVERGE (growth -> 1); on an
    # infeasible one they diverge along a Farkas direction -- the
    # first-order analogue of Mosek's certificate (qcqp_impl.h:715-770).
    # Growth is scale-invariant (a ratio), unlike any absolute lam bound.
    infeas_growth: float = 10.0
    # Dual warm start (lam0_ball/lam0_half given).  warm_s_min INFLATES the
    # start into the interior: measured on the flagship family, hugging the
    # boundary (warm_s_min 1e-3) stalls the fraction-to-boundary steps no
    # matter how the duals are centered (max violation ~5e-3 at 8 steps),
    # while an interior start that keeps only the duals' SCALE converges to
    # the exact optimum with max violation ~2e-6 in 10 steps -- strictly
    # better than a primal-only warm start (feasible but +0.04% cost) AND
    # than boundary-hugging dual starts.
    warm_s_min: float = 1.0
    warm_lam_min: float = 1e-5
    # Central-path re-centering of the warm duals (see solve_qcqp_ipm):
    # products s_i lam_i are clipped into [mu0/beta, beta*mu0] with
    # mu0 = warm_mu_boost * mean(s lam).
    warm_beta: float = 10.0
    warm_mu_boost: float = 1.0
    # float32-endgame safeguards (plane-layout path, solver/ipm_lanes.py):
    # centering floor, fraction-to-boundary step cap, and complementarity-
    # weight cap.  Unrestricted Mehrotra steps drive mu below what f32 can
    # resolve (r2 = c + s noise x w = lam/s spanning ~7 decades) and the
    # Newton directions blow up; these bound the per-step mu decrease and
    # the Newton system's condition number.  The rows-layout path keeps the
    # classic aggressive schedule (sigma >= 1e-4, uncapped alpha, w <= 1e10)
    # for f64 ground-truth use.
    sigma_min: float = 0.1
    alpha_max: float = 1.0
    w_cap: float = 1e6
    # Post-IPM feasibility snap (lanes path): Gauss-Newton sweeps on the
    # violated rows only (branch-stable), repairing the f32 endgame's
    # violation tail at O(violation)-sized, second-order-in-cost moves.
    snap_iters: int = 2
    snap_rho: float = 1e4
    # Mehrotra predictor-corrector toggle (lanes path).  False = single
    # direction per step with fixed centering sigma = sigma_min: drops one
    # factored solve + one G dx matvec per step.  With the sigma floor
    # already bounding the centering schedule and the snap repairing the
    # tail, the corrector's adaptive sigma buys little on warm starts.
    corrector: bool = True
    # Hessian inverse backend: "schur" (matmul-only recursive block Schur,
    # no Cholesky custom call) or "cholesky".  Both are explicit inverses
    # with the same cond*eps forward-error class.
    hess_inverse: str = "schur"


@linear.full_matmul_precision
def solve_qcqp_ipm(structure: ProblemStructure,
                   d_fixed: jnp.ndarray,
                   times: jnp.ndarray,
                   waypoints: jnp.ndarray,
                   radii: jnp.ndarray,
                   config: IPMConfig = IPMConfig(),
                   x0: Optional[jnp.ndarray] = None,
                   lam0_ball: Optional[jnp.ndarray] = None,
                   lam0_half: Optional[jnp.ndarray] = None) -> QCQPSolution:
    """Interior-point solve of one tube-QCQP scenario (vmap for batches).

    Same inputs/outputs as solver.qcqp.solve_qcqp; `converged` reflects
    mu < eps_mu and primal feasibility < eps_feas.

    ``lam0_ball`` (n_ball, 3) / ``lam0_half`` (n_half,): dual warm start in
    the QCQPSolution.dual_ball/dual_half convention (e.g. straight from an
    ADMM solve).  With both x0 and duals given the IPM starts next to the
    central path and typically needs ~half the Newton steps of a cold start.
    """
    dtype = jnp.result_type(d_fixed, times)
    d_fixed = jnp.asarray(d_fixed, dtype)
    times = jnp.asarray(times, dtype)
    waypoints = jnp.asarray(waypoints, dtype)
    radii = jnp.asarray(radii, dtype)

    nf = structure.n_fixed
    n_free = structure.n_free
    dim = structure.dimension
    nfd = n_free * dim

    r = linear.assemble_r(structure, times)
    r_pf = r[nf:, :nf]
    r_pp = r[nf:, nf:]
    q_lin = jnp.einsum('pf,fd->pd', r_pf, d_fixed)

    cons = build_constraints(structure, times, d_fixed, waypoints, radii)

    # ---- Equilibration (same scheme as the ADMM backend). ----------------
    d_scale = jax.lax.rsqrt(jnp.diagonal(r_pp))
    p_eq = r_pp * d_scale[:, None] * d_scale[None, :]
    q_eq = (q_lin * d_scale[:, None]).reshape(nfd)
    gb = cons.g_ball * d_scale[None, None, :, None]       # (n_ball,3,nf,D)
    gh = cons.g_half * d_scale[None, :, None]             # (n_half,nf,D)
    # Row scales clamped to [1e-2, 1e2]: constraints whose Jacobian block is
    # (near-)zero -- e.g. tube constraints on the first segment's leading
    # control points, which depend only on *fixed* start derivatives -- are
    # constants; unbounded up-scaling of those rows poisons the solvers.
    sb = 1.0 / jnp.clip(
        jnp.sqrt(jnp.sum(gb ** 2, axis=(1, 2, 3)) / 3.0), 1e-2, 1e2)
    sh = 1.0 / jnp.clip(jnp.sqrt(jnp.sum(gh ** 2, axis=(1, 2))), 1e-2, 1e2)
    gb = gb * sb[:, None, None, None]
    bb = cons.b_ball * sb[:, None]
    rb = cons.r_ball * sb
    gh = gh * sh[:, None, None]
    bh = cons.b_half * sh

    n_ball = gb.shape[0]
    n_half = gh.shape[0]
    mc = n_ball + n_half
    gb_rows = gb.reshape(n_ball, 3, nfd)                  # (n_ball, 3, nfd)
    gb_flat = gb_rows.reshape(n_ball * 3, nfd)
    gh_flat = gh.reshape(n_half, nfd)

    spd_inv = (linalg.spd_inverse_schur if config.hess_inverse == "schur"
               else lambda m: linalg.spd_inverse(m, newton_steps=0))
    # The Newton Hessian p_big + a_w^T a_w + reg I shares the stage-KKT's
    # EXACT block-tridiagonal structure (banded.kkt_tridiag_block): every
    # constraint row's support is one segment's two endpoint vertices.
    # Per Newton step only the BAND of the Hessian is assembled (diag/super
    # block slices of the dense weighted Gram + krons of p_eq's vertex
    # blocks) and the direction comes from a block-Thomas factor + two
    # single-column solves -- the full-inverse path spends ~3x the
    # factorization cost on (b, nfd) identity panels the two Newton matvecs
    # never need, and the dense p_big/h tensors are never materialized.
    from . import banded
    _blk = (banded.kkt_tridiag_block(structure)
            if config.hess_inverse == "schur" else None)
    if _blk is not None:
        m_blk = nfd // _blk
        bp = _blk // dim
        eye_d = jnp.eye(dim, dtype=dtype)
        eye_b = jnp.eye(_blk, dtype=dtype)

        def kron_e(a):
            return jnp.einsum('ab,cd->acbd', a, eye_d).reshape(
                a.shape[0] * dim, a.shape[1] * dim)

        pe_d = [kron_e(p_eq[i * bp:(i + 1) * bp, i * bp:(i + 1) * bp])
                for i in range(m_blk)]
        pe_u = [kron_e(p_eq[i * bp:(i + 1) * bp, (i + 1) * bp:(i + 2) * bp])
                for i in range(m_blk - 1)]
        p_big = None
    else:
        p_big = jnp.kron(p_eq, jnp.eye(dim, dtype=dtype))

    def p_big_matvec(x):
        # kron(p_eq, I_dim) @ x without the dense kron: (p_eq @ X) row-major.
        return (p_eq @ x.reshape(n_free, dim)).reshape(nfd)

    if x0 is None:
        x_init = -(spd_inv(
            p_eq + config.reg * jnp.eye(n_free, dtype=dtype))
            @ q_eq.reshape(n_free, dim))
    else:
        x_init = jnp.asarray(x0, dtype) / d_scale[:, None]
    x_flat0 = x_init.reshape(nfd)

    def constraint_values(x):
        yb = (gb_flat @ x).reshape(n_ball, 3) + bb        # (n_ball, 3)
        yh = gh_flat @ x + bh                             # (n_half,)
        cb = 0.5 * (jnp.sum(yb * yb, axis=1) - rb * rb)
        return jnp.concatenate([cb, yh]), yb

    def max_step(v, dv):
        # Fraction-to-boundary: largest alpha in (0, 1] with v + a dv > 0.
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, config.tau * jnp.min(ratio))

    def merit_of(x, s, lam):
        c, _ = constraint_values(x)
        return (jnp.max(jnp.maximum(c, 0.0))
                + jnp.max(jnp.abs(c + s))
                + jnp.sum(s * lam) / mc)

    def newton_step(carry, _):
        x, s, lam, best_x, best_merit = carry
        s = jnp.maximum(s, 1e-14)
        c, yb = constraint_values(x)
        # Jacobian rows: ball grad G_i^T y_i; half grad g_j.
        j_ball = jnp.einsum('bcn,bc->bn', gb_rows, yb)    # (n_ball, nfd)
        jmat = jnp.concatenate([j_ball, gh_flat], axis=0) # (mc, nfd)

        mu = jnp.sum(s * lam) / mc
        # Cap the complementarity weights: as mu -> 0 active slacks vanish
        # and lam/s would make the Newton system numerically singular (the
        # classic IPM endgame); the cap bounds the condition number, and
        # best-iterate tracking below keeps the pre-breakdown solution.
        w = jnp.minimum(lam / s, 1e10)                    # (mc,)
        # Stacked weighted Gram: ball curvature rows (sqrt(lam_b) G rows)
        # plus (sqrt(lam/s) * jac) rows, one matmul.
        lam_b3 = jnp.repeat(lam[:n_ball], 3)
        a_w = jnp.concatenate([
            gb_flat * jnp.sqrt(lam_b3)[:, None],
            jmat * jnp.sqrt(w)[:, None],
        ], axis=0)
        gram = a_w.T @ a_w                                # (nfd, nfd) dense
        # (The dense Gram stays on this row-layout path; the plane-layout
        # path computes only the band, ops/ipm_eval.gram_band.)
        if _blk is not None:
            hd = [pe_d[i] + gram[i * _blk:(i + 1) * _blk,
                                 i * _blk:(i + 1) * _blk] + config.reg * eye_b
                  for i in range(m_blk)]
            hu = [pe_u[i] + gram[i * _blk:(i + 1) * _blk,
                                 (i + 1) * _blk:(i + 2) * _blk]
                  for i in range(m_blk - 1)]
            s_inv_f, t_f = banded.spd_block_tridiag_factor(hd, hu)

            def solve_h(rhs):
                return banded.spd_block_tridiag_solve_factored(
                    s_inv_f, t_f, rhs[:, None])[:, 0]
        else:
            h = (p_big + gram
                 + config.reg * jnp.eye(nfd, dtype=dtype))
            # Inexact Newton tolerates a polish-free inverse.
            h_inv = spd_inv(h)

            def solve_h(rhs):
                return h_inv @ rhs

        grad_f = p_big_matvec(x) + q_eq
        r1 = grad_f + jmat.T @ lam
        r2 = c + s

        def direction(sigma_mu):
            # Reduced rhs: -(r1 + J^T (w r2 - lam + sigma_mu / s)).
            rhs = -(r1 + jmat.T @ (w * r2 - lam + sigma_mu / s))
            dx = solve_h(rhs)
            ds = -r2 - jmat @ dx
            dlam = (sigma_mu - lam * s) / s - w * ds
            return dx, ds, dlam

        # Mehrotra predictor-corrector: the affine direction reuses the same
        # Hessian inverse, so the second solve is just matvecs.
        dx_a, ds_a, dlam_a = direction(jnp.zeros_like(s))
        alpha_a = jnp.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = jnp.sum((s + alpha_a * ds_a) * (lam + alpha_a * dlam_a)) / mc
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 1e-4, 0.9)
        dx, ds, dlam = direction(sigma * mu)
        alpha = jnp.minimum(max_step(s, ds), max_step(lam, dlam))

        # Select, don't scale: freeze the scenario on a blown-up (non-
        # finite) Newton direction instead of poisoning the running state
        # through alpha * NaN.  A NaN direction yields a *finite* alpha
        # (NaN < 0 is False in max_step, ratios all inf), so the gate must
        # check the direction itself (ds/dlam contain J dx -- dx finiteness
        # is implied).  Mirrors ipm_lanes._finite_step_mask.
        upd = ((alpha > 0) & jnp.all(jnp.isfinite(ds))
               & jnp.all(jnp.isfinite(dlam)))
        x_new = jnp.where(upd, x + alpha * dx, x)
        s_new = jnp.where(upd, s + alpha * ds, s)
        lam_new = jnp.where(upd, jnp.maximum(lam + alpha * dlam, 1e-16), lam)

        # Best-iterate tracking: keep the lowest-merit x seen; the fixed-
        # length scan may keep stepping after the numerical endgame.
        merit = merit_of(x_new, s_new, lam_new)
        better = merit < best_merit
        best_x = jnp.where(better, x_new, best_x)
        best_merit = jnp.where(better, merit, best_merit)
        return (x_new, s_new, lam_new, best_x, best_merit), (
            jnp.max(jnp.abs(r2)), mu, jnp.max(lam_new))

    if (lam0_ball is None) != (lam0_half is None):
        raise ValueError("pass lam0_ball and lam0_half together")
    c0, yb0 = constraint_values(x_flat0)
    if lam0_ball is not None:
        # Invert the QCQPSolution dual convention (dual_ball = 2 sb lam y
        # with y the SCALED residual; dual_half = 2 sh lam): the IPM's own
        # row scales sb/sh may differ from the producer's (per-family
        # penalty factors), but the originals cancel in the original-space
        # stationarity both solvers share.
        nrm_y0 = jnp.linalg.norm(yb0, axis=1)
        lam_b = (jnp.linalg.norm(jnp.asarray(lam0_ball, dtype), axis=-1)
                 / jnp.maximum(2.0 * sb * nrm_y0, 1e-12))
        lam_h = jnp.asarray(lam0_half, dtype) / (2.0 * sh)
        lam_est = jnp.clip(jnp.concatenate([lam_b, lam_h]),
                           config.warm_lam_min, 1e8)
        s0 = jnp.maximum(-c0, config.warm_s_min)
        # Re-center onto the central path (Gondzio-style warm-start shift):
        # raw first-order duals leave s_i lam_i spread over ~10 decades, and
        # rows with near-zero complementarity stall the fraction-to-boundary
        # steps (measured: p99 violation 2.4e-3 at 12 steps vs 3.1e-5 from a
        # cold start).  Clip every product into [mu0/beta, beta*mu0] around
        # the point's average complementarity.
        beta = config.warm_beta
        mu0 = jnp.maximum(
            config.warm_mu_boost * jnp.sum(s0 * lam_est) / mc, 1e-10)
        lam0 = jnp.clip(lam_est, mu0 / (beta * s0), beta * mu0 / s0)
    else:
        s0 = jnp.maximum(-c0, config.s_init)
        lam0 = jnp.full((mc,), config.lam_init, dtype)
    carry0 = (x_flat0, s0, lam0, x_flat0,
              jnp.asarray(jnp.inf, dtype))
    (x_last, s_fin, lam_fin, x_fin, best_merit), \
        (feas_hist, mu_hist, lam_hist) = \
        jax.lax.scan(newton_step, carry0, None, length=config.n_iters)

    c_fin, yb_fin = constraint_values(x_fin)
    mu_fin = jnp.sum(s_fin * lam_fin) / mc
    prim_res = jnp.max(jnp.maximum(c_fin, 0.0))
    # Scale-invariant convergence: the merit's complementarity term scales
    # with the objective gradient (q_eq after equilibration), so normalize.
    obj_scale = 1.0 + jnp.max(jnp.abs(q_eq))
    converged = ((prim_res < config.eps_feas)
                 & (best_merit < config.eps_merit * obj_scale))
    # Primal-infeasibility certificate: diverging multipliers with a
    # persistently positive lam-weighted average violation.  ``farkas`` is
    # the complementarity-weighted mean of c_i at the last iterate -- for a
    # feasible problem it is <= 0 at any KKT-trending point; staying
    # positive while ||lam|| keeps GROWING (ratio over the scan's second
    # half, scale-invariant) evidences an unsatisfiable constraint
    # combination (the Farkas-direction analogue of Mosek's certificate).
    growth = (lam_hist[-1]
              / jnp.maximum(lam_hist[config.n_iters // 2], 1e-30))
    c_last, _ = constraint_values(x_last)   # certificate at the LAST iterate
    farkas = (jnp.sum(lam_fin * c_last)
              / jnp.maximum(jnp.sum(lam_fin), 1e-30))
    dyn_infeasible = ((prim_res > 10.0 * config.eps_feas)
                      & (growth > config.infeas_growth)
                      & (farkas > config.eps_feas))
    # Static certificate: a constraint row with (numerically) zero Jacobian
    # is a CONSTANT -- e.g. tube constraints on the first segment's leading
    # control points, which depend only on the *fixed* start state.  A
    # violated constant row proves infeasibility in closed form, and no
    # iterative certificate can: its un-satisfiable slack collapses the
    # fraction-to-boundary step, freezing the multipliers instead of letting
    # them diverge along a Farkas direction.  (Raw, unequilibrated tensors:
    # the row-scale clip would hide exactly these rows.)
    ball_jac = jnp.sqrt(jnp.sum(cons.g_ball ** 2, axis=(1, 2, 3)))
    ball_const = jnp.linalg.norm(cons.b_ball, axis=1)
    half_jac = jnp.sqrt(jnp.sum(cons.g_half ** 2, axis=(1, 2)))
    static_infeasible = (
        jnp.any((ball_jac < 1e-9 * (1.0 + ball_const))
                & (ball_const - cons.r_ball > config.eps_feas))
        | jnp.any((half_jac < 1e-9 * (1.0 + jnp.abs(cons.b_half)))
                  & (cons.b_half > config.eps_feas)))
    infeasible = static_infeasible | dyn_infeasible

    d_free = x_fin.reshape(n_free, dim) * d_scale[:, None]
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)

    # True-space violation (same convention as the ADMM backend).
    yb_true = (jnp.einsum('bipd,pd->bi', cons.g_ball, d_free) + cons.b_ball)
    viol_ball = jnp.max(jnp.linalg.norm(yb_true, axis=-1) - cons.r_ball)
    yh_true = jnp.einsum('hpd,pd->h', cons.g_half, d_free) + cons.b_half
    viol = jnp.maximum(viol_ball, jnp.max(yh_true))

    # Dual certificates in the reference J_d convention (factor 2), mapped
    # back to original scaling: for ball constraints the multiplier of the
    # conic form ||y|| <= r relates to the quadratic form's lambda via
    # nu_i = lambda_i * y_i (direction y), scaled by the row equilibration.
    lam_ball = lam_fin[:n_ball]
    dual_ball = 2.0 * sb[:, None] * lam_ball[:, None] * yb_fin
    dual_half = 2.0 * sh * lam_fin[n_ball:]

    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=mu_fin,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half,
        infeasible=infeasible)


def solve_qcqp_polished(structure: ProblemStructure,
                        d_fixed: jnp.ndarray,
                        times: jnp.ndarray,
                        waypoints: jnp.ndarray,
                        radii: jnp.ndarray,
                        admm_config=None,
                        ipm_config: Optional[IPMConfig] = None,
                        x0: Optional[jnp.ndarray] = None) -> QCQPSolution:
    """Throughput + accuracy hybrid: ADMM to the 1e-3 neighborhood, then a
    short interior-point polish to ~1e-9 violations and the exact optimum.

    The ADMM iterate warm-starts the IPM's primal AND duals (the scaled
    ADMM multipliers in QCQPSolution.dual_ball/dual_half, re-centered onto
    the central path from an interior-inflated slack point -- see
    IPMConfig.warm_s_min): 10 Newton steps reach the exact optimum with
    ~1e-6 max violation where a cold start needs ~25.  This is the
    recommended path when Mosek-grade output matters but the full IPM from
    cold start is too slow.
    """
    from . import qcqp as qcqp_mod
    if admm_config is None:
        # The tuned production throughput config (bench.py).
        admm_config = qcqp_mod.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                          rho_tube_factor=0.125,
                                          rho_half_factor=0.125)
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=10)
    admm_sol = qcqp_mod.solve_qcqp(structure, d_fixed, times, waypoints,
                                   radii, config=admm_config, x0=x0)
    return solve_qcqp_ipm(structure, d_fixed, times, waypoints, radii,
                          config=ipm_config, x0=admm_sol.d_free,
                          lam0_ball=admm_sol.dual_ball,
                          lam0_half=admm_sol.dual_half)
