"""Tube/corridor-constrained QCQP solver: batched first-order ADMM.

Replaces the reference's Mosek interior-point QCQP
(PolynomialOptimizationConstrained, polynomial_optimization_qcqp.h +
qcqp_impl.h): minimize the derivative energy subject to

  * sphere constraints   ||cp_last(k) - vertex_{k+1}|| <= r2_k at interior
    vertices (compute_sphere_constraints, qcqp_impl.h:358-365),
  * tube constraints     ||(I - n n^T)(cp_j(k) - p_k)|| <= r1_k confining the
    mid control points 1..N-2 to a cylinder around the segment line
    (compute_tube_constraints, qcqp_impl.h:370-429),
  * tube end-caps        two half-space cuts per mid control point capping
    the cylinder (compute_tube_end_constraints, qcqp_impl.h:432-474),

where cp are Bezier control points of each segment (convex-hull property).

Batched design: every constraint is an affine image of the free endpoint
derivatives landing in a ball or half-line, so the problem is

    min 0.5 x^T P x + q^T x   s.t.  y = G x + g,  y in C (balls x halflines)

solved by over-relaxed ADMM with one batched Cholesky factorization of
(P + rho G^T G) per scenario and fixed-iteration scans -- no per-scenario
control flow, perfectly vmappable, with per-scenario convergence status
outputs instead of aborts (a Mosek IPM has data-dependent iteration counts
and is unbatchable).  Jacobi cost equilibration + per-constraint row
equilibration keep it float32-robust for the batched fast path.

Reference defects intentionally fixed, not replicated (SURVEY.md section 2,
C10): the dead ``solveLinear`` overwrite (qcqp_impl.h:257), hard-coded D=3
result unpacking (:259-261, :781-783), and reading the Mosek solution even
when the solve failed (:777-779).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bezier, linalg, qmatrix
from . import linear
from .structure import ProblemStructure, make_structure, standard_mask


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """First-order solver knobs (static).

    Iterations are organized as ``n_stages`` stages of ``n_iters`` fixed-shape
    scan steps; between stages the penalty rho is rebalanced from the
    primal/dual residual ratio (OSQP-style) and the KKT matrix refactored.
    Everything stays fixed-shape and vmappable; rho adapts per scenario.
    """
    rho: float = 0.1            # initial ADMM penalty (after equilibration)
    sigma: float = 1e-8         # KKT regularization
    alpha: float = 1.6          # over-relaxation
    n_iters: int = 200          # iterations per stage (scan length)
    n_stages: int = 5           # rho-rebalancing stages (refactorizations)
    rho_min: float = 1e-4
    rho_max: float = 1e4
    eps_primal: float = 1e-5    # convergence thresholds for status output
    eps_dual: float = 1e-5
    # Solve in the padded component-plane lane layout (_PadLayout), with
    # the ADMM stages of ops/admm_stage.py and the KKT factored in its
    # block-tridiagonal band; float32 only.  False = the unpadded
    # reference-layout scan path (f64-capable).
    padded_lanes: bool = False
    # KKT inverse backend: "schur" = matmul-only recursive block-Schur
    # (no Cholesky custom call; safe because the equilibrated KKT has
    # cond ~2e2), "cholesky" = XLA Cholesky + matmul-only triangular
    # inverse.
    kkt_inverse: str = "schur"
    # Per-constraint-family penalty factors: scaling a row by sqrt(f) after
    # equilibration gives that constraint an effective penalty f * rho (the
    # feasible set is invariant).  OSQP-style rho heterogeneity without a
    # per-row rho in the stage.
    rho_sphere_factor: float = 1.0
    rho_tube_factor: float = 1.0
    rho_half_factor: float = 1.0
    # How the padded path applies the KKT inverse when the block-tridiagonal
    # structure holds: "factored" forms m1 = W^-1 G^T by block-Thomas
    # sweeps over the block-LDL^T factors (the dense (nfd, nfd) inverse is
    # never materialized); "inverse" materializes the dense inverse.
    kkt_apply: str = "factored"

    def __post_init__(self):
        if self.kkt_apply not in ("factored", "inverse"):
            raise ValueError(
                f"kkt_apply must be 'factored' or 'inverse', got "
                f"{self.kkt_apply!r}")
        if self.kkt_inverse not in ("schur", "cholesky"):
            raise ValueError(
                f"kkt_inverse must be 'schur' or 'cholesky', got "
                f"{self.kkt_inverse!r}")


class QCQPSolution(NamedTuple):
    coefficients: jnp.ndarray     # (..., K, N, D)
    times: jnp.ndarray            # (..., K)
    d_fixed: jnp.ndarray          # (..., n_fixed, D)
    d_free: jnp.ndarray           # (..., n_free, D)
    cost: jnp.ndarray             # (...,) 0.5 c^T Q c derivative energy
    converged: jnp.ndarray        # (...,) bool
    primal_residual: jnp.ndarray  # (...,)
    dual_residual: jnp.ndarray    # (...,)
    max_violation: jnp.ndarray    # (...,) max constraint violation of output
    dual_ball: jnp.ndarray        # (..., n_ball, 3) scaled ADMM duals (rho*u)
    dual_half: jnp.ndarray        # (..., n_half,) scaled ADMM duals (rho*u)
    # Primal-infeasibility evidence (IPM backend only; None from ADMM):
    # True when the duals diverge while a positive lam-weighted average
    # violation persists -- the first-order analogue of Mosek's primal
    # infeasibility certificate (qcqp_impl.h:715-770).  Distinguishes
    # "problem infeasible" from "solver stalled" (both have converged=False).
    infeasible: Optional[jnp.ndarray] = None


class _ConstraintSystem(NamedTuple):
    """Affine constraint maps (per scenario batch)."""
    g_ball: jnp.ndarray       # (n_ball, 3, n_free, D) jacobian
    b_ball: jnp.ndarray       # (n_ball, 3) offset
    r_ball: jnp.ndarray       # (n_ball,) radius
    g_half: jnp.ndarray       # (n_half, n_free, D) jacobian
    b_half: jnp.ndarray       # (n_half,) offset (constraint: y + b <= 0 form
                              #  folded: y <= 0 with offset inside)


class _PadLayout(NamedTuple):
    """Static description of the packed component-plane lane layout.

    Each of the 3 ball planes is nb_p lanes: [ball rows (n_ball) | packed
    half-space rows (tail)]; remaining half rows go to a final plane of
    nh_p lanes.  Planes are padded to 128-lane multiples; packing the
    tails cuts the flagship shape from 640 to 512 lanes (427 of them
    real constraint rows)."""
    n_ball: int
    n_half: int
    nb_p: int
    nh_p: int

    @property
    def tail(self) -> int:
        return self.nb_p - self.n_ball

    @property
    def m_p(self) -> int:
        return 3 * self.nb_p + self.nh_p

    def half_chunks(self):
        """[(plane_index, lane_offset, half_offset, length)] covering all
        n_half rows: planes 0-2 tails first, then the final plane."""
        out = []
        for c in range(3):
            off = c * self.tail
            ln = max(0, min(self.tail, self.n_half - off))
            if ln:
                out.append((c, self.n_ball, off, ln))
        rest = min(3 * self.tail, self.n_half)
        if self.n_half - rest:
            out.append((3, 0, rest, self.n_half - rest))
        return out

    @staticmethod
    def make(n_ball: int, n_half: int) -> "_PadLayout":
        round_up = lambda x: -(-x // 128) * 128
        nb_p = round_up(max(n_ball, 1))
        rest = max(n_half - 3 * (nb_p - n_ball), 0)
        nh_p = round_up(rest) if rest else 0
        return _PadLayout(n_ball, n_half, nb_p, nh_p)


def _control_point_maps(structure: ProblemStructure, times: jnp.ndarray,
                        d_fixed: jnp.ndarray):
    """(cp0 (K, N, D), Ecp (K, N, n_free)): affine map cp = cp0 + Ecp x."""
    n = structure.n_coefficients
    nf = structure.n_fixed
    m_hot = jnp.asarray(structure.one_hot_m(), dtype=times.dtype)
    m_fix = m_hot[:, :, :nf]
    m_free = m_hot[:, :, nf:]
    binv = jnp.asarray(bezier.inv_control_point_mapping_unit(n),
                       dtype=times.dtype)
    iord = jnp.asarray(qmatrix.row_derivative_orders(n), dtype=times.dtype)
    ipow = times[..., None] ** iord                       # (K, N)
    binv_t = binv[None, :, :] * ipow[:, None, :]          # (K, N, N)
    cp0 = jnp.einsum('kjr,krf,fd->kjd', binv_t, m_fix, d_fixed)
    ecp = jnp.einsum('kjr,krp->kjp', binv_t, m_free)
    return cp0, ecp


def _row_scale_bounds(n_coefficients: int):
    """Constraint-row equilibration clamp, N-aware.

    [1e-2, 1e2] at N <= 10: the round-2-tuned bounds every headline quality
    number, certificate threshold, and penalty-factor choice was calibrated
    against.  At N = 12 the Bezier control-point maps' T^l dynamic range
    (l <= N-1) pushes REAL constraint rows' equilibrated norms well below
    1e-2; capping their up-scaling at 1e2 leaves the f32 stage KKT at cond
    ~1.9e6 (measured, K=10 nfabian times: Newton/ADMM f32 solves lose
    feasibility digits -- the old test_ngen N=12 caveat), while widening to
    [1e-4, 1e4] restores cond ~3.4e3, the N=10 class.  Near-zero constant
    rows at N=12 get up-scaled by at most 1e4 -- still bounded, and the
    static certificate reads the raw (unscaled) tensors either way.
    """
    return (1e-2, 1e2) if n_coefficients <= 10 else (1e-4, 1e4)


def build_constraints(structure: ProblemStructure,
                      times: jnp.ndarray,
                      d_fixed: jnp.ndarray,
                      waypoints: jnp.ndarray,
                      radii: jnp.ndarray) -> _ConstraintSystem:
    """Assemble the ball/half-space constraint system for one scenario.

    Args:
      structure: free-interior problem family (D == 3 for tube geometry).
      times: (K,) segment times.
      d_fixed: (n_fixed, D) fixed start/goal derivatives.
      waypoints: (V, D) vertex positions (interior positions are *geometry*
        for the tubes, not equality constraints).
      radii: (K, 2) per-segment (tube radius r1, sphere radius r2) -- the
        reference's std::pair<double, double> radii (qcqp.h:29-30).
    """
    k = structure.n_segments
    n = structure.n_coefficients
    d = structure.dimension
    if d != 3:
        raise ValueError("Tube constraints require dimension == 3 "
                         "(reference qcqp_impl.h is 3-D only).")
    cp0, ecp = _control_point_maps(structure, times, d_fixed)

    p_start = waypoints[:-1]                              # (K, 3)
    p_end = waypoints[1:]                                 # (K, 3)
    seg_vec = p_end - p_start
    seg_norm = jnp.linalg.norm(seg_vec, axis=-1, keepdims=True)
    nvec = seg_vec / jnp.maximum(seg_norm, 1e-12)         # (K, 3)
    proj = jnp.eye(3, dtype=times.dtype) - nvec[:, :, None] * nvec[:, None, :]

    eye3 = jnp.eye(3, dtype=times.dtype)

    # --- Sphere constraints at interior vertices (segments 0..K-2). -------
    # y = cp[k, N-1, :] - waypoint_{k+1}  in Ball(r2_k).
    g_sph = ecp[:k - 1, n - 1][:, None, :, None] * eye3[None, :, None, :]
    b_sph = cp0[:k - 1, n - 1, :] - waypoints[1:k]
    r_sph = radii[:k - 1, 1]

    # --- Tube constraints on mid control points 1..N-2 of every segment. --
    # y = P_k (cp[k, j, :] - p_k)  in Ball(r1_k).
    mid = slice(1, n - 1)
    n_mid = n - 2
    # g_tube[k, j, i, p, dd] = proj[k, i, dd] * ecp[k, j, p]
    g_tube = jnp.einsum('kid,kjp->kjipd', proj, ecp[:, mid])
    b_tube = jnp.einsum('kid,kjd->kji', proj, cp0[:, mid] - p_start[:, None, :])
    r_tube = jnp.broadcast_to(radii[:, 0][:, None], (k, n_mid))

    g_ball = jnp.concatenate(
        [g_sph, g_tube.reshape(k * n_mid, 3, ecp.shape[-1], 3)], axis=0)
    b_ball = jnp.concatenate([b_sph, b_tube.reshape(k * n_mid, 3)], axis=0)
    r_ball = jnp.concatenate([r_sph, r_tube.reshape(k * n_mid)], axis=0)

    # --- End-cap half spaces on the same mid control points. --------------
    # start side: (-n_k)^T cp[k,j] <= (-n_k)^T p_cap_start
    #   p_cap_start = p_k - n_k * r_prev  (r_prev = radii[k-1].second, or
    #   radii[0].first for the first segment; qcqp_impl.h:451-456)
    # end side:    n_k^T cp[k,j] <= n_k^T p_cap_end,
    #   p_cap_end = p_{k+1} + n_k * radii[k].second.
    r_prev = jnp.concatenate([radii[:1, 0], radii[:-1, 1]])
    p_cap_start = p_start - nvec * r_prev[:, None]
    p_cap_end = p_end + nvec * radii[:, 1][:, None]

    dirs = jnp.stack([-nvec, nvec], axis=1)               # (K, 2, 3)
    caps = jnp.stack([p_cap_start, p_cap_end], axis=1)    # (K, 2, 3)
    # g_half[k, j, s, p, d] = dirs[k, s, d] * ecp[k, j, p]
    g_half = jnp.einsum('ksd,kjp->kjspd', dirs, ecp[:, mid])
    b_half = (jnp.einsum('ksd,kjd->kjs', dirs, cp0[:, mid])
              - jnp.einsum('ksd,ksd->ks', dirs, caps)[:, None, :])

    nfree = ecp.shape[-1]
    return _ConstraintSystem(
        g_ball=g_ball,
        b_ball=b_ball,
        r_ball=r_ball,
        g_half=g_half.reshape(k * n_mid * 2, nfree, 3),
        b_half=b_half.reshape(k * n_mid * 2),
    )


def _padded_gather_maps(k: int, n: int, layout: _PadLayout):
    """Static lane -> source-row index maps for the padded component-plane
    layout (NumPy, cached): every constraint row of G^T is an outer product
    ``ecp_s[k_m, j_m, :] (x) w_m`` with ``w_m`` a direction vector times a
    row scale, so the whole (nfd, m_p) tensor can be written ONCE by a
    gather + broadcast-multiply instead of per-family einsums + relayout
    copies + a concatenate.

    Lane order per ball plane c: [spheres (k-1) | tubes (k*(n-2)) | packed
    half rows | zero pad]; final plane: [remaining half rows | zero pad].

    Returns int32 arrays of length m_p: ecp_idx (into ecp_s.reshape(k*n,
    nf)), dir_idx (into the [eye3 | proj | dirs | 0] direction pool),
    scl_idx (into [sb_sph | sb_tube | sh | 0]), off_idx (into
    [b_sph | b_tube | b_half | 0]).
    """
    n_mid = n - 2
    n_ball = layout.n_ball
    m_p = layout.m_p
    ecp_idx = np.zeros(m_p, np.int32)
    dir_idx = np.full(m_p, 3 + 3 * k + 2 * k, np.int32)     # zero pool row
    scl_idx = np.full(m_p, n_ball + layout.n_half, np.int32)  # zero scale
    off_idx = np.full(m_p, 3 * n_ball + layout.n_half, np.int32)  # zero b

    def set_half(lane, h):
        ki, rem = divmod(h, n_mid * 2)
        j, s = divmod(rem, 2)
        ecp_idx[lane] = ki * n + 1 + j
        dir_idx[lane] = 3 + 3 * k + ki * 2 + s
        scl_idx[lane] = n_ball + h
        off_idx[lane] = 3 * n_ball + h

    for c in range(3):
        base = c * layout.nb_p
        for b in range(k - 1):                               # spheres
            lane = base + b
            ecp_idx[lane] = b * n + (n - 1)
            dir_idx[lane] = c
            scl_idx[lane] = b
            off_idx[lane] = b * 3 + c
        for r in range(k * n_mid):                           # tubes
            lane = base + (k - 1) + r
            ki, j = divmod(r, n_mid)
            ecp_idx[lane] = ki * n + 1 + j
            dir_idx[lane] = 3 + ki * 3 + c
            scl_idx[lane] = (k - 1) + r
            off_idx[lane] = 3 * (k - 1) + r * 3 + c
    for (c, lane0, off, ln) in layout.half_chunks():
        base = c * layout.nb_p if c < 3 else 3 * layout.nb_p
        for i in range(ln):
            set_half(base + lane0 + i, off + i)
    return ecp_idx, dir_idx, scl_idx, off_idx


_GATHER_MAP_CACHE: dict = {}


def penalty_unscale_maps(structure: ProblemStructure, layout: _PadLayout,
                         f_sphere: float, f_tube: float, f_half: float):
    """Static multipliers that convert the ADMM's penalty-scaled padded
    system (ADMMConfig.rho_*_factor baked into the row scales as sqrt(f))
    back to the penalty-free (f=1) system the IPM/lanes path assembles --
    letting tier-0 reuse ONE G^T assembly for both solvers.

    Returns (lane_ratio (m_p,), ball_ratio (n_ball,), half_ratio (n_half,))
    as float32 NumPy arrays (pad lanes get ratio 1).
    """
    k = structure.n_segments
    n = structure.n_coefficients
    key = (k, n, layout)
    maps = _GATHER_MAP_CACHE.get(key)
    if maps is None:
        maps = _padded_gather_maps(k, n, layout)
        _GATHER_MAP_CACHE[key] = maps
    scl_idx = maps[2]
    n_sph = k - 1
    n_ball = layout.n_ball
    n_half = layout.n_half
    inv = np.concatenate([
        np.full(n_sph, 1.0 / np.sqrt(f_sphere)),
        np.full(n_ball - n_sph, 1.0 / np.sqrt(f_tube)),
        np.full(n_half, 1.0 / np.sqrt(f_half)),
        np.ones(1)]).astype(np.float32)
    lane_ratio = inv[scl_idx]
    ball_ratio = inv[:n_ball]
    half_ratio = inv[n_ball:n_ball + n_half]
    return lane_ratio, ball_ratio, half_ratio


def _padded_constraint_system(structure: ProblemStructure,
                              times: jnp.ndarray,
                              d_fixed: jnp.ndarray,
                              waypoints: jnp.ndarray,
                              radii: jnp.ndarray,
                              d_scale: jnp.ndarray,
                              layout: _PadLayout,
                              f_sphere: float = 1.0,
                              f_tube: float = 1.0,
                              f_half: float = 1.0):
    """Equilibrated constraint system assembled DIRECTLY in the padded
    component-plane lane layout.

    Same math as ``build_constraints`` + the equilibration block of
    ``solve_qcqp`` (sphere/tube/end-cap forms, qcqp_impl.h:358-474), but the
    per-constraint Jacobians are never materialized in their (m, 3, n_free,
    D) form: the row norms have closed forms (sphere ``e``, tube
    ``|P|_F e / sqrt(3)``, half-space ``e`` for ``e = |ecp_j * d_scale|_2``),
    and the scaled G^T lands straight in its final (nfd, m_p) layout, with
    no transpose/slice/concat chain.

    Returns (gt (nfd, m_p), b_pad (1, m_p), rb (n_ball,) scaled radii,
             sb (n_ball,), sh (n_half,)); gt/b_pad/rb in float32.

    (Rejected experiment on the first accelerator this ran on, worth
    re-measuring: computing the Gram G G^T from the compact family
    factors -- delta_de S0 + sum_k B1_k kron P_k + B2_k kron n_k n_k^T --
    is ~10x fewer FLOPs than the (nfd, m_p) matmul but benched slower
    end-to-end there: the tiny (45, 8) @ (8, 45) batched contractions were
    latency-bound and their layouts cascaded extra copies.)
    """
    k = structure.n_segments
    n = structure.n_coefficients
    if structure.dimension != 3:
        raise ValueError("Tube constraints require dimension == 3.")
    f32 = jnp.float32
    cp0, ecp = _control_point_maps(structure, times, d_fixed)
    n_free = ecp.shape[-1]
    nfd = n_free * 3
    n_mid = n - 2
    n_ball = (k - 1) + k * n_mid
    n_half = k * n_mid * 2

    p_start = waypoints[:-1]
    p_end = waypoints[1:]
    seg_vec = p_end - p_start
    seg_norm = jnp.linalg.norm(seg_vec, axis=-1, keepdims=True)
    nvec = seg_vec / jnp.maximum(seg_norm, 1e-12)          # (K, 3)
    eye3 = jnp.eye(3, dtype=times.dtype)
    proj = eye3 - nvec[:, :, None] * nvec[:, None, :]      # (K, 3, 3)

    ecp_s = ecp * d_scale[None, None, :]                   # (K, N, n_free)
    e_norm = jnp.linalg.norm(ecp_s, axis=-1)               # (K, N)
    proj_f = jnp.linalg.norm(proj, axis=(-2, -1))          # (K,) ~sqrt(2)
    mid = slice(1, n - 1)

    # Row equilibration scales (identical semantics to solve_qcqp's clip),
    # times the per-family sqrt(penalty factor) (ADMMConfig.rho_*_factor).
    rs_lo, rs_hi = _row_scale_bounds(n)
    # Python-float scales, NOT np scalars: a NumPy f64 scalar is strongly
    # typed and would promote the whole assembly to f64 under
    # jax_enable_x64.
    f_sphere, f_tube, f_half = (float(np.sqrt(f_sphere)),
                                float(np.sqrt(f_tube)),
                                float(np.sqrt(f_half)))
    sb_sph = f_sphere / jnp.clip(
        e_norm[:k - 1, n - 1], rs_lo, rs_hi)                        # (K-1,)
    sb_tube = f_tube / jnp.clip(
        proj_f[:, None] * e_norm[:, mid] * float(1.0 / np.sqrt(3.0)),
        rs_lo, rs_hi)                                               # (K,M)
    sh_kj = f_half / jnp.clip(e_norm[:, mid], rs_lo, rs_hi)       # (K,M)

    # --- G^T in ONE write: gather + broadcast-multiply. --------------------
    # Every constraint row is ecp_s[k_m, j_m, :] (x) w_m (direction vector
    # times row scale), so gt[(p,d), m] = E_sel[m, p] * W[m, d] with static
    # lane -> source maps; no per-family einsums, no relayout copies, no
    # concatenate.  (Also rejected earlier: a broadcast-multiply
    # restructure that KEPT the per-family parts + concat; the win here is
    # the single full-tensor write.)
    key = (k, n, layout)
    maps = _GATHER_MAP_CACHE.get(key)
    if maps is None:
        # Cache NUMPY arrays only: a jnp array materialized inside a jit
        # trace is that trace's constant tracer, and reusing it from a later
        # trace raises UnexpectedTracerError.
        maps = _padded_gather_maps(k, n, layout)
        _GATHER_MAP_CACHE[key] = maps
    ecp_idx, dir_idx, scl_idx, off_idx = (jnp.asarray(a) for a in maps)

    dirs = jnp.stack([-nvec, nvec], axis=1)                # (K, 2, 3)
    dtype = times.dtype
    dir_pool = jnp.concatenate([
        eye3, proj.reshape(k * 3, 3), dirs.reshape(k * 2, 3),
        jnp.zeros((1, 3), dtype)], axis=0)                 # (3+5K+1, 3)
    sh_flat = jnp.broadcast_to(sh_kj[..., None],
                               (k, n_mid, 2)).reshape(-1)  # (n_half,)
    scl_pool = jnp.concatenate([
        sb_sph, sb_tube.reshape(-1), sh_flat, jnp.zeros((1,), dtype)])

    e_sel = ecp_s.reshape(k * n, n_free)[ecp_idx]          # (m_p, n_free)
    w_lane = dir_pool[dir_idx] * scl_pool[scl_idx][:, None]  # (m_p, 3)
    gt = jnp.einsum('mp,md->pdm', e_sel,
                    w_lane).reshape(nfd, layout.m_p).astype(f32)

    # --- Offsets / radii (small tensors; same gather trick for b). ---------
    b_sph = (cp0[:k - 1, n - 1, :] - waypoints[1:k]) * sb_sph[:, None]
    b_tube = jnp.einsum('kcd,kjd->kjc', proj,
                        cp0[:, mid] - p_start[:, None, :]) \
        * sb_tube[..., None]                               # (K, M, 3)
    r_prev = jnp.concatenate([radii[:1, 0], radii[:-1, 1]])
    p_cap_start = p_start - nvec * r_prev[:, None]
    p_cap_end = p_end + nvec * radii[:, 1][:, None]
    caps = jnp.stack([p_cap_start, p_cap_end], axis=1)     # (K, 2, 3)
    b_half = (jnp.einsum('ksd,kjd->kjs', dirs, cp0[:, mid])
              - jnp.einsum('ksd,ksd->ks', dirs, caps)[:, None, :]) \
        * sh_kj[..., None]                                 # (K, M, 2)

    off_pool = jnp.concatenate([
        b_sph.reshape(-1), b_tube.reshape(-1), b_half.reshape(-1),
        jnp.zeros((1,), dtype)])
    b_pad = off_pool[off_idx][None, :].astype(f32)         # (1, m_p)

    rb = jnp.concatenate([radii[:k - 1, 1] * sb_sph,
                          (jnp.broadcast_to(radii[:, :1], (k, n_mid))
                           * sb_tube).reshape(-1)]).astype(f32)
    sb = jnp.concatenate([sb_sph, sb_tube.reshape(-1)])
    sh = jnp.broadcast_to(sh_kj[..., None], (k, n_mid, 2)).reshape(-1)
    return gt, b_pad, rb, sb, sh


def _project(z_ball: jnp.ndarray, r_ball: jnp.ndarray,
             z_half: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    norm = jnp.linalg.norm(z_ball, axis=-1)
    scale = jnp.where(norm > r_ball, r_ball / jnp.maximum(norm, 1e-30), 1.0)
    return z_ball * scale[..., None], jnp.minimum(z_half, 0.0)


def _run_stages_xla(config, g_all, b_all, gtg, p_big, eye_kkt, q_flat,
                    x_flat0, z0, project_flat, dtype):
    """Staged ADMM with the inner iterations as an XLA scan."""

    def make_step(wgt, xq, rho):
        def step(carry, _):
            x, z, _, u = carry
            x_new = xq + rho * (wgt @ (z - u - b_all))
            y = g_all @ x_new + b_all
            y_rel = config.alpha * y + (1 - config.alpha) * z
            z_new = project_flat(y_rel + u)
            u_new = u + y_rel - z_new
            prim = jnp.max(jnp.abs(y - z_new))
            return (x_new, z_new, z, u_new), prim
        return step

    spd_inv = (linalg.spd_inverse_schur if config.kkt_inverse == "schur"
               else linalg.spd_inverse)
    rho = jnp.asarray(config.rho, dtype)
    state = (x_flat0, z0, z0, jnp.zeros_like(z0))
    prim_res = jnp.asarray(jnp.inf, dtype)
    dual_res = jnp.asarray(jnp.inf, dtype)
    for stage in range(config.n_stages):
        kkt = p_big + rho * gtg + config.sigma * eye_kkt
        w_inv = spd_inv(kkt)                                # (nfd, nfd)
        wgt = w_inv @ g_all.T                               # (nfd, m)
        xq = -(w_inv @ q_flat)
        state, prims = jax.lax.scan(
            make_step(wgt, xq, rho), state, None, length=config.n_iters)
        x_c, z_c, z_prev_c, u_c = state
        prim_res = prims[-1]
        dual_res = rho * jnp.max(jnp.abs(g_all.T @ (z_c - z_prev_c)))
        if stage + 1 < config.n_stages:
            # Residual balancing (OSQP section 5.2): rho <- rho sqrt(rp/rd),
            # duals u = nu/rho rescale inversely.
            ratio = jnp.sqrt(jnp.maximum(prim_res, 1e-30)
                             / jnp.maximum(dual_res, 1e-30))
            new_rho = jnp.clip(rho * ratio, config.rho_min, config.rho_max)
            state = (x_c, z_c, z_prev_c, u_c * (rho / new_rho))
            rho = new_rho

    x_fin, z_fin, _, u_fin = state
    return x_fin, z_fin, u_fin, rho, prim_res, dual_res


def _kkt_tridiag_block(structure: ProblemStructure):
    """See banded.kkt_tridiag_block (moved there; kept as an alias)."""
    from . import banded
    return banded.kkt_tridiag_block(structure)


def _run_stages_padded(config, gt, b_pad, rb, layout, p_big,
                       q_flat, x_flat0, nfd, out_dtype, kkt_block=None,
                       p_eq=None):
    """Staged ADMM in the padded lane layout (ops/admm_stage.py).

    ALL array arguments carry a leading scenario-block axis S.  Shapes:
    gt (S, nfd, m_p), b_pad (S, 1, m_p), rb (S, n_ball), p_big (S, nfd,
    nfd), q_flat (S, nfd), x_flat0 (S, nfd); per-stage rho adaptation and
    the KKT (re)factorization are batched over S.

    ``gt`` arrives from _padded_constraint_system already equilibrated and in
    the padded component-plane layout: G^T G and the KKT-inverse product
    inherit the layout for free (padding columns are zero, so they
    contribute nothing to the Gram matrix), and no unpadded (m, nfd) G is
    ever materialized.

    Returns (x (S, nfd), z, u, y (S, m), rho, prim, dual (S,)) -- z/u/y
    unpadded, in the flat [ball-x | ball-y | ball-z | half] order;
    y = G x + b (scaled space) for the caller's violation check.
    """
    from ..ops import admm_stage

    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    nb_p, n_ball = layout.nb_p, layout.n_ball
    s = b_pad.shape[0]
    # Tail lanes are half-space rows; the projection masks them off the
    # ball path, so their radius entry is inert (set to 1).
    rb_pad = jnp.concatenate(
        [rb.astype(f32), jnp.ones((s, layout.tail), f32)],
        axis=-1)[:, None, :]                              # (S, 1, nb_p)

    gt = gt.astype(f32)
    x = x_flat0.astype(f32)[:, :, None]                   # (S, nfd, 1)
    z = u = None   # stage 0 initializes z/u from x inside the stage

    banded_kkt = kkt_block is not None and config.kkt_inverse == "schur" \
        and p_eq is not None
    factored = banded_kkt and config.kkt_apply == "factored"
    if banded_kkt:
        # Structured path: the KKT kron(R_pp, I3) + rho G^T G + sigma I is
        # EXACTLY block-tridiagonal in vertex blocks (_kkt_tridiag_block),
        # so only its band is assembled: the Gram band from per-block lane
        # contractions of gt, plus small krons of p_eq's vertex blocks; the
        # dense p_big / Gram / kkt tensors are never materialized.
        from . import banded
        blk = kkt_block
        m_blk = nfd // blk
        dim = blk * m_blk // p_eq.shape[-1]
        bp = blk // dim                                    # p_eq block (5)
        eye_d = jnp.eye(dim, dtype=f32)
        pe = p_eq.astype(f32).reshape(s, m_blk, bp, m_blk, bp)
        pe_d = jnp.stack([pe[:, i, :, i, :] for i in range(m_blk)], axis=1)
        pe_u = jnp.stack([pe[:, i, :, i + 1, :] for i in range(m_blk - 1)],
                         axis=1)
        kron = lambda a: jnp.einsum('smab,cd->smacbd', a, eye_d).reshape(
            s, a.shape[1], blk, blk)
        pb_d, pb_u = kron(pe_d), kron(pe_u)
        gd, gu = linalg.gram_band(gt, gt, blk)
        eye_b = jnp.eye(blk, dtype=f32)
    else:
        gtg = jnp.matmul(gt, jnp.swapaxes(gt, -1, -2),
                         precision=hi)                     # (S, nfd, nfd)
        spd_inv = (linalg.spd_inverse_schur if config.kkt_inverse == "schur"
                   else linalg.spd_inverse)
    rho = jnp.full((s, 1, 1), config.rho, f32)
    prim_res = jnp.full((s,), jnp.inf, f32)
    dual_res = jnp.full((s,), jnp.inf, f32)
    y = None
    q_col = q_flat.astype(f32)[:, :, None]
    stage_kw = dict(n_iters=config.n_iters, alpha=config.alpha, nb_p=nb_p,
                    n_ball=n_ball)
    for stage in range(config.n_stages):
        if banded_kkt:
            rho_b = rho[:, None, :, :]                     # (S, 1, 1, 1)
            db = pb_d + rho_b * gd + config.sigma * eye_b
            ub = pb_u + rho_b * gu
            if factored:
                # Block-LDL^T factors only; m1 = W^-1 G^T comes from
                # block-Thomas sweeps in the stage, xq from the same
                # factored solve here.
                s_inv, t_fac = banded.spd_block_tridiag_factor(db, ub)
                xq = -banded.spd_block_tridiag_solve_factored(
                    s_inv, t_fac, q_col)
            else:
                w_inv = banded.spd_block_tridiag_inverse_blocks(db, ub)
        else:
            kkt = (p_big + rho * gtg
                   + config.sigma * jnp.eye(nfd, dtype=f32)).astype(f32)
            w_inv = spd_inv(kkt)                           # (S, nfd, nfd)
        if factored:
            t_st = jnp.stack(t_fac[1:], axis=1)            # (S, m-1, b, b)
            x, z, z_prev, u, prim, dualm, y = admm_stage.admm_stage_factored(
                rho, jnp.stack(s_inv, axis=1), t_st,
                jnp.swapaxes(t_st, -1, -2), gt, b_pad, rb_pad, xq, x, z, u,
                init_z=(stage == 0), **stage_kw)
        else:
            xq = -jnp.matmul(w_inv, q_col, precision=hi)   # (S, nfd, 1)
            x, z, z_prev, u, prim, dualm, y = admm_stage.admm_stage(
                rho, w_inv, gt, b_pad, rb_pad, xq, x, z, u,
                init_z=(stage == 0), **stage_kw)
        prim_res = prim[:, 0, 0]
        # Padded entries of z are fixed points of the iteration (y=0, b=0),
        # so dz is zero there and the padded matvec is exact.
        dual_res = rho[:, 0, 0] * dualm[:, 0, 0]
        if stage + 1 < config.n_stages:
            ratio = jnp.sqrt(jnp.maximum(prim_res, 1e-30)
                             / jnp.maximum(dual_res, 1e-30))[:, None, None]
            new_rho = jnp.clip(rho * ratio, config.rho_min, config.rho_max)
            u = u * (rho / new_rho)
            rho = new_rho

    def unpad(vp):
        """Padded (S, 1, m_p) -> (S, m) flat [ball-x|ball-y|ball-z|half]."""
        cols = [vp[:, 0, c * nb_p:c * nb_p + n_ball] for c in range(3)]
        half = [vp[:, 0, c * nb_p + lane:c * nb_p + lane + ln]
                for (c, lane, _, ln) in layout.half_chunks()]
        return jnp.concatenate(cols + half, axis=-1).astype(out_dtype)

    x_fin = x[:, :, 0].astype(out_dtype)
    return (x_fin, unpad(z), unpad(u), unpad(y),
            rho[:, 0, 0].astype(out_dtype),
            prim_res.astype(out_dtype), dual_res.astype(out_dtype))


class _PaddedPre(NamedTuple):
    """Per-scenario pre-stage tensors (equilibrated, padded layout)."""
    gt: jnp.ndarray           # (nfd, m_p)
    b_pad: jnp.ndarray        # (1, m_p)
    rb: jnp.ndarray           # (n_ball,) scaled radii
    sb: jnp.ndarray           # (n_ball,)
    sh: jnp.ndarray           # (n_half,)
    p_big: jnp.ndarray        # (nfd, nfd) kron(p_eq, I_D) -- dense fallback
    p_eq: jnp.ndarray         # (n_free, n_free) equilibrated R_pp
    q_flat: jnp.ndarray       # (nfd,)
    x_flat0: jnp.ndarray      # (nfd,)
    d_scale: jnp.ndarray      # (n_free,)


def _warmstart_position_cols(structure: ProblemStructure):
    """Static (pos, rest) free-column index split for the in-trace warm
    start: pos = interior-vertex position columns, rest = the others."""
    fc = np.asarray(structure.free_cols)
    interior = (fc[:, 0] > 0) & (fc[:, 0] < structure.n_vertices - 1)
    pos_mask = interior & (fc[:, 1] == 0)
    pos = np.nonzero(pos_mask)[0].astype(np.int32)
    rest = np.nonzero(~pos_mask)[0].astype(np.int32)
    return pos, rest


def _objective_blocks(structure, d_fixed, times, config, x0, dtype,
                      warmstart_positions=None):
    """Equilibrated objective (p_eq/q_eq/d_scale) + scaled warm start.

    warmstart_positions: (V-2, D) interior waypoint positions.  When given
    (and x0 is None), the position-constrained warm start is computed ON the
    free-structure R blocks assembled here: pin the interior-position free
    columns to the waypoints and solve the remaining (n_free - V + 2)-sized
    SPD system -- the same equality-constrained minimum the reference's
    computeInitialSolutionWithPositionConstraints obtains via a separate
    standard-structure solve (nonlinear_impl.h:199-272), without assembling
    a second R.  Start/goal derivatives are taken from ``d_fixed``.
    """
    nf = structure.n_fixed
    n_free = structure.n_free
    # Objective blocks: per-dim quadratic with the same R_pp
    # (constructRkDim, qcqp_impl.h:189-221, is block-diagonal over dims).
    r = linear.assemble_r(structure, times)
    r_pf = r[nf:, :nf]
    r_pp = r[nf:, nf:]
    q_lin = jnp.einsum('pf,fd->pd', r_pf, d_fixed)        # 0.5 grad at x=0
    # Cost scaling: x = d_scale * x_tilde with unit-diagonal P_tilde.
    d_scale = jax.lax.rsqrt(jnp.diagonal(r_pp))           # (n_free,)
    p_eq = r_pp * d_scale[:, None] * d_scale[None, :]
    q_eq = q_lin * d_scale[:, None]
    if x0 is not None:
        x_init = jnp.asarray(x0, dtype) / d_scale[:, None]
    elif warmstart_positions is not None:
        pos, rest = _warmstart_position_cols(structure)
        pos_j = jnp.asarray(pos)
        rest_j = jnp.asarray(rest)
        wp = jnp.asarray(warmstart_positions, dtype)       # (n_pos, D)
        r_rr = r_pp[rest][:, rest]
        r_rp = r_pp[rest][:, pos]
        rhs = -(q_lin[rest_j] + r_rp @ wp)
        s_r = jax.lax.rsqrt(jnp.diagonal(r_rr))
        x_r = s_r[:, None] * (linalg.spd_inverse_schur(
            r_rr * s_r[:, None] * s_r[None, :]) @ (rhs * s_r[:, None]))
        x0_full = jnp.zeros((n_free, wp.shape[-1]), dtype)
        x0_full = x0_full.at[pos_j].set(wp).at[rest_j].set(x_r)
        x_init = x0_full / d_scale[:, None]
    else:
        # Unconstrained minimum: P x = -q  (per dim).
        x_init = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(
                p_eq + config.sigma * jnp.eye(n_free, dtype=dtype),
                lower=True), q_eq)
    return p_eq, q_eq, d_scale, x_init


def _padded_pre(structure: ProblemStructure, d_fixed, times, waypoints,
                radii, config: ADMMConfig, x0,
                layout: _PadLayout, warmstart_positions=None) -> _PaddedPre:
    """Per-scenario setup for the padded path: the equilibrated system
    assembled directly in the padded component-plane layout (no unpadded
    G, no big repacks)."""
    dtype = jnp.result_type(d_fixed, times)
    dim = structure.dimension
    p_eq, q_eq, d_scale, x_init = _objective_blocks(
        structure, d_fixed, times, config, x0, dtype,
        warmstart_positions=warmstart_positions)
    gt, b_pad, rb, sb, sh = _padded_constraint_system(
        structure, times, d_fixed, waypoints, radii, d_scale, layout,
        config.rho_sphere_factor, config.rho_tube_factor,
        config.rho_half_factor)
    return _PaddedPre(
        gt=gt, b_pad=b_pad, rb=rb, sb=sb, sh=sh,
        p_big=jnp.kron(p_eq, jnp.eye(dim, dtype=dtype)), p_eq=p_eq,
        q_flat=q_eq.reshape(-1), x_flat0=x_init.reshape(-1),
        d_scale=d_scale)


def _padded_post(structure: ProblemStructure, config: ADMMConfig,
                 d_fixed, times, pre: _PaddedPre,
                 x_fin_flat, u_fin, y_fin, rho, prim_res, dual_res,
                 dtype) -> QCQPSolution:
    """Per-scenario outputs: violation from the scaled y, coefficients,
    dual certificates (flat [ball-x|ball-y|ball-z|half] vector order)."""
    n_free = structure.n_free
    dim = structure.dimension
    n_ball = pre.sb.shape[0]
    # True-space violation from the scaled y: y_scaled = s * y_true.
    yb_pl = y_fin[:3 * n_ball].reshape(3, n_ball)
    nb_norm = jnp.linalg.norm(yb_pl, axis=0)
    viol_ball = jnp.max((nb_norm - pre.rb) / pre.sb)
    yh = y_fin[3 * n_ball:]
    viol = jnp.maximum(viol_ball, jnp.max(yh / pre.sh)).astype(dtype)

    ub = u_fin[:3 * n_ball].reshape(3, n_ball).T
    uh = u_fin[3 * n_ball:]
    converged = (prim_res < config.eps_primal) & (dual_res < config.eps_dual)
    d_free = x_fin_flat.reshape(n_free, dim) * pre.d_scale[:, None]
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)
    # Dual convention: see solve_qcqp.
    dual_ball = 2.0 * rho * pre.sb[:, None] * ub
    dual_half = 2.0 * rho * pre.sh * uh
    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=dual_res,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half)


def _flagship_layout(structure: ProblemStructure) -> _PadLayout:
    k_seg = structure.n_segments
    n_co = structure.n_coefficients
    return _PadLayout.make((k_seg - 1) + k_seg * (n_co - 2),
                           k_seg * (n_co - 2) * 2)


@linear.full_matmul_precision
def solve_qcqp(structure: ProblemStructure,
               d_fixed: jnp.ndarray,
               times: jnp.ndarray,
               waypoints: jnp.ndarray,
               radii: jnp.ndarray,
               config: ADMMConfig = ADMMConfig(),
               x0: Optional[jnp.ndarray] = None,
               warmstart_positions: Optional[jnp.ndarray] = None
               ) -> QCQPSolution:
    """Solve one tube-constrained QCQP scenario (vmap over a batch for many;
    prefer ``solve_qcqp_batch`` for large padded-path batches).

    Args mirror the reference's Constrained::setupFromVertices + solveQCQP
    (qcqp_impl.h:121-186, 477-788); ``structure`` must be the free-interior
    family (``free_interior_mask``): start/goal fully fixed, interior vertex
    derivatives all free, positions confined by the sphere/tube geometry.

    ``warmstart_positions`` (V-2, D): interior waypoint positions for the
    position-constrained warm start (computeInitialSolutionWithPosition-
    Constraints, nonlinear_impl.h:199-272) -- mutually exclusive with x0.

    Returns QCQPSolution with per-scenario convergence status (never aborts).
    """
    if x0 is not None and warmstart_positions is not None:
        raise ValueError("pass x0 or warmstart_positions, not both")
    dtype = jnp.result_type(d_fixed, times)
    d_fixed = jnp.asarray(d_fixed, dtype)
    times = jnp.asarray(times, dtype)
    waypoints = jnp.asarray(waypoints, dtype)
    radii = jnp.asarray(radii, dtype)

    nf = structure.n_fixed
    n_free = structure.n_free
    dim = structure.dimension
    nfd = n_free * dim

    if config.padded_lanes:
        layout = _flagship_layout(structure)
        pre = _padded_pre(structure, d_fixed, times, waypoints, radii,
                          config, x0, layout,
                          warmstart_positions=warmstart_positions)
        (x_fin, _, u_fin, y_fin, rho, prim_res, dual_res) = (
            jax.tree.map(lambda a: a[0], _run_stages_padded(
                config, pre.gt[None], pre.b_pad[None], pre.rb[None], layout,
                pre.p_big[None], pre.q_flat[None], pre.x_flat0[None],
                nfd, dtype, kkt_block=_kkt_tridiag_block(structure),
                p_eq=pre.p_eq[None])))
        return _padded_post(structure, config, d_fixed, times, pre,
                            x_fin, u_fin, y_fin, rho, prim_res, dual_res,
                            dtype)

    p_eq, q_eq, d_scale, x_init = _objective_blocks(
        structure, d_fixed, times, config, x0, dtype,
        warmstart_positions=warmstart_positions)
    p_big = jnp.kron(p_eq, jnp.eye(dim, dtype=dtype))
    eye_kkt = jnp.eye(nfd, dtype=dtype)
    q_flat = q_eq.reshape(nfd)
    x_flat0 = x_init.reshape(nfd)

    # XLA scan path (f64-capable, reference-layout tensors).
    cons = build_constraints(structure, times, d_fixed, waypoints, radii)
    gb = cons.g_ball * d_scale[None, None, :, None]
    gh = cons.g_half * d_scale[None, :, None]

    # Row scaling: per ball block / half row -> unit Frobenius scale,
    # clamped to _row_scale_bounds(N): constraints whose Jacobian block is
    # (near-)zero -- e.g. tube constraints on the first segment's leading
    # control points, which depend only on *fixed* start derivatives --
    # are constants; unbounded up-scaling of those rows poisons the
    # solvers.
    rs_lo, rs_hi = _row_scale_bounds(structure.n_coefficients)
    sb = 1.0 / jnp.clip(
        jnp.sqrt(jnp.sum(gb ** 2, axis=(1, 2, 3)) / 3.0), rs_lo, rs_hi)
    sh = 1.0 / jnp.clip(jnp.sqrt(jnp.sum(gh ** 2, axis=(1, 2))),
                        rs_lo, rs_hi)
    if (config.rho_sphere_factor, config.rho_tube_factor,
            config.rho_half_factor) != (1.0, 1.0, 1.0):
        n_sph = structure.n_segments - 1
        fac_b = jnp.concatenate([
            jnp.full((n_sph,), np.sqrt(config.rho_sphere_factor), dtype),
            jnp.full((sb.shape[0] - n_sph,),
                     np.sqrt(config.rho_tube_factor), dtype)])
        sb = sb * fac_b
        # dtype-pinned: a bare np scalar would promote f32 -> f64 under
        # x64 and break the scan carry.
        sh = sh * dtype.type(np.sqrt(config.rho_half_factor))
    gb = gb * sb[:, None, None, None]
    bb = cons.b_ball * sb[:, None]
    rb = cons.r_ball * sb
    gh = gh * sh[:, None, None]
    bh = cons.b_half * sh

    # x (n_free, D) flattens p-major (index p*dim + d); ball rows flatten
    # COMPONENT-major ([all x | all y | all z]) so the ball projection is
    # three contiguous slices (also the padded lane layout).  All
    # per-iteration work becomes two dense matvecs against precomputed
    # matrices -- deliberately NO triangular solves inside the scan
    # (batched triangular solves are latency-bound row sweeps).
    n_ball = gb.shape[0]
    n_half = gh.shape[0]
    mb = n_ball * 3
    gb_cm = jnp.moveaxis(gb, 1, 0)                        # (3, n_ball, nf, D)
    g_all = jnp.concatenate([gb_cm.reshape(mb, nfd),
                             gh.reshape(n_half, nfd)], axis=0)  # (m, nfd)
    b_all = jnp.concatenate([bb.T.reshape(mb), bh])
    gtg = g_all.T @ g_all

    def project_flat(v):
        vb = v[:mb].reshape(3, n_ball)
        sq = jnp.sum(vb * vb, axis=0)
        scale = jnp.where(sq > rb * rb,
                          rb / jnp.sqrt(jnp.maximum(sq, 1e-30)), 1.0)
        return jnp.concatenate([(vb * scale).reshape(mb),
                                jnp.minimum(v[mb:], 0.0)])

    z0 = project_flat(g_all @ x_flat0 + b_all)
    x_fin_flat, z_fin, u_fin, rho, prim_res, dual_res = _run_stages_xla(
        config, g_all, b_all, gtg, p_big, eye_kkt, q_flat,
        x_flat0, z0, project_flat, dtype)

    mb = n_ball * 3
    ub = u_fin[:mb].reshape(3, n_ball).T
    uh = u_fin[mb:]
    converged = (prim_res < config.eps_primal) & (dual_res < config.eps_dual)

    d_free = x_fin_flat.reshape(n_free, dim) * d_scale[:, None]   # unscale

    # Outputs: coefficients + true-space violation check.
    sol = linear.solve_linear_with_free(structure, d_fixed, d_free, times)
    yb_true = (jnp.einsum('bipd,pd->bi', cons.g_ball, d_free)
               + cons.b_ball)
    viol_ball = jnp.max(jnp.linalg.norm(yb_true, axis=-1) - cons.r_ball)
    yh_true = jnp.einsum('hpd,pd->h', cons.g_half, d_free) + cons.b_half
    viol = jnp.maximum(viol_ball, jnp.max(yh_true))

    # Original-space dual certificates: for the scaled system
    # grad f_eq + Geq^T (rho u) = 0; unscaling gives multipliers S * rho * u.
    # The internal objective is 0.5 x^T R_pp x + (R_pf d_f)^T x; the factor 2
    # converts the duals to the reference's J_d = x^T R x + 2 d_f^T R_fp x
    # convention (getCostAndGradientDerivative, nonlinear_impl.h:1537-1606)
    # so that  2 R_pp x + 2 R_pf d_f + G^T nu = 0  holds at optimality.
    dual_ball = 2.0 * rho * sb[:, None] * ub
    dual_half = 2.0 * rho * sh * uh

    return QCQPSolution(
        coefficients=sol.coefficients, times=times, d_fixed=d_fixed,
        d_free=d_free, cost=sol.cost, converged=converged,
        primal_residual=prim_res, dual_residual=dual_res,
        max_violation=viol, dual_ball=dual_ball, dual_half=dual_half)


@linear.full_matmul_precision
def solve_qcqp_batch(structure: ProblemStructure,
                     d_fixed: jnp.ndarray,
                     times: jnp.ndarray,
                     waypoints: jnp.ndarray,
                     radii: jnp.ndarray,
                     config: ADMMConfig = ADMMConfig(),
                     x0: Optional[jnp.ndarray] = None,
                     warmstart_values: Optional[jnp.ndarray] = None,
                     scenario_block: int = 4,
                     _return_pre: bool = False) -> QCQPSolution:
    """Batched QCQP (all args carry a leading batch axis B).

    With ``config.padded_lanes`` the batch runs the padded lane-layout
    ADMM (_run_stages_padded), grouped into blocks of ``scenario_block``
    scenarios -- a reshape only: the blocks run as one batched program.
    B is padded to a multiple of S by repeating the last scenario, then
    sliced back.  Otherwise it is a vmap of ``solve_qcqp``.

    ``warmstart_values`` (B, V, n_d, D) vertex values: compute the
    position-constrained warm start INSIDE the per-scenario trace (schur
    linear solve), letting XLA CSE the Hessian blocks it shares with the
    QCQP objective assembly -- cheaper than passing a separately-computed
    ``x0``.  Mutually exclusive with ``x0``.
    """
    if x0 is not None and warmstart_values is not None:
        raise ValueError("pass x0 or warmstart_values, not both")
    if _return_pre and not config.padded_lanes:
        raise ValueError("_return_pre requires padded_lanes=True (the "
                         "reusable padded system only exists on the "
                         "padded path)")
    if not config.padded_lanes:
        if warmstart_values is not None:
            wv_d = jnp.asarray(warmstart_values,
                               jnp.result_type(d_fixed, times))
            return jax.vmap(lambda df, t, w, r, wv: solve_qcqp(
                structure, df, t, w, r, config,
                warmstart_positions=wv[1:-1, 0, :]))(
                d_fixed, times, waypoints, radii, wv_d)
        return jax.vmap(lambda df, t, w, r, xx: solve_qcqp(
            structure, df, t, w, r, config, xx))(
            d_fixed, times, waypoints, radii, x0)
    s = scenario_block
    b = d_fixed.shape[0]
    b_pad = ((b + s - 1) // s) * s
    nfd = structure.n_free * structure.dimension
    dtype = jnp.result_type(d_fixed, times)
    layout = _flagship_layout(structure)

    kkt_block = _kkt_tridiag_block(structure)

    def pad(a):
        if a is None or b_pad == b:
            return a
        reps = jnp.repeat(a[-1:], b_pad - b, axis=0)
        return jnp.concatenate([a, reps], axis=0)

    def group(a):
        return None if a is None else a.reshape((b_pad // s, s) + a.shape[1:])

    d_fixed_g, times_g, waypoints_g, radii_g, x0_g, wv_g = (
        group(pad(jnp.asarray(a, dtype) if a is not None else None))
        for a in (d_fixed, times, waypoints, radii, x0, warmstart_values))

    def block(df, t, w, r, xx=None, wv=None):
        if wv is not None:
            # Position-constrained warm start computed ON the free-structure
            # R blocks (_objective_blocks): no second (standard-structure) R
            # assembly.  Interior positions come from the vertex values;
            # start/goal derivatives from d_fixed (callers pass consistent
            # values, as the reference's init path assumes).
            def pre_one(a1, a2, a3, a4, a5):
                return _padded_pre(structure, a1, a2, a3, a4, config, None,
                                   layout,
                                   warmstart_positions=a5[1:-1, 0, :])
            pre = jax.vmap(pre_one)(df, t, w, r, wv)
        elif xx is None:
            pre = jax.vmap(lambda a1, a2, a3, a4: _padded_pre(
                structure, a1, a2, a3, a4, config, None, layout))(df, t, w, r)
        else:
            pre = jax.vmap(lambda a1, a2, a3, a4, a5: _padded_pre(
                structure, a1, a2, a3, a4, config, a5, layout))(
                df, t, w, r, xx)
        outs = _run_stages_padded(
            config, pre.gt, pre.b_pad, pre.rb, layout, pre.p_big,
            pre.q_flat, pre.x_flat0, nfd, dtype, kkt_block=kkt_block,
            p_eq=pre.p_eq)
        sol_b = jax.vmap(lambda dfi, ti, prei, x, u, y, rho, pr, du:
                         _padded_post(structure, config, dfi, ti, prei,
                                      x, u, y, rho, pr, du, dtype))(
            df, t, pre, outs[0], outs[2], outs[3], outs[4], outs[5], outs[6])
        if _return_pre:
            # The lanes polish reuses the assembled system (rescaled by
            # penalty_unscale_maps); p_big is the dense fallback the
            # banded path never materializes -- drop it from the reuse
            # bundle so it is not forced live.
            return sol_b, pre._replace(p_big=pre.q_flat)
        return sol_b

    if wv_g is not None:
        sol = jax.vmap(lambda a, b, c, d, e: block(a, b, c, d, wv=e))(
            d_fixed_g, times_g, waypoints_g, radii_g, wv_g)
    elif x0_g is None:
        sol = jax.vmap(block)(d_fixed_g, times_g, waypoints_g, radii_g)
    else:
        sol = jax.vmap(block)(d_fixed_g, times_g, waypoints_g, radii_g, x0_g)
    # Both the solution and (when _return_pre) the pre bundle carry the
    # same (b_pad // s, s, ...) leading blocking.
    flat = jax.tree.map(lambda a: a.reshape((b_pad,) + a.shape[2:])[:b], sol)
    return flat


def position_constrained_warmstart(free_structure: ProblemStructure,
                                   vertex_values: jnp.ndarray,
                                   times: jnp.ndarray,
                                   method: str = "cholesky") -> jnp.ndarray:
    """x0 for the QCQP: solve the position-constrained linear problem and
    re-express its endpoint derivatives as free-interior d_free.

    The reference's computeInitialSolutionWithPositionConstraints
    (nonlinear_impl.h:199-272): solve with interior positions fixed, then
    free them and seed d_p from the old solution (d_all = M^+ A p there; here
    we read the endpoint derivatives off the compact solution directly --
    same result without the pseudo-inverse detour).
    """
    n = free_structure.n_coefficients
    v = free_structure.n_vertices
    std = make_structure(standard_mask(v, n), free_structure.dimension, n,
                         free_structure.derivative_to_optimize)
    d_fixed_std = linear.extract_fixed_values(std, vertex_values)
    # Compact solve only: the warm start needs d_free, not coefficients.
    d_free_std = linear.solve_free_derivatives(std, d_fixed_std, times,
                                               method=method)
    d_all_std = jnp.concatenate(
        [jnp.broadcast_to(
            jnp.asarray(d_fixed_std, d_free_std.dtype),
            d_free_std.shape[:-2] + (std.n_fixed, std.dimension)),
         d_free_std], axis=-2)

    # Static index map: free column (vtx, deriv) of the free structure ->
    # compact column in the standard structure.
    std_col = {tuple(c): i for i, c in enumerate(std.fixed_cols)}
    std_col.update({tuple(c): std.n_fixed + i
                    for i, c in enumerate(std.free_cols)})
    idx = np.asarray([std_col[tuple(c)] for c in free_structure.free_cols],
                     dtype=np.int32)
    return jnp.take(d_all_std, jnp.asarray(idx), axis=-2)
